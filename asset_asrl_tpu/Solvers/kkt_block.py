"""Block-tridiagonal KKT backend: the structured Pardiso replacement.

Reference: MKL Pardiso sparse LDL^T (`src/Solvers/PardisoInterface.h`) +
METIS ordering.  Instead of general sparse factorization, this backend
commits to the structure LGL transcription produces (SURVEY.md section 5.7):
with the phase layout [(x_i,u_i) per node | t0,tf,params], every defect /
path-constraint row couples a bounded window of consecutive nodes, so the
reduced KKT (inequalities condensed by slack/dual elimination) is

    K = [ T   B ]      T: symmetric block-tridiagonal over macro-blocks
        [ B^T C ]      B: coupling to a small dense border
                       C: border block (t0/tf/params + boundary rows)

Macro-blocks group q consecutive node-blocks plus the equality-multiplier
rows assigned to them, with q chosen so every constraint's node span fits two
adjacent macros.

Factorization = block cyclic reduction (BCR): log2(K) levels, each level a
vmapped batch of dense eliminations of the odd macro-blocks — batched
matmuls instead of Pardiso's sequential supernodal sweep.  Inertia comes from
batched eigendecompositions of the eliminated diagonal blocks (Sylvester's
law of inertia over the congruence), which drives PSIOPT's perturbation
ladder exactly like Pardiso's neigs count (`PSIOPT.cpp:422`).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from functools import partial

from ..config import DEFAULT_DTYPE


class _nullctx:
    def __enter__(self):
        return None

    def __exit__(self, *a):
        return False


# ===========================================================================
# Structure analysis
# ===========================================================================

class BlockStructure:
    """Maps global unknowns (primal vars + eq multipliers) to
    (macro k, offset) or the border; precomputes scatter indices for
    assembling K directly in block form.

    Parameters
    ----------
    node_of_var : (n,) int array; node id per primal var, -1 = border var.
    eq_fams : list of (Vidx, rows, nout) per equality family (numpy).
    iq_fams : list of (Vidx, rows, nout) per inequality family.
    obj_fams : list of Vidx per objective family.
    """

    def __init__(self, numPrimal, numEq, numIq, node_of_var,
                 eq_fams, iq_fams, obj_fams):
        """eq_fams/iq_fams: [(Vidx, rows, jac_cm, hess_cm)], obj_fams:
        [(Vidx, jac_cm, hess_cm)] — (nin,) bool masks of the inputs the
        function's Jacobian / adjoint-Hessian actually touch (probed
        sparsity, the analog of the reference's INPUT_DOMAIN tracking
        in `FunctionDomains.h`).  For inequalities hess_cm must include
        the slack-condensation coupling (all Jacobian-column pairs).

        Far couplings do NOT force a dense fallback (the reference's
        Pardiso handles arbitrary sparsity; our escape hatch is the dense
        border): an application whose *Jacobian* row spans non-adjacent
        macros puts that constraint row in the border, and an application
        whose *Hessian* couples non-adjacent macros (nonlinear
        front-to-back constraints, periodicity, long-range links) promotes
        its minority variables to the border so every remaining in-band
        entry couples adjacent macros only."""
        node_of_var = np.asarray(node_of_var, np.int64)
        self._node_of_var = node_of_var
        self.n, self.mE, self.mI = numPrimal, numEq, numIq
        nnodes = int(node_of_var.max()) + 1

        def app_spans(Vidx, colmask, extra_excl=None):
            nds = node_of_var[Vidx]              # (napps, nin)
            valid = (nds >= 0) & colmask[None, :]
            if extra_excl is not None:
                valid &= ~extra_excl[Vidx]
            lo = np.where(valid, nds, np.iinfo(np.int64).max).min(axis=1)
            hi = np.where(valid, nds, -1).max(axis=1)
            return lo, hi

        # -------- macro sizing: max node window of any LOCAL application.
        # Apps spanning more than LOCAL_THR nodes (front-to-back rows,
        # periodicity, Accumulation-style couplings) are routed via the
        # border instead of inflating the macro size q.
        LOCAL_THR = max(2, nnodes // 4)
        max_span = 1
        for Vidx, rows, jcm, hcm in eq_fams + iq_fams:
            lo, hi = app_spans(Vidx, jcm | hcm)
            if len(lo):
                sp = np.where(hi >= 0, hi - lo + 1, 1)
                sp = sp[sp <= LOCAL_THR]
                if len(sp):
                    max_span = max(max_span, int(sp.max()))
        for Vidx, jcm, hcm in obj_fams:
            lo, hi = app_spans(Vidx, hcm)
            if len(lo):
                sp = np.where(hi >= 0, hi - lo + 1, 1)
                sp = sp[sp <= LOCAL_THR]
                if len(sp):
                    max_span = max(max_span, int(sp.max()))

        self.q = max(1, max_span - 1)            # nodes per macro
        self.K = max(1, -(-nnodes // self.q))    # number of macros
        macro_of_node = np.minimum(np.arange(nnodes) // self.q, self.K - 1)

        # -------- border promotion of far-coupled Hessian variables -------
        # For every app whose Hessian couples non-adjacent macros, keep the
        # adjacent macro pair holding the most of its variables and promote
        # the rest to the border (their rows/cols land in B / C).
        promote = np.zeros(numPrimal, bool)
        hess_groups = [(V, h) for V, r, j, h in eq_fams + iq_fams] \
            + [(V, h) for V, j, h in obj_fams]
        for Vidx, hcm in hess_groups:
            if not hcm.any() or not len(Vidx):
                continue
            lo, hi = app_spans(Vidx, hcm)
            far = (hi >= 0) & (macro_of_node[np.maximum(hi, 0)]
                               - macro_of_node[np.clip(lo, 0, nnodes - 1)]
                               > 1)
            for a in np.where(far)[0]:
                cols = np.where(hcm & (node_of_var[Vidx[a]] >= 0))[0]
                vids = Vidx[a][cols]
                macs = macro_of_node[node_of_var[vids]]
                # best adjacent macro pair by member count
                cnt = np.bincount(macs, minlength=self.K)
                pair = cnt + np.append(cnt[1:], 0)    # count in {m, m+1}
                m0 = int(np.argmax(pair))
                keep = (macs == m0) | (macs == m0 + 1)
                promote[vids[~keep]] = True

        # -------- unknown -> (macro, slot) assignment ----------------------
        # vars first, then eq rows, macro by macro
        var_macro = np.where((node_of_var >= 0) & ~promote,
                             macro_of_node[np.maximum(node_of_var, 0)], -1)

        # eq row macro: middle node of the app's banded-jacobian span
        # (border if no banded nodes or the span crosses >2 macros)
        row_macro = np.full(numEq, -1, np.int64)
        for Vidx, rows, jcm, hcm in eq_fams:
            lo, hi = app_spans(Vidx, jcm, extra_excl=promote)
            for a in range(Vidx.shape[0]):
                if hi[a] < 0:
                    continue  # border row (params/promoted only)
                mlo = macro_of_node[lo[a]]
                mhi = macro_of_node[hi[a]]
                if mhi - mlo > 1:
                    continue  # spans too far even after promotion: border
                row_macro[rows[a]] = mlo if (hi[a] - lo[a] == 0) else \
                    macro_of_node[(lo[a] + hi[a]) // 2]

        # slots
        self.var_slot = np.zeros(numPrimal, np.int64)
        self.row_slot = np.zeros(numEq, np.int64)
        counts = np.zeros(self.K, np.int64)
        border_count = 0
        order_vars = np.argsort(var_macro, kind="stable")
        # assign var slots macro-major preserving var order
        for k in range(self.K):
            idx = np.where(var_macro == k)[0]
            self.var_slot[idx] = counts[k] + np.arange(len(idx))
            counts[k] += len(idx)
        bidx = np.where(var_macro < 0)[0]
        self.border_var_slot = {int(v): border_count + i
                                for i, v in enumerate(bidx)}
        border_count += len(bidx)
        self.nborder_vars = len(bidx)
        for k in range(self.K):
            idx = np.where(row_macro == k)[0]
            self.row_slot[idx] = counts[k] + np.arange(len(idx))
            counts[k] += len(idx)
        bre = np.where(row_macro < 0)[0]
        self.border_row_slot = {int(r): border_count + i
                                for i, r in enumerate(bre)}
        border_count += len(bre)
        self.b = border_count
        self.W = int(counts.max()) if self.K else 0
        self.counts = counts
        self.var_macro = var_macro
        self.row_macro = row_macro
        self.macro_of_node = macro_of_node

        # global unknown id -> (macro, slot) arrays for vars and rows
        self._uvar_macro = var_macro
        self._uvar_slot = np.where(
            var_macro >= 0, self.var_slot,
            np.array([self.border_var_slot.get(int(v), 0)
                      for v in range(numPrimal)]))
        self._urow_macro = row_macro
        self._urow_slot = np.where(
            row_macro >= 0, self.row_slot,
            np.array([self.border_row_slot.get(int(r), 0)
                      for r in range(numEq)]))

        # number of negative eigenvalues expected: mE (+mI condensed)
        self.target_neigs = numEq

    # ------------------------------------------------------------- targets
    def jac_targets(self, Vidx, rows, nz=None):
        """Scatter targets for a constraint-Jacobian batch.

        Input J values are ordered (app, r, c) flattened.  Each value lands
        symmetrically in K; returns dict arr_name -> (src_flat, tgt_flat)
        covering both triangles (diag/C get two placements per value, the
        lower/B arrays hold one canonical triangle).  nz: (nout, nin) bool
        sparsity mask — structurally-zero entries are pruned.
        """
        napps, nout = rows.shape
        nin = Vidx.shape[1]
        W, b = self.W, self.b
        src = np.arange(napps * nout * nin).reshape(napps, nout, nin)
        if nz is not None:
            src = np.where(nz[None, :, :], src, -1)
        rmac = self._urow_macro[rows][:, :, None] + np.zeros((1, 1, nin),
                                                            np.int64)
        rslot = self._urow_slot[rows][:, :, None] + np.zeros((1, 1, nin),
                                                             np.int64)
        cmac = self._uvar_macro[Vidx][:, None, :] + np.zeros((1, nout, 1),
                                                             np.int64)
        cslot = self._uvar_slot[Vidx][:, None, :] + np.zeros((1, nout, 1),
                                                              np.int64)
        return self._classify(src, rmac, rslot, cmac, cslot, sym_from_one=True)

    def hess_targets(self, Vidx, nz=None):
        """Scatter targets for a symmetric-Hessian batch ordered
        (app, a, b): each value lands once at its natural position; upper
        inter-macro entries are skipped (covered by their transposed
        partner).  nz: (nin, nin) bool sparsity mask."""
        napps, nin = Vidx.shape
        src = np.arange(napps * nin * nin).reshape(napps, nin, nin)
        if nz is not None:
            src = np.where(nz[None, :, :], src, -1)
        amac = self._uvar_macro[Vidx][:, :, None] + np.zeros((1, 1, nin),
                                                             np.int64)
        aslot = self._uvar_slot[Vidx][:, :, None] + np.zeros((1, 1, nin),
                                                              np.int64)
        bmac = self._uvar_macro[Vidx][:, None, :] + np.zeros((1, nin, 1),
                                                             np.int64)
        bslot = self._uvar_slot[Vidx][:, None, :] + np.zeros((1, nin, 1),
                                                              np.int64)
        return self._classify(src, amac, aslot, bmac, bslot,
                              sym_from_one=False)

    def _classify(self, src, rmac, rslot, cmac, cslot, sym_from_one):
        W, b, K = self.W, self.b, self.K
        src = src.ravel()
        rmac, rslot = rmac.ravel(), rslot.ravel()
        cmac, cslot = cmac.ravel(), cslot.ravel()
        keep = src >= 0
        src, rmac, rslot = src[keep], rmac[keep], rslot[keep]
        cmac, cslot = cmac[keep], cslot[keep]
        rb = rmac < 0
        cb = cmac < 0
        out = {}

        both = (~rb) & (~cb)
        same = both & (rmac == cmac)
        low = both & (rmac == cmac + 1)
        upp = both & (cmac == rmac + 1)
        bad = both & (np.abs(rmac - cmac) > 1)
        if np.any(bad):
            raise ValueError(
                "KKT structure violation: entry couples non-adjacent "
                "macro-blocks; increase macro size q")

        def flatD(k, i, j):
            return k * W * W + i * W + j

        if sym_from_one:
            # J value -> both (r,c) and (c,r)
            s = np.concatenate([src[same], src[same]])
            t = np.concatenate([flatD(rmac[same], rslot[same], cslot[same]),
                                flatD(rmac[same], cslot[same], rslot[same])])
            out["diag"] = (s, t)
            s = np.concatenate([src[low], src[upp]])
            t = np.concatenate([
                flatD(cmac[low], rslot[low], cslot[low]),
                flatD(rmac[upp], cslot[upp], rslot[upp])])
            out["lower"] = (s, t)
            # banded x border
            rbb = (~rb) & cb
            brb = rb & (~cb)
            s = np.concatenate([src[rbb], src[brb]])
            t = np.concatenate([
                rmac[rbb] * W * b + rslot[rbb] * b + cslot[rbb],
                cmac[brb] * W * b + cslot[brb] * b + rslot[brb]])
            out["B"] = (s, t)
            bb = rb & cb
            s = np.concatenate([src[bb], src[bb]])
            t = np.concatenate([rslot[bb] * b + cslot[bb],
                                cslot[bb] * b + rslot[bb]])
            out["C"] = (s, t)
        else:
            out["diag"] = (src[same],
                           flatD(rmac[same], rslot[same], cslot[same]))
            out["lower"] = (src[low],
                            flatD(cmac[low], rslot[low], cslot[low]))
            rbb = (~rb) & cb
            out["B"] = (src[rbb],
                        rmac[rbb] * W * b + rslot[rbb] * b + cslot[rbb])
            bb = rb & cb
            out["C"] = (src[bb], rslot[bb] * b + cslot[bb])
        return {k: (np.asarray(s, np.int32), np.asarray(t, np.int32))
                for k, (s, t) in out.items()}

    def app_anchors(self, Vidx, colmask):
        """Anchor macro per application: macro of its lowest banded node
        (-1 when the app touches no banded node)."""
        nds = self.macro_of_node
        node_of_var = self._node_of_var
        nn = node_of_var[Vidx]
        valid = (nn >= 0) & colmask[None, :]
        lo = np.where(valid, nn, np.iinfo(np.int64).max).min(axis=1)
        out = np.where(lo < np.iinfo(np.int64).max,
                       nds[np.clip(lo, 0, len(nds) - 1)], -1)
        return out

    def rhs_perm(self):
        """Flat positions of (vars ++ eq rows) in the block rhs layout:
        banded unknown -> k*W + slot, border unknown -> K*W + border_slot."""
        n, mE = self.n, self.mE
        pos = np.empty(n + mE, np.int64)
        vm, vs = self._uvar_macro, self._uvar_slot
        pos[:n] = np.where(vm >= 0, vm * self.W + vs, self.K * self.W + vs)
        rm, rs = self._urow_macro, self._urow_slot
        pos[n:] = np.where(rm >= 0, rm * self.W + rs, self.K * self.W + rs)
        return pos


# ===========================================================================
# Elementwise small-batched linear algebra
#
# Every small batched product in the solver uses these helpers: a
# broadcast-multiply-reduce that only ever reduces a non-minor axis, in
# place of a batched dot_general.  Their cost against jnp.matmul at the
# (K, 24, 24) block shapes on the H100 is not measured yet.
# ===========================================================================

def _bmm(A, B):
    """(K,a,b) @ (K,b,c) -> (K,a,c), reduction on a non-minor axis."""
    return (A[:, :, :, None] * B[:, None, :, :]).sum(2)


def _bmm_tn(A, B):
    """(K,b,a)^T @ (K,b,c) -> (K,a,c)."""
    return (A[:, :, :, None] * B[:, :, None, :]).sum(1)


def _bT(A):
    return A.transpose(0, 2, 1)


def _mv(A, v):
    """(K,a,b) @ (K,b) -> (K,a)."""
    return (_bT(A) * v[:, :, None]).sum(1)


def _mv_t(A, v):
    """(K,b,a)^T @ (K,b) -> (K,a)."""
    return (A * v[:, :, None]).sum(1)


def _mv_const(B, z):
    """(K,a,b) @ (b,) -> (K,a): unrolled over the small static b."""
    b = B.shape[-1]
    if b == 0:
        return jnp.zeros(B.shape[:-1], B.dtype)
    out = B[:, :, 0] * z[0]
    for v in range(1, b):
        out = out + B[:, :, v] * z[v]
    return out


# ===========================================================================
# BCR factorization of [T, B; B^T, C]
# ===========================================================================

def _ldl_pivots(D):
    """Batched unpivoted LDL^T pivot sequence of symmetric blocks.

    Unrolled right-looking elimination (W static, each step a batched rank-1
    update); the pivot signs give the block's inertia by Sylvester's law.
    Unpivoted is numerically safe here because PSIOPT regularizes the KKT to
    symmetric quasi-definite form (delta/gamma diagonals)."""
    K, W, _ = D.shape
    ar = jnp.arange(W)

    def body(j, carry):
        M, pivs = carry
        col = M[:, :, j]
        d = col[:, j]
        pivs = pivs.at[:, j].set(d)
        mask = (ar > j).astype(D.dtype)
        l = col * mask[None, :]
        dsafe = jnp.where(jnp.abs(d) > 1e-300, d, 1.0)
        M = M - l[:, :, None] * l[:, None, :] / dsafe[:, None, None]
        return M, pivs

    _, pivs = jax.lax.fori_loop(
        0, W, body, (D, jnp.zeros((K, W), D.dtype)))
    return pivs


# Inverse used by the "mixed" pivot mode: "f64" exact LU (default), "gj"
# unpivoted Gauss-Jordan, "mixed" f32 LU + f64 Newton refinement.
INV_MODE = "f64"

# Precision of the BCR factorization.  Default "f64": the f32+Ruiz+FGMRES
# refinement path is kept selectable ("f32") for experimentation only; at
# late-IPM conditioning (kappa ~ 1/gamma ~ 1e10 >> 1/eps_f32) it loses.
FACTOR_DTYPE = "f64"

# Iterative-refinement rounds per solve when factoring in f32.
REFINE_STEPS = 3


def _refine_steps():
    """System-level Richardson refinement steps of every f64 BCR solve,
    dx += M^-1 (r - K dx) against the exact stored blocks.  Native f64
    needs none (0); ASSET_REFINE_STEPS sets a count."""
    import os
    return int(os.environ.get("ASSET_REFINE_STEPS", 0))


def _factor_dtype():
    import os
    mode = os.environ.get("ASSET_FACTOR_DTYPE", FACTOR_DTYPE)
    if mode == "auto":
        mode = "f64"
    return jnp.float32 if mode == "f32" else DEFAULT_DTYPE


def _inv_newton(D):
    """Batched matrix inverse.

    INV_MODE "f64": exact LU inverse.  "mixed": f32 LU inverse + f64
    Newton refinement steps (X <- X(2I - DX)), mirroring Pardiso's
    QPRefSteps iterative refinement (`PSIOPT.h:146`); four refinement steps
    handle block condition numbers up to ~1e7."""
    mode = INV_MODE
    if mode == "f64":
        return jnp.linalg.inv(D)
    if mode == "gj":
        return _inv_gj(D)
    W = D.shape[-1]
    X = jnp.linalg.inv(D.astype(jnp.float32)).astype(DEFAULT_DTYPE)
    X = jnp.where(jnp.isfinite(X), X, 0.0)
    eye = jnp.eye(W, dtype=DEFAULT_DTYPE)
    for _ in range(4):
        R = eye - D @ X
        X = X + X @ R
    return X


def _inv_gj(D):
    """Batched unpivoted Gauss-Jordan inverse in the input's precision.
    Valid for the regularized quasi-definite KKT blocks (INV_MODE='gj')."""
    K, W, _ = D.shape
    eye = jnp.broadcast_to(jnp.eye(W, dtype=D.dtype), (K, W, W))
    M = jnp.concatenate([D, eye], axis=2)

    def body(j, M):
        dj = M[:, j, j]
        dsafe = jnp.where(jnp.abs(dj) > 1e-300, dj, 1.0)
        piv = M[:, j, :] / dsafe[:, None]
        M = M - M[:, :, j][:, :, None] * piv[:, None, :]
        M = M.at[:, j, :].set(piv)
        return M

    M = jax.lax.fori_loop(0, W, body, M)
    return M[:, :, W:]


def _inv_gj_pivots(D):
    """Batched unpivoted Gauss-Jordan: full-f64 inverse AND the pivot
    sequence in one W-step loop.  The GJ pivots equal the LDL^T pivots
    (ratios of leading principal minors), so one sweep yields both the
    inverse and the inertia — no LU custom call, no refinement
    iterations."""
    K, W, _ = D.shape
    eye = jnp.broadcast_to(jnp.eye(W, dtype=D.dtype), (K, W, W))
    M = jnp.concatenate([D, eye], axis=2)

    def body(j, carry):
        M, pivs = carry
        dj = M[:, j, j]
        pivs = pivs.at[:, j].set(dj)
        dsafe = jnp.where(jnp.abs(dj) > 1e-300, dj, 1.0)
        piv = M[:, j, :] / dsafe[:, None]
        M = M - M[:, :, j][:, :, None] * piv[:, None, :]
        M = M.at[:, j, :].set(piv)
        return M, pivs

    M, pivs = jax.lax.fori_loop(
        0, W, body, (M, jnp.zeros((K, W), D.dtype)))
    return M[:, :, W:], pivs


def _newton_refine(D, X32, steps=4):
    """Refine an approximate f32 inverse to f64: X <- X(2I - DX), with the
    elementwise batched products (_bmm)."""
    W = D.shape[-1]
    X = jnp.asarray(X32, DEFAULT_DTYPE)
    X = jnp.where(jnp.isfinite(X), X, 0.0)
    eye = jnp.eye(W, dtype=DEFAULT_DTYPE)
    for _ in range(steps):
        R = eye[None] - _bmm(D, X)
        X = X + _bmm(X, R)
    return X


def _inv_sym(D):
    """Batched symmetric inverse + negative-pivot inertia count.

    Singular or non-finite pivots are counted as inertia failures so the
    solver's perturbation ladder engages (Pardiso's rank-deficiency path,
    reference factor_impl `PSIOPT.cpp:422`); with delta/gamma regularization
    every macro block is quasi-definite and elimination is clean."""
    if D.dtype == jnp.float32:
        # f32 factorization path (FACTOR_DTYPE="f32"): plain GJ; accuracy
        # is recovered by system-level iterative refinement in the solve
        Dinv, pivs = _inv_gj_pivots(D)
    else:
        # f64 inverse, selected by ASSET_INV_MODE:
        #   "gj" (default): one f64 unpivoted GJ sweep gives the inverse
        #     AND the pivot sequence.
        #   "mixed32": f32 GJ inverse + pivots refined to f64 by Newton
        #     steps X <- X(2I - DX); only the PIVOT SIGNS are f32, every
        #     downstream Schur product stays f64.
        #   "mixed": LDL pivots + the INV_MODE inverse (_inv_newton).
        import os
        mode = os.environ.get("ASSET_INV_MODE", "gj")
        if mode == "mixed":
            pivs = _ldl_pivots(D)
            Dinv = _inv_newton(D)
        elif mode == "mixed32":
            # f32 GJ inverse + pivots (validated sign-exact vs f64 on the
            # Ruiz-scaled blocks, incl. the delta-floor pivots), refined
            # to f64 by Newton steps.  The rel-to-blockmax threshold is a
            # BREAKDOWN detector only (pivot dynamic range spans 1e-5 ..
            # 1e5 post-Ruiz, so any sign-noise-sized relative threshold
            # over-flags and the ladder rejects everything).
            X32, pivs32 = _inv_gj_pivots(D.astype(jnp.float32))
            Dinv = _newton_refine(D, X32, steps=2)
            pivs = pivs32.astype(D.dtype)
            relb = float(os.environ.get("ASSET_PIVOT_REL", 1e-12))
            scale32 = jnp.max(jnp.abs(pivs), axis=1, keepdims=True)
            # absolute floor too: an all-zero pivot block has scale32=0
            # and would otherwise pass the inertia test on breakdown
            extra_bad = (jnp.abs(pivs) < relb * scale32) \
                | (jnp.abs(pivs) < 1e-30)
            neg32 = jnp.sum((pivs < 0) | extra_bad
                            | ~jnp.isfinite(pivs))
            Dinv = jnp.where(jnp.isfinite(Dinv), Dinv, 0.0)
            return Dinv, neg32
        else:
            Dinv, pivs = _inv_gj_pivots(D)
    tiny = 1e-25 if Dinv.dtype == jnp.float32 else 1e-250
    bad = ~jnp.isfinite(pivs) | (jnp.abs(pivs) < tiny)
    # Pivot-sign trust policy: a RELATIVE sub-blockmax pivot threshold
    # flags spurious inertia failures against an exact host block-LDL^T
    # inertia (the audit `chip_smoke.py` runs) and makes the ladder thrash,
    # so f64 pivots count by sign alone unless ASSET_PIVOT_REL sets one.
    import os
    if D.dtype == jnp.float32:
        rel = float(os.environ.get("ASSET_PIVOT_REL_F32", 1e-5))
    else:
        rel = float(os.environ.get("ASSET_PIVOT_REL", 0.0))
    if rel > 0.0:
        scale = jnp.max(jnp.abs(pivs), axis=1, keepdims=True)
        bad = bad | (jnp.abs(pivs) < rel * scale)
    neg = jnp.sum((pivs < 0) | bad)
    Dinv = jnp.where(jnp.isfinite(Dinv), Dinv, 0.0)
    return Dinv, neg


def _ruiz_iters():
    import os
    return int(os.environ.get("ASSET_RUIZ_ITERS", 2))


def _ruiz_equilibrate(diag, lower, Bmat, C, iters=None):
    """Symmetric Ruiz equilibration of the block-tridiagonal+border system.

    Collocation KKT rows scale like 1/h ~ K (defect jacobians), so the
    condition number grows with mesh size and an f32 factorization loses
    convergence beyond a few hundred segments.  Scaling S A S with
    s_i = prod 1/sqrt(max|row_i|) restores size-independent conditioning
    before the f32 cast; the congruence preserves inertia, so the pivot
    counts driving the perturbation ladder are unchanged (the reference
    enables the analogous Pardiso matching/scaling knobs,
    `src/Solvers/PSIOPT.h:143-151`).

    Returns (diag', lower', B', C', s (K,W), sb (b,)).
    """
    if iters is None:
        iters = _ruiz_iters()
    K, W, _ = diag.shape
    b = C.shape[0]
    # entry K-1 of lower is unused: mask it out of row maxima and scaling
    lmask = (jnp.arange(K) < K - 1)[:, None, None]
    lower = lower * lmask
    s = jnp.ones((K, W), diag.dtype)
    sb = jnp.ones((b,), diag.dtype)
    d, l, B, Cs = diag, lower, Bmat, C
    for _ in range(iters):
        rmax = jnp.max(jnp.abs(d), axis=2)                    # (K,W)
        rmax = jnp.maximum(rmax, jnp.max(jnp.abs(l), axis=1))  # (k,k+1) cols
        rmax = jnp.maximum(
            rmax, jnp.pad(jnp.max(jnp.abs(l), axis=2)[:-1], ((1, 0), (0, 0))))
        if b > 0:
            rmax = jnp.maximum(rmax, jnp.max(jnp.abs(B), axis=2))
            bmax = jnp.maximum(jnp.max(jnp.abs(B), axis=(0, 1)),
                               jnp.max(jnp.abs(Cs), axis=1))
            rb = jnp.where(bmax > 0, 1.0 / jnp.sqrt(bmax), 1.0)
            sb = sb * rb
        r = jnp.where(rmax > 0, 1.0 / jnp.sqrt(rmax), 1.0)
        s = s * r
        d = s[:, :, None] * diag * s[:, None, :]
        l = jnp.pad(s[1:, :, None], ((0, 1), (0, 0), (0, 0)),
                    constant_values=1.0) * lower * s[:, None, :]
        if b > 0:
            B = s[:, :, None] * Bmat * sb[None, None, :]
            Cs = sb[:, None] * C * sb[None, :]
    return d, l, B, Cs, s, sb


def bcr_factor(diag, lower, Bmat, C, nlevels=None, fdtype=None,
               invert_border=True):
    """Compacted block cyclic reduction of [T, B; B^T, C].

    diag (K,W,W) symmetric; lower (K,W,W) with lower[k] = K[k+1,k]
    (entry K-1 unused); Bmat (K,W,b); C (b,b).

    Each level halves the chain: odd blocks are eliminated in one batched
    (vmapped) sweep of dense inverses + matmuls, so the whole factorization
    is ~2K small dense eigendecompositions and O(K) matmuls over log2(K)
    sequential levels — the parallel substitute for Pardiso's sequential
    supernodal LDL^T.  Returns (fac, neigs); neigs is the exact count of
    negative eigenvalues of the full matrix (Sylvester congruence).

    fdtype: compute precision of the factorization (f32 under
    FACTOR_DTYPE="f32"; callers recover f64 accuracy via iterative
    refinement in the solve).
    """
    if fdtype is not None and diag.dtype != fdtype:
        diag = diag.astype(fdtype)
        lower = lower.astype(fdtype)
        Bmat = Bmat.astype(fdtype)
        C = C.astype(fdtype)
    K, W, _ = diag.shape
    b = C.shape[0]
    neigs = jnp.zeros((), jnp.int32)
    levels = []
    d, l, B = diag, lower, Bmat
    while d.shape[0] > 1:
        Ka = d.shape[0]
        Ke = Ka // 2
        Kn = Ka - Ke
        # pad so strided slices line up
        dpad = jnp.concatenate(
            [d, jnp.zeros((1, W, W), d.dtype)], axis=0)
        lpad = jnp.concatenate(
            [l, jnp.zeros((2, W, W), l.dtype)], axis=0)
        Bpad = jnp.concatenate(
            [B, jnp.zeros((1, W, b), B.dtype)], axis=0)
        d_even = dpad[0::2][:Kn]
        d_odd = dpad[1::2][:Ke]
        L_le = lpad[0::2][:Ke]          # K[2i+1, 2i]
        L_er = lpad[1::2][:Ke]          # K[2i+2, 2i+1]
        B_even = Bpad[0::2][:Kn]
        B_odd = Bpad[1::2][:Ke]

        Dinv, neg = _inv_sym(d_odd)
        neigs = neigs + neg
        levels.append(dict(Dinv=Dinv, L_le=L_le, L_er=L_er, B_odd=B_odd))

        def overlap2(base, at0, at1):
            """base (Kn,...) - at0 placed at [0:Ke] - at1 placed at [1:Ke+1]
            (entries beyond Kn dropped), via pads — no dynamic-update-slice
            on the hot path."""
            pz = [(0, 0)] * (base.ndim - 1)
            out = base - jnp.pad(at0[:Kn], [(0, Kn - min(Ke, Kn))] + pz)
            a1 = at1[:Kn - 1]
            out = out - jnp.pad(a1, [(1, Kn - 1 - a1.shape[0])] + pz)
            return out

        # Packed elimination: every Schur update of the level comes from TWO
        # batched products.  X = [L_le^T; L_er; B_odd^T] (Ke, 2W+b, W),
        # Z = (X Dinv) [L_le | L_er^T | B_odd]:
        #   Z[:W,  :W]  = L_le^T Dinv L_le      (even-diag update, left)
        #   Z[W:2W,:W]  = L_er  Dinv L_le       (-l_new)
        #   Z[W:2W,W:2W]= L_er  Dinv L_er^T     (even-diag update, right)
        #   Z[:W,  2W:] = L_le^T Dinv B_odd     (B update, left)
        #   Z[W:2W,2W:] = L_er  Dinv B_odd      (B update, right)
        #   Z[2W:, 2W:] = B_odd^T Dinv B_odd    (border C update)
        # One sweep replaces six separate products; padded/odd tails carry
        # zero blocks so the extra rows cost nothing extra to correctness.
        X = jnp.concatenate([_bT(L_le), L_er, _bT(B_odd)], axis=1)
        R = jnp.concatenate([L_le, _bT(L_er), B_odd], axis=2)
        Z = _bmm(_bmm(X, Dinv), R)
        d_new = overlap2(d_even, Z[:, :W, :W], Z[:, W:2 * W, W:2 * W])
        if b > 0:
            B_new = overlap2(B_even, Z[:, :W, 2 * W:], Z[:, W:2 * W, 2 * W:])
            C = C - Z[:, 2 * W:, 2 * W:].sum(0)
        else:
            B_new = B_even

        l_new = -Z[:, W:2 * W, :W]
        if Kn > 1:
            l_new = l_new[:Kn - 1] if l_new.shape[0] >= Kn - 1 else \
                jnp.concatenate(
                    [l_new, jnp.zeros((Kn - 1 - l_new.shape[0], W, W),
                                      l.dtype)], axis=0)
        else:
            l_new = jnp.zeros((1, W, W), l.dtype)
        d, l, B = d_new, l_new, B_new

    # final single block + border Schur complement
    Dinv0, neg0 = _inv_sym(d)
    neigs = neigs + neg0
    D0inv = Dinv0[0]
    C_schur = C - B[0].T @ D0inv @ B[0]
    if not invert_border:
        # substructuring path: the border Schur complement is exchanged
        # across shards and factorized globally (kkt_sharded)
        return dict(levels=levels, D0inv=D0inv, B0=B[0],
                    C_schur=C_schur), neigs
    if b > 0:
        Cinv1, negC = _inv_sym(C_schur[None])
        neigs = neigs + negC
        Cinv = Cinv1[0]
    else:
        Cinv = jnp.zeros((0, 0), diag.dtype)
    return dict(levels=levels, D0inv=D0inv, B0=B[0], Cinv=Cinv), neigs


def bcr_reduce_rhs(fac, rhs_blocks, rhs_border):
    """Forward sweep: reduce the banded rhs onto the root block + border.

    Returns (stack of eliminated odd rhs per level, root rhs (W,),
    reduced border rhs) — split out of bcr_solve so the sharded
    substructured solver can reduce locally, exchange only the border,
    and back-substitute with an externally solved border (SURVEY.md
    section 2.9 P6)."""
    W = rhs_blocks.shape[1]
    r = rhs_blocks
    rb = rhs_border
    stack = []
    for lev in fac["levels"]:
        Ka = r.shape[0]
        Ke = lev["Dinv"].shape[0]
        Kn = Ka - Ke
        rpad = jnp.concatenate([r, jnp.zeros((1, W), r.dtype)], axis=0)
        r_even = rpad[0::2][:Kn]
        r_odd = rpad[1::2][:Ke]
        stack.append(r_odd)
        Dinv, L_le, L_er = lev["Dinv"], lev["L_le"], lev["L_er"]
        t = _mv(Dinv, r_odd)
        a0 = _mv_t(L_le, t)[:Kn]
        a1 = _mv(L_er, t)[:Kn - 1]
        r = r_even \
            - jnp.pad(a0, ((0, Kn - a0.shape[0]), (0, 0))) \
            - jnp.pad(a1, ((1, Kn - 1 - a1.shape[0]), (0, 0)))
        rb = rb - (lev["B_odd"] * t[:, :, None]).sum((0, 1))
    rb = rb - fac["B0"].T @ (fac["D0inv"] @ r[0])
    return stack, r[0], rb


def bcr_backsub(fac, stack, r_root, z):
    """Back-substitution with a given border solution z."""
    W = r_root.shape[0]
    y = (fac["D0inv"] @ (r_root - fac["B0"] @ z))[None, :]
    for lev, r_odd in zip(reversed(fac["levels"]), reversed(stack)):
        Ke = lev["Dinv"].shape[0]
        Kn = y.shape[0]
        Ka = Kn + Ke
        Dinv, L_le, L_er = lev["Dinv"], lev["L_le"], lev["L_er"]
        y_even = y  # (Kn, W)
        ypad = jnp.concatenate([y_even, jnp.zeros((1, W), y.dtype)], axis=0)
        contrib = r_odd \
            - _mv(L_le, y_even[:Ke]) \
            - _mv_t(L_er, ypad[1:Ke + 1]) \
            - _mv_const(lev["B_odd"], z)
        y_odd = _mv(Dinv, contrib)
        # interleave even/odd without scatter: stack + reshape
        y_odd_p = jnp.pad(y_odd, ((0, Kn - Ke), (0, 0)))
        y_full = jnp.stack([y_even, y_odd_p], axis=1).reshape(2 * Kn, W)
        y = y_full[:Ka]
    return y


def bcr_solve(fac, rhs_blocks, rhs_border, nlevels=None):
    """Solve [T,B;B^T,C][y;z]=[r;rb] using bcr_factor output."""
    stack, r_root, rb = bcr_reduce_rhs(fac, rhs_blocks, rhs_border)
    if fac["Cinv"].shape[0] > 0:
        z = fac["Cinv"] @ rb
    else:
        z = rb
    y = bcr_backsub(fac, stack, r_root, z)
    return y, z


def _block_matvec(blocks64):
    """Matvec closure over the exact stored blocks [T,B;B^T,C]."""
    diag, lower, Bm, C = blocks64
    K = diag.shape[0]
    b = C.shape[0]

    def matvec(y, z):
        out = _mv(diag, y)
        if K > 1:
            out = out + jnp.pad(_mv(lower[:-1], y[:-1]),
                                ((1, 0), (0, 0)))
            out = out + jnp.pad(_mv_t(lower[:-1], y[1:]),
                                ((0, 1), (0, 0)))
        if b > 0:
            out = out + _mv_const(Bm, z)
            outb = (Bm * y[:, :, None]).sum((0, 1)) + C @ z
        else:
            outb = z
        return out, outb

    return matvec


def bcr_richardson_solve(fac, rblk, rbrd, nlevels=None, steps=1):
    """f64 solve + Richardson iterative refinement against the exact
    stored blocks:  dx += M^-1 (r - K dx)  (ASSET_REFINE_STEPS > 0;
    Pardiso QPRefSteps analog, `src/Solvers/PSIOPT.h:146`).  The residual
    matvec is exact-blocks elementwise work with no recursive
    amplification, so each step contracts the solve error by the solve's
    own error ratio.

    When fac carries a Ruiz "scale" (the factorization was of S A S),
    the preconditioner solves through the scaled factor."""
    matvec = _block_matvec(fac["blocks64"])
    scale = fac.get("scale")

    def precond(ry, rz):
        if scale is None:
            return bcr_solve(fac, ry, rz, nlevels)
        sK, sb = scale
        dy, dz = bcr_solve(fac, sK * ry, sb * rz, nlevels)
        return sK * dy, sb * dz

    y, z = precond(rblk, rbrd)
    for _ in range(steps):
        Ay, Az = matvec(y, z)
        dy, dz = precond(rblk - Ay, rbrd - Az)
        y = y + dy
        z = z + dz
    return y, z


def bcr_refined_solve(fac, rblk, rbrd, nlevels=None, m=None):
    """f64 solve through an f32 factorization of the equilibrated system.

    Krylov-accelerated refinement (FGMRES(m), right-preconditioned by the
    f32 factor of the Ruiz-equilibrated system): plain Richardson
    refinement stalls once the f32 factor's contraction ratio nears 1
    (late-IPM barrier conditioning), while GMRES still converges on the
    clustered preconditioned spectrum.  This replaces Pardiso's QPRefSteps
    refinement (`src/Solvers/PSIOPT.h:146`): the m matvecs are O(K W^2)
    f64 elementwise work, tiny next to the O(K W^3) f32 factor.

    fac must hold "blocks64" (exact f64 blocks) and "scale" (Ruiz scale).
    """
    diag, lower, Bm, C = fac["blocks64"]
    K, W, _ = diag.shape
    b = C.shape[0]
    fdt = fac["D0inv"].dtype
    if m is None:
        m = REFINE_STEPS + 2

    matvec = _block_matvec(fac["blocks64"])
    sK, sbrd = fac["scale"]

    def precond(ry, rz):
        dy, dz = bcr_solve(fac, (sK * ry).astype(fdt),
                           (sbrd * rz).astype(fdt), nlevels)
        return sK * dy.astype(DEFAULT_DTYPE), \
            sbrd * dz.astype(DEFAULT_DTYPE)

    def dot(ay, az, by_, bz):
        return jnp.sum(ay * by_) + jnp.sum(az * bz)

    beta = jnp.sqrt(dot(rblk, rbrd, rblk, rbrd))
    bsafe = jnp.where(beta > 0, beta, 1.0)
    Vy = jnp.zeros((m + 1, K, W), DEFAULT_DTYPE).at[0].set(rblk / bsafe)
    Vz = jnp.zeros((m + 1, b), DEFAULT_DTYPE).at[0].set(rbrd / bsafe)
    Zy = jnp.zeros((m, K, W), DEFAULT_DTYPE)
    Zz = jnp.zeros((m, b), DEFAULT_DTYPE)
    H = jnp.zeros((m + 1, m), DEFAULT_DTYPE)
    rows = jnp.arange(m + 1)

    def gmres_step(j, carry):
        # fori body so the preconditioner sweep is instantiated once
        # in the graph (compile time), not m times
        Vy, Vz, Zy, Zz, H = carry
        zy, zz = precond(Vy[j], Vz[j])
        Zy = jax.lax.dynamic_update_index_in_dim(Zy, zy, j, 0)
        Zz = jax.lax.dynamic_update_index_in_dim(Zz, zz, j, 0)
        wy, wz = matvec(zy, zz)
        # classical Gram-Schmidt with reorthogonalization (CGS2):
        # vectorized over the basis, masked to columns <= j
        mask = (rows <= j).astype(DEFAULT_DTYPE)
        h1 = ((Vy * wy[None]).sum((1, 2)) +
              (Vz * wz[None]).sum(1)) * mask
        wy = wy - jnp.einsum("i,ikw->kw", h1, Vy)
        wz = wz - h1 @ Vz
        h2 = ((Vy * wy[None]).sum((1, 2)) +
              (Vz * wz[None]).sum(1)) * mask
        wy = wy - jnp.einsum("i,ikw->kw", h2, Vy)
        wz = wz - h2 @ Vz
        hcol = h1 + h2
        hj1 = jnp.sqrt(dot(wy, wz, wy, wz))
        hcol = hcol + hj1 * (rows == j + 1)
        H = jax.lax.dynamic_update_slice(H, hcol[:, None], (0, j))
        hsafe = jnp.where(hj1 > 0, hj1, 1.0)
        Vy = jax.lax.dynamic_update_index_in_dim(Vy, wy / hsafe, j + 1, 0)
        Vz = jax.lax.dynamic_update_index_in_dim(Vz, wz / hsafe, j + 1, 0)
        return Vy, Vz, Zy, Zz, H

    Vy, Vz, Zy, Zz, H = jax.lax.fori_loop(
        0, m, gmres_step, (Vy, Vz, Zy, Zz, H))
    e1 = jnp.zeros((m + 1,), DEFAULT_DTYPE).at[0].set(beta)
    # least squares via regularized normal equations with the GJ
    # inverse; H is (m+1, m) with m ~ 5 so conditioning is benign
    G = H.T @ H + 1e-30 * jnp.eye(m, dtype=DEFAULT_DTYPE)
    coef = _inv_gj(G[None])[0] @ (H.T @ e1)
    coef = jnp.where(jnp.isfinite(coef), coef, 0.0)
    y = jnp.einsum("j,jkw->kw", coef, Zy)
    z = coef @ Zz
    return y, z


def _try_patch_plan(tdict, anchors, off, E, napps, W, K):
    """Try to convert a contribution group's diag/lower scatter pairs into a
    structured patch plan: assembly as exact one-hot matmuls instead of
    gathers.  Its cost against a direct gather or scatter-add on the H100
    is not measured yet.

    Requirements: a contiguous run of apps whose (entry -> patch-slot)
    pattern is identical and whose anchors increase by one every P apps.
    Each app's in-band entries must live in the (2W x 2W) patch spanning
    macros (anchor, anchor+1).  Returns (plan | None, leftover_dict)."""
    diag_pairs = tdict.get("diag", (np.zeros(0, np.int32),) * 2)
    low_pairs = tdict.get("lower", (np.zeros(0, np.int32),) * 2)
    nd = len(diag_pairs[0])
    src = np.concatenate([diag_pairs[0], low_pairs[0]]).astype(np.int64)
    tgt = np.concatenate([diag_pairs[1], low_pairs[1]]).astype(np.int64)
    if len(src) == 0 or napps < 8:
        return None, tdict
    is_low = np.arange(len(src)) >= nd
    app = (src - off) // E
    e = (src - off) % E
    mac = tgt // (W * W)
    i = (tgt // W) % W
    j = tgt % W
    rel = mac - anchors[app]
    ok = np.where(is_low, rel == 0, (rel >= 0) & (rel <= 1))
    # patch slot within (2W, 2W): lower block sits at rows [W:2W], cols [:W]
    prow = np.where(is_low, W + i, rel * W + i)
    pcol = np.where(is_low, j, rel * W + j)
    slot = prow * (2 * W) + pcol

    # canonical pattern from a middle app
    order = np.lexsort((e, slot, app))
    app_s, e_s, slot_s, ok_s = app[order], e[order], slot[order], ok[order]
    counts = np.bincount(app_s, minlength=napps)
    mid = napps // 2
    cnt = counts[mid]
    if cnt == 0:
        return None, tdict
    starts = np.zeros(napps + 1, np.int64)
    starts[1:] = np.cumsum(counts)
    canon_e = e_s[starts[mid]:starts[mid + 1]]
    canon_slot = slot_s[starts[mid]:starts[mid + 1]]

    # apps matching the canonical pattern (count, entries, slots, in-band)
    match = counts == cnt
    cand = np.where(match)[0]
    if len(cand) < napps // 2:
        return None, tdict
    idx = starts[cand][:, None] + np.arange(cnt)[None, :]
    em = e_s[idx]
    sm = slot_s[idx]
    km = ok_s[idx]
    good = (em == canon_e[None, :]).all(1) & \
        (sm == canon_slot[None, :]).all(1) & km.all(1)
    match_apps = cand[good]
    if len(match_apps) < napps // 2:
        return None, tdict
    # largest contiguous run with anchors advancing by 1 every P apps
    runs = np.split(match_apps,
                    np.where(np.diff(match_apps) != 1)[0] + 1)
    run = max(runs, key=len)
    a0, a1 = int(run[0]), int(run[-1]) + 1
    anc = anchors[a0:a1]
    u, c = np.unique(anc, return_counts=True)
    if not np.all(np.diff(u) == 1):
        return None, tdict
    P = int(np.median(c))
    # maximal contiguous run of anchor groups with exactly P apps
    okg = c == P
    runs_g = np.split(np.arange(len(u)), np.where(np.diff(okg))[0] + 1)
    best = max((r for r in runs_g if okg[r[0]]), key=len, default=None)
    if best is None or len(best) < 4:
        return None, tdict
    gstart = int(best[0])
    gend = int(best[-1]) + 1
    # app offsets of those groups (anchors sorted ascending within the run)
    gfirst = np.searchsorted(anc, u[gstart])
    a1 = a0 + int(gfirst) + (gend - gstart) * P
    a0 = a0 + int(gfirst)
    if (a1 - a0) < 4:
        return None, tdict

    # greedy layering: unique slots per layer
    layers = []
    remaining = list(range(cnt))
    while remaining:
        used = set()
        this = []
        rest = []
        for t in remaining:
            s = int(canon_slot[t])
            if s in used:
                rest.append(t)
            else:
                used.add(s)
                this.append(t)
        S = np.zeros((E, 4 * W * W), np.float32)
        for t in this:
            S[int(canon_e[t]), int(canon_slot[t])] += 1.0
        layers.append(S)
        remaining = rest

    plan = dict(a0=a0, a1=a1, P=P, m0=int(anchors[a0]), E=E, W=W,
                layers=layers)
    # leftover pairs: everything outside the matched contiguous run
    inrun = (app >= a0) & (app < a1)
    left = dict(tdict)
    keep_d = ~inrun[:nd]
    keep_l = ~inrun[nd:]
    left["diag"] = (diag_pairs[0][keep_d], diag_pairs[1][keep_d])
    left["lower"] = (low_pairs[0][keep_l], low_pairs[1][keep_l])
    return plan, left


def _apply_patch_plan(plan, vals2d, diag, lower):
    """Add a patch plan's contribution to (K, W, W) diag/lower via exact
    split-f32 one-hot matmuls (each output slot receives exactly one source
    per layer, so the f32 product is the exact value; the hi/lo split keeps
    ~2^-48 relative accuracy on the f64 inputs)."""
    W = plan["W"]
    a0, a1, P, m0 = plan["a0"], plan["a1"], plan["P"], plan["m0"]
    K = diag.shape[0]
    v = vals2d[a0:a1]
    hi = v.astype(jnp.float32)
    acc = jnp.zeros((a1 - a0, 4 * W * W), diag.dtype)
    if v.dtype == jnp.float32:
        # f32 source values (ASSET_JAC/HESS_DTYPE=f32): hi IS exact
        for S in plan["layers"]:
            acc = acc + jnp.dot(hi, S, precision="highest").astype(acc.dtype)
    else:
        lo = (v - hi.astype(v.dtype)).astype(jnp.float32)
        for S in plan["layers"]:
            acc = acc + jnp.dot(hi, S, precision="highest").astype(acc.dtype) \
                + jnp.dot(lo, S, precision="highest").astype(acc.dtype)
    G = (a1 - a0) // P
    A = acc.reshape(G, P, 2 * W, 2 * W).sum(1)
    g0 = min(G, K - m0)
    diag = diag.at[m0:m0 + g0].add(A[:g0, :W, :W])
    g1 = min(G, K - (m0 + 1))
    if g1 > 0:
        diag = diag.at[m0 + 1:m0 + 1 + g1].add(A[:g1, W:, W:])
    gl = min(G, K - m0)
    lower = lower.at[m0:m0 + gl].add(A[:gl, W:, :W])
    return diag, lower


def _try_patch_plan_B(src, tgt, anchors, E, napps, W, b, K):
    """Patch plan for the border matrix B (K, W, b): the defect family's
    t0/tf Jacobian columns hit B in the same per-app pattern every
    segment, so the (app, entry) -> (rel, row, col) map is one one-hot
    matmul per layer instead of a (K*W*b*width) gather.  Returns
    (plan | None, leftover (src, tgt))."""
    if len(src) == 0 or napps < 8 or b == 0:
        return None, (src, tgt)
    src = np.asarray(src, np.int64)
    tgt = np.asarray(tgt, np.int64)
    app = src // E
    e = src % E
    mac = tgt // (W * b)
    i = (tgt // b) % W
    j = tgt % b
    rel = mac - anchors[app]
    ok = (rel >= 0) & (rel <= 1)
    slot = (rel * W + i) * b + j

    order = np.lexsort((e, slot, app))
    app_s, e_s, slot_s, ok_s = app[order], e[order], slot[order], ok[order]
    counts = np.bincount(app_s, minlength=napps)
    mid = napps // 2
    cnt = counts[mid]
    if cnt == 0:
        return None, (src, tgt)
    starts = np.zeros(napps + 1, np.int64)
    starts[1:] = np.cumsum(counts)
    canon_e = e_s[starts[mid]:starts[mid + 1]]
    canon_slot = slot_s[starts[mid]:starts[mid + 1]]
    cand = np.where(counts == cnt)[0]
    if len(cand) < napps // 2:
        return None, (src, tgt)
    idx = starts[cand][:, None] + np.arange(cnt)[None, :]
    good = (e_s[idx] == canon_e[None, :]).all(1) & \
        (slot_s[idx] == canon_slot[None, :]).all(1) & ok_s[idx].all(1)
    match_apps = cand[good]
    if len(match_apps) < napps // 2:
        return None, (src, tgt)
    runs = np.split(match_apps, np.where(np.diff(match_apps) != 1)[0] + 1)
    run = max(runs, key=len)
    a0, a1 = int(run[0]), int(run[-1]) + 1
    anc = anchors[a0:a1]
    u, c = np.unique(anc, return_counts=True)
    if not np.all(np.diff(u) == 1):
        return None, (src, tgt)
    P = int(np.median(c))
    okg = c == P
    runs_g = np.split(np.arange(len(u)), np.where(np.diff(okg))[0] + 1)
    best = max((r for r in runs_g if okg[r[0]]), key=len, default=None)
    if best is None or len(best) < 4:
        return None, (src, tgt)
    gfirst = np.searchsorted(anc, u[int(best[0])])
    a1 = a0 + int(gfirst) + (int(best[-1]) + 1 - int(best[0])) * P
    a0 = a0 + int(gfirst)
    if (a1 - a0) < 4:
        return None, (src, tgt)

    layers = []
    remaining = list(range(cnt))
    while remaining:
        used = set()
        this, rest = [], []
        for t in remaining:
            s_ = int(canon_slot[t])
            (rest if s_ in used else this).append(t)
            used.add(s_)
        S = np.zeros((E, 2 * W * b), np.float32)
        for t in this:
            S[int(canon_e[t]), int(canon_slot[t])] += 1.0
        layers.append(S)
        remaining = rest

    plan = dict(a0=a0, a1=a1, P=P, m0=int(anchors[a0]), E=E, W=W, b=b,
                layers=layers)
    inrun = (app >= a0) & (app < a1)
    return plan, (src[~inrun], tgt[~inrun])


def _apply_patch_plan_B(plan, vals2d, Bmat):
    """Add a border patch plan's contribution to (K, W, b) via exact
    split-f32 one-hot matmuls (see _apply_patch_plan)."""
    W, b = plan["W"], plan["b"]
    a0, a1, P, m0 = plan["a0"], plan["a1"], plan["P"], plan["m0"]
    K = Bmat.shape[0]
    v = vals2d[a0:a1]
    hi = v.astype(jnp.float32)
    acc = jnp.zeros((a1 - a0, 2 * W * b), Bmat.dtype)
    if v.dtype == jnp.float32:
        for S in plan["layers"]:
            acc = acc + jnp.dot(hi, S, precision="highest").astype(acc.dtype)
    else:
        lo = (v - hi.astype(v.dtype)).astype(jnp.float32)
        for S in plan["layers"]:
            acc = acc + jnp.dot(hi, S, precision="highest").astype(acc.dtype) \
                + jnp.dot(lo, S, precision="highest").astype(acc.dtype)
    G = (a1 - a0) // P
    A = acc.reshape(G, P, 2, W, b).sum(1)
    g0 = min(G, K - m0)
    Bmat = Bmat.at[m0:m0 + g0].add(A[:g0, 0])
    g1 = min(G, K - (m0 + 1))
    if g1 > 0:
        Bmat = Bmat.at[m0 + 1:m0 + 1 + g1].add(A[:g1, 1])
    return Bmat


def _build_table(pairs, size, zero_slot, max_width=16):
    """Invert (src, tgt) scatter pairs into a gather table.

    Returns (table (size, maxc) int32 pointing into the value buffer —
    unused slots point at `zero_slot` — plus overflow (src, tgt) pairs for
    slots with more than `max_width` contributors, to be handled by a
    fallback scatter).  This turns KKT assembly from element scatter-adds
    into gathers + sums.
    """
    if not pairs:
        return np.full((size, 1), zero_slot, np.int32), (
            np.zeros(0, np.int32), np.zeros(0, np.int32))
    src = np.concatenate([np.asarray(s, np.int64) for s, t in pairs])
    tgt = np.concatenate([np.asarray(t, np.int64) for s, t in pairs])
    order = np.argsort(tgt, kind="stable")
    src, tgt = src[order], tgt[order]
    counts = np.bincount(tgt, minlength=size)
    maxc = int(counts.max()) if len(counts) else 1
    width = min(maxc, max_width)
    first = np.zeros(size + 1, np.int64)
    first[1:] = np.cumsum(counts)
    slot = np.arange(len(tgt)) - first[tgt]
    keep = slot < width
    table = np.full((size, max(width, 1)), zero_slot, np.int64)
    table[tgt[keep], slot[keep]] = src[keep]
    over = (np.asarray(src[~keep], np.int32), np.asarray(tgt[~keep],
                                                         np.int32))
    return np.asarray(table, np.int32), over


class BlockKKT:
    """KKT provider over the block-tridiagonal+border structure.

    Unified backend API used by PSIOPT (same surface as
    `kkt_dense.DenseKKT`):
      eval_resid(x, lamE, lamI, sigma) -> (obj, gradf, cE, cI, rd)
      factor(x, lamE, lamI, sigma, sig_tilde, delta, gammaE, gammaI)
          -> (fac, neigs)
      solve(fac, rhs_x, rhs_E) -> (dx, dlamE)
      iq_matvec(fac, dx) -> J_I dx ;  iq_rmatvec(fac, v) -> J_I^T v

    Internally the hot path is split reference-style (evalKKT once,
    refactor many: `PSIOPT.cpp:422`):
      _ad_impl        — one vmapped f/J/adjoint-H pass over every family
      _blocks_impl    — gather-table assembly of (diag, lower, B, C)
      _factor_blocks_impl — regularize + block cyclic reduction
    """

    def __init__(self, nlp, node_of_var, probe_seed=7, x0=None):
        nlp.freeze()
        self.nlp = nlp
        from .nlp import (_family_full, _family_valjac, _family_valjac_bm,
                          _family_hess, _family_hess_f32,
                          _family_hess_true32, _family_valgradjac_mixed)
        import os
        # Precision of the family AD passes feeding the KKT *matrix* (the
        # residuals rd/cE/cI always stay f64; see nlp._family_hess_f32 /
        # _family_valgradjac_mixed).
        self._hess32 = os.environ.get("ASSET_HESS_DTYPE", "f64") == "f32"
        self._jac32 = os.environ.get("ASSET_JAC_DTYPE", "f64") == "f32"
        fam_hess = _family_hess_f32 if self._hess32 else _family_hess
        # ASSET_FAMAD: "dd" (default) = batch-major all-f64; "fast" =
        # batch-minor f64 value/Jacobian + genuinely-f32 adjoint Hessian
        # (nlp._family_valjac_bm / _family_hess_true32).
        famad = os.environ.get("ASSET_FAMAD", "") or "dd"
        self._famad = famad
        fam_vj = _family_valjac_bm if famad == "fast" else _family_valjac

        def make_hess(f, need):
            if famad == "fast" and not self._hess32 and need:
                try:
                    h = _family_hess_true32(f.fun, f.nin,
                                            f.consts.shape[1])
                    # trace-only probe (no XLA compile): falls back to the
                    # f64 pass for families whose graphs can't retrace
                    # under x64-disabled canonicalization (callbacks with
                    # declared f64 result shapes, custom roots, ...)
                    jax.eval_shape(
                        h,
                        jax.ShapeDtypeStruct((f.napps, f.nin),
                                             DEFAULT_DTYPE),
                        jax.ShapeDtypeStruct(f.consts.shape, DEFAULT_DTYPE),
                        jax.ShapeDtypeStruct((f.napps, f.nout),
                                             DEFAULT_DTYPE))
                    return h
                except Exception:
                    pass
            return fam_hess(f.fun)

        # ---- probe structural sparsity of every family (analog of the
        # reference's INPUT_DOMAIN tracking): evaluate |J|,|H| near the
        # initial trajectory (physical inputs — pure-random points can
        # overflow stiff expressions like exp(-h/h_scale) and poison the
        # masks) and OR over apps/probes.  Non-finite entries count as
        # nonzero (conservative). ----
        rng = np.random.default_rng(probe_seed)
        if x0 is not None:
            x0 = np.asarray(x0, np.float64)

        def probe(f):
            # Jacobian-only probing: compiling the family *hessian* just for
            # sparsity costs minutes of XLA compile for table/trig-heavy
            # dynamics.  Hessian sparsity is inferred instead: H = sum_k
            # lam_k grad^2 f_k can couple (i,j) only if some row k touches
            # both i and j, and only if at least one of the two jacobian
            # columns is non-constant across probe points (a linear column
            # has identically zero second derivatives).  Conservative in the
            # same sense as the value probing itself.
            valjac = jax.jit(_family_valjac(f.fun))
            jac_nz = np.zeros((f.nout, f.nin), bool)
            jxs = []
            for k in range(2):
                if x0 is not None:
                    base = x0[f.Vidx]
                    scale = np.maximum(np.abs(base), 1e-3)
                    xg = jnp.asarray(
                        base + rng.normal(size=base.shape) * scale
                        * (0.01 + 0.1 * k))
                else:
                    xg = jnp.asarray(rng.normal(size=(f.napps, f.nin)) * 0.7
                                     + 0.3)
                fx, jx = valjac(xg, jnp.asarray(f.consts))
                jxa = np.asarray(jx)
                jxs.append(jxa)
                jac_nz |= np.nanmax(np.abs(jxa), axis=0) > 1e-250
                jac_nz |= ~np.isfinite(jxa).all(axis=0)
            with np.errstate(invalid="ignore"):
                nonconst = (np.nanmax(np.abs(jxs[0] - jxs[1]), axis=0)
                            > 1e-250).any(axis=0)
            nonconst |= ~np.isfinite(jxs[0]).all(axis=(0, 1))
            nonconst |= ~np.isfinite(jxs[1]).all(axis=(0, 1))
            shared_row = np.zeros((f.nin, f.nin), bool)
            for k in range(f.nout):
                cols = jac_nz[k]
                shared_row |= cols[:, None] & cols[None, :]
            hess_nz = shared_row & (nonconst[:, None] | nonconst[None, :])
            hess_nz |= hess_nz.T
            return jac_nz, hess_nz

        def probe_cached(f):
            # Sparsity masks depend on the function, not on how many
            # applications it has: families carry a persistent cache slot
            # (`_probe_cache`, attached by the transcription layer) so a
            # re-mesh at a new segment count skips every probe jit —
            # the dominant rebuild cost in adaptive-mesh loops
            # (SURVEY.md section 7 dynamic-shape mitigation).
            slot = getattr(f.fun, "_probe_cache", None)
            if slot is not None:
                store, pkey = slot
                pkey = (pkey, f.nin, f.nout)
                hit = store.get(pkey)
                if hit is not None:
                    return hit
                out = probe(f)
                store[pkey] = out
                return out
            return probe(f)

        # Probing is structure analysis, not solver math: a few small jits
        # per family whose results the host reads at once.  Pin it to the
        # host CPU backend, which compiles such programs faster than the
        # GPU's compiler and needs no device-to-host copy.
        try:
            cpu = jax.devices("cpu")[0]
        except RuntimeError:
            cpu = None
        ctx = jax.default_device(cpu) if cpu is not None else _nullctx()
        with ctx:
            eq_nz = [probe_cached(f) for f in nlp.eqcons]
            iq_nz = [probe_cached(f) for f in nlp.iqcons]
            obj_nz = [probe_cached(f) for f in nlp.objectives]

        eq_fams = [(f.Vidx, rows, jnz.any(axis=0), hnz.any(axis=0))
                   for f, rows, (jnz, hnz) in zip(nlp.eqcons, nlp._eq_rows,
                                                  eq_nz)]
        # iq Hessian coupling includes the slack condensation J^T Sigma~ J:
        # all Jacobian-column pairs of an application couple
        iq_fams = [(f.Vidx, rows, jnz.any(axis=0),
                    jnz.any(axis=0) | hnz.any(axis=0))
                   for f, rows, (jnz, hnz) in zip(nlp.iqcons, nlp._iq_rows,
                                                  iq_nz)]
        obj_fams = [(f.Vidx, jnz.any(axis=0), hnz.any(axis=0))
                    for f, (jnz, hnz) in zip(nlp.objectives, obj_nz)]
        self.bs = BlockStructure(nlp.numPrimal, nlp.numEq, nlp.numIq,
                                 node_of_var, eq_fams, iq_fams, obj_fams)
        bs = self.bs
        self.nlevels = max(1, int(np.ceil(np.log2(max(bs.K, 2)))))
        self._perm = np.asarray(bs.rhs_perm())

        self._eq = []
        for f, rows, (jnz, hnz) in zip(nlp.eqcons, nlp._eq_rows, eq_nz):
            self._eq.append(dict(
                full=_family_full(f.fun), vj=fam_vj(f.fun),
                vjg=_family_valgradjac_mixed(f.fun),
                hess=make_hess(f, bool(hnz.any())),
                Vidx=np.asarray(f.Vidx), rows=np.asarray(rows),
                need_hess=bool(hnz.any()), jnz=jnz, hnz=hnz,
                nout=f.nout, nin=f.nin, napps=f.napps))
        self._iq = []
        for f, rows, (jnz, hnz) in zip(nlp.iqcons, nlp._iq_rows, iq_nz):
            # condensation term J^T Sig~ J fills the union of jac-column
            # outer products — include it in the hessian mask
            hfull = hnz.copy()
            for r in range(f.nout):
                hfull |= np.outer(jnz[r], jnz[r])
            self._iq.append(dict(
                full=_family_full(f.fun), vj=fam_vj(f.fun),
                vjg=_family_valgradjac_mixed(f.fun),
                hess=make_hess(f, bool(hnz.any())),
                Vidx=np.asarray(f.Vidx), rows=np.asarray(rows),
                need_hess=bool(hnz.any()), jnz=jnz, hnz=hnz, hfull=hfull,
                nout=f.nout, nin=f.nin, napps=f.napps))
        self._obj = []
        for f, (jnz, hnz) in zip(nlp.objectives, obj_nz):
            self._obj.append(dict(
                full=_family_full(f.fun), vj=fam_vj(f.fun),
                vjg=_family_valgradjac_mixed(f.fun),
                hess=make_hess(f, bool(hnz.any())),
                Vidx=np.asarray(f.Vidx),
                need_hess=bool(hnz.any()), jnz=jnz, hnz=hnz,
                nout=f.nout, nin=f.nin, napps=f.napps))
        self._build_plan()

        # regularization diagonal masks
        K, W, b = bs.K, bs.W, bs.b
        sign = np.zeros(K * W * W)   # +1 -> +delta, -1 -> -gammaE
        fix = np.zeros(K * W * W)    # identity rows for unused padded slots
        for k in range(bs.K):
            for s in range(W):
                sign[k * W * W + s * W + s] = 1.0
            for s in range(int(bs.counts[k]), W):
                fix[k * W * W + s * W + s] = 1.0
                sign[k * W * W + s * W + s] = 0.0
        self._diag_fix = None
        for r in range(bs.mE):
            mk, sl = bs._urow_macro[r], bs._urow_slot[r]
            if mk >= 0:
                sign[mk * W * W + sl * W + sl] = -1.0
        self._diag_sign = sign.reshape(K, W, W)
        self._diag_fix = fix.reshape(K, W, W)
        csign = np.zeros(b * b)
        for i in range(b):
            csign[i * b + i] = 1.0
        for r, sl in bs.border_row_slot.items():
            csign[sl * b + sl] = -1.0
        self._c_sign = csign.reshape(b, b)

        self._jit_factor = jax.jit(self._factor_impl)
        self._jit_solve = jax.jit(self._solve_impl)
        self._jit_resid = jax.jit(self._resid_impl)
        self._jit_iqmv = jax.jit(self._iq_matvec_impl)
        self._jit_iqrmv = jax.jit(self._iq_rmatvec_impl)

    # ------------------------------------------------------------ build plan
    def _build_plan(self):
        """Gather-table assembly plan.

        The reference matches each (row, col) coefficient to a CSR slot once
        during sparsity analysis and scatters per evaluation
        (`NonLinearProgram.cpp:267`, KKTLocations).  Here the mapping is
        inverted: every family's J/H/condensation values
        are concatenated into one value buffer per iteration, and each KKT
        array is produced by a static gather table + sum over contributors —
        pure gathers, deterministic, no locks (SURVEY.md section 2.9 P2).
        """
        bs = self.bs
        K, W, b, n = bs.K, bs.W, bs.b, bs.n
        off = 0
        dpairs, lpairs, bpairs, cpairs = [], [], [], []
        self._patch_plans = []
        self._patch_plans_B = []
        self._vpart_count = 0

        def add_targets(t, off):
            for name, lst in (("diag", dpairs), ("lower", lpairs),
                              ("B", bpairs), ("C", cpairs)):
                if name in t and len(t[name][0]):
                    s, tg = t[name]
                    lst.append((np.asarray(s, np.int64) + off, tg))

        # value-buffer layout: eq jac, [eq hess], iq hess(+cond), [obj hess]
        for fam, rows_np, Vidx_np in [
                (f, r, v) for f, r, v in zip(
                    self._eq,
                    [np.asarray(f["rows"]) for f in self._eq],
                    [np.asarray(f["Vidx"]) for f in self._eq])]:
            nv = fam["napps"] * fam["nout"] * fam["nin"]
            # structured patch plans (diag/lower via one-hot matmuls)
            vpart_idx = self._vpart_count

            def add_group(t, off_, anchors, E, napps, vpi):
                # src indices in t are local to the contribution group
                plan, left = _try_patch_plan(t, anchors, 0, E, napps, W, K)
                if b > 0 and "B" in left and len(left["B"][0]):
                    bplan, bleft = _try_patch_plan_B(
                        left["B"][0], left["B"][1], anchors, E, napps,
                        W, b, K)
                    if bplan is not None:
                        left = dict(left)
                        left["B"] = bleft
                        self._patch_plans_B.append((vpi, bplan))
                add_targets(left, off_)
                return plan

            cm = fam["jnz"].any(0) | fam["hnz"].any(0)
            anchors = bs.app_anchors(Vidx_np, cm)
            fam["jac_off"] = off
            plan = add_group(bs.jac_targets(Vidx_np, rows_np, fam["jnz"]),
                             off, anchors, fam["nout"] * fam["nin"],
                             fam["napps"], vpart_idx)
            if plan is not None:
                self._patch_plans.append((vpart_idx, plan))
            vpart_idx += 1
            off += nv
            if fam["need_hess"]:
                fam["hess_off"] = off
                plan = add_group(bs.hess_targets(Vidx_np, fam["hnz"]),
                                 off, anchors, fam["nin"] * fam["nin"],
                                 fam["napps"], vpart_idx)
                if plan is not None:
                    self._patch_plans.append((vpart_idx, plan))
                vpart_idx += 1
                off += fam["napps"] * fam["nin"] * fam["nin"]
            self._vpart_count = vpart_idx
        vpart_idx = self._vpart_count
        for fam in self._iq:
            Vidx_np = np.asarray(fam["Vidx"])
            cm = fam["hfull"].any(0)
            anchors = bs.app_anchors(Vidx_np, cm)
            fam["hess_off"] = off
            t = bs.hess_targets(Vidx_np, fam["hfull"])
            plan, left = _try_patch_plan(t, anchors, 0,
                                         fam["nin"] * fam["nin"],
                                         fam["napps"], W, K)
            add_targets(left, off)
            if plan is not None:
                self._patch_plans.append((vpart_idx, plan))
            vpart_idx += 1
            off += fam["napps"] * fam["nin"] * fam["nin"]
        for fam in self._obj:
            if fam["need_hess"]:
                Vidx_np = np.asarray(fam["Vidx"])
                cm = fam["hnz"].any(0)
                anchors = bs.app_anchors(Vidx_np, cm)
                fam["hess_off"] = off
                t = bs.hess_targets(Vidx_np, fam["hnz"])
                plan, left = _try_patch_plan(t, anchors, 0,
                                             fam["nin"] * fam["nin"],
                                             fam["napps"], W, K)
                add_targets(left, off)
                if plan is not None:
                    self._patch_plans.append((vpart_idx, plan))
                vpart_idx += 1
                off += fam["napps"] * fam["nin"] * fam["nin"]
        self._vpart_count = vpart_idx
        self._vbuf_len = off

        # leftover diag/lower contributions (non-uniform apps, boundary
        # rows) are FEW after patch planning: a small scatter-add beats a
        # full-size gather table that streams every empty slot
        def flat_pairs(pairs):
            if not pairs:
                return (np.zeros(0, np.int32), np.zeros(0, np.int32))
            return (np.concatenate([np.asarray(s, np.int32)
                                    for s, t in pairs]),
                    np.concatenate([np.asarray(t, np.int32)
                                    for s, t in pairs]))

        self._d_scatter = flat_pairs(dpairs)
        self._l_scatter = flat_pairs(lpairs)
        tB, bov = _build_table(bpairs, K * W * b, off)
        tC, cov = _build_table(cpairs, b * b, off, max_width=1 << 30)
        self._tB = tB.reshape(K, W, b, -1) if b > 0 else None
        self._tC = tC.reshape(b, b, -1) if b > 0 else None
        self._overflow = [(np.asarray(s), np.asarray(t), name)
                          for (s, t), name in [(bov, "B")] if len(s)]

        # ---- adjoint-gradient gather plan (rd) ----
        goff = 0
        gpairs = []          # banded (src, var)
        self._g_border = []  # (fam_list, i, cols, ids)
        for which, fams, use_lam in (("eq", self._eq, True),
                                     ("iq", self._iq, True),
                                     ("obj", self._obj, False)):
            for i, fam in enumerate(fams):
                Vidx_np = np.asarray(fam["Vidx"])
                napps, nin = fam["napps"], fam["nin"]
                fam["g_off"] = goff
                bcol = bs._uvar_macro[Vidx_np] < 0          # (napps, nin)
                uniform = np.all(bcol == bcol[0:1], axis=0)
                src = goff + np.arange(napps * nin).reshape(napps, nin)
                bc = np.where(uniform & bcol[0])[0] if napps else \
                    np.zeros(0, np.int64)
                if len(bc) and napps and \
                        np.all(Vidx_np[:, bc] == Vidx_np[0:1, bc]):
                    ids = Vidx_np[0, bc]
                    self._g_border.append((which, i, np.asarray(bc),
                                           np.asarray(ids)))
                    keep = np.ones(nin, bool)
                    keep[bc] = False
                else:
                    keep = np.ones(nin, bool)
                gpairs.append((src[:, keep].ravel(),
                               Vidx_np[:, keep].ravel()))
                goff += napps * nin
        self._gbuf_len = goff
        trd, gov = _build_table(gpairs, n, goff, max_width=24)
        self._trd = trd
        if len(gov[0]):
            self._g_overflow = (np.asarray(gov[0]), np.asarray(gov[1]))
        else:
            self._g_overflow = None

    # --------------------------------------------------- family evaluation
    def _eval_core(self, x, lamE, lamI, sigma, consts, want_hess):
        """One vmapped pass over every family (reference evalKKT,
        `NonLinearProgram.cpp:473`): values + Jacobians (+ adjoint Hessians
        when `want_hess`), assembled into obj/cE/cI/rd via concatenation and
        gather tables — no scatters on the hot path.  consts: the runtime
        (obj, eq, iq) device tuple from nlp.consts_dev(), threaded as a jit
        argument so subVariables/mesh updates never retrace."""
        ocon, econ, icon = consts
        famvals = dict(jx_eq=[], hx_eq=[], jx_iq=[], hx_iq=[], hx_obj=[])
        g2d = []
        ce, ci = [], []
        obj = jnp.zeros((), DEFAULT_DTYPE)

        import os as _os
        nohess = _os.environ.get("ASSET_DIFF_NOHESS", "0") == "1"

        def hess_of(fam, xg, cc, lam):
            # want_hess: True = real adjoint Hessian; "zeros" = structural
            # zeros (Gauss-Newton / reference evalSOE+evalAUG first-order
            # modes, `NonLinearProgram.cpp:590-627`); False = skip.
            # ASSET_DIFF_NOHESS=1 is a TIMING-ONLY diagnostic (in-loop
            # differential attribution of the hessian AD cost).
            if nohess and fam["need_hess"]:
                return jnp.zeros((fam["napps"], fam["nin"], fam["nin"]),
                                 DEFAULT_DTYPE)
            if want_hess is True and fam["need_hess"]:
                return fam["hess"](xg, cc, lam)
            if want_hess == "zeros" and fam["need_hess"]:
                return jnp.zeros((fam["napps"], fam["nin"], fam["nin"]),
                                 DEFAULT_DTYPE)
            return None

        def valgrad(fam, cc, lam):
            """Value, adjoint gradient J^T lam (always f64), matrix
            Jacobian (f32 under ASSET_JAC_DTYPE=f32 — the matrix entries
            tolerate inexactness, rd does not)."""
            if self._jac32:
                return fam["vjg"](x[fam["Vidx"]], cc, lam)
            fx, jx = fam["vj"](x[fam["Vidx"]], cc)
            return fx, (jx * lam[:, :, None]).sum(1), jx

        for fam, cc in zip(self._eq, econ):
            lam = lamE[fam["rows"]]
            fx, g, jx = valgrad(fam, cc, lam)
            hx = hess_of(fam, x[fam["Vidx"]], cc, lam)
            famvals["jx_eq"].append(jx)
            famvals["hx_eq"].append(hx)
            ce.append(fx.ravel())
            g2d.append(g)
        for fam, cc in zip(self._iq, icon):
            lam = lamI[fam["rows"]]
            fx, g, jx = valgrad(fam, cc, lam)
            hx = hess_of(fam, x[fam["Vidx"]], cc, lam)
            famvals["jx_iq"].append(jx)
            famvals["hx_iq"].append(hx)
            ci.append(fx.ravel())
            g2d.append(g)
        for fam, cc in zip(self._obj, ocon):
            ones = jnp.ones((fam["napps"], 1), DEFAULT_DTYPE)
            fx, g, jx = valgrad(fam, cc, ones)
            if want_hess is True and fam["need_hess"]:
                hx = sigma * fam["hess"](x[fam["Vidx"]], cc, ones)
            elif want_hess == "zeros" and fam["need_hess"]:
                hx = jnp.zeros((fam["napps"], fam["nin"], fam["nin"]),
                               DEFAULT_DTYPE)
            else:
                hx = None
            obj = obj + jnp.sum(fx)
            famvals["hx_obj"].append(hx)
            g2d.append(sigma * g)
        cE = jnp.concatenate(ce) if ce else jnp.zeros((0,), DEFAULT_DTYPE)
        cI = jnp.concatenate(ci) if ci else jnp.zeros((0,), DEFAULT_DTYPE)
        gbuf = jnp.concatenate([g.ravel() for g in g2d]
                               + [jnp.zeros((1,), DEFAULT_DTYPE)])
        rd = gbuf[self._trd].sum(-1)
        base = {"eq": 0, "iq": len(self._eq),
                "obj": len(self._eq) + len(self._iq)}
        for which, i, cols, ids in self._g_border:
            rd = rd.at[ids].add(g2d[base[which] + i][:, cols].sum(0))
        if self._g_overflow is not None:
            s, t = self._g_overflow
            rd = rd.at[t].add(gbuf[s])
        return obj, cE, cI, rd, famvals

    def _ad_impl(self, x, lamE, lamI, sigma, consts):
        return self._eval_core(x, lamE, lamI, sigma, consts, want_hess=True)

    def _ad_impl_gn(self, x, lamE, lamI, sigma, consts):
        """First-order (Gauss-Newton) pass: Jacobians + gradients with
        structurally zero Hessians — the reference evalSOE / evalAUG
        eval modes (`NonLinearProgram.cpp:590-627`)."""
        return self._eval_core(x, lamE, lamI, sigma, consts,
                               want_hess="zeros")

    def _resid_impl(self, x, lamE, lamI, sigma, consts):
        obj, cE, cI, rd, _ = self._eval_core(x, lamE, lamI, sigma, consts,
                                             want_hess=False)
        return obj, rd, cE, cI, rd   # 2nd slot (gradf) kept for API shape

    def eval_resid(self, x, lamE, lamI, sigma):
        return self._jit_resid(x, lamE, lamI, jnp.asarray(sigma),
                               self.nlp.consts_dev())

    # ------------------------------------------------------ block assembly
    def _blocks_impl(self, famvals, sig_tilde):
        """Gather-table assembly of (diag, lower, B, C) from the family
        value buffer; the iq condensation J^T Sigma~ J is folded in here so
        the perturbation ladder can refactor without re-running AD."""
        bs = self.bs
        K, W, b = bs.K, bs.W, bs.b
        vparts = []
        for i, fam in enumerate(self._eq):
            vparts.append(famvals["jx_eq"][i].ravel())
            if fam["need_hess"]:
                vparts.append(famvals["hx_eq"][i].ravel())
        for i, fam in enumerate(self._iq):
            jx = famvals["jx_iq"][i]
            st = sig_tilde[fam["rows"]]
            jst = jx * st[:, :, None]
            h = (jst[:, :, :, None] * jx[:, :, None, :]).sum(1)
            if fam["need_hess"]:
                h = h + famvals["hx_iq"][i]
            vparts.append(h.ravel())
        for i, fam in enumerate(self._obj):
            if fam["need_hess"]:
                vparts.append(famvals["hx_obj"][i].ravel())
        vbuf = jnp.concatenate([p.ravel() for p in vparts]
                               + [jnp.zeros((1,), DEFAULT_DTYPE)])
        ds, dt_ = self._d_scatter
        ls_, lt = self._l_scatter
        diag = jnp.zeros((K * W * W,), DEFAULT_DTYPE)
        if len(ds):
            diag = diag.at[dt_].add(vbuf[ds])
        lower = jnp.zeros((K * W * W,), DEFAULT_DTYPE)
        if len(ls_):
            lower = lower.at[lt].add(vbuf[ls_])
        if b > 0:
            B = vbuf[self._tB].sum(-1).ravel()
            C = vbuf[self._tC].sum(-1).ravel()
        else:
            B = jnp.zeros((K * W * b,), DEFAULT_DTYPE)
            C = jnp.zeros((0,), DEFAULT_DTYPE)
        for s, t, name in self._overflow:
            if name == "B":
                B = B.at[t].add(vbuf[s])
        diag = diag.reshape(K, W, W)
        lower = lower.reshape(K, W, W)
        B = B.reshape(K, W, b)
        # structured contributions: exact one-hot matmul patches
        for vi, plan in self._patch_plans:
            vals2d = vparts[vi].reshape(-1, plan["E"])
            diag, lower = _apply_patch_plan(plan, vals2d, diag, lower)
        for vi, plan in self._patch_plans_B:
            vals2d = vparts[vi].reshape(-1, plan["E"])
            B = _apply_patch_plan_B(plan, vals2d, B)
        return (diag, lower, B, C.reshape(b, b))

    # -------------------------------------------------------------- factor
    def _factor_blocks_impl(self, blocks, delta, gammaE):
        """Regularize + factor pre-assembled blocks (the ladder's refactor
        path: reference evaluates KKT once per iteration and only refactors,
        `PSIOPT.cpp:422`)."""
        diag, lower, B, C = blocks
        diag = diag + jnp.where(
            self._diag_sign > 0, delta,
            jnp.where(self._diag_sign < 0, -gammaE, 0.0)) + self._diag_fix
        C = C + jnp.where(self._c_sign > 0, delta,
                          jnp.where(self._c_sign < 0, -gammaE, 0.0))
        fdtype = _factor_dtype()
        if fdtype != DEFAULT_DTYPE:
            # equilibrate in f64 before the f32 cast (see _ruiz_equilibrate)
            dq, lq, Bq, Cq, s, sbrd = _ruiz_equilibrate(diag, lower, B, C)
            fac, neigs = bcr_factor(dq, lq, Bq, Cq, self.nlevels,
                                    fdtype=fdtype)
            # keep the exact f64 blocks for iterative refinement at solve
            # time (Pardiso QPRefSteps analog, `PSIOPT.h:146`)
            fac["blocks64"] = (diag, lower, B, C)
            fac["scale"] = (s, sbrd)
        elif _refine_steps() > 0:
            # refinement path (ASSET_REFINE_STEPS): Ruiz-equilibrate before
            # factoring so pivot magnitudes are O(1) and the recursion's
            # error amplification is minimized; keep the exact blocks for
            # Richardson refinement at solve time.
            dq, lq, Bq, Cq, s, sbrd = _ruiz_equilibrate(diag, lower, B, C)
            fac, neigs = bcr_factor(dq, lq, Bq, Cq, self.nlevels,
                                    fdtype=fdtype)
            fac["blocks64"] = (diag, lower, B, C)
            fac["scale"] = (s, sbrd)
        else:
            fac, neigs = bcr_factor(diag, lower, B, C, self.nlevels,
                                    fdtype=fdtype)
        return fac, neigs

    def _factor_impl(self, x, lamE, lamI, sigma, sig_tilde, delta, gammaE,
                     consts):
        _, _, _, _, famvals = self._ad_impl(x, lamE, lamI, sigma, consts)
        blocks = self._blocks_impl(famvals, sig_tilde)
        fac, neigs = self._factor_blocks_impl(blocks, delta, gammaE)
        fac["iq_jx"] = famvals["jx_iq"]
        return fac, neigs

    def factor(self, x, lamE, lamI, sigma, sig_tilde, delta,
               gammaE, gammaI=None):
        fac, neigs = self._jit_factor(
            x, lamE, lamI, jnp.asarray(sigma), sig_tilde,
            jnp.asarray(delta), jnp.asarray(gammaE),
            self.nlp.consts_dev())
        return fac, int(neigs)

    # --------------------------------------------------------------- solve
    def _solve_impl(self, fac, rhs_x, rhs_E):
        bs = self.bs
        K, W, b = bs.K, bs.W, bs.b
        full = jnp.zeros((K * W + b,), DEFAULT_DTYPE)
        full = full.at[self._perm].set(jnp.concatenate([rhs_x, rhs_E]))
        rblk = full[:K * W].reshape(K, W)
        rbrd = full[K * W:]
        if "blocks64" not in fac:
            y, z = bcr_solve(fac, rblk, rbrd, self.nlevels)
        elif fac["D0inv"].dtype != DEFAULT_DTYPE:
            # f32 factorization: FGMRES refinement on the equilibrated
            # system (the f32 factor's contraction ratio can approach 1)
            y, z = bcr_refined_solve(fac, rblk, rbrd, self.nlevels)
        else:
            # Ruiz-scaled f64 factorization: Richardson refinement
            y, z = bcr_richardson_solve(fac, rblk, rbrd, self.nlevels,
                                        steps=_refine_steps())
        flat = jnp.concatenate([y.reshape(-1), z])
        sol = flat[self._perm]
        return sol[:bs.n], sol[bs.n:]

    def solve(self, fac, rhs_x, rhs_E):
        return self._jit_solve(fac, rhs_x, rhs_E)

    # -------------------------------------------------------------- matvec
    def _iq_matvec_impl(self, fac, dx):
        out = jnp.zeros((self.nlp.numIq,), DEFAULT_DTYPE)
        for fam, jx in zip(self._iq, fac["iq_jx"]):
            v = (jx.transpose(0, 2, 1) * dx[fam["Vidx"]][:, :, None]).sum(1)
            out = out.at[fam["rows"].ravel()].add(v.ravel())
        return out

    def iq_matvec(self, fac, dx):
        return self._jit_iqmv(fac, dx)

    def _iq_rmatvec_impl(self, fac, v):
        out = jnp.zeros((self.nlp.numPrimal,), DEFAULT_DTYPE)
        for fam, jx in zip(self._iq, fac["iq_jx"]):
            g = (jx * v[fam["rows"]][:, :, None]).sum(1)
            out = out.at[fam["Vidx"].ravel()].add(g.ravel())
        return out

    def iq_rmatvec(self, fac, v):
        return self._jit_iqrmv(fac, v)


