"""Segment-axis sharded block-tridiagonal KKT (multi-chip substructuring).

The single-chip backend factors [T, B; B^T, C] by block cyclic reduction
(`kkt_block.bcr_factor`).  Here the macro chain is partitioned over a
`jax.sharding.Mesh` axis: each device owns L consecutive macros, keeps its
FIRST macro as the shard's boundary representative, eliminates its L-1
interior macros with a purely local BCR (the representative, the next
shard's representative, and the global border form an *extended border* of
that local factorization), and exchanges only the (b + 2W)-sized border
Schur complements via `all_gather`.  The reduced system — a
block-tridiagonal chain over the D representatives plus the global border
— is factorized redundantly on every device (O(D) serial work per
device: fine at single-host D<=8; across many hosts use the 2-axis
hierarchical mesh, `sharded_factor_hier`, whose cross-host reduced
chain is O(#hosts)).

This is the multi-device replacement for the reference's shared-memory
Pardiso factorization (`src/Solvers/PardisoInterface.h`):
SURVEY.md section 2.9 P6 / section 5.8 — phases/segments are index-disjoint
blocks whose only coupling is through boundary rows, so the chain is the
natural sharding seam (`OptimalControlProblem.cpp:115-388`).

Inertia is exact: per-shard interior pivot counts are `psum`-reduced and
added to the reduced system's count (Sylvester congruence over the whole
elimination), so PSIOPT's perturbation ladder behaves identically to the
single-chip path.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
try:
    from jax import shard_map
except ImportError:  # older jax
    from jax.experimental.shard_map import shard_map

from ..config import DEFAULT_DTYPE
from .kkt_block import (bcr_factor, bcr_reduce_rhs, bcr_backsub, bcr_solve,
                        _factor_dtype)

__all__ = ["sharded_factor", "sharded_solve", "sharded_factor_hier",
           "sharded_solve_hier", "pad_chain", "ShardedBlockKKT"]


def pad_chain(diag, lower, B, C, D):
    """Pad the K-macro chain to D*L macros with identity diagonal blocks
    (clean +1 pivots, zero couplings)."""
    K, W, _ = diag.shape
    L = max(2, -(-K // D))   # >= 1 interior macro per shard
    Kp = D * L
    if Kp != K:
        eye = jnp.broadcast_to(jnp.eye(W, dtype=diag.dtype),
                               (Kp - K, W, W))
        diag = jnp.concatenate([diag, eye], axis=0)
        lower = jnp.concatenate(
            [lower, jnp.zeros((Kp - K, W, W), lower.dtype)], axis=0)
        B = jnp.concatenate(
            [B, jnp.zeros((Kp - K, W, B.shape[2]), B.dtype)], axis=0)
    # the padded region must not couple to the real chain
    if Kp != K:
        mask = (jnp.arange(Kp) < K - 1)[:, None, None]
        lower = jnp.where(mask, lower, 0.0)
    return diag, lower, B, C, L


def sharded_factor(diag, lower, B, C, mesh, axis="seg", fdtype=None):
    """Factor the padded chain over `mesh[axis]`.

    diag/lower: (D*L, W, W); B: (D*L, W, b); C: (b, b) replicated.
    Returns (fac, neigs); fac holds per-shard local factors (sharded
    leaves) + the replicated reduced factorization.
    """
    D = mesh.shape[axis]
    Kp, W, _ = diag.shape
    b_orig = C.shape[0]
    if b_orig == 0:
        # zero-sized border operands break XLA:Shardy inside shard_map;
        # pad to a decoupled 1-wide border (positive unit pivot, no effect)
        B = jnp.zeros((Kp, W, 1), diag.dtype)
        C = jnp.eye(1, dtype=diag.dtype)
    b = C.shape[0]
    bext = b + 2 * W
    if fdtype is not None and diag.dtype != fdtype:
        diag = diag.astype(fdtype)
        lower = lower.astype(fdtype)
        B = B.astype(fdtype)
        C = C.astype(fdtype)

    def local(diag_l, lower_l, B_l, C_g):
        # diag_l (L, W, W); rep = local macro 0, interior 1..L-1
        L = diag_l.shape[0]
        dt = diag_l.dtype
        diag_i = diag_l[1:]
        # interior couplings: K[int j+1, int j] = lower_l[1+j], j=0..L-3
        lower_i = jnp.concatenate(
            [lower_l[1:L - 1], jnp.zeros((1, W, W), dt)], axis=0)
        # extended border columns: [global b | own rep | next rep]
        own = jnp.concatenate(
            [lower_l[0:1],                       # K[int 0, rep] = lower_l[0]
             jnp.zeros((L - 2, W, W), dt)], axis=0)
        nxt = jnp.concatenate(
            [jnp.zeros((L - 2, W, W), dt),
             lower_l[L - 1:L].transpose(0, 2, 1)], axis=0)
        B_ext = jnp.concatenate([B_l[1:], own, nxt], axis=2)
        C0 = jnp.zeros((bext, bext), dt)
        C0 = C0.at[b:b + W, b:b + W].set(diag_l[0])
        C0 = C0.at[b:b + W, :b].set(B_l[0])
        C0 = C0.at[:b, b:b + W].set(B_l[0].T)
        fac_loc, neigs_loc = bcr_factor(diag_i, lower_i, B_ext, C0,
                                        invert_border=False)
        Cs = fac_loc.pop("C_schur")
        # exchange border Schur complements (the only inter-chip traffic)
        Cs_all = jax.lax.all_gather(Cs, axis)           # (D, bext, bext)
        neigs = jax.lax.psum(neigs_loc, axis)
        # reduced chain over the D representatives (+ global border)
        # rep g also receives shard g-1's (next-rep x next-rep / border)
        # Schur updates
        shift = jnp.concatenate(
            [jnp.zeros((1, W, W + b), dt),
             jnp.concatenate([Cs_all[:-1, b + W:, b + W:],
                              Cs_all[:-1, b + W:, :b]], axis=2)], axis=0)
        redD = Cs_all[:, b:b + W, b:b + W] + shift[:, :, :W]
        redB = Cs_all[:, b:b + W, :b] + shift[:, :, W:]
        redL = Cs_all[:, b + W:, b:b + W]
        redC = C_g + Cs_all[:, :b, :b].sum(0)
        fac_red, neigs_red = bcr_factor(redD, redL, redB, redC)
        neigs = neigs + neigs_red
        # leading singleton axis so every per-shard leaf shards uniformly
        fac_loc = jax.tree.map(lambda t: t[None], fac_loc)
        return fac_loc, fac_red, neigs[None]

    spec_l = P(axis)
    fac_loc, fac_red, neigs = shard_map(
        local, mesh=mesh,
        in_specs=(spec_l, spec_l, spec_l, P()),
        out_specs=(spec_l, P(), P(axis)),
        check_vma=False,
    )(diag, lower, B, C)
    # metadata stays OUT of the returned dict: the fused solver carries
    # fac through lax.while_loop, which would turn python ints into tracers
    return dict(loc=fac_loc, red=fac_red), neigs[0]


def sharded_solve(fac, rhs_blocks, rhs_border, mesh, axis="seg"):
    """Solve with a sharded_factor result.

    rhs_blocks (D*L, W) padded; rhs_border (b,) replicated."""
    W = fac["loc"]["D0inv"].shape[-1]
    b = fac["red"]["Cinv"].shape[-1]
    b_orig = 0 if rhs_border.shape[0] == 0 else b
    if b_orig == 0:
        rhs_border = jnp.zeros((1,), rhs_blocks.dtype)
    D = mesh.shape[axis]

    def local(fac_loc, fac_red, r_l, rb):
        fac_loc = jax.tree.map(lambda t: t[0], fac_loc)
        dt = fac_loc["D0inv"].dtype
        g = jax.lax.axis_index(axis)
        r_int = r_l[1:].astype(dt)
        rb_ext0 = jnp.concatenate(
            [jnp.zeros((b,), dt), r_l[0].astype(dt), jnp.zeros((W,), dt)])
        stack, r_root, rb_red = bcr_reduce_rhs(fac_loc, r_int, rb_ext0)
        all_red = jax.lax.all_gather(rb_red, axis)      # (D, bext)
        # red rhs for rep g: own-rep part of shard g + next-rep part of
        # shard g-1; border parts sum once over shards
        shift = jnp.concatenate(
            [jnp.zeros((1, W), dt), all_red[:-1, b + W:b + 2 * W]], axis=0)
        red_r = all_red[:, b:b + W] + shift
        red_rb = rb.astype(dt) + all_red[:, :b].sum(0)
        y_red, z = bcr_solve(fac_red, red_r, red_rb)
        y_red_pad = jnp.concatenate(
            [y_red, jnp.zeros((1, W), dt)], axis=0)
        z0 = jnp.zeros((), g.dtype)
        y_own = jax.lax.dynamic_slice(y_red_pad, (g, z0), (1, W))[0]
        y_nxt = jax.lax.dynamic_slice(y_red_pad, (g + 1, z0), (1, W))[0]
        z_ext = jnp.concatenate([z, y_own, y_nxt])
        y_int = bcr_backsub(fac_loc, stack, r_root, z_ext)
        y_l = jnp.concatenate([y_own[None], y_int], axis=0)
        return y_l, z[None]

    spec_l = P(axis)
    y, z = shard_map(
        local, mesh=mesh,
        in_specs=(spec_l, P(), spec_l, P()),
        out_specs=(spec_l, P(axis)),
        check_vma=False,
    )(fac["loc"], fac["red"], rhs_blocks, rhs_border)
    z = z[0]
    if b_orig == 0:
        z = z[:0]
    return y, z


def sharded_factor_hier(diag, lower, B, C, mesh, axes=("host", "chip"),
                        fdtype=None):
    """Two-level hierarchical substructuring for multi-host meshes.

    Same elimination as `sharded_factor` with one more level: each CHIP
    eliminates its interior macros locally; each HOST then gathers its
    chips' (b+2W)-sized border Schur complements over the intra-host axis,
    eliminates the chip representatives down to ONE host representative,
    and only the host-level Schur complements cross the host boundary
    (`all_gather` over axes[0]).  The final H-host chain is factorized
    redundantly.  This keeps cross-host volume at
    H x (b+2W)^2 instead of (H*Dc) x (b+2W)^2 and the redundant reduced
    factorization at O(H) instead of O(H*Dc) (BASELINE.md:33 N>=2 hosts;
    SURVEY.md section 5.8).

    diag/lower: (H*Dc*L, W, W) padded with `pad_chain(..., D=H*Dc)`.
    """
    hax, cax = axes
    H = mesh.shape[hax]
    Dc = mesh.shape[cax]
    Kp, W, _ = diag.shape
    b_orig = C.shape[0]
    if b_orig == 0:
        B = jnp.zeros((Kp, W, 1), diag.dtype)
        C = jnp.eye(1, dtype=diag.dtype)
    b = C.shape[0]
    bext = b + 2 * W
    if fdtype is not None and diag.dtype != fdtype:
        diag, lower = diag.astype(fdtype), lower.astype(fdtype)
        B, C = B.astype(fdtype), C.astype(fdtype)

    def local(diag_l, lower_l, B_l, C_g):
        L = diag_l.shape[0]
        dt = diag_l.dtype
        cidx = jax.lax.axis_index(cax)
        # ---- level 0: eliminate this chip's interior macros ----
        diag_i = diag_l[1:]
        lower_i = jnp.concatenate(
            [lower_l[1:L - 1], jnp.zeros((1, W, W), dt)], axis=0)
        own = jnp.concatenate(
            [lower_l[0:1], jnp.zeros((L - 2, W, W), dt)], axis=0)
        nxt = jnp.concatenate(
            [jnp.zeros((L - 2, W, W), dt),
             lower_l[L - 1:L].transpose(0, 2, 1)], axis=0)
        B_ext = jnp.concatenate([B_l[1:], own, nxt], axis=2)
        C0 = jnp.zeros((bext, bext), dt)
        C0 = C0.at[b:b + W, b:b + W].set(diag_l[0])
        C0 = C0.at[b:b + W, :b].set(B_l[0])
        C0 = C0.at[:b, b:b + W].set(B_l[0].T)
        fac_loc, neigs_loc = bcr_factor(diag_i, lower_i, B_ext, C0,
                                        invert_border=False)
        Cs = fac_loc.pop("C_schur")

        # ---- level 1: host-local reduction over chip reps ----
        Csc = jax.lax.all_gather(Cs, cax)               # (Dc, bext, bext)
        # interior chip-reps j=1..Dc-1 of this host
        shift_c = jnp.concatenate([Csc[:-1, b + W:, b + W:],
                                   Csc[:-1, b + W:, :b]], axis=2)
        hd_i = Csc[1:, b:b + W, b:b + W] + shift_c[:, :, :W]
        hB_i = Csc[1:, b:b + W, :b] + shift_c[:, :, W:]
        hl_full = Csc[:, b + W:, b:b + W]     # K_red[rep_{j+1}, rep_j]
        hl_i = jnp.concatenate(
            [hl_full[1:Dc - 1], jnp.zeros((1, W, W), dt)], axis=0)
        hown = jnp.concatenate(
            [hl_full[0:1], jnp.zeros((Dc - 2, W, W), dt)], axis=0)
        hnxt = jnp.concatenate(
            [jnp.zeros((Dc - 2, W, W), dt),
             hl_full[Dc - 1:Dc].transpose(0, 2, 1)], axis=0)
        hB_ext = jnp.concatenate([hB_i, hown, hnxt], axis=2)
        C0h = jnp.zeros((bext, bext), dt)
        C0h = C0h.at[:b, :b].set(Csc[:, :b, :b].sum(0))
        C0h = C0h.at[b:b + W, b:b + W].set(Csc[0, b:b + W, b:b + W])
        C0h = C0h.at[b:b + W, :b].set(Csc[0, b:b + W, :b])
        C0h = C0h.at[:b, b:b + W].set(Csc[0, :b, b:b + W])
        # chip Dc-1's direct Schur contributions onto the NEXT host's
        # representative (diag + border coupling) ride the host-level
        # Schur complement to the top-level shift (the hierarchical
        # analog of the flat scheme's Cs_all[d-1] shift)
        C0h = C0h.at[b + W:, b + W:].set(Csc[Dc - 1, b + W:, b + W:])
        C0h = C0h.at[b + W:, :b].set(Csc[Dc - 1, b + W:, :b])
        C0h = C0h.at[:b, b + W:].set(Csc[Dc - 1, :b, b + W:])
        fac_host, neigs_host = bcr_factor(hd_i, hl_i, hB_ext, C0h,
                                          invert_border=False)
        Cs2 = fac_host.pop("C_schur")

        # ---- level 2: cross-host reduction ----
        Csh = jax.lax.all_gather(Cs2, hax)              # (H, bext, bext)
        shift_h = jnp.concatenate(
            [jnp.zeros((1, W, W + b), dt),
             jnp.concatenate([Csh[:-1, b + W:, b + W:],
                              Csh[:-1, b + W:, :b]], axis=2)], axis=0)
        topD = Csh[:, b:b + W, b:b + W] + shift_h[:, :, :W]
        topB = Csh[:, b:b + W, :b] + shift_h[:, :, W:]
        topL = Csh[:, b + W:, b:b + W]
        topC = C_g.astype(dt) + Csh[:, :b, :b].sum(0)
        fac_top, neigs_top = bcr_factor(topD, topL, topB, topC)

        neigs = jax.lax.psum(
            neigs_loc + jnp.where(cidx == 0, neigs_host, 0),
            (hax, cax)) + neigs_top
        fac_loc = jax.tree.map(lambda t: t[None], fac_loc)
        fac_host = jax.tree.map(lambda t: t[None], fac_host)
        return fac_loc, fac_host, fac_top, neigs[None]

    spec_l = P((hax, cax))
    fac_loc, fac_host, fac_top, neigs = shard_map(
        local, mesh=mesh,
        in_specs=(spec_l, spec_l, spec_l, P()),
        out_specs=(spec_l, P(hax), P(), P((hax, cax))),
        check_vma=False,
    )(diag, lower, B, C)
    return dict(loc=fac_loc, host=fac_host, red=fac_top), neigs[0]


def sharded_solve_hier(fac, rhs_blocks, rhs_border, mesh,
                       axes=("host", "chip")):
    """Solve with a sharded_factor_hier result (two gather levels:
    within a host, then across hosts)."""
    hax, cax = axes
    W = fac["loc"]["D0inv"].shape[-1]
    b = fac["red"]["Cinv"].shape[-1]
    b_orig = 0 if rhs_border.shape[0] == 0 else b
    if b_orig == 0:
        rhs_border = jnp.zeros((1,), rhs_blocks.dtype)
    Dc = mesh.shape[cax]

    def local(fac_loc, fac_host, fac_top, r_l, rb):
        fac_loc = jax.tree.map(lambda t: t[0], fac_loc)
        fac_host = jax.tree.map(lambda t: t[0], fac_host)
        dt = fac_loc["D0inv"].dtype
        h = jax.lax.axis_index(hax)
        c = jax.lax.axis_index(cax)
        # level 0 reduce
        r_int = r_l[1:].astype(dt)
        rb_ext0 = jnp.concatenate(
            [jnp.zeros((b,), dt), r_l[0].astype(dt), jnp.zeros((W,), dt)])
        stack, r_root, rb_red = bcr_reduce_rhs(fac_loc, r_int, rb_ext0)
        # level 1 reduce (within the host)
        allc = jax.lax.all_gather(rb_red, cax)          # (Dc, bext)
        r_int_h = allc[1:, b:b + W] + allc[:-1, b + W:b + 2 * W]
        # last chip's next-rep rhs part belongs to the NEXT host's
        # representative: carry it in the host Schur rhs (top-level shift)
        rb_ext_h = jnp.concatenate(
            [allc[:, :b].sum(0), allc[0, b:b + W],
             allc[Dc - 1, b + W:b + 2 * W]])
        stack_h, r_root_h, rb_red_h = bcr_reduce_rhs(fac_host, r_int_h,
                                                     rb_ext_h)
        # level 2 (across hosts)
        allh = jax.lax.all_gather(rb_red_h, hax)        # (H, bext)
        shift = jnp.concatenate(
            [jnp.zeros((1, W), dt), allh[:-1, b + W:b + 2 * W]], axis=0)
        top_r = allh[:, b:b + W] + shift
        top_rb = rb.astype(dt) + allh[:, :b].sum(0)
        y_top, z = bcr_solve(fac_top, top_r, top_rb)
        # host-level backsub: reps 1..Dc-1 of this host
        y_top_pad = jnp.concatenate([y_top, jnp.zeros((1, W), dt)], axis=0)
        z0 = jnp.zeros((), h.dtype)
        y_hown = jax.lax.dynamic_slice(y_top_pad, (h, z0), (1, W))[0]
        y_hnxt = jax.lax.dynamic_slice(y_top_pad, (h + 1, z0), (1, W))[0]
        z_ext_h = jnp.concatenate([z, y_hown, y_hnxt])
        y_reps_i = bcr_backsub(fac_host, stack_h, r_root_h, z_ext_h)
        # this chip's own/next rep values
        y_reps = jnp.concatenate([y_hown[None], y_reps_i, y_hnxt[None]],
                                 axis=0)                # (Dc+1, W)
        y_own = jax.lax.dynamic_slice(y_reps, (c, z0), (1, W))[0]
        y_nxt = jax.lax.dynamic_slice(y_reps, (c + 1, z0), (1, W))[0]
        z_ext = jnp.concatenate([z, y_own, y_nxt])
        y_int = bcr_backsub(fac_loc, stack, r_root, z_ext)
        y_l = jnp.concatenate([y_own[None], y_int], axis=0)
        return y_l, z[None]

    spec_l = P((hax, cax))
    y, z = shard_map(
        local, mesh=mesh,
        in_specs=(spec_l, P(hax), P(), spec_l, P()),
        out_specs=(spec_l, P((hax, cax))),
        check_vma=False,
    )(fac["loc"], fac["host"], fac["red"], rhs_blocks, rhs_border)
    z = z[0]
    if b_orig == 0:
        z = z[:0]
    return y, z


class ShardedBlockKKT:
    """Drop-in BlockKKT variant whose factorization/solve run segment-axis
    sharded over a device mesh (SURVEY.md section 2.9 P6: ONE problem's KKT
    distributed over chips, boundary Schur complements exchanged via
    all_gather).

    Wraps an existing BlockKKT (reusing its probing/assembly plan) and
    overrides only the factor/solve kernels, so the fused PSIOPT loop and
    the host loop work unchanged."""

    def __init__(self, base, mesh, axis="seg"):
        """mesh: 1-axis (flat substructuring) or 2-axis ("host",
        "chip")-style (hierarchical: reduction per host, exchange across
        hosts — see sharded_factor_hier).  `axis` names
        the chain axis for 1-axis meshes; for 2-axis meshes the mesh's
        own axis order (outer=host, inner=chip) is used."""
        import jax
        self._base = base
        self.mesh = mesh
        names = list(mesh.axis_names)
        sizes = [mesh.shape[n] for n in names]
        # hierarchical substructuring needs >=2 on BOTH axes (the
        # intra-level eliminations build (size-2)-length chains); a
        # (H, 1)- or (1, C)-shaped mesh degrades to flat sharding over
        # its non-unit axis
        self.hier = len(names) >= 2 and sizes[0] >= 2 and sizes[1] >= 2
        if self.hier:
            self.axes = tuple(names[:2])
            self.D = sizes[0] * sizes[1]
        else:
            if len(names) >= 2:
                axis = names[int(np.argmax(sizes[:2]))]
            self.axis = axis
            self.D = mesh.shape[axis]
        self.nlp = base.nlp
        self.bs = base.bs
        self.nlevels = base.nlevels
        self._eq, self._iq, self._obj = base._eq, base._iq, base._obj
        self._perm = base._perm
        self._diag_sign = base._diag_sign
        self._diag_fix = base._diag_fix
        self._c_sign = base._c_sign
        self._L = max(2, -(-base.bs.K // self.D))
        self._jit_factor = jax.jit(self._factor_impl)
        self._jit_solve = jax.jit(self._solve_impl)
        self._jit_resid = base._jit_resid

    # family evaluation / assembly delegate to the base plan
    def _eval_core(self, *a, **kw):
        return self._base._eval_core(*a, **kw)

    def _ad_impl(self, *a):
        return self._base._ad_impl(*a)

    def _resid_impl(self, *a):
        return self._base._resid_impl(*a)

    def _blocks_impl(self, *a):
        return self._base._blocks_impl(*a)

    def _iq_matvec_impl(self, *a):
        return self._base._iq_matvec_impl(*a)

    def _iq_rmatvec_impl(self, *a):
        return self._base._iq_rmatvec_impl(*a)

    def eval_resid(self, x, lamE, lamI, sigma):
        return self._base.eval_resid(x, lamE, lamI, sigma)

    def iq_matvec(self, fac, dx):
        return self._base._jit_iqmv(fac, dx)

    def iq_rmatvec(self, fac, v):
        return self._base._jit_iqrmv(fac, v)

    # ------------------------------------------------- sharded factor/solve
    def _factor_blocks_impl(self, blocks, delta, gammaE):
        import jax.numpy as jnp
        base = self._base
        diag, lower, B, C = blocks
        diag = diag + jnp.where(
            base._diag_sign > 0, delta,
            jnp.where(base._diag_sign < 0, -gammaE, 0.0)) + base._diag_fix
        C = C + jnp.where(base._c_sign > 0, delta,
                          jnp.where(base._c_sign < 0, -gammaE, 0.0))
        dg, lo, Bp, Cp, L = pad_chain(diag, lower, B, C, self.D)
        fdt = _factor_dtype() if _factor_dtype() != diag.dtype else None
        if self.hier:
            fac, neigs = sharded_factor_hier(dg, lo, Bp, Cp, self.mesh,
                                             self.axes, fdtype=fdt)
        else:
            fac, neigs = sharded_factor(dg, lo, Bp, Cp, self.mesh,
                                        self.axis, fdtype=fdt)
        from .kkt_block import _refine_steps
        if _refine_steps() > 0:
            # exact regularized blocks for Richardson refinement of the
            # sharded solve (ASSET_REFINE_STEPS, as on the single-chip
            # path, kkt_block.bcr_richardson_solve)
            fac["blocks64"] = (diag, lower, B, C)
        # padded identity blocks contribute +1 pivots only
        return fac, neigs

    def _factor_impl(self, x, lamE, lamI, sigma, sig_tilde, delta, gammaE,
                     consts):
        _, _, _, _, famvals = self._ad_impl(x, lamE, lamI, sigma, consts)
        blocks = self._blocks_impl(famvals, sig_tilde)
        fac, neigs = self._factor_blocks_impl(blocks, delta, gammaE)
        fac["iq_jx"] = famvals["jx_iq"]
        return fac, neigs

    def factor(self, x, lamE, lamI, sigma, sig_tilde, delta, gammaE,
               gammaI=None):
        import jax.numpy as jnp
        fac, neigs = self._jit_factor(
            x, lamE, lamI, jnp.asarray(sigma), sig_tilde,
            jnp.asarray(delta), jnp.asarray(gammaE), self.nlp.consts_dev())
        return fac, int(neigs)

    def _solve_impl(self, fac, rhs_x, rhs_E):
        import jax.numpy as jnp
        from .kkt_block import _block_matvec, _refine_steps
        bs = self.bs
        K, W, b = bs.K, bs.W, bs.b
        full = jnp.zeros((K * W + b,), rhs_x.dtype)
        full = full.at[self._perm].set(jnp.concatenate([rhs_x, rhs_E]))
        rblk = full[:K * W].reshape(K, W)
        rbrd = full[K * W:]
        Kp = self.D * self._L

        def sweep(rb, rz):
            rpad = jnp.concatenate(
                [rb, jnp.zeros((Kp - K, W), rb.dtype)], axis=0)
            if self.hier:
                y, z = sharded_solve_hier(fac, rpad, rz, self.mesh,
                                          self.axes)
            else:
                y, z = sharded_solve(fac, rpad, rz, self.mesh, self.axis)
            return y[:K], z

        y, z = sweep(rblk, rbrd)
        # plain Richardson refinement is only safe around a full-precision
        # factor; an f32 factor's contraction ratio can approach 1 late in
        # the IPM (the single-chip path uses FGMRES there instead), so gate
        # on the factor dtype like kkt_block._solve_impl does.
        from ..config import DEFAULT_DTYPE
        if "blocks64" in fac and fac["D0inv"].dtype == DEFAULT_DTYPE:
            matvec = _block_matvec(fac["blocks64"])
            for _ in range(_refine_steps()):
                Ay, Az = matvec(y, z)
                dy, dz = sweep(rblk - Ay, rbrd - Az)
                y = y + dy
                z = z + dz
        flat = jnp.concatenate([y.reshape(-1), z])
        sol = flat[self._perm]
        return sol[:bs.n], sol[bs.n:]

    def solve(self, fac, rhs_x, rhs_E):
        return self._jit_solve(fac, rhs_x, rhs_E)
