"""NonLinearProgram: batched assembly of objective/constraint families.

JAX replacement for `src/Solvers/NonLinearProgram.{h,cpp}` +
`src/VectorFunctions/IndexingData.h`:

* reference `SolverIndexingData` (Vindex/Cindex gather-scatter metadata)
  -> int32 index arrays driving `x[Vidx]` gathers and `.at[Cidx].add` scatters
* reference SuperScalar/thread-pool bulk evaluation
  (`DenseFunctionBase.h:1171-1211`, `NonLinearProgram.cpp:473-538`)
  -> one `jax.vmap` over ALL applications of each function kind
* reference KKT CSR slot matching + clash mutexes
  (`NonLinearProgram.h:103-107`) -> deterministic dense/block scatter-adds
  (no locks needed; XLA scatter-add has a fixed reduction order).

A *family* is one function applied at many index sets: e.g. the LGL5 defect
applied to every segment of a phase, or a variable bound applied at every
node.  Per-application constant data (mesh fractions, quadrature weights,
bound values) rides along in `consts` so one traced function serves every
application.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ..config import DEFAULT_DTYPE
from ..VectorFunctions.function import VectorFunction

__all__ = ["IndexedFunction", "NonLinearProgram"]


class IndexedFunction:
    """A function kind + the index sets of all its applications.

    fun: callable (xloc (nin,), consts (nc,)) -> (nout,)   [traced by jax]
         or a VectorFunction (consts ignored).
    Vidx: (napps, nin) int array of global variable indices per application.
    consts: (napps, nc) float array of per-application constants.
    """

    def __init__(self, fun, Vidx, consts=None, name="fun", scale=None,
                 in_scales=None, out_scales=None):
        if isinstance(fun, VectorFunction):
            vfun = fun
            self.fun = lambda x, c: vfun.trace(x)
            self.nout = vfun.ORows()
            nin_expected = vfun.IRows()
        else:
            self.fun = fun
            self.nout = None  # determined by probing
            nin_expected = None
        self.Vidx = np.asarray(Vidx, dtype=np.int32)
        if self.Vidx.ndim != 2:
            raise ValueError("Vidx must be (napps, nin)")
        self.napps, self.nin = self.Vidx.shape
        if nin_expected is not None and self.nin != nin_expected:
            raise ValueError(
                f"{name}: Vidx width {self.nin} != function input {nin_expected}")
        if consts is None:
            consts = np.zeros((self.napps, 0))
        self.consts = np.asarray(consts, dtype=np.float64)
        if self.consts.ndim == 1:
            self.consts = self.consts[:, None]
        if self.consts.shape[0] != self.napps:
            raise ValueError(f"{name}: consts rows != napps")
        self.name = name
        self.scale = None if scale is None else np.asarray(scale, np.float64)
        # auto-scaling (reference calc_auto_scales/IOScaled): fold variable
        # units and row scales into the traced function via per-application
        # constants, so every downstream consumer (dense/block assembly,
        # residuals, sparsity probing) sees the scaled problem uniformly
        if in_scales is not None or out_scales is not None:
            nc0 = self.consts.shape[1]
            nin = self.nin
            ins = np.ones((self.napps, nin)) if in_scales is None \
                else np.asarray(in_scales, np.float64)
            base = self.fun
            if out_scales is not None:
                outs = np.asarray(out_scales, np.float64)
                nout = outs.shape[1]
                self.consts = np.concatenate(
                    [self.consts, ins, outs], axis=1)

                def scaled(g, c, base=base, nc0=nc0, nin=nin, nout=nout):
                    return c[nc0 + nin:nc0 + nin + nout] * jnp.atleast_1d(
                        base(c[nc0:nc0 + nin] * g, c[:nc0]))
            else:
                self.consts = np.concatenate([self.consts, ins], axis=1)

                def scaled(g, c, base=base, nc0=nc0, nin=nin):
                    return jnp.atleast_1d(
                        base(c[nc0:nc0 + nin] * g, c[:nc0]))
            self.fun = scaled
        if self.nout is None:
            probe = jax.eval_shape(
                self.fun,
                jax.ShapeDtypeStruct((self.nin,), DEFAULT_DTYPE),
                jax.ShapeDtypeStruct((self.consts.shape[1],), DEFAULT_DTYPE))
            self.nout = int(np.prod(probe.shape)) if probe.shape else 1

    def __repr__(self):
        return (f"<IndexedFunction {self.name}: {self.napps} apps, "
                f"{self.nin}->{self.nout}>")


def _family_value(fun):
    def one(xloc, consts):
        return jnp.atleast_1d(fun(xloc, consts))
    return jax.vmap(one)


def _family_valjac(fun):
    def one(xloc, consts):
        f = lambda z: jnp.atleast_1d(fun(z, consts))
        return f(xloc), jax.jacfwd(f)(xloc)
    return jax.vmap(one)


def _family_full(fun):
    """value, jacobian, adjoint hessian for a batch of applications."""
    def one(xloc, consts, lam):
        f = lambda z: jnp.atleast_1d(fun(z, consts))
        fx = f(xloc)
        jx = jax.jacfwd(f)(xloc)
        agrad = lambda z: jax.vjp(f, z)[1](lam)[0]
        hx = jax.jacfwd(agrad)(xloc)
        return fx, jx, hx
    return jax.vmap(one)


def _family_hess(fun):
    """Adjoint Hessian alone (forward-over-reverse), one vmapped pass.

    Kept SEPARATE from the value/Jacobian pass so the line-search and
    residual passes never pay for it; the split costs one extra forward
    evaluation per KKT build."""
    def one(xloc, consts, lam):
        f = lambda z: jnp.atleast_1d(fun(z, consts))
        agrad = lambda z: jax.vjp(f, z)[1](lam)[0]
        return jax.jacfwd(agrad)(xloc)
    return jax.vmap(one)


def _family_hess_f32(fun):
    """Adjoint Hessian computed in f32, returned as DEFAULT_DTYPE.

    The adjoint Hessian is the single most expensive family-AD pass (nin
    forward tangents through a reverse sweep) yet only enters the KKT
    MATRIX, never the residuals — the convergence measurements (rd, cE,
    cI) always come from the f64 value/Jacobian pass.  An f32-accurate
    curvature block turns exact Newton into an inexact Newton step whose
    relative error tracks the scaled matrix perturbation (~1e-7 * the
    Ruiz-scaled conditioning), which the IPM absorbs as a slightly higher
    linear rate near the optimum.  Select with ASSET_HESS_DTYPE=f32.

    The inner function may still promote pieces to f64 (np-constant
    coefficient matrices inside closures); the cotangent is therefore cast
    to the primal output dtype so the vjp stays well-typed either way."""
    def one(xloc, consts, lam):
        x32 = xloc.astype(jnp.float32)
        c32 = consts.astype(jnp.float32)
        f = lambda z: jnp.atleast_1d(fun(z, c32))

        def agrad(z):
            fx, vjpf = jax.vjp(f, z)
            return vjpf(lam.astype(fx.dtype))[0]

        hx = jax.jacfwd(agrad)(x32)
        return hx.astype(DEFAULT_DTYPE)
    return jax.vmap(one)


def _family_valjac_bm(fun):
    """Batch-MINOR value+Jacobian: identical math and output layout to
    `_family_valjac`, but vmapped with in_axes=-1/out_axes=-1 so every AD
    intermediate is (..., napps) instead of (napps, k) with a tiny minor
    k (nin/nout ~ 8-17).  Selected by ASSET_FAMAD=fast (see
    kkt_block.BlockKKT); its cost on the H100 is not measured."""
    def one(xloc, consts):
        f = lambda z: jnp.atleast_1d(fun(z, consts))
        return f(xloc), jax.jacfwd(f)(xloc)
    vm = jax.vmap(one, in_axes=-1, out_axes=-1)

    def run(xg, cc):
        fx, jx = vm(xg.T, cc.T)
        return fx.T, jx.transpose(2, 0, 1)
    return run


def _retrace_f32(fun, nin, nc):
    """Build a genuinely-f32 version of a per-application family function.

    Casting inputs to f32 at the boundary is NOT enough: f64 constants
    embedded in the traced closures (coefficient matrices, mesh weights,
    physical constants) re-promote every downstream op to f64.  (Tracing
    under `jax.enable_x64(False)` is not a fix either: f64 closure array
    constants then meet f32 tracers and lower to invalid stablehlo.)
    Instead the function is traced ONCE at f64 and re-interpreted
    primitive-by-primitive with every float constant, literal, and dtype
    parameter rewritten to f32 — the result is an ordinary differentiable
    jax function whose whole graph is f32.

    Families whose graphs carry control flow, callbacks, or custom
    derivative rules raise at build/probe time and fall back to the f64
    pass (see kkt_block.BlockKKT make_hess)."""
    from jax.extend.core import ClosedJaxpr, Literal  # noqa: F401
    closed = jax.make_jaxpr(lambda z, c: jnp.atleast_1d(fun(z, c)))(
        jax.ShapeDtypeStruct((nin,), DEFAULT_DTYPE),
        jax.ShapeDtypeStruct((nc,), DEFAULT_DTYPE))
    f64 = np.dtype(np.float64)

    def cast32(v):
        dt = getattr(v, "dtype", None)
        if dt is not None and np.issubdtype(dt, np.floating) \
                and dt != np.float32:
            return jnp.asarray(v, jnp.float32) if isinstance(v, jax.Array) \
                else np.asarray(v, np.float32)
        if isinstance(v, float):
            return np.float32(v)
        return v

    def fix_param(v):
        # only rewrite actual dtype-valued params (np.dtype(None) would
        # "helpfully" default to float64 and clobber None params)
        if isinstance(v, np.dtype) or (isinstance(v, type)
                                       and issubclass(v, np.generic)):
            if np.dtype(v) == f64:
                return np.dtype(np.float32)
        return v

    def interp(jaxpr, consts, *args):
        env = {}

        def read(v):
            if isinstance(v, Literal):
                return cast32(v.val)
            return env[v]

        for var, c in zip(jaxpr.constvars, consts):
            env[var] = cast32(c)
        for var, a in zip(jaxpr.invars, args):
            env[var] = a
        for eqn in jaxpr.eqns:
            invals = [read(v) for v in eqn.invars]
            if eqn.primitive.name in ("pjit", "jit"):
                # inline nested jit bodies (they all end up inside the
                # solver's outer jit anyway)
                sub = eqn.params["jaxpr"]
                outs = interp(sub.jaxpr, sub.consts, *invals)
            else:
                if any(isinstance(v, (ClosedJaxpr,))
                       or (isinstance(v, (tuple, list))
                           and any(isinstance(w, ClosedJaxpr) for w in v))
                       for v in eqn.params.values()):
                    raise NotImplementedError(
                        f"f32 retrace: {eqn.primitive.name} carries "
                        "sub-jaxprs (control flow / custom rules)")
                params = {k: fix_param(v) for k, v in eqn.params.items()}
                outs = eqn.primitive.bind(*invals, **params)
                if not eqn.primitive.multiple_results:
                    outs = [outs]
            for var, o in zip(eqn.outvars, outs):
                env[var] = o
        return [read(v) for v in jaxpr.outvars]

    def f32fun(z32, c32):
        out = interp(closed.jaxpr, closed.consts, z32, c32)
        return out[0] if len(out) == 1 else out
    return f32fun


def _family_hess_true32(fun, nin, nc):
    """Adjoint Hessian with a genuinely-f32 graph (see `_retrace_f32`),
    returned as DEFAULT_DTYPE.

    Accuracy: the Hessian only enters the KKT *matrix*, never the
    residuals — rd/cE/cI always come from the f64 value/Jacobian pass, so
    convergence is still measured exactly.  An f32-accurate curvature
    block is an inexact-Newton perturbation the IPM absorbs."""
    f32t = _retrace_f32(fun, nin, nc)

    def one(xloc, consts, lam):
        x32 = xloc.astype(jnp.float32)
        c32 = consts.astype(jnp.float32)
        l32 = lam.astype(jnp.float32)
        g = lambda z: f32t(z, c32)
        agrad = lambda z: jax.vjp(g, z)[1](l32)[0]
        return jax.jacfwd(agrad)(x32).astype(DEFAULT_DTYPE)
    return jax.vmap(one)


def _family_valgradjac_mixed(fun):
    """Value + exact adjoint gradient (f64 vjp) + f32 matrix Jacobian.

    Splits the two jobs the full Jacobian currently serves: the KKT
    residual rd needs J^T lam EXACTLY (one f64 reverse sweep, ~2 function
    evaluations), while the assembled KKT matrix tolerates f32 entries
    (inexact Newton, see _family_hess_f32).  Replaces one f64 jacfwd
    over nin tangents with one f64 vjp + one f32 jacfwd.  Select with
    ASSET_JAC_DTYPE=f32."""
    def one(xloc, consts, lam):
        f = lambda z: jnp.atleast_1d(fun(z, consts))
        fx, vjpf = jax.vjp(f, xloc)
        g = vjpf(lam.astype(fx.dtype))[0]
        x32 = xloc.astype(jnp.float32)
        c32 = consts.astype(jnp.float32)
        f32 = lambda z: jnp.atleast_1d(fun(z, c32))
        jx = jax.jacfwd(f32)(x32)
        return fx, g, jx
    return jax.vmap(one)


class NonLinearProgram:
    """Assembles families into one NLP with dense or structured KKT output.

    Variable vector x has `numPrimal` entries.  Constraint rows are assigned
    contiguously per family, equality rows and inequality rows in separate
    spaces (reference: `NonLinearProgram::make_NLP`, `PhaseIndexer`).
    Inequality convention: c_I(x) <= 0 with slack c_I + s = 0, s >= 0
    (matches PSIOPT slack handling, `PSIOPT.h:549`).
    """

    def __init__(self, numPrimal):
        self.numPrimal = int(numPrimal)
        self.objectives: list[IndexedFunction] = []
        self.eqcons: list[IndexedFunction] = []
        self.iqcons: list[IndexedFunction] = []
        self._frozen = False
        # family consts are runtime arguments of every jitted evaluator, so
        # boundary values / lock values / mesh fractions can change between
        # solves with ZERO retracing (subVariables & warm continuation,
        # reference `ODEPhaseBase.cpp` LockedValues).  bump_consts()
        # invalidates the cached device copies.
        self.consts_version = 0
        self._consts_cache = (-1, None)

    # ------------------------------------------------------------- consts
    def bump_consts(self):
        self.consts_version += 1

    def consts_dev(self):
        """(obj, eq, iq) tuples of device consts arrays, cache-refreshed
        when bump_consts() was called."""
        ver, cached = self._consts_cache
        if ver != self.consts_version:
            cached = (tuple(jnp.asarray(f.consts) for f in self.objectives),
                      tuple(jnp.asarray(f.consts) for f in self.eqcons),
                      tuple(jnp.asarray(f.consts) for f in self.iqcons))
            self._consts_cache = (self.consts_version, cached)
        return cached

    # ------------------------------------------------------------- builders
    def addObjective(self, f: IndexedFunction):
        if f.nout != 1:
            raise ValueError("objective families must have scalar output")
        self.objectives.append(f)

    def addEqualCon(self, f: IndexedFunction):
        self.eqcons.append(f)

    def addInequalCon(self, f: IndexedFunction):
        self.iqcons.append(f)

    # ------------------------------------------------------------- freezing
    def freeze(self):
        """Assign constraint rows and build jitted evaluators."""
        if self._frozen:
            return
        self._frozen = True
        row = 0
        self._eq_rows = []
        for f in self.eqcons:
            rows = row + np.arange(f.napps * f.nout, dtype=np.int32).reshape(
                f.napps, f.nout)
            self._eq_rows.append(rows)
            row += f.napps * f.nout
        self.numEq = row
        row = 0
        self._iq_rows = []
        for f in self.iqcons:
            rows = row + np.arange(f.napps * f.nout, dtype=np.int32).reshape(
                f.napps, f.nout)
            self._iq_rows.append(rows)
            row += f.napps * f.nout
        self.numIq = row
        self._build_evaluators()

    # ------------------------------------------------------- dense evaluators
    def _build_evaluators(self):
        n = self.numPrimal
        mE, mI = self.numEq, self.numIq
        obj_fams = [(f, _family_value(f.fun), _family_full(f.fun),
                     np.asarray(f.Vidx))
                    for f in self.objectives]
        eq_fams = [(f, _family_value(f.fun), _family_full(f.fun),
                    np.asarray(f.Vidx), np.asarray(rows))
                   for f, rows in zip(self.eqcons, self._eq_rows)]
        iq_fams = [(f, _family_value(f.fun), _family_full(f.fun),
                    np.asarray(f.Vidx), np.asarray(rows))
                   for f, rows in zip(self.iqcons, self._iq_rows)]

        def eval_obj_cons(x, consts):
            """Objective value + raw constraint residuals (reference evalOCC:
            used by the merit line search).  Constraint rows are assigned
            contiguously per family in family order (freeze), so cE/cI are
            plain concatenations — no scatter.  consts: the (obj, eq, iq)
            device tuple from consts_dev()."""
            ocon, econ, icon = consts
            obj = jnp.zeros((), DEFAULT_DTYPE)
            for (f, fval, _, vidx), cc in zip(obj_fams, ocon):
                obj = obj + jnp.sum(fval(x[vidx], cc))
            ceparts = [fval(x[vidx], cc).ravel()
                       for (f, fval, _, vidx, rows), cc in zip(eq_fams, econ)]
            cE = jnp.concatenate(ceparts) if ceparts else \
                jnp.zeros((mE,), DEFAULT_DTYPE)
            ciparts = [fval(x[vidx], cc).ravel()
                       for (f, fval, _, vidx, rows), cc in zip(iq_fams, icon)]
            cI = jnp.concatenate(ciparts) if ciparts else \
                jnp.zeros((mI,), DEFAULT_DTYPE)
            return obj, cE, cI

        def eval_kkt(x, lamE, lamI, sigma, consts):
            """Full KKT data (reference NonLinearProgram::evalKKT):
            obj, gradf (scaled by sigma), cE, cI, dense H = sigma*grad^2 f +
            sum lam * grad^2 c, dense JE, JI."""
            ocon, econ, icon = consts
            obj = jnp.zeros((), DEFAULT_DTYPE)
            gradf = jnp.zeros((n,), DEFAULT_DTYPE)
            H = jnp.zeros((n, n), DEFAULT_DTYPE)
            for (f, _, ffull, vidx), cc in zip(obj_fams, ocon):
                ones = jnp.ones((f.napps, 1), DEFAULT_DTYPE)
                fx, jx, hx = ffull(x[vidx], cc, ones)
                obj = obj + jnp.sum(fx)
                gradf = gradf.at[vidx.ravel()].add(sigma * jx.ravel())
                hr = jnp.broadcast_to(vidx[:, :, None],
                                      (f.napps, f.nin, f.nin))
                hc = jnp.broadcast_to(vidx[:, None, :],
                                      (f.napps, f.nin, f.nin))
                H = H.at[hr.ravel(), hc.ravel()].add(sigma * hx.ravel())

            cE = jnp.zeros((mE,), DEFAULT_DTYPE)
            JE = jnp.zeros((mE, n), DEFAULT_DTYPE)
            for (f, _, ffull, vidx, rows), cc in zip(eq_fams, econ):
                lam = lamE[rows]
                fx, jx, hx = ffull(x[vidx], cc, lam)
                cE = cE.at[rows.ravel()].add(fx.ravel())
                jr = jnp.broadcast_to(rows[:, :, None],
                                      (f.napps, f.nout, f.nin))
                jc = jnp.broadcast_to(vidx[:, None, :],
                                      (f.napps, f.nout, f.nin))
                JE = JE.at[jr.ravel(), jc.ravel()].add(jx.ravel())
                hr = jnp.broadcast_to(vidx[:, :, None],
                                      (f.napps, f.nin, f.nin))
                hc = jnp.broadcast_to(vidx[:, None, :],
                                      (f.napps, f.nin, f.nin))
                H = H.at[hr.ravel(), hc.ravel()].add(hx.ravel())

            cI = jnp.zeros((mI,), DEFAULT_DTYPE)
            JI = jnp.zeros((mI, n), DEFAULT_DTYPE)
            for (f, _, ffull, vidx, rows), cc in zip(iq_fams, icon):
                lam = lamI[rows]
                fx, jx, hx = ffull(x[vidx], cc, lam)
                cI = cI.at[rows.ravel()].add(fx.ravel())
                jr = jnp.broadcast_to(rows[:, :, None],
                                      (f.napps, f.nout, f.nin))
                jc = jnp.broadcast_to(vidx[:, None, :],
                                      (f.napps, f.nout, f.nin))
                JI = JI.at[jr.ravel(), jc.ravel()].add(jx.ravel())
                hr = jnp.broadcast_to(vidx[:, :, None],
                                      (f.napps, f.nin, f.nin))
                hc = jnp.broadcast_to(vidx[:, None, :],
                                      (f.napps, f.nin, f.nin))
                H = H.at[hr.ravel(), hc.ravel()].add(hx.ravel())

            return obj, gradf, cE, cI, H, JE, JI

        self.eval_obj_cons_impl = eval_obj_cons   # raw (inlinable) version
        self.eval_kkt_impl = eval_kkt
        self._jit_eval_oc = jax.jit(eval_obj_cons)
        self._jit_eval_kkt = jax.jit(eval_kkt)
        self.eval_obj_cons = lambda x: self._jit_eval_oc(x, self.consts_dev())
        self.eval_kkt = lambda x, lamE, lamI, sigma: self._jit_eval_kkt(
            x, lamE, lamI, sigma, self.consts_dev())

    # ------------------------------------------------------------- info
    def __repr__(self):
        return (f"<NonLinearProgram n={self.numPrimal} "
                f"eqfams={len(self.eqcons)} iqfams={len(self.iqcons)} "
                f"objfams={len(self.objectives)}>")
