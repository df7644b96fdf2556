"""PSIOPT: primal-dual interior-point NLP solver, JAX re-design.

Functional re-implementation of the reference solver
(`src/Solvers/PSIOPT.{h,cpp}`): same state (primal X, slacks S per inequality,
eq/iq multipliers), same barrier modes (LOQO / PROBE-Mehrotra), same
fraction-to-boundary + merit line-search + slack-reset + inertia-corrected
factorization ladder (deltaH/incrH/decrH, `PSIOPT.cpp:422`), same convergence
ladder (CONVERGED / ACCEPTABLE / NOTCONVERGED / DIVERGING with acceptable and
divergence tolerance tiers, `PSIOPT.cpp:130`).

Differences by design:
* The KKT system is reduced by analytic slack elimination to the symmetric
  quasi-definite form  [[H+dI, JE^T, JI^T], [JE, -gI, 0], [JI, 0, -(1/Sig+g)]]
  instead of Pardiso's full sparse form; the factorization backend is
  pluggable (`kkt` argument): dense eigendecomposition for the reference
  path, block-tridiagonal cyclic-reduction LDL^T for structured (collocation)
  problems.
* Inertia correction uses the factorization's negative-pivot count exactly
  like Pardiso's neigs (`factor_impl`), driving the same perturbation ladder.
* Per-iteration math is jitted; the outer loop is host-side so line-search /
  refactorization retries stay data-dependent without recompiles.
"""

from __future__ import annotations

import math
import time
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from ..config import DEFAULT_DTYPE
from .nlp import NonLinearProgram

__all__ = ["PSIOPT", "ConvergenceFlags"]


class ConvergenceFlags:
    CONVERGED = 0
    ACCEPTABLE = 1
    NOTCONVERGED = 2
    DIVERGING = 3

    _names = {0: "CONVERGED", 1: "ACCEPTABLE", 2: "NOTCONVERGED",
              3: "DIVERGING"}


# --------------------------------------------------------------------------
# jitted iteration pieces
# --------------------------------------------------------------------------

@jax.jit
def _slack_reset(s, cI, negreset):
    """Reference PSIOPT::apply_reset_slacks (`PSIOPT.h:549`): when the raw
    inequality value is feasible (<0), zero its residual and snap the slack to
    |c|; otherwise residual = c + s."""
    s = jnp.maximum(s, negreset)
    feas = cI < 0.0
    rI = jnp.where(feas, 0.0, cI + s)
    s = jnp.where(feas, jnp.maximum(jnp.abs(cI), negreset), s)
    return s, rI


@jax.jit
def _sigma_diag(s, lamI, mu):
    """Primal-dual barrier diagonal lam/s with primal fallback mu/s^2
    (reference barrier_hessian, `PSIOPT.h:606`)."""
    hp = lamI / s
    return jnp.where(hp < 0.0, mu / (s * s), hp)


@jax.jit
def _max_step_to_boundary(v, dv, bfrac):
    """max alpha with v + alpha*dv >= (1-bfrac)*v (reference `PSIOPT.h:565`)."""
    bad = dv < -bfrac * v
    cand = jnp.where(bad, -bfrac * v / jnp.where(bad, dv, -1.0), 1.0)
    return jnp.minimum(1.0, jnp.min(cand, initial=1.0))


class PSIOPT:
    """Interior-point optimizer over a NonLinearProgram."""

    def __init__(self, nlp: NonLinearProgram | None = None, kkt=None):
        # kkt: a KKT provider (kkt_dense.DenseKKT / kkt_block.BlockKKT);
        # created lazily from the NLP when not supplied.
        # --- tolerance / algorithm knobs, names follow the reference ---
        self.MaxIters = 500
        self.MaxAccIters = 50
        self.MaxLSIters = 2
        self.MaxRefac = 15
        self.KKTtol = 1.0e-6
        self.EContol = 1.0e-6
        self.IContol = 1.0e-6
        self.Bartol = 1.0e-6
        self.AccKKTtol = 1.0e-2
        self.AccEContol = 1.0e-3
        self.AccIContol = 1.0e-3
        self.AccBartol = 1.0e-3
        self.DivKKTtol = 1.0e15
        self.DivEContol = 1.0e15
        self.DivIContol = 1.0e15
        self.DivBartol = 1.0e15
        self.BoundFraction = 0.99
        self.BoundPush = 1.0e-3
        self.NegSlackReset = 1.0e-12
        self.deltaH = 1.0e-5
        self.incrH = 8.0
        self.decrH = 1.0 / 3.0
        self.initMu = 1.0e-3
        self.MaxMu = 100.0
        self.MinMu = 1.0e-12
        self.ObjScale = 1.0
        self.alphaRed = 2.0
        self.OptBarMode = "LOQO"
        self.SoeBarMode = "LOQO"
        self.OptLSMode = "AUGLANG"
        self.SoeLSMode = "NOLS"
        # SoeMode: algorithm run by solve() passes — "SOE" (reference
        # default: first-order feasibility steps) or "OPTNO" (constraint
        # Hessians, no objective; reference `PSIOPT.h:28-33`).
        self.SoeMode = "SOE"
        # Primal-dual step strategy (reference `PSIOPT.cpp:30-57`):
        # PrimSlackEq_Iq | AllMinimum | PrimSlack_EqIq | MaxEq
        self.PDStepStrategy = "PrimSlackEq_Iq"
        # Mehrotra second-order correction in PROBE barrier mode: reuse
        # the affine probe's ds/dlam products in the complementarity rhs
        # (predictor-corrector; the reference probe only adjusts mu).
        self.ProbeCorrector = True
        # Initialize equality multipliers with the reference init_impl
        # least-squares estimate (`PSIOPT.cpp:728-807`) before each pass.
        self.InitLmults = True
        self.PrintLevel = 0
        self.FastFactorAlg = True
        self.gammaE = 1.0e-10   # dual regularization (quasi-definiteness)
        self.gammaI = 1.0e-10
        self.CNRMode = False          # disable ANSI colors in the console
        # storespmat (reference `PSIOPT.h:418`): keep the KKT matrix of the
        # final iterate for user inspection.  Here that is the block form
        # (diag (K,W,W), lower (K,W,W), B (K,W,b), C (b,b)) stored in
        # LastKKTBlocks after each solve.
        self.storespmat = False
        self.LastKKTBlocks = None
        self.WideConsole = False      # wider iterate table
        self.ReturnBest = False
        self.BestCriteria = "ECons"
        # user callbacks (reference EarlyCallBack/LateCallBack,
        # `src/Solvers/PSIOPT.h:432-448`): called with a dict of the
        # iterate record.  On the fused device loop the callback fires
        # once per SOLVE with the full iterate history (per-iteration
        # callbacks would force a host sync each iteration).
        self.EarlyCallBack = None
        self.LateCallBack = None
        # Use the fused device-resident while_loop solver for BlockKKT
        # backends (one dispatch per solve); the host loop remains for the
        # dense backend and for debugging.
        self.UseFused = True
        # The fused loop runs the whole solve in one device program, so
        # Func/KKT time cannot be read off the host clock per stage.  When
        # True, each fused solve additionally compiles and times the
        # separately-jitted stage pieces (family AD, assembly, factor,
        # solve, value pass) at the final iterate and attributes the
        # measured wall time to LastFuncTime/LastKKTTime by those measured
        # fractions (reference timing surface `PSIOPT.h:399-413`); the raw
        # per-stage ms land in LastStageTimes.  Off by default: otherwise
        # the whole solve time is booked as LastKKTTime.
        self.MeasureStageTimes = False
        self.LastStageTimes = None
        # Reuse multipliers/slacks from the previous solve as the starting
        # point (reference collectPostOptInfo warm start,
        # `ODEPhaseBase.cpp:1606-1609`).
        self.WarmStart = False
        self.LastSlacks = None

        # --- outputs (reference timing/statistics surface) ---
        self.LastObjVal = 0.0
        self.LastIterNum = 0
        self.LastTotalTime = 0.0
        self.LastFuncTime = 0.0
        self.LastKKTTime = 0.0
        self.LastPreTime = 0.0
        self.LastMiscTime = 0.0
        self.ConvergeFlag = ConvergenceFlags.NOTCONVERGED
        self.LastEqLmults = None
        self.LastIqLmults = None

        self.nlp = nlp
        self.kkt = kkt

    # ---------------------------------------------------------------- knobs
    def set_OptLSMode(self, m):
        self.OptLSMode = m

    def set_SoeLSMode(self, m):
        self.SoeLSMode = m

    def set_OptBarMode(self, m):
        self.OptBarMode = m

    def set_SoeBarMode(self, m):
        self.SoeBarMode = m

    def set_PrintLevel(self, p):
        self.PrintLevel = int(p)

    def set_SoeMode(self, m):
        m = str(m)
        if m not in ("SOE", "OPTNO"):
            raise ValueError("SoeMode must be SOE or OPTNO")
        self.SoeMode = m

    def set_PDStepStrategy(self, m):
        m = str(m)
        if m not in ("PrimSlackEq_Iq", "AllMinimum", "PrimSlack_EqIq",
                     "MaxEq"):
            raise ValueError(f"unknown PDStepStrategy {m}")
        self.PDStepStrategy = m

    def set_MaxIters(self, n):
        self.MaxIters = int(n)

    def set_MaxAccIters(self, n):
        self.MaxAccIters = int(n)

    def set_MaxLSIters(self, n):
        self.MaxLSIters = int(n)

    def set_tols(self, KKTtol=None, EContol=None, IContol=None, Bartol=None):
        if KKTtol is not None:
            self.KKTtol = abs(KKTtol)
        if EContol is not None:
            self.EContol = abs(EContol)
        if IContol is not None:
            self.IContol = abs(IContol)
        if Bartol is not None:
            self.Bartol = abs(Bartol)

    def set_Acctols(self, k, e, i, b):
        self.AccKKTtol, self.AccEContol = abs(k), abs(e)
        self.AccIContol, self.AccBartol = abs(i), abs(b)

    def set_KKTtol(self, v):
        self.KKTtol = abs(v)

    def set_EContol(self, v):
        self.EContol = abs(v)

    def set_IContol(self, v):
        self.IContol = abs(v)

    def set_Bartol(self, v):
        self.Bartol = abs(v)

    def set_BoundFraction(self, v):
        self.BoundFraction = v

    def set_deltaH(self, v):
        self.deltaH = abs(v)

    def set_QPOrderingMode(self, *_):
        pass  # no sparse ordering on the block backend

    def set_QPParams(self, *_, **__):
        pass

    def setNLP(self, nlp, kkt=None):
        self.nlp = nlp
        self.kkt = kkt

    # ------------------------------------------------------------- slack init
    def _init_state(self, x, mu):
        """Reference init_impl (`PSIOPT.cpp:728`): slacks from constraint
        values with BoundPush floor; iq multipliers mu/s; eq multipliers 0."""
        nlp = self.nlp
        x = jnp.asarray(x, DEFAULT_DTYPE)
        _, cE, cI = nlp.eval_obj_cons(x)
        if nlp.numIq > 0:
            cI = np.asarray(cI)
            s = np.where(cI < -self.BoundPush, np.abs(cI), self.BoundPush)
            lamI = mu / s
            s = jnp.asarray(s)
            lamI = jnp.asarray(lamI)
        else:
            s = jnp.zeros((0,), DEFAULT_DTYPE)
            lamI = jnp.zeros((0,), DEFAULT_DTYPE)
        lamE = jnp.zeros((nlp.numEq,), DEFAULT_DTYPE)
        return x, s, lamE, lamI

    # ------------------------------------------------------------ public API
    def init(self, x):
        """Reference AlgorithmModes::INIT pass (`src/Solvers/PSIOPT.h:29`,
        init_impl `PSIOPT.cpp:728-807`): slack + iq-multiplier
        initialization and a first-order (unit-primal-diagonal, zero
        Hessian) least-squares estimate of the equality multipliers,
        stored for warm-starting the next solve/optimize call.  Returns
        (x, s, lamE, lamI) as numpy arrays."""
        self.nlp.freeze()
        if self.kkt is None:
            from .kkt_dense import DenseKKT
            self.kkt = DenseKKT(self.nlp)
        x, s, lamE, lamI = self._init_state(np.asarray(x, np.float64),
                                            self.initMu)
        mE, mI = self.nlp.numEq, self.nlp.numIq
        from .kkt_block import BlockKKT
        if mE > 0 and isinstance(self.kkt, BlockKKT):
            kkt = self.kkt
            jit = getattr(kkt, "_jit_init_lsq", None)
            if jit is None:
                sigma = float(self.ObjScale)
                gE = float(self.gammaE)

                def impl(x, consts):
                    zE = jnp.zeros((mE,), DEFAULT_DTYPE)
                    zI = jnp.zeros((mI,), DEFAULT_DTYPE)
                    _, _, _, rd0, fam0 = kkt._eval_core(
                        x, zE, zI, sigma, consts, want_hess="zeros")
                    st1 = jnp.ones((mI,), DEFAULT_DTYPE)
                    blocks0 = kkt._blocks_impl(fam0, st1)
                    fac0, _ = kkt._factor_blocks_impl(
                        blocks0, jnp.asarray(1.0), jnp.asarray(gE))
                    _, lamE0 = kkt._solve_impl(fac0, -rd0, zE)
                    return lamE0

                jit = jax.jit(impl)
                kkt._jit_init_lsq = jit
            lamE0 = np.asarray(jit(x, self.nlp.consts_dev()))
            if np.isfinite(lamE0).all():
                lamE = jnp.asarray(lamE0)
        elif mE > 0:
            # dense path: factor at unit perturbation, first-order rhs
            _, gradf, cE, cI, rd = self.kkt.eval_resid(
                x, jnp.zeros((mE,)), jnp.zeros((mI,)), self.ObjScale)
            st1 = jnp.ones((mI,), DEFAULT_DTYPE)
            fac, _ = self.kkt.factor(x, jnp.zeros((mE,)),
                                     jnp.zeros((mI,)), self.ObjScale,
                                     st1, 1.0, self.gammaE)
            _, lamE0 = self.kkt.solve(fac, -rd, jnp.zeros((mE,)))
            lamE0 = np.asarray(lamE0)
            if np.isfinite(lamE0).all():
                lamE = jnp.asarray(lamE0)
        self.LastEqLmults = np.asarray(lamE)
        self.LastIqLmults = np.asarray(lamI)
        self.LastSlacks = np.asarray(s)
        return (np.asarray(x), np.asarray(s), np.asarray(lamE),
                np.asarray(lamI))

    def solve(self, x):
        return self._run(x, [("SOE",)])

    def optimize(self, x):
        return self._run(x, [("OPT",)])

    def solve_optimize(self, x):
        return self._run(x, [("SOE",), ("OPT",)])

    def solve_optimize_solve(self, x):
        return self._run(x, [("SOE",), ("OPT",), ("SOE",)])

    def optimize_solve(self, x):
        return self._run(x, [("OPT",), ("SOE",)])

    # ---------------------------------------------------------------- driver
    def _run(self, x0, schedule):
        self.nlp.freeze()
        if self.kkt is None:
            from .kkt_dense import DenseKKT
            self.kkt = DenseKKT(self.nlp)
        t0 = time.perf_counter()
        self.LastIterNum = 0
        x, s, lamE, lamI = self._init_state(np.asarray(x0, np.float64),
                                            self.initMu)
        self._warm_applied = False
        if self.WarmStart and self.LastEqLmults is not None \
                and len(self.LastEqLmults) == self.nlp.numEq \
                and self.LastIqLmults is not None \
                and len(self.LastIqLmults) == self.nlp.numIq:
            self._warm_applied = True
            lamE = jnp.asarray(self.LastEqLmults)
            lamI = jnp.maximum(jnp.asarray(self.LastIqLmults), 1e-8) \
                if self.nlp.numIq else lamI
            if self.LastSlacks is not None \
                    and len(self.LastSlacks) == self.nlp.numIq \
                    and self.nlp.numIq:
                s = jnp.maximum(jnp.asarray(self.LastSlacks),
                                self.BoundPush * 1e-3)
        from .kkt_block import BlockKKT
        from .kkt_sharded import ShardedBlockKKT
        use_fused = self.UseFused and isinstance(
            self.kkt, (BlockKKT, ShardedBlockKKT))
        flag = ConvergenceFlags.NOTCONVERGED
        for (mode,) in schedule:
            if mode == "SOE":
                mode = str(self.SoeMode)
            if use_fused:
                x, s, lamE, lamI, flag = self._alg_fused(mode, x, s,
                                                         lamE, lamI)
            else:
                x, s, lamE, lamI, flag = self._alg_impl(mode, x, s,
                                                        lamE, lamI)
            if flag == ConvergenceFlags.DIVERGING:
                break
        self.ConvergeFlag = flag
        self.LastTotalTime = time.perf_counter() - t0
        self.LastEqLmults = np.asarray(lamE)
        self.LastIqLmults = np.asarray(lamI)
        self.LastSlacks = np.asarray(s)
        obj, _, _ = self.nlp.eval_obj_cons(x)
        self.LastObjVal = float(obj)
        return np.asarray(x)

    # ------------------------------------------------- fused device solver
    def _opts_snapshot(self):
        keys = ("MaxIters", "MaxAccIters", "MaxLSIters", "MaxRefac",
                "KKTtol", "EContol", "IContol", "Bartol",
                "AccKKTtol", "AccEContol", "AccIContol", "AccBartol",
                "DivKKTtol", "DivEContol", "DivIContol", "DivBartol",
                "BoundFraction", "NegSlackReset", "deltaH", "incrH",
                "decrH", "initMu", "MaxMu", "MinMu", "ObjScale",
                "alphaRed", "OptBarMode", "SoeBarMode", "OptLSMode",
                "SoeLSMode", "FastFactorAlg", "gammaE", "gammaI",
                "BestCriteria", "PDStepStrategy", "InitLmults",
                "ProbeCorrector")
        return {k: getattr(self, k) for k in keys}

    def _alg_fused(self, mode, x, s, lamE, lamI):
        """One mode pass through the fused whole-solve jit (one dispatch)."""
        from .fused import build_fused_alg
        opts = self._opts_snapshot()
        opts["InitLmults"] = bool(self.InitLmults) \
            and not getattr(self, "_warm_applied", False)
        key = (mode, tuple(sorted(opts.items())), id(self.kkt))
        cache = getattr(self, "_fused_cache", None)
        if cache is None or cache[0] != key:
            fn = build_fused_alg(self.kkt, opts, mode)
            self._fused_cache = (key, fn)
        fn = self._fused_cache[1]
        tq0 = time.perf_counter()
        (x, s, lamE, lamI, Mu, flag, niters, infos,
         bx, bs_, blE, blI) = fn(x, s, lamE, lamI,
                                 jnp.asarray(self.initMu),
                                 self.nlp.consts_dev())
        flag = int(flag)
        niters = int(niters)
        elapsed = time.perf_counter() - tq0
        split_done = False
        if self.MeasureStageTimes:
            try:
                st = self.measure_stage_times(
                    x, s, lamE, lamI, float(Mu),
                    0.0 if mode in ("SOE", "OPTNO") else self.ObjScale)
            except Exception:
                st = None
            if st:
                func = st["func_ad"] + st["value_pass"]
                kkt_t = st["assembly"] + st["factor"] + st["solve"]
                tot = max(func + kkt_t, 1e-12)
                self.LastFuncTime += elapsed * func / tot
                self.LastKKTTime += elapsed * kkt_t / tot
                split_done = True
        if not split_done:
            self.LastKKTTime += elapsed
        infos = np.asarray(infos[:max(niters, 1)])
        if self.ReturnBest and flag not in (ConvergenceFlags.CONVERGED,
                                            ConvergenceFlags.ACCEPTABLE):
            x, s, lamE, lamI = bx, bs_, blE, blI
        self.LastIterNum += niters
        if self.storespmat:
            self._store_spmat(x, s, lamE, lamI, Mu,
                              0.0 if mode in ("SOE", "OPTNO")
                              else self.ObjScale)
        if callable(self.LateCallBack):
            self.LateCallBack(dict(mode=mode, flag=flag, iters=niters,
                                   infos=infos, x=np.asarray(x),
                                   lamE=np.asarray(lamE),
                                   lamI=np.asarray(lamI)))
        if self.PrintLevel == 0:
            self._print_iterate_table(mode, infos)
        if self.PrintLevel <= 1:
            r = infos[-1]
            print(f"PSIOPT [{mode}] {ConvergenceFlags._names[flag]} in "
                  f"{len(infos)} iters: obj {r[0]:+.8e} kkt {r[1]:.2e} "
                  f"econ {r[2]:.2e} icon {r[3]:.2e} barr {r[4]:.2e}")
        return x, s, lamE, lamI, flag

    def measure_stage_times(self, x, s, lamE, lamI, Mu, sigma):
        """Per-stage ms of one IPM iteration's pipeline at the given
        iterate, via the separately-jitted stage pieces (family AD +
        residuals, block assembly, regularize+factor, solve, line-search
        value pass).  Returns the dict (also stored in LastStageTimes)."""
        from .kkt_block import BlockKKT
        if not isinstance(self.kkt, BlockKKT):
            return None
        kkt = self.kkt
        nlp = self.nlp
        jits = getattr(kkt, "_stage_jits", None)
        if jits is None:
            jits = dict(ad=jax.jit(kkt._ad_impl),
                        blocks=jax.jit(kkt._blocks_impl),
                        factor_blocks=jax.jit(kkt._factor_blocks_impl),
                        oc=jax.jit(nlp.eval_obj_cons_impl))
            kkt._stage_jits = jits
        consts = nlp.consts_dev()
        x = jnp.asarray(x)
        lamE = jnp.asarray(lamE)
        lamI = jnp.asarray(lamI)
        if nlp.numIq > 0:
            s_ = jnp.maximum(jnp.asarray(s), 1e-300)
            Sig = jnp.where(lamI / s_ < 0.0, Mu / (s_ * s_), lamI / s_)
            sig_tilde = Sig / (1.0 + self.gammaI * Sig)
        else:
            sig_tilde = jnp.zeros((0,), DEFAULT_DTYPE)

        def timed(fn, *a, reps=3):
            out = jax.block_until_ready(fn(*a))    # compile + warm
            t0 = time.perf_counter()
            for _ in range(reps):
                out = jax.block_until_ready(fn(*a))
            return (time.perf_counter() - t0) / reps, out

        t_ad, adout = timed(jits["ad"], x, lamE, lamI,
                            jnp.asarray(float(sigma)), consts)
        t_blk, blocks = timed(jits["blocks"], adout[4], sig_tilde)
        t_fac, facout = timed(jits["factor_blocks"], blocks,
                              jnp.asarray(self.deltaH),
                              jnp.asarray(self.gammaE))
        zx = jnp.zeros((nlp.numPrimal,), DEFAULT_DTYPE)
        zE = jnp.zeros((nlp.numEq,), DEFAULT_DTYPE)
        t_slv, _ = timed(kkt._jit_solve, facout[0], zx, zE)
        t_oc, _ = timed(jits["oc"], x, consts)
        self.LastStageTimes = dict(
            func_ad=t_ad, assembly=t_blk, factor=t_fac, solve=t_slv,
            value_pass=t_oc)
        return self.LastStageTimes

    def _store_spmat(self, x, s, lamE, lamI, Mu, sigma):
        """Assemble and stash the KKT blocks at the given iterate
        (reference storespmat, `PSIOPT.h:418`)."""
        from .kkt_block import BlockKKT
        if not isinstance(self.kkt, BlockKKT):
            return
        kkt = self.kkt
        jits = getattr(kkt, "_spmat_jits", None)
        if jits is None:
            jits = (jax.jit(kkt._ad_impl), jax.jit(kkt._blocks_impl))
            kkt._spmat_jits = jits
        jad, jblk = jits
        _, _, _, _, famvals = jad(
            jnp.asarray(x), jnp.asarray(lamE), jnp.asarray(lamI),
            jnp.asarray(sigma), self.nlp.consts_dev())
        if self.nlp.numIq > 0:
            s_ = jnp.maximum(jnp.asarray(s), 1e-300)
            Sig = jnp.where(jnp.asarray(lamI) / s_ < 0.0,
                            Mu / (s_ * s_), jnp.asarray(lamI) / s_)
            sig_tilde = Sig / (1.0 + self.gammaI * Sig)
        else:
            sig_tilde = jnp.zeros((0,), DEFAULT_DTYPE)
        blocks = jblk(famvals, sig_tilde)
        self.LastKKTBlocks = tuple(np.asarray(b) for b in blocks)

    # --------------------------------------------------------- console table
    def _print_iterate_table(self, mode, infos):
        """Reference print_last_iterate console scroll
        (`src/Solvers/PSIOPT.cpp:238`): fixed-width iterate table; colors
        unless CNRMode; WideConsole adds the factorization columns."""
        use_color = not self.CNRMode
        GRN, RED, CYN, END = ("\033[92m", "\033[91m", "\033[96m",
                              "\033[0m") if use_color else ("",) * 4
        cols = ["iter", "objective", "KKT-inf", "ECons-inf", "ICons-inf",
                "barrier", "mu", "alpha"]
        if self.WideConsole:
            cols += ["nfacs", "Hpert"]
        w = [5, 15, 10, 10, 10, 10, 9, 7, 6, 9]
        head = " ".join(f"{c:>{w[i]}}" for i, c in enumerate(cols))
        print(f"{CYN}[{mode}] {head}{END}")
        rows = infos if isinstance(infos, (list, tuple)) else list(infos)
        for i, r in enumerate(rows):
            if isinstance(r, dict):
                vals = [r["obj"], r["kkt"], r["econ"], r["icon"], r["barr"],
                        r["mu"], r["alpha"], r["nfacs"], r["hpert"]]
            else:
                vals = list(r[:9])
            ok = vals[2] < self.EContol and vals[1] < self.KKTtol
            C = GRN if ok else ""
            line = (f"{i:>5d} {vals[0]:>+15.8e} {vals[1]:>10.2e} "
                    f"{vals[2]:>10.2e} {vals[3]:>10.2e} {vals[4]:>10.2e} "
                    f"{vals[5]:>9.1e} {vals[6]:>7.3f}")
            if self.WideConsole:
                line += f" {int(vals[7]):>6d} {vals[8]:>9.1e}"
            print(f"{C}{line}{END if C else ''}")

    # ------------------------------------------------------------- main loop
    def _alg_impl(self, mode, x, s, lamE, lamI):
        nlp = self.nlp
        n, mE, mI = nlp.numPrimal, nlp.numEq, nlp.numIq
        # OPTNO (a solve-pass mode, reference SoeMode): objective off,
        # Soe bar/LS knobs, constraint Hessians kept (sigma=0 drops the
        # objective gradient/Hessian in the KKT eval)
        soe_like = mode in ("SOE", "OPTNO")
        sigma = 0.0 if soe_like else self.ObjScale
        barmode = self.SoeBarMode if soe_like else self.OptBarMode
        lsmode = self.SoeLSMode if soe_like else self.OptLSMode

        Mu = self.initMu
        Hpert0 = self.deltaH
        first_pert = True
        hfacs_hist = []
        infos = []
        flag = ConvergenceFlags.NOTCONVERGED

        for it in range(self.MaxIters):
            tf0 = time.perf_counter()
            obj, gradf, cE, cIraw, rd0 = self.kkt.eval_resid(
                x, lamE, lamI, sigma)

            if mI > 0:
                s, rI = _slack_reset(s, cIraw, self.NegSlackReset)
                Sig = _sigma_diag(s, lamI, Mu)
                comp = s * lamI
                avgcomp = float(jnp.mean(comp))
                mincomp = float(jnp.min(comp))
                maxcomp = float(jnp.max(comp))
            else:
                rI = cIraw
                Sig = jnp.zeros((0,), DEFAULT_DTYPE)
                avgcomp = mincomp = maxcomp = 0.0

            rd = rd0
            self.LastFuncTime += time.perf_counter() - tf0

            # ---------------- factorization with inertia correction ladder
            # Inequalities are condensed: Sigma~ = Sig/(1+gammaI*Sig) folds
            # into the primal block, so the target inertia is mE negatives.
            tq0 = time.perf_counter()
            SigInv = jnp.where(Sig > 0, 1.0 / jnp.maximum(Sig, 1e-300), 0.0)
            sig_tilde = Sig / (1.0 + self.gammaI * Sig) if mI > 0 \
                else jnp.zeros((0,), DEFAULT_DTYPE)
            target_neigs = mE

            # FastFactorAlg: skip the zero-perturbation probe when recent
            # iterations always needed perturbation (reference alg_impl).
            zfac = True
            if self.FastFactorAlg and it > 6 and ((it * 3) % 4) != 0:
                cycling = all(hf > 0 for hf in hfacs_hist[-4:])
                zfac = not cycling

            nfacs = 0
            nhpert = 0.0
            factor = None
            if zfac:
                factor, neigs = self.kkt.factor(
                    x, lamE, lamI, sigma, sig_tilde, 0.0, self.gammaE)
                if neigs <= target_neigs:
                    nhpert = 0.0
                else:
                    factor = None
            if factor is None:
                p = Hpert0
                incr = self.incrH * (self.incrH if first_pert else 1.0)
                for k in range(self.MaxRefac):
                    factor, neigs = self.kkt.factor(
                        x, lamE, lamI, sigma, sig_tilde, p, self.gammaE)
                    nfacs = k + 1
                    nhpert = p
                    if neigs <= target_neigs:
                        break
                    p = p * (incr if k == 0 else self.incrH)
                if nfacs > 0:
                    Hpert0 = max(self.deltaH, nhpert * self.decrH)
                    first_pert = False
            hfacs_hist.append(nfacs)

            # ------------------------------------------- barrier mu update
            corr = 0.0
            if mI > 0:
                if barmode == "PROBE":
                    # Mehrotra probe: affine step (mu = 0 dual gradient)
                    w_aff = rI - SigInv * lamI
                    rx_aff = rd + self.kkt.iq_rmatvec(
                        factor, sig_tilde * w_aff)
                    dxa, _ = self.kkt.solve(factor, -rx_aff, -cE)
                    dlamI_aff = sig_tilde * (
                        self.kkt.iq_matvec(factor, dxa) + w_aff)
                    ds_aff = -SigInv * (lamI + dlamI_aff)
                    # fraction-to-boundary damping of the affine probe
                    apa = float(_max_step_to_boundary(
                        s, ds_aff, self.BoundFraction))
                    ada = float(_max_step_to_boundary(
                        lamI, dlamI_aff, self.BoundFraction))
                    navg = float(jnp.mean((s + apa * ds_aff)
                                          * (lamI + ada * dlamI_aff)))
                    Mu = (navg / avgcomp) ** 3 * avgcomp if avgcomp != 0 else Mu
                    if self.ProbeCorrector:
                        # Mehrotra second-order correction (see fused.py)
                        corr = ds_aff * dlamI_aff / s
                else:  # LOQO (reference default)
                    eta = mincomp / avgcomp if avgcomp != 0 else 0.0
                    sigmat = 0.1 * (0.05 * (1.0 - eta) / max(eta, 1e-300)) ** 3 \
                        if eta > 0 else 0.8
                    sig_mu = min(0.8, abs(sigmat))
                    Mu = sig_mu * avgcomp
                Mu = float(np.clip(Mu, self.MinMu, self.MaxMu))
                BarrObj = float(-Mu * jnp.sum(jnp.log(s))) if mI > 0 else 0.0
                rs = lamI - Mu / s + corr
            else:
                BarrObj = 0.0
                rs = jnp.zeros((0,), DEFAULT_DTYPE)

            # ------------------------------------------------- newton solve
            w = rI - SigInv * rs
            rhs_x = rd + (self.kkt.iq_rmatvec(factor, sig_tilde * w)
                          if mI > 0 else 0.0)
            dx, dlamE = self.kkt.solve(factor, -rhs_x, -cE)
            if mI > 0:
                dlamI = sig_tilde * (self.kkt.iq_matvec(factor, dx) + w)
                ds = -SigInv * (rs + dlamI)
            else:
                dlamI = lamI
                ds = s
            good = bool(jnp.isfinite(jnp.sum(dx ** 2))
                        and jnp.isfinite(jnp.sum(dlamE ** 2)))
            self.LastKKTTime += time.perf_counter() - tq0

            alphap = alphad = 1.0
            if mI > 0 and good:
                alphap = float(_max_step_to_boundary(s, ds,
                                                     self.BoundFraction))
                alphad = float(_max_step_to_boundary(lamI, dlamI,
                                                     self.BoundFraction))
                # PDStepStrategies (reference `PSIOPT.cpp:30-57`)
                strat = str(self.PDStepStrategy)
                if strat == "AllMinimum":
                    am = min(alphap, alphad)
                    sp = ss = se = si = am
                elif strat == "PrimSlack_EqIq":
                    sp = ss = alphap
                    se = si = alphad
                elif strat == "MaxEq":
                    sp = ss = alphap
                    se = max(alphap, alphad)
                    si = alphad
                else:  # PrimSlackEq_Iq (reference default)
                    sp = ss = se = alphap
                    si = alphad
                dx = dx * sp
                ds = ds * ss
                dlamE = dlamE * se
                dlamI = dlamI * si

            # -------------------------------------------------- line search
            tf0 = time.perf_counter()
            alpha = 1.0
            if good and lsmode in ("AUGLANG", "L1", "LANG"):
                alpha = self._line_search(
                    lsmode, sigma if mode != "SOE" else 0.0, Mu,
                    float(obj) * sigma, BarrObj,
                    x, s, lamE, lamI, dx, ds, dlamE, dlamI,
                    rd, rs, cE, rI)
            self.LastFuncTime += time.perf_counter() - tf0

            # ----------------------------------------------- iterate record
            kktinf = float(jnp.max(jnp.abs(rd))) if n else 0.0
            econinf = float(jnp.max(jnp.abs(cE))) if mE else 0.0
            iconinf = float(jnp.max(jnp.abs(rI))) if mI else 0.0
            barrinf = maxcomp
            infos.append(dict(iter=it, obj=float(obj), kkt=kktinf,
                              econ=econinf, icon=iconinf, barr=barrinf,
                              mu=Mu, alpha=alpha, nfacs=nfacs,
                              hpert=nhpert))
            if callable(self.EarlyCallBack):
                # reference early callback: per-iteration, receives the
                # iterate and step data (`PSIOPT.h:432-448`)
                self.EarlyCallBack(dict(
                    mode=mode, x=np.asarray(x), dx=np.asarray(dx),
                    lamE=np.asarray(lamE), lamI=np.asarray(lamI),
                    info=infos[-1]))
            if self.PrintLevel == 0:
                i0 = infos[-1]
                print(f"  [{mode}] it {it:3d} obj {i0['obj']:+.6e} "
                      f"kkt {kktinf:8.2e} econ {econinf:8.2e} "
                      f"icon {iconinf:8.2e} barr {barrinf:8.2e} "
                      f"mu {Mu:8.2e} a {alpha:5.3f} f {nfacs}")

            flag = self._converge_check(infos)
            if not good:
                flag = ConvergenceFlags.DIVERGING
            if flag in (ConvergenceFlags.CONVERGED,
                        ConvergenceFlags.ACCEPTABLE,
                        ConvergenceFlags.DIVERGING) \
                    or it == self.MaxIters - 1:
                break

            x = x + alpha * dx
            if mI > 0:
                s = s + alpha * ds
                lamI = lamI + alpha * dlamI
            lamE = lamE + alpha * dlamE

        self.LastIterNum += len(infos)
        if self.PrintLevel <= 1:
            i0 = infos[-1]
            print(f"PSIOPT [{mode}] {ConvergenceFlags._names[flag]} in "
                  f"{len(infos)} iters: obj {i0['obj']:+.8e} kkt {i0['kkt']:.2e} "
                  f"econ {i0['econ']:.2e} icon {i0['icon']:.2e} "
                  f"barr {i0['barr']:.2e}")
        if self.storespmat:
            self._store_spmat(x, s, lamE, lamI, Mu, sigma)
        return x, s, lamE, lamI, flag

    # ------------------------------------------------------------ line search
    def _line_search(self, lsmode, sigma, Mu, PrimObj, BarrObj,
                     x, s, lamE, lamI, dx, ds, dlamE, dlamI,
                     rd, rs, cE, rI):
        """Merit line search; AUGLANG branch mirrors reference ls_impl
        (`PSIOPT.cpp:811`)."""
        nlp = self.nlp
        mE, mI = nlp.numEq, nlp.numIq
        allcons = np.concatenate([np.asarray(cE), np.asarray(rI)])
        lm = np.concatenate([np.asarray(lamE), np.asarray(lamI)])
        dlm = np.concatenate([np.asarray(dlamE), np.asarray(dlamI)])

        vv = float(np.concatenate([np.asarray(rd), np.asarray(rs)]) @
                   np.concatenate([np.asarray(dx), np.asarray(ds)]))
        cv = float(dlm @ allcons)
        init_l2 = float(allcons @ allcons)
        init_linf = float(np.max(np.abs(allcons))) if allcons.size else 0.0
        sc = (0.01 if lsmode == "AUGLANG" else 0.1) + \
            abs(vv - cv) / init_l2 if init_l2 > 0 else 1.0

        lang_init = PrimObj + BarrObj
        init_l1 = float(np.abs(lm) @ np.abs(allcons))
        lang_init += init_l1 + init_l2 * sc

        alpha = 1.0
        for j in range(self.MaxLSIters):
            x2 = x + alpha * dx
            s2 = s + alpha * ds if mI > 0 else s
            obj2, cE2, cI2raw = nlp.eval_obj_cons(x2)
            ptest = float(obj2) * sigma
            if mI > 0:
                s2r, rI2 = _slack_reset(s2, cI2raw, self.NegSlackReset)
                btest = float(-Mu * jnp.sum(jnp.log(s2r)))
            else:
                rI2 = cI2raw
                btest = 0.0
            allcons2 = np.concatenate([np.asarray(cE2), np.asarray(rI2)])
            test_l2 = float(allcons2 @ allcons2)
            test_linf = float(np.max(np.abs(allcons2))) if allcons2.size else 0.0

            if lsmode == "AUGLANG":
                # L1 term only counts rows still infeasible beyond 10x tol
                eqerr = np.abs(np.asarray(cE2))
                iqerr = np.abs(np.asarray(rI2))
                test_l1 = 0.0
                if mE:
                    m = eqerr > self.EContol * 10
                    test_l1 += float(eqerr[m] @ np.abs(np.asarray(lamE))[m])
                if mI:
                    m = iqerr > self.IContol * 10
                    test_l1 += float(iqerr[m] @ np.abs(np.asarray(lamI))[m])
                l2eff = test_l2
                if test_l2 < (self.EContol ** 2 * mE + self.IContol ** 2 * mI):
                    l2eff = 0.0
                lang_test = ptest + btest + test_l1 + l2eff * sc
            else:  # L1 / LANG simplified to the same descent test
                test_l1 = float(np.abs(lm) @ np.abs(allcons2))
                lang_test = ptest + btest + test_l1 + test_l2 * sc

            if lang_test < lang_init \
                    or (ptest < PrimObj and test_l2 < init_l2) \
                    or (ptest < PrimObj and test_linf < init_linf):
                break
            alpha /= self.alphaRed
        return alpha

    # -------------------------------------------------------- convergence
    def _converge_check(self, infos):
        """Reference convergeCheck (`PSIOPT.cpp:130`)."""
        last = infos[-1]
        vals = (last["kkt"], last["econ"], last["icon"], last["barr"])
        if any(not math.isfinite(v) for v in vals) \
                or last["kkt"] > self.DivKKTtol \
                or last["econ"] > self.DivEContol \
                or last["icon"] > self.DivIContol \
                or last["barr"] > self.DivBartol:
            return ConvergenceFlags.DIVERGING
        if (last["kkt"] < self.KKTtol and last["econ"] < self.EContol
                and last["icon"] < self.IContol and last["barr"] < self.Bartol):
            return ConvergenceFlags.CONVERGED
        if len(infos) > self.MaxAccIters:
            ok = all(
                i["kkt"] < self.AccKKTtol and i["econ"] < self.AccEContol
                and i["icon"] < self.AccIContol and i["barr"] < self.AccBartol
                for i in infos[-self.MaxAccIters:])
            if ok:
                return ConvergenceFlags.ACCEPTABLE
        return ConvergenceFlags.NOTCONVERGED
