"""Fused device-resident PSIOPT solve loop.

The reference solver's per-iteration work — evalKKT, slack reset, barrier
update, inertia-corrected factorization ladder, Newton solve,
fraction-to-boundary, merit line search, convergence check
(`src/Solvers/PSIOPT.cpp:465-727` alg_impl) — runs here as ONE
`lax.while_loop` over iterations inside a single jit:

* family AD runs once per iteration (`BlockKKT._ad_impl`); the
  perturbation ladder refactors pre-assembled blocks in an inner
  `lax.while_loop` (reference: evalKKT once, refactor many,
  `PSIOPT.cpp:422`);
* the merit line search is an inner `lax.while_loop` over the cheap
  value-only family pass (`nlp.eval_obj_cons_impl`);
* the convergence ladder (CONVERGED / ACCEPTABLE / NOTCONVERGED /
  DIVERGING with acceptable-window tiers, `PSIOPT.cpp:130`) is evaluated
  on-device from an iterate-info ring buffer;
* ReturnBest iterate tracking (`PSIOPT.h:426-427`, `PSIOPT.cpp:633-650`)
  is carried in the loop state.

One host<->device round trip per *solve* (not per iteration): no
per-iteration dispatch or host sync.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ..config import DEFAULT_DTYPE
from .kkt_block import BlockKKT

__all__ = ["build_fused_alg", "INFO_FIELDS"]

INFO_FIELDS = ("obj", "kkt", "econ", "icon", "barr", "mu", "alpha",
               "nfacs", "hpert")

# flags (match psiopt.ConvergenceFlags)
_CONV, _ACC, _NOTCONV, _DIV = 0, 1, 2, 3


def build_fused_alg(kkt: BlockKKT, opts: dict, mode: str):
    """Build the jitted whole-solve function for one mode ('OPT', 'OPTNO'
    or 'SOE').

    opts: snapshot of PSIOPT knobs (plain python floats/ints/strings).
    Returns fn(x, s, lamE, lamI, Mu0, consts) -> (x, s, lamE, lamI, Mu,
    flag, niters, infos, best_x, best_s, best_lE, best_lI)."""
    nlp = kkt.nlp
    n, mE, mI = nlp.numPrimal, nlp.numEq, nlp.numIq
    # Algorithm modes (reference `PSIOPT.h:28-33` AlgorithmModes + evalNLP
    # dispatch `PSIOPT.cpp:100-130`):
    #   OPT   — full KKT: objective grad+Hessian, constraint adjoint
    #           Hessians (evalKKT).
    #   OPTNO — constraint Hessians but NO objective derivatives
    #           (evalKKTNO); line-search objective scale 0.
    #   SOE   — solve-only: first-order (Gauss-Newton) with unit primal
    #           diagonal and zeroed primal gradient (evalSOE +
    #           setPrimalDiags(1)).
    # OPTNO is reached as a solve-pass mode (reference SoeMode knob,
    # `PSIOPT.cpp:1047`), so it uses the Soe bar/LS knobs.
    soe = mode in ("SOE", "OPTNO")
    sigma = 0.0 if mode in ("SOE", "OPTNO") else float(opts["ObjScale"])
    want_hess = "zeros" if mode == "SOE" else True
    unit_diag = 1.0 if mode == "SOE" else 0.0
    zero_rd = mode == "SOE"
    barmode = opts["SoeBarMode"] if soe else opts["OptBarMode"]
    lsmode = opts["SoeLSMode"] if soe else opts["OptLSMode"]
    pdstrat = str(opts.get("PDStepStrategy", "PrimSlackEq_Iq"))
    init_lmults = bool(opts.get("InitLmults", False))
    probe_corr = bool(opts.get("ProbeCorrector", True))
    MaxIters = int(opts["MaxIters"])
    MaxAccIters = int(opts["MaxAccIters"])
    MaxLSIters = int(opts["MaxLSIters"])
    MaxRefac = int(opts["MaxRefac"])
    KKTtol, ECtol, ICtol, Btol = (float(opts["KKTtol"]),
                                  float(opts["EContol"]),
                                  float(opts["IContol"]),
                                  float(opts["Bartol"]))
    AccK, AccE, AccI, AccB = (float(opts["AccKKTtol"]),
                              float(opts["AccEContol"]),
                              float(opts["AccIContol"]),
                              float(opts["AccBartol"]))
    DivK, DivE, DivI, DivB = (float(opts["DivKKTtol"]),
                              float(opts["DivEContol"]),
                              float(opts["DivIContol"]),
                              float(opts["DivBartol"]))
    bfrac = float(opts["BoundFraction"])
    negreset = float(opts["NegSlackReset"])
    deltaH = float(opts["deltaH"])
    incrH = float(opts["incrH"])
    decrH = float(opts["decrH"])
    MinMu, MaxMu = float(opts["MinMu"]), float(opts["MaxMu"])
    gammaE = float(opts["gammaE"])
    gammaI = float(opts["gammaI"])
    alphaRed = float(opts["alphaRed"])
    FastFactor = bool(opts["FastFactorAlg"])
    initMu = float(opts["initMu"])
    best_mode = str(opts.get("BestCriteria", "ECons"))

    eval_oc = nlp.eval_obj_cons_impl
    ninfo = len(INFO_FIELDS)

    def iq_matvec(iq_jx, dx):
        out = []
        for fam, jx in zip(kkt._iq, iq_jx):
            v = (jx.transpose(0, 2, 1)
                 * dx[fam["Vidx"]][:, :, None]).sum(1)
            out.append(v.ravel())
        return jnp.concatenate(out) if out else jnp.zeros((0,),
                                                          DEFAULT_DTYPE)

    def iq_rmatvec(iq_jx, v):
        out = jnp.zeros((n,), DEFAULT_DTYPE)
        for fam, jx in zip(kkt._iq, iq_jx):
            g = (jx * v[fam["rows"]][:, :, None]).sum(1)
            out = out.at[fam["Vidx"].ravel()].add(g.ravel())
        return out

    def slack_reset(s, cI):
        s = jnp.maximum(s, negreset)
        feas = cI < 0.0
        rI = jnp.where(feas, 0.0, cI + s)
        s = jnp.where(feas, jnp.maximum(jnp.abs(cI), negreset), s)
        return s, rI

    def maxstep(v, dv):
        bad = dv < -bfrac * v
        cand = jnp.where(bad, -bfrac * v / jnp.where(bad, dv, -1.0), 1.0)
        return jnp.minimum(1.0, jnp.min(cand, initial=1.0))

    def factor_ladder(blocks, Hpert0, first_pert, zfac):
        """Inertia-correction ladder (reference factor_impl + alg_impl
        retry loop, `PSIOPT.cpp:422`): probe at delta=0 when allowed, then
        climb deltas until inertia is correct.  Structured as a forced-entry
        while_loop so the factorization graph (the largest subgraph in the
        whole solve — batched block inverses per BCR level) is
        instantiated exactly once."""

        def factor_blocks(bl, d):
            # unit_diag: SOE mode's setPrimalDiags(1.0) analog
            return kkt._factor_blocks_impl(bl, d + unit_diag, gammaE)

        fac_shapes, _ = jax.eval_shape(factor_blocks, blocks,
                                       jnp.zeros((), DEFAULT_DTYPE))
        d0 = jnp.where(zfac, 0.0, Hpert0)
        incr0 = incrH * jnp.where(first_pert, incrH, 1.0)
        dnext0 = jnp.where(zfac, Hpert0, Hpert0 * incr0)
        fac_init = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype),
                                fac_shapes)

        def cond(c):
            fac, neigs, dused, dnext, k, started = c
            return (~started) | ((neigs > mE) & (k < MaxRefac))

        def body(c):
            fac, neigs, dused, dnext, k, started = c
            d = jnp.where(started, dnext, d0)
            fac2, neigs2 = factor_blocks(blocks, d)
            neigs2 = jnp.asarray(neigs2, jnp.int32)
            dn2 = jnp.where(started, dnext * incrH, dnext0)
            k2 = jnp.where(started, k + 1, k)
            return (fac2, neigs2, d, dn2, k2, jnp.ones((), bool))

        init = (fac_init, jnp.asarray(mE + 1, jnp.int32),
                jnp.zeros((), DEFAULT_DTYPE), d0,
                jnp.zeros((), jnp.int32), jnp.zeros((), bool))
        fac, neigs, dused, _, k, _ = jax.lax.while_loop(cond, body, init)
        return fac, neigs, dused, k

    def line_search(x, s, lamE, lamI, dx, ds, PrimObj, BarrObj, Mu,
                    rd, rs, cE, rI, lamE_d, lamI_d, consts):
        """Merit line search (reference ls_impl, `PSIOPT.cpp:811`)."""
        allcons = jnp.concatenate([cE, rI])
        lm = jnp.concatenate([lamE, lamI])
        vv = jnp.concatenate([rd, rs]) @ jnp.concatenate([dx, ds])
        cv = jnp.concatenate([lamE_d, lamI_d]) @ allcons
        init_l2 = allcons @ allcons
        init_linf = jnp.max(jnp.abs(allcons), initial=0.0)
        sc0 = 0.01 if lsmode == "AUGLANG" else 0.1
        sc = jnp.where(init_l2 > 0, sc0 + jnp.abs(vv - cv) / init_l2, 1.0)
        init_l1 = jnp.abs(lm) @ jnp.abs(allcons)
        lang_init = PrimObj + BarrObj + init_l1 + init_l2 * sc

        def merit(alpha):
            x2 = x + alpha * dx
            obj2, cE2, cI2 = eval_oc(x2, consts)
            ptest = obj2 * sigma
            if mI > 0:
                s2 = s + alpha * ds
                s2r, rI2 = slack_reset(s2, cI2)
                btest = -Mu * jnp.sum(jnp.log(s2r))
            else:
                rI2 = cI2
                btest = 0.0
            allcons2 = jnp.concatenate([cE2, rI2])
            test_l2 = allcons2 @ allcons2
            test_linf = jnp.max(jnp.abs(allcons2), initial=0.0)
            if lsmode == "AUGLANG":
                eqerr = jnp.abs(cE2)
                iqerr = jnp.abs(rI2)
                test_l1 = jnp.sum(jnp.where(eqerr > ECtol * 10,
                                            eqerr * jnp.abs(lamE), 0.0))
                test_l1 += jnp.sum(jnp.where(iqerr > ICtol * 10,
                                             iqerr * jnp.abs(lamI), 0.0))
                l2eff = jnp.where(
                    test_l2 < (ECtol ** 2 * mE + ICtol ** 2 * mI),
                    0.0, test_l2)
                lang_test = ptest + btest + test_l1 + l2eff * sc
            else:
                test_l1 = jnp.abs(lm) @ jnp.abs(allcons2)
                lang_test = ptest + btest + test_l1 + test_l2 * sc
            ok = (lang_test < lang_init) \
                | ((ptest < PrimObj) & (test_l2 < init_l2)) \
                | ((ptest < PrimObj) & (test_linf < init_linf))
            return ok

        def cond(c):
            alpha, j, done = c
            return (~done) & (j < MaxLSIters)

        def body(c):
            alpha, j, done = c
            ok = merit(alpha)
            alpha2 = jnp.where(ok, alpha, alpha / alphaRed)
            return (alpha2, j + 1, ok)

        alpha, _, _ = jax.lax.while_loop(
            cond, body, (jnp.ones((), DEFAULT_DTYPE),
                         jnp.zeros((), jnp.int32),
                         jnp.zeros((), bool)))
        return alpha

    def iteration(carry, consts):
        (it, x, s, lamE, lamI, Mu, Hpert0, first_pert, nonzero4, infos,
         flag, acc_count, best_crit, best_x, best_s, best_lE,
         best_lI) = carry
        # Lane freezing: in the single-problem while_loop the body only
        # runs while flag == NOTCONVERGED, but under vmap (ensembles) the
        # batched while_loop keeps executing every lane until ALL lanes
        # finish.  `active` gates the carry update below so a finished
        # lane's state is bit-identical to its per-problem solve.
        active = flag == _NOTCONV

        obj, cE, cIraw, rd, famvals = kkt._eval_core(
            x, lamE, lamI, sigma, consts, want_hess=want_hess)
        if zero_rd:
            # reference evalSOE zeroes the primal gradients
            # (`PSIOPT.cpp:120-126`): pure feasibility (least-norm) steps
            rd = jnp.zeros_like(rd)

        if mI > 0:
            s, rI = slack_reset(s, cIraw)
            Sig = jnp.where(lamI / s < 0.0, Mu / (s * s), lamI / s)
            SigInv = jnp.where(Sig > 0, 1.0 / jnp.maximum(Sig, 1e-300), 0.0)
            sig_tilde = Sig / (1.0 + gammaI * Sig)
            comp = s * lamI
            avgcomp = jnp.mean(comp)
            mincomp = jnp.min(comp)
            maxcomp = jnp.max(comp)
        else:
            rI = cIraw
            sig_tilde = jnp.zeros((0,), DEFAULT_DTYPE)
            SigInv = sig_tilde
            avgcomp = mincomp = maxcomp = jnp.zeros((), DEFAULT_DTYPE)

        blocks = kkt._blocks_impl(famvals, sig_tilde)

        # FastFactorAlg probe heuristic (reference alg_impl): skip the
        # delta=0 probe when the last 4 iterations all needed perturbation.
        cycling = jnp.all(nonzero4)
        zfac = ~(jnp.asarray(FastFactor)
                 & (it > 6) & (((it * 3) % 4) != 0) & cycling)
        fac, neigs, dused, nfacs = factor_ladder(blocks, Hpert0,
                                                 first_pert, zfac)
        pert_used = dused > 0
        Hpert0 = jnp.where(pert_used,
                           jnp.maximum(deltaH, dused * decrH), Hpert0)
        first_pert = first_pert & ~pert_used
        nonzero4 = jnp.concatenate([nonzero4[1:], pert_used[None]])

        # ------------------------------------------- barrier mu update
        iq_jx = famvals["jx_iq"]
        corr = jnp.zeros((mI,), DEFAULT_DTYPE)
        if mI > 0:
            if barmode == "PROBE":
                w_aff = rI - SigInv * lamI
                rx_aff = rd + iq_rmatvec(iq_jx, sig_tilde * w_aff)
                dxa, _ = kkt._solve_impl(fac, -rx_aff, -cE)
                dlamI_aff = sig_tilde * (iq_matvec(iq_jx, dxa) + w_aff)
                ds_aff = -SigInv * (lamI + dlamI_aff)
                # fraction-to-boundary damping of the affine probe (the
                # undamped products can go negative and corrupt mu_aff)
                apa = maxstep(s, ds_aff)
                ada = maxstep(lamI, dlamI_aff)
                navg = jnp.mean((s + apa * ds_aff)
                                * (lamI + ada * dlamI_aff))
                Mu = jnp.where(avgcomp != 0,
                               (navg / avgcomp) ** 3 * avgcomp, Mu)
                if probe_corr:
                    # Mehrotra second-order correction: the affine
                    # products ds_aff*dlam_aff enter the complementarity
                    # rhs, reusing the probe solve this mode already pays
                    # for (standard predictor-corrector; the reference
                    # probe adjusts mu only)
                    corr = ds_aff * dlamI_aff / s
            else:  # LOQO
                eta = jnp.where(avgcomp != 0, mincomp / avgcomp, 0.0)
                sigmat = 0.1 * (0.05 * (1.0 - eta)
                                / jnp.maximum(eta, 1e-300)) ** 3
                sig_mu = jnp.where(eta > 0,
                                   jnp.minimum(0.8, jnp.abs(sigmat)), 0.8)
                Mu = sig_mu * avgcomp
            Mu = jnp.clip(Mu, MinMu, MaxMu)
            BarrObj = -Mu * jnp.sum(jnp.log(jnp.maximum(s, 1e-300)))
            rs = lamI - Mu / s + corr
        else:
            BarrObj = jnp.zeros((), DEFAULT_DTYPE)
            rs = jnp.zeros((0,), DEFAULT_DTYPE)

        # ---------------------------------------------------- newton solve
        if mI > 0:
            w = rI - SigInv * rs
            rhs_x = rd + iq_rmatvec(iq_jx, sig_tilde * w)
        else:
            rhs_x = rd
        dx, dlamE = kkt._solve_impl(fac, -rhs_x, -cE)
        if mI > 0:
            dlamI = sig_tilde * (iq_matvec(iq_jx, dx) + w)
            ds = -SigInv * (rs + dlamI)
        else:
            dlamI = lamI
            ds = s
        good = jnp.isfinite(jnp.sum(dx ** 2)) \
            & jnp.isfinite(jnp.sum(dlamE ** 2))

        if mI > 0:
            alphap = maxstep(s, ds)
            alphad = maxstep(lamI, dlamI)
            # PDStepStrategies (reference `PSIOPT.cpp:30-57`)
            if pdstrat == "AllMinimum":
                am = jnp.minimum(alphap, alphad)
                steps = (am, am, am, am)
            elif pdstrat == "PrimSlack_EqIq":
                steps = (alphap, alphap, alphad, alphad)
            elif pdstrat == "MaxEq":
                steps = (alphap, alphap, jnp.maximum(alphap, alphad),
                         alphad)
            else:  # PrimSlackEq_Iq (reference default)
                steps = (alphap, alphap, alphap, alphad)
            dx = dx * steps[0]
            ds = ds * steps[1]
            dlamE = dlamE * steps[2]
            dlamI = dlamI * steps[3]

        # ------------------------------------------------------ line search
        if lsmode in ("AUGLANG", "L1", "LANG"):
            alpha = line_search(x, s, lamE, lamI, dx, ds,
                                obj * sigma, BarrObj, Mu,
                                rd, rs, cE, rI, dlamE, dlamI, consts)
            alpha = jnp.where(good, alpha, 1.0)
        else:
            alpha = jnp.ones((), DEFAULT_DTYPE)

        # -------------------------------------------------- iterate record
        kktinf = jnp.max(jnp.abs(rd), initial=0.0)
        econinf = jnp.max(jnp.abs(cE), initial=0.0)
        iconinf = jnp.max(jnp.abs(rI), initial=0.0)
        barrinf = maxcomp
        info = jnp.stack([obj, kktinf, econinf, iconinf, barrinf, Mu,
                          alpha, nfacs.astype(DEFAULT_DTYPE), dused])
        infos = jax.lax.dynamic_update_slice(
            infos, info[None, :], (it, jnp.zeros((), it.dtype)))

        # ---------------------------------------------- convergence ladder
        diverging = (~good) \
            | ~jnp.isfinite(kktinf + econinf + iconinf + barrinf) \
            | (kktinf > DivK) | (econinf > DivE) | (iconinf > DivI) \
            | (barrinf > DivB)
        converged = (kktinf < KKTtol) & (econinf < ECtol) \
            & (iconinf < ICtol) & (barrinf < Btol)
        # acceptable tier: MaxAccIters consecutive iterates within the
        # acceptable tolerances (reference convergeCheck, `PSIOPT.cpp:130`)
        accrow = (kktinf < AccK) & (econinf < AccE) \
            & (iconinf < AccI) & (barrinf < AccB)
        acc_count = jnp.where(accrow, acc_count + 1, 0)
        acceptable = acc_count > MaxAccIters
        i32 = lambda v: jnp.asarray(v, jnp.int32)
        flag = jnp.where(diverging, i32(_DIV),
                         jnp.where(converged, i32(_CONV),
                                   jnp.where(acceptable, i32(_ACC),
                                             i32(_NOTCONV))))

        # --------------------------------------------- ReturnBest tracking
        if best_mode == "ObjVal":
            crit = obj
        elif best_mode == "KKT":
            crit = kktinf
        else:  # ECons (reference default)
            crit = jnp.maximum(econinf, iconinf)
        better = crit < best_crit
        best_crit = jnp.where(better, crit, best_crit)
        best_x = jnp.where(better, x, best_x)
        best_s = jnp.where(better, s, best_s)
        best_lE = jnp.where(better, lamE, best_lE)
        best_lI = jnp.where(better, lamI, best_lI)

        # ------------------------------------------------------ take step
        step_ok = (flag == _NOTCONV)
        stepa = jnp.where(step_ok & good, alpha, 0.0)
        x = x + stepa * dx
        lamE = lamE + stepa * dlamE
        if mI > 0:
            s = s + stepa * ds
            lamI = lamI + stepa * dlamI

        new_carry = (it + 1, x, s, lamE, lamI, Mu, Hpert0, first_pert,
                     nonzero4, infos, flag, acc_count, best_crit, best_x,
                     best_s, best_lE, best_lI)
        return jax.tree.map(lambda nw, od: jnp.where(active, nw, od),
                            new_carry, carry)

    def cond(carry):
        it, flag = carry[0], carry[10]
        return (flag == _NOTCONV) & (it < MaxIters)

    def init_multipliers(x, consts):
        """Reference init_impl (`PSIOPT.cpp:728-807`, AlgorithmModes::INIT):
        one first-order (evalAUG) factorization with unit primal diagonal
        and unit slack Hessian; the equality-multiplier block of
        -K^{-1} [sigma*gradf; 0] is the least-squares multiplier estimate
        that initializes lamE."""
        zE = jnp.zeros((mE,), DEFAULT_DTYPE)
        zI = jnp.zeros((mI,), DEFAULT_DTYPE)
        _, _, _, rd0, fam0 = kkt._eval_core(
            x, zE, zI, float(opts["ObjScale"]), consts, want_hess="zeros")
        st1 = jnp.ones((mI,), DEFAULT_DTYPE)
        blocks0 = kkt._blocks_impl(fam0, st1)
        fac0, _ = kkt._factor_blocks_impl(blocks0, jnp.asarray(1.0),
                                          jnp.asarray(gammaE))
        _, lamE0 = kkt._solve_impl(fac0, -rd0, zE)
        good = jnp.isfinite(jnp.sum(lamE0 ** 2))
        return jnp.where(good, lamE0, zE)

    def make_init(x, s, lamE, lamI, Mu0, consts):
        if init_lmults and mE > 0:
            lamE = init_multipliers(x, consts)
        infos = jnp.zeros((MaxIters, ninfo), DEFAULT_DTYPE)
        return (jnp.zeros((), jnp.int32), x, s, lamE, lamI,
                jnp.asarray(Mu0, DEFAULT_DTYPE),
                jnp.asarray(deltaH, DEFAULT_DTYPE),
                jnp.ones((), bool), jnp.zeros((4,), bool), infos,
                jnp.asarray(_NOTCONV, jnp.int32),
                jnp.zeros((), jnp.int32),
                jnp.asarray(jnp.inf, DEFAULT_DTYPE), x, s, lamE, lamI)

    def finalize(out):
        (it, x, s, lamE, lamI, Mu, _, _, _, infos, flag, _, best_crit,
         best_x, best_s, best_lE, best_lI) = out
        return (x, s, lamE, lamI, Mu, flag, it, infos,
                best_x, best_s, best_lE, best_lI)

    def run(x, s, lamE, lamI, Mu0, consts):
        init = make_init(x, s, lamE, lamI, Mu0, consts)
        out = jax.lax.while_loop(cond, lambda c: iteration(c, consts), init)
        return finalize(out)

    return jax.jit(run)


def build_fused_ensemble(kkt: BlockKKT, opts: dict, mode: str, mesh=None,
                         axis: str = "scenario"):
    """Vmapped full-fidelity ensemble solve (the reference Jet's job,
    `src/Solvers/Jet.h:92-151`, as ONE compiled program).

    Every lane runs the COMPLETE PSIOPT algorithm — probe/perturbation
    factorization ladder, LOQO/PROBE barrier, merit line search,
    convergence tiers — identical to `phase.optimize()` (finished lanes
    are frozen in the batched while_loop, see `iteration`).  The scenario
    axis is optionally sharded over a device mesh: batched per-scenario
    BCR factorizations on each chip, scenarios data-parallel across chips
    (SURVEY.md section 2.9 P4).

    Returns fn(xB, sB, lamEB, lamIB, mu0, consts) with a leading batch
    axis on the four state arrays; mu0/consts are shared.
    """
    run = build_fused_alg(kkt, opts, mode)
    vrun = jax.vmap(run, in_axes=(0, 0, 0, 0, None, None))
    if mesh is None:
        return jax.jit(vrun)
    from jax.sharding import NamedSharding, PartitionSpec as P
    sh = NamedSharding(mesh, P(axis))
    rep = NamedSharding(mesh, P())
    crep = jax.tree.map(lambda _: rep, kkt.nlp.consts_dev())
    out_sh = (sh, sh, sh, sh, sh, sh, sh, sh, sh, sh, sh, sh)
    return jax.jit(vrun,
                   in_shardings=(sh, sh, sh, sh, rep, crep),
                   out_shardings=out_sh)
