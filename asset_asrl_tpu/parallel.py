"""Scenario-batch and device-mesh execution (the reference Jet analog).

Reference: `src/Solvers/Jet.h` runs N whole optimization problems on a
thread pool (one MKL thread each).  JAX equivalent: the entire IPM
iteration of a transcribed phase is one jitted function of the solver state,
so a *batch* of scenarios is `jax.vmap` of that function, and the batch axis
is sharded over a `jax.sharding.Mesh` — scenario data-parallelism over
chips/hosts (SURVEY.md section 2.9 P4/P6), with the per-scenario
block-tridiagonal KKT factorization running batched on each chip.

`make_iteration_step(phase)` builds the single-scenario jitted step (a
simplified always-full-step LOQO iteration: slack reset, barrier update,
condensed block-KKT factor+solve, fraction-to-boundary, no merit retries —
the NOLS path of the reference solver).  `make_batched_step` vmaps it and
annotates shardings over the scenario axis.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from .config import DEFAULT_DTYPE

__all__ = ["make_iteration_step", "make_batched_step", "solve_ensemble"]


def make_iteration_step(phase, delta=1.0e-5, gammaE=1.0e-10,
                        gammaI=1.0e-10, boundfrac=0.99):
    """One full primal-dual IPM iteration as a pure jittable function.

    state = (x, s, lamE, lamI, mu); returns the updated state plus the
    (kkt, econ, icon, barr) infeasibility scalars.
    """
    if phase._need_transcribe or phase._nlp is None:
        phase.transcribe()
    kkt = phase.optimizer.kkt
    from .Solvers.kkt_block import BlockKKT
    if not isinstance(kkt, BlockKKT):
        raise ValueError("iteration step requires the block KKT backend")
    nlp = phase._nlp
    mI = nlp.numIq

    consts0 = nlp.consts_dev()

    def step(state):
        x, s, lamE, lamI, mu = state
        obj, gradf, cE, cIraw, rd = kkt._resid_impl(x, lamE, lamI, 1.0,
                                                    consts0)

        # slack reset (PSIOPT.h:549)
        s = jnp.maximum(s, 1e-12)
        feas = cIraw < 0.0
        rI = jnp.where(feas, 0.0, cIraw + s)
        s = jnp.where(feas, jnp.maximum(jnp.abs(cIraw), 1e-12), s)

        Sig = jnp.where(lamI / s < 0.0, mu / (s * s), lamI / s)
        SigInv = jnp.where(Sig > 0, 1.0 / jnp.maximum(Sig, 1e-300), 0.0)
        sig_tilde = Sig / (1.0 + gammaI * Sig)

        comp = s * lamI
        avgcomp = jnp.mean(comp)
        mincomp = jnp.min(comp)
        eta = mincomp / avgcomp
        sigmat = 0.1 * (0.05 * (1.0 - eta) / jnp.maximum(eta, 1e-300)) ** 3
        mu_new = jnp.clip(jnp.minimum(0.8, jnp.abs(sigmat)) * avgcomp,
                          1e-12, 100.0)
        rs = lamI - mu_new / s

        fac, neigs = kkt._factor_impl(
            x, lamE, lamI, jnp.asarray(1.0), sig_tilde,
            jnp.asarray(delta), jnp.asarray(gammaE), consts0)
        w = rI - SigInv * rs
        rhs_x = rd + kkt._iq_rmatvec_impl(fac, sig_tilde * w)
        dx, dlamE = kkt._solve_impl(fac, -rhs_x, -cE)
        dlamI = sig_tilde * (kkt._iq_matvec_impl(fac, dx) + w)
        ds = -SigInv * (rs + dlamI)

        def maxstep(v, dv):
            bad = dv < -boundfrac * v
            cand = jnp.where(bad, -boundfrac * v / jnp.where(bad, dv, -1.0),
                             1.0)
            return jnp.minimum(1.0, jnp.min(cand, initial=1.0))

        ap = maxstep(s, ds)
        ad = maxstep(lamI, dlamI)
        x = x + ap * dx
        s = s + ap * ds
        lamE = lamE + ap * dlamE
        lamI = lamI + ad * dlamI

        info = jnp.stack([jnp.max(jnp.abs(rd)),
                          jnp.max(jnp.abs(cE)) if nlp.numEq else 0.0,
                          jnp.max(jnp.abs(rI)) if mI else 0.0,
                          jnp.max(comp) if mI else 0.0])
        return (x, s, lamE, lamI, mu_new), info

    return step


def init_state(phase, mu0=1.0e-3, boundpush=1.0e-3):
    """Solver state from the phase's current trajectory (init_impl analog).

    Evaluates the constraints on the host CPU backend (set-up, not solver
    math: one small jit whose result the host reads at once); mu is a strong
    f64 scalar so the state aval exactly matches the iteration output (no
    retrace on the second step)."""
    if phase._need_transcribe or phase._nlp is None:
        phase.transcribe()
    nlp = phase._nlp
    x0 = phase.makeSolverInput()
    try:
        cpu = jax.devices("cpu")[0]
    except RuntimeError:
        cpu = None
    import contextlib
    ctx = jax.default_device(cpu) if cpu is not None \
        else contextlib.nullcontext()
    with ctx:
        _, cE, cI = nlp.eval_obj_cons(jnp.asarray(x0))
    cI = np.asarray(cI)
    s = np.where(cI < -boundpush, np.abs(cI), boundpush)
    lamI = mu0 / s
    return (jnp.asarray(x0), jnp.asarray(s),
            jnp.zeros((nlp.numEq,), DEFAULT_DTYPE),
            jnp.asarray(lamI), jnp.array(mu0, dtype=DEFAULT_DTYPE))


def make_batched_step(phase, mesh=None, axis="scenario"):
    """Vmapped iteration step over a leading scenario axis, optionally
    sharded over a device mesh (the Jet analog across devices)."""
    step = make_iteration_step(phase)
    vstep = jax.vmap(step)
    if mesh is None:
        return jax.jit(vstep)
    from jax.sharding import NamedSharding, PartitionSpec as P
    shard = NamedSharding(mesh, P(axis))
    state_shard = (shard, shard, shard, shard, shard)

    return jax.jit(vstep, in_shardings=(state_shard,),
                   out_shardings=(state_shard, shard))


def solve_ensemble(phase, perturb_states=None, mesh=None, mode="OPT",
                   x0s=None):
    """Full-fidelity vmapped ensemble solve: B scenarios sharing the
    phase's structure, each run through the COMPLETE fused PSIOPT
    algorithm (probe/perturbation ladder, barrier update, merit line
    search, convergence tiers) — one compiled program whose results match
    per-scenario `phase.optimize()` exactly (reference Jet,
    `src/Solvers/Jet.h:92-151`).

    perturb_states: B initial-state perturbation vectors, OR x0s: B full
    solver-input vectors.  mesh: optional device mesh to shard the
    scenario axis over.  Returns a dict with "x" (B, n), "flags" (B,),
    "iters" (B,), "objs" (B,), "infos" (B, MaxIters, 9).
    """
    if phase._need_transcribe or phase._nlp is None:
        phase.transcribe()
    opt = phase.optimizer
    kkt = opt.kkt
    nlp = phase._nlp
    from .Solvers.fused import build_fused_ensemble
    fn = build_fused_ensemble(kkt, opt._opts_snapshot(), mode, mesh=mesh)

    if x0s is None:
        base = np.asarray(phase.makeSolverInput())
        x0s = np.stack([base + np.asarray(p) for p in perturb_states])
    else:
        x0s = np.stack([np.asarray(x) for x in x0s])
    B = x0s.shape[0]

    # per-scenario slack/multiplier init (init_impl), batched on the host
    # CPU: set-up whose results the host reads at once
    try:
        cpu = jax.devices("cpu")[0]
    except RuntimeError:
        cpu = None
    import contextlib
    ctx = jax.default_device(cpu) if cpu is not None \
        else contextlib.nullcontext()
    mu0 = float(opt.initMu)
    with ctx:
        voc = jax.vmap(nlp.eval_obj_cons_impl, in_axes=(0, None))
        _, _, cI = voc(jnp.asarray(x0s), nlp.consts_dev())
    cI = np.asarray(cI)
    if nlp.numIq > 0:
        sB = np.where(cI < -opt.BoundPush, np.abs(cI), opt.BoundPush)
        lamIB = mu0 / sB
    else:
        sB = np.zeros((B, 0))
        lamIB = np.zeros((B, 0))
    lamEB = np.zeros((B, nlp.numEq))

    out = fn(jnp.asarray(x0s), jnp.asarray(sB), jnp.asarray(lamEB),
             jnp.asarray(lamIB), jnp.asarray(mu0), nlp.consts_dev())
    x, s, lamE, lamI, Mu, flag, niters, infos = out[:8]
    niters_np = np.asarray(niters)
    with ctx:
        objs, _, _ = voc(jnp.asarray(x), nlp.consts_dev())
    objs = np.asarray(objs)
    return dict(x=np.asarray(x), flags=np.asarray(flag),
                iters=niters_np, objs=objs, infos=np.asarray(infos),
                lamE=np.asarray(lamE), lamI=np.asarray(lamI),
                s=np.asarray(s))
