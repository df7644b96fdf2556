"""Scenario-batch + device-mesh execution tests (Jet analog) and
sharding determinism: 1-device vs 8-device results must agree
(the reference's NLPTest thread-count equivalence, SURVEY.md section 4)."""

import numpy as np
import pytest
import jax

import asset_asrl_tpu as ast
from asset_asrl_tpu.parallel import (make_iteration_step, make_batched_step,
                                     init_state)

vf = ast.VectorFunctions
oc = ast.OptimalControl
Args = vf.Arguments


def _phase(nsegs=12):
    class Cart(oc.ODEBase):
        def __init__(self):
            XtU = oc.ODEArguments(2, 1)
            super().__init__(vf.stack([XtU.XVar(1), XtU.UVar(0)]), 2, 1)

    ts = np.linspace(0, 2, 30)
    IG = [[t / 2, 0.5, t, 0.0] for t in ts]
    ode = Cart()
    phase = ode.phase("LGL3", IG, nsegs)
    phase.addBoundaryValue("Front", [0, 1, 2], [0, 0, 0])
    phase.addBoundaryValue("Back", [0, 1, 2], [1, 0, 2])
    phase.addLUVarBound("Path", 3, -4.0, 4.0)
    phase.addIntegralObjective(Args(1)[0] ** 2, [3])
    return phase


def test_iteration_step_converges():
    phase = _phase()
    step = jax.jit(make_iteration_step(phase))
    state = init_state(phase)
    for _ in range(25):
        state, info = step(state)
    kkt, econ, icon, barr = np.asarray(info)
    assert econ < 1e-8 and kkt < 1e-5, (kkt, econ)


def test_batched_step_matches_single():
    phase = _phase()
    step = jax.jit(make_iteration_step(phase))
    vstep = make_batched_step(phase)

    base = init_state(phase)
    B = 4
    rng = np.random.default_rng(0)
    perts = [rng.normal(size=base[0].shape) * 1e-3 for _ in range(B)]
    xb = np.stack([np.asarray(base[0]) + p for p in perts])
    bstate = (jax.numpy.asarray(xb),) + tuple(
        jax.numpy.broadcast_to(v, (B,) + v.shape) for v in base[1:])

    for _ in range(5):
        bstate, binfo = vstep(bstate)

    # scenario 2 must equal a single-problem run from the same start
    state = (jax.numpy.asarray(xb[2]),) + tuple(base[1:])
    for _ in range(5):
        state, info = step(state)
    assert np.allclose(np.asarray(bstate[0][2]), np.asarray(state[0]),
                       atol=1e-12)


def test_fused_ensemble_matches_optimize():
    """solve_ensemble runs the FULL fused PSIOPT per lane: flags, iteration
    counts and solutions must match per-scenario phase.optimize() runs
    (reference Jet equivalence, `src/Solvers/Jet.h:92-151`)."""
    from asset_asrl_tpu.parallel import solve_ensemble

    phase = _phase()
    phase.transcribe()
    opt = phase.optimizer
    opt.PrintLevel = 2

    rng = np.random.default_rng(3)
    base = np.asarray(phase.makeSolverInput())
    B = 3
    perts = [rng.normal(size=base.shape) * 1e-3 for _ in range(B)]
    res = solve_ensemble(phase, perturb_states=perts)

    for i in range(B):
        xi = opt.optimize(base + perts[i])
        assert int(res["flags"][i]) == int(opt.ConvergeFlag), i
        assert int(res["iters"][i]) == int(opt.LastIterNum), i
        assert np.allclose(res["x"][i], xi, atol=1e-9), i


def test_sharded_mesh_determinism():
    """8-device sharded ensemble equals unsharded (the multi-device substitute for
    the reference's threaded-scatter determinism test NLPTest)."""
    devs = jax.devices()
    if len(devs) < 8:
        pytest.skip("needs the 8-device virtual CPU mesh")
    from jax.sharding import Mesh
    mesh = Mesh(np.array(devs[:8]), ("scenario",))

    phase = _phase()
    base = init_state(phase)
    B = 8
    rng = np.random.default_rng(1)
    xb = np.stack([np.asarray(base[0]) + rng.normal(size=base[0].shape) * 1e-3
                   for _ in range(B)])
    mk_state = lambda: (jax.numpy.asarray(xb),) + tuple(
        jax.numpy.broadcast_to(v, (B,) + v.shape) for v in base[1:])

    vs_plain = make_batched_step(phase)
    st1 = mk_state()
    for _ in range(4):
        st1, _ = vs_plain(st1)

    vs_mesh = make_batched_step(phase, mesh=mesh)
    st2 = mk_state()
    for _ in range(4):
        st2, _ = vs_mesh(st2)

    assert np.allclose(np.asarray(st1[0]), np.asarray(st2[0]), atol=1e-12)


@pytest.mark.slow
def test_multispacecraft_ensemble_64():
    """64-scenario FULL-solve ensemble sharded over the virtual mesh
    (SURVEY 2.9 P4 at 64 scenarios)."""
    import sys
    import os
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))), "examples"))
    from MultiSpacecraftOptimization import ensemble_demo
    from jax.sharding import Mesh
    devs = jax.devices()
    if len(devs) < 8:
        pytest.skip("needs the 8-device virtual CPU mesh")
    mesh = Mesh(np.array(devs[:8]), ("scenario",))
    res = ensemble_demo(nscen=64, mesh=mesh)
    assert int(np.sum(res["flags"] == 0)) == 64, res["flags"]
