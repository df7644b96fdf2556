"""Block cyclic-reduction KKT: factor/solve/inertia vs dense reference."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from asset_asrl_tpu.Solvers.kkt_block import bcr_factor, bcr_solve


def make_block_tridiag(K, W, b, seed=0, spd=False):
    rng = np.random.default_rng(seed)
    diag = rng.normal(size=(K, W, W))
    diag = (diag + diag.transpose(0, 2, 1)) / 2
    if spd:
        for k in range(K):
            diag[k] += W * np.eye(W)
    lower = rng.normal(size=(K, W, W)) * 0.3
    lower[-1] = 0.0
    B = rng.normal(size=(K, W, b)) * 0.2
    C = rng.normal(size=(b, b))
    C = (C + C.T) / 2 - b * np.eye(b)

    dim = K * W + b
    A = np.zeros((dim, dim))
    for k in range(K):
        A[k * W:(k + 1) * W, k * W:(k + 1) * W] = diag[k]
        if k + 1 < K:
            A[(k + 1) * W:(k + 2) * W, k * W:(k + 1) * W] = lower[k]
            A[k * W:(k + 1) * W, (k + 1) * W:(k + 2) * W] = lower[k].T
        A[k * W:(k + 1) * W, K * W:] = B[k]
        A[K * W:, k * W:(k + 1) * W] = B[k].T
    A[K * W:, K * W:] = C
    return diag, lower, B, C, A


@pytest.mark.parametrize("K,W,b", [(1, 3, 2), (2, 3, 2), (5, 4, 3),
                                   (8, 4, 0), (13, 5, 4), (16, 2, 1)])
def test_bcr_solve_matches_dense(K, W, b):
    diag, lower, B, C, A = make_block_tridiag(K, W, b, seed=K + W, spd=True)
    nlevels = max(1, int(np.ceil(np.log2(max(K, 2)))))
    # jitted: eager dispatch routes through jaxlib's shipped AOT CPU
    # kernels, which mis-execute on hosts whose CPU features differ from
    # the wheel build (observed heap-corruption aborts)
    fac, neigs = jax.jit(bcr_factor)(jnp.asarray(diag), jnp.asarray(lower),
                                     jnp.asarray(B), jnp.asarray(C))
    rng = np.random.default_rng(1)
    r = rng.normal(size=(K, W))
    rb = rng.normal(size=(b,))
    y, z = jax.jit(bcr_solve)(fac, jnp.asarray(r), jnp.asarray(rb))
    sol = np.linalg.solve(A, np.concatenate([r.ravel(), rb]))
    got = np.concatenate([np.asarray(y).ravel(), np.asarray(z)])
    assert np.allclose(got, sol, atol=1e-8), np.abs(got - sol).max()


@pytest.mark.parametrize("K,W,b", [(4, 3, 2), (7, 4, 3), (16, 3, 0)])
def test_bcr_inertia(K, W, b):
    """Negative-eigenvalue count must match the dense eigendecomposition
    (this drives PSIOPT's perturbation ladder)."""
    for seed in range(4):
        diag, lower, B, C, A = make_block_tridiag(K, W, b, seed=seed,
                                                  spd=False)
        nlevels = max(1, int(np.ceil(np.log2(max(K, 2)))))
        fac, neigs = jax.jit(bcr_factor)(
            jnp.asarray(diag), jnp.asarray(lower),
            jnp.asarray(B), jnp.asarray(C))
        w = np.linalg.eigvalsh(A)
        assert int(neigs) == int(np.sum(w < 0)), \
            f"seed {seed}: bcr {int(neigs)} vs dense {int(np.sum(w < 0))}"


def test_nonbanded_rows_use_border_not_dense(capsys):
    """Nonlinear front-to-back constraints must stay on the BlockKKT via
    border promotion (reference: Pardiso handles arbitrary sparsity,
    `src/Solvers/PardisoInterface.h`; our escape hatch is the dense
    border).  Previously any such row raised and dropped the whole problem
    to the O(n^3) dense backend."""
    import asset_asrl_tpu as ast
    from asset_asrl_tpu.Solvers.kkt_block import BlockKKT

    vf = ast.VectorFunctions
    oc = ast.OptimalControl

    class Brach(oc.ODEBase):
        def __init__(self, g):
            XtU = oc.ODEArguments(3, 1)
            x, y, v = XtU.XVec().tolist()
            theta = XtU.UVar(0)
            ode = vf.stack([vf.sin(theta) * v, -1.0 * vf.cos(theta) * v,
                            g * vf.cos(theta)])
            super().__init__(ode, 3, 1)

    g = 9.81
    ode = Brach(g)
    x0, y0, v0, theta0, xf, yf, tf = 0, 10, 0, 1.0, 10, 5, 1
    ts = np.linspace(0, tf, 50)
    IG = [[x0 + (xf - x0) * t / tf, y0 + (yf - y0) * t / tf,
           g * t * np.cos(theta0), t, theta0] for t in ts]
    phase = ode.phase("LGL3", IG, 16)
    phase.addBoundaryValue("Front", range(0, 4), [x0, y0, v0, 0])
    phase.addLUVarBound("Path", 4, -0.1, 2.00)
    phase.addBoundaryValue("Back", [1], [yf])
    # NONLINEAR front-to-back coupling: |r_back - r_front|^2 = 100
    Args = vf.Arguments
    fb = Args(4)
    con = (fb.segment(2, 2) - fb.segment(0, 2)).squared_norm() - 100.0
    phase.addEqualCon("FrontandBack", con, [0, 1, 5, 6])
    phase.addDeltaTimeObjective(1.0)
    phase.optimizer.PrintLevel = 2
    flag = phase.optimize()
    out = capsys.readouterr().out
    assert "falling back to dense" not in out
    assert isinstance(phase.optimizer.kkt, BlockKKT)
    assert flag == ast.Solvers.ConvergenceFlags.CONVERGED
    # the constraint must hold at the solution
    tr = np.asarray(phase.returnTraj())
    d2 = (tr[-1, 0] - tr[0, 0]) ** 2 + (tr[-1, 1] - tr[0, 1]) ** 2
    assert abs(d2 - 100.0) < 1e-6
