#!/usr/bin/env python
"""Smoke run of the PSIOPT solve path on an NVIDIA GPU.

    python chip_smoke.py            # phases a-d on one GPU
    python chip_smoke.py --four     # phase e only: the 4-GPU sharded paths

Phases (one process; every check raises on failure):

  a. CartPole LGL5 swing-up at 5,000 segments (10,001 collocation nodes)
     through `phase.optimize()`: flag 0, |obj - 58.83| < 0.1, solver state
     on the GPU, set-up / compile / solve seconds, memory_analysis() of the
     fused program.
  b. Delta III 4-phase launch (examples/Delta3Launch.py, 40 LGL3 segments
     per phase) through `ocp.optimize()`: final mass within 0.01 kg of
     7529.749892668763.
  c. Plain references on the card:
     1. block-BCR backend vs the dense backend at 40 segments, both
        converged to 1e-10: flags equal, objective and x at rel <= 1e-8;
     2. at the converged phase-a iterate, the device's negative-pivot
        count vs an exact host block-LDL^T inertia over a delta ladder
        ending at delta = 0 (equal for delta > 0; at 0 never below the
        exact count), and one BCR factor+solve vs a pivoted host solve
        of the same assembled KKT (LAPACK banded LU + border Schur): after
        one refinement step through each factor, normwise backward error
        <= 1e-10 for both (f64); the plain BCR residual is printed;
     3. CartPole at 500 segments on the GPU and on the host CPU device in
        this process, converged to 1e-10: flags equal, objectives at
        rel <= 1e-8.
  d. `parallel.solve_ensemble` of 64 perturbed CartPoles (40 segments) on
     one card: all flags 0, two lanes equal to their own optimize() at
     rel <= 1e-8.
  e. (--four) a 4-GPU scenario-sharded ensemble vs the unsharded one, and
     a segment-sharded full solve over 4 GPUs vs the one-GPU solve (both
     converged to 1e-10): flags equal, objective and x at rel <= 1e-8.

All solver math is f64.  The KKT assembly's one-hot patches run split
f32 hi+lo products at precision="highest" (no TF32), so assembled entries
carry ~48 mantissa bits; nothing sets a global matmul precision.

It exits non-zero, printing no result line, when JAX finds no GPU.  The
last line of a passing run is one JSON object naming the device.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

CARTPOLE_OBJ = 58.83          # reference 58.832 at the converged mesh
DELTA3_MASS = 7529.749892668763
TIGHT = 1e-10                 # stopping tolerances of compared solves


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))


def log(msg):
    print(msg, flush=True)


def _load_example(name):
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", os.path.join(HERE, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cartpole(nsegs, tol=None):
    """The bench's CartPole phase, silent; `tol` tightens every stopping
    tolerance so two solves are compared at the optimum rather than at
    two different points inside the default 1e-6 tolerances."""
    from bench import build_phase
    phase = build_phase(nsegs)
    phase.optimizer.set_PrintLevel(2)
    if tol is not None:
        phase.optimizer.set_tols(tol, tol, tol, tol)
    return phase


def _sig_tilde(opt, s, lamI, Mu):
    import jax.numpy as jnp
    s = jnp.maximum(s, 1e-300)
    Sig = jnp.where(lamI / s < 0.0, Mu / (s * s), lamI / s)
    return Sig / (1.0 + opt.gammaI * Sig)


# --------------------------------------------------------------------- a
def phase_main(nsegs=5000):
    """CartPole through phase.optimize(); returns the phase and the state
    the fused loop returned on a second, warm-compiled solve."""
    import jax
    import jax.numpy as jnp
    platform = jax.devices()[0].platform
    t0 = time.perf_counter()
    phase = cartpole(nsegs)
    phase.transcribe()
    t_tr = time.perf_counter() - t0
    opt = phase.optimizer
    x0 = phase.makeSolverInput()

    t0 = time.perf_counter()
    flag = phase.optimize()
    t_first = time.perf_counter() - t0
    obj = opt.LastObjVal
    check(flag == 0, f"phase a: flag {flag}")
    check(abs(obj - CARTPOLE_OBJ) < 0.1, f"phase a: objective {obj}")

    # the same solve again through the fused program optimize() compiled
    fn = opt._fused_cache[1]
    x, s, lamE, lamI = opt._init_state(x0, opt.initMu)
    args = (x, s, lamE, lamI, jnp.asarray(opt.initMu),
            phase._nlp.consts_dev())
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    t_second = time.perf_counter() - t0
    flag2, niters = int(out[5]), int(out[6])
    check(flag2 == 0, f"phase a: second solve flag {flag2}")
    where = {d.platform for leaf in out for d in leaf.devices()}
    check(where == {platform},
          f"phase a: solver state on {where}, expected {platform}")
    info = np.asarray(out[7][niters - 1])
    mem = fn.lower(*args).compile().memory_analysis()
    log(f"[a] CartPole LGL5 {nsegs} segs ({2 * nsegs + 1} nodes): flag "
        f"{flag} obj {obj:.6f} iters {opt.LastIterNum} (second solve "
        f"{niters}) kkt {info[1]:.3e} econ {info[2]:.3e}")
    log(f"[a] transcription {t_tr:.3f} s, first solve (with compile) "
        f"{t_first:.3f} s, second solve (warm) {t_second:.3f} s, "
        f"state on {sorted(where)}")
    log(f"[a] fused program memory_analysis: {mem}")
    return phase, out


# --------------------------------------------------------------------- b
def phase_multiphase(nsegs=40):
    """Delta III launch through ocp.optimize() at the example's 40 LGL3
    segments per phase, which already lands within 0.01 kg of the
    converged-mesh reference (tests/test_delta3.py refines the mesh too;
    every re-mesh would compile a new program)."""
    mod = _load_example("Delta3Launch")
    t0 = time.perf_counter()
    ocp = mod.build_ocp(nsegs, print_level=2)
    flag = ocp.optimize()
    dt = time.perf_counter() - t0
    mfinal = float(ocp.Phases[3].returnTraj()[-1][6] * mod.Mstar)
    log(f"[b] Delta III 4 phases x {nsegs} segs: flag {flag} final mass "
        f"{mfinal:.6f} kg (reference {DELTA3_MASS}), {dt:.3f} s with "
        "compile")
    check(flag == 0, f"phase b: flag {flag}")
    check(abs(mfinal - DELTA3_MASS) < 0.01, f"phase b: final mass {mfinal}")


# -------------------------------------------------------------------- c.1
def phase_dense_reference(nsegs=40):
    """Block-BCR backend vs the dense eigendecomposition backend."""
    pb = cartpole(nsegs, TIGHT)
    fb = pb.optimize()
    pd = cartpole(nsegs, TIGHT)
    pd.setKKTBackend("dense")
    fd = pd.optimize()
    ob, od = pb.optimizer.LastObjVal, pd.optimizer.LastObjVal
    rx = rel(pb.makeSolverInput(), pd.makeSolverInput())
    robj = abs(ob - od) / abs(od)
    log(f"[c.1] block vs dense at {nsegs} segs: flags {fb}/{fd}, obj "
        f"{ob:.12f}/{od:.12f} (rel {robj:.3e}), x rel {rx:.3e}")
    check(fb == fd == 0, f"phase c.1: flags {fb}/{fd}")
    check(robj <= 1e-8, f"phase c.1: objective rel {robj}")
    check(rx <= 1e-8, f"phase c.1: x rel {rx}")


# -------------------------------------------------------------------- c.2
def host_block_inertia(diag, lower, B, C):
    """Exact inertia (negative eigenvalue count) of [T, B; B^T, C] by
    sequential block LDL^T in numpy f64: eigvalsh of every eliminated
    diagonal block and of the final border Schur complement (Sylvester)."""
    K = diag.shape[0]
    neg = 0
    Dk = diag[0].copy()
    Bh = B[0].copy()
    Csch = C.copy()
    for k in range(K):
        neg += int((np.linalg.eigvalsh(Dk) < 0).sum())
        Dinv = np.linalg.inv(Dk)
        Csch -= Bh.T @ Dinv @ Bh
        if k + 1 < K:
            Lk = lower[k]
            Dk = diag[k + 1] - Lk @ Dinv @ Lk.T
            Bh = B[k + 1] - Lk @ Dinv @ Bh
    if Csch.shape[0]:
        neg += int((np.linalg.eigvalsh(Csch) < 0).sum())
    return neg


def regularized_blocks(kkt, blocks, delta, gammaE):
    """Host copy of BlockKKT._factor_blocks_impl's regularization."""
    diag, lower, B, C = (np.asarray(b, np.float64) for b in blocks)
    sd, sc = kkt._diag_sign, kkt._c_sign
    diag = diag + np.where(sd > 0, delta, np.where(sd < 0, -gammaE, 0.0)) \
        + kkt._diag_fix
    C = C + np.where(sc > 0, delta, np.where(sc < 0, -gammaE, 0.0))
    return diag, lower, B, C


def assemble_sparse(diag, lower, B, C):
    """The symmetric block-tridiagonal + border matrix as scipy CSR."""
    import scipy.sparse as sp
    K, W, _ = diag.shape
    b = C.shape[0]
    n = K * W + b
    r, c, v = [], [], []
    ii, jj = np.meshgrid(np.arange(W), np.arange(W), indexing="ij")
    for k in range(K):
        r.append(k * W + ii.ravel())
        c.append(k * W + jj.ravel())
        v.append(diag[k].ravel())
    low_r = (np.arange(1, K)[:, None, None] * W + ii[None]).ravel()
    low_c = (np.arange(0, K - 1)[:, None, None] * W + jj[None]).ravel()
    low_v = lower[:K - 1].ravel()
    r += [low_r, low_c]
    c += [low_c, low_r]
    v += [low_v, low_v]
    if b:
        bi, bj = np.meshgrid(np.arange(K * W), np.arange(b), indexing="ij")
        bv = B.reshape(K * W, b).ravel()
        r += [bi.ravel(), K * W + bj.ravel()]
        c += [K * W + bj.ravel(), bi.ravel()]
        v += [bv, bv]
        ci, cj = np.meshgrid(np.arange(b), np.arange(b), indexing="ij")
        r.append(K * W + ci.ravel())
        c.append(K * W + cj.ravel())
        v.append(C.ravel())
    A = sp.coo_matrix((np.concatenate(v), (np.concatenate(r),
                                           np.concatenate(c))), shape=(n, n))
    return A.tocsr()


def host_bordered_solve(diag, lower, B, C, rhs):
    """Solve [T, B; B^T, C] y = rhs on the host: LAPACK banded LU with
    partial pivoting (scipy.linalg.solve_banded) for the block-tridiagonal
    T, bandwidth 2W-1, and a dense Schur complement on the b-wide border.
    (SuperLU, behind scipy's spsolve, runs out of its own memory at the
    10,001-node KKT.)"""
    from scipy.linalg import solve_banded
    K, W, _ = diag.shape
    b = C.shape[0]
    n = K * W
    bw = 2 * W - 1
    ab = np.zeros((2 * bw + 1, n))
    ii, jj = np.meshgrid(np.arange(W), np.arange(W), indexing="ij")
    k = np.arange(K)[:, None, None]
    r, c = (k * W + ii).ravel(), (k * W + jj).ravel()
    ab[bw + r - c, c] = diag.ravel()
    k = np.arange(K - 1)[:, None, None]
    r, c = ((k + 1) * W + ii).ravel(), (k * W + jj).ravel()
    ab[bw + r - c, c] = lower[:K - 1].ravel()
    ab[bw + c - r, r] = lower[:K - 1].ravel()
    Bn = B.reshape(n, b)
    X = solve_banded((bw, bw), ab, np.column_stack([rhs[:n], Bn]))
    if not b:
        return X[:, 0]
    S = C - Bn.T @ X[:, 1:]
    z = np.linalg.solve(S, rhs[n:] - Bn.T @ X[:, 0])
    return np.concatenate([X[:, 0] - X[:, 1:] @ z, z])


def phase_host_reference(phase, out, ladder=(1e-2, 1e-4, 1e-6, 1e-8, 0.0)):
    """At a converged iterate: the BCR negative-pivot count vs the exact
    host inertia over `ladder` (which ends at delta = 0), and one BCR
    factor+solve vs a pivoted host solve at the delta the solver accepted
    last.

    For every delta > 0 the counts must be equal.  At delta = 0 the
    unpivoted elimination meets structurally zero pivots (variables with
    no curvature), which `_inv_sym` counts as failures so that the ladder
    climbs: there the device count may exceed the exact one but never
    fall below it, so the ladder never accepts a factor of wrong
    inertia."""
    import jax
    import jax.numpy as jnp
    opt = phase.optimizer
    kkt = opt.kkt
    nlp = kkt.nlp
    x, s, lamE, lamI, Mu = out[:5]
    niters = int(out[6])
    d_last = float(np.asarray(out[7])[niters - 1, 8])
    sig_tilde = _sig_tilde(opt, s, lamI, Mu)
    sigma = jnp.asarray(opt.ObjScale)
    fam = jax.jit(kkt._ad_impl)(x, lamE, lamI, sigma, nlp.consts_dev())[4]
    blocks = jax.jit(kkt._blocks_impl)(fam, sig_tilde)
    blocks = [np.asarray(b) for b in blocks]
    gammaE = opt.gammaE

    counts = []
    for delta in sorted(set(ladder) | {d_last}, reverse=True):
        fac, neigs = kkt.factor(x, lamE, lamI, opt.ObjScale, sig_tilde,
                                delta, gammaE)
        exact = host_block_inertia(*regularized_blocks(kkt, blocks, delta,
                                                       gammaE))
        counts.append((delta, neigs, exact))
        if delta == d_last:
            fac_last = fac
    log(f"[c.2] inertia (delta, device count, exact host), mE={nlp.numEq}: "
        f"{counts}")
    for delta, neigs, exact in counts:
        if delta > 0:
            check(neigs == exact, f"phase c.2: delta {delta}: device "
                  f"negative pivots {neigs}, exact inertia {exact}")
        else:
            check(neigs >= exact, f"phase c.2: delta 0: device count "
                  f"{neigs} below the exact inertia {exact}")

    # one factor+solve at the solver's last accepted delta vs the host.
    # The unpivoted BCR recursion amplifies rounding with depth (|r|/|b|
    # ~1e-6 at 10,001 nodes), so the check refines once through the same
    # device factor, with the residual taken on the host in f64: a faithful
    # factor contracts the error by its own error ratio, a wrong one does
    # not.
    reg = regularized_blocks(kkt, blocks, d_last, gammaE)
    A = assemble_sparse(*reg)
    perm = kkt._perm
    n = nlp.numPrimal

    def device_solve(r):
        dx, dl = jax.block_until_ready(kkt.solve(
            fac_last, jnp.asarray(r[perm][:n]), jnp.asarray(r[perm][n:])))
        y = np.zeros_like(r)
        y[perm] = np.concatenate([np.asarray(dx), np.asarray(dl)])
        return y

    rhs = np.zeros(A.shape[0])       # padded block slots stay zero
    rhs[perm] = np.random.default_rng(0).standard_normal(len(perm))
    t0 = time.perf_counter()
    y1 = device_solve(rhs)
    t_solve = time.perf_counter() - t0
    y2 = y1 + device_solve(rhs - A @ y1)
    t0 = time.perf_counter()
    yhost = host_bordered_solve(*reg, rhs)
    yhost += host_bordered_solve(*reg, rhs - A @ yhost)   # one refinement
    t_host = time.perf_counter() - t0
    rn = np.linalg.norm(rhs)
    res = [float(np.linalg.norm(A @ y - rhs) / rn) for y in (y1, y2, yhost)]
    bwd = [backward_error(A, y, rhs) for y in (y1, y2, yhost)]
    log(f"[c.2] KKT n={A.shape[0]} nnz={A.nnz} at delta {d_last}: "
        f"|r|/|b| device BCR {res[0]:.3e} (solve {t_solve:.4f} s), "
        f"refined once {res[1]:.3e}, host banded LU {res[2]:.3e} "
        f"({t_host:.3f} s); normwise backward error {bwd[0]:.3e} / "
        f"{bwd[1]:.3e} / {bwd[2]:.3e}; refined vs host rel "
        f"{rel(y2, yhost):.3e}")
    check(np.isfinite(y1).all(), "phase c.2: BCR solve not finite")
    check(bwd[1] <= 1e-10, f"phase c.2: refined BCR backward error {bwd[1]}")
    check(bwd[2] <= 1e-10, f"phase c.2: host backward error {bwd[2]}")


def backward_error(A, y, b):
    """Normwise backward error max|Ay - b| / (|A|_inf max|y| + max|b|):
    the smallest relative perturbation of A and b that y solves exactly
    (Rigal-Gaches), independent of the system's conditioning."""
    import scipy.sparse.linalg as spla
    r = A @ y - b
    return float(np.abs(r).max() / (spla.norm(A, np.inf) * np.abs(y).max()
                                     + np.abs(b).max()))


# -------------------------------------------------------------------- c.3
def phase_cpu_reference(nsegs=500):
    """The same solve on the default device and on the host CPU device."""
    import jax
    cpu = jax.devices("cpu")[0]
    t0 = time.perf_counter()
    pg = cartpole(nsegs, TIGHT)
    fg = pg.optimize()
    tg = time.perf_counter() - t0
    with jax.default_device(cpu):
        t0 = time.perf_counter()
        pc = cartpole(nsegs, TIGHT)
        fc = pc.optimize()
        tc = time.perf_counter() - t0
        where = {d.platform for leaf in jax.tree.leaves(pc._nlp.consts_dev())
                 for d in leaf.devices()}
    og, oc = pg.optimizer.LastObjVal, pc.optimizer.LastObjVal
    robj = abs(og - oc) / abs(oc)
    log(f"[c.3] CartPole {nsegs} segs, {jax.devices()[0].platform} vs cpu: "
        f"flags {fg}/{fc}, iters {pg.optimizer.LastIterNum}/"
        f"{pc.optimizer.LastIterNum}, obj {og:.12f}/{oc:.12f} (rel "
        f"{robj:.3e}), {tg:.3f} s / {tc:.3f} s with compile")
    check(where == {"cpu"}, f"phase c.3: host solve ran on {where}")
    check(fg == fc, f"phase c.3: flags {fg}/{fc}")
    check(fg == 0, f"phase c.3: flag {fg}")
    check(robj <= 1e-8, f"phase c.3: objective rel {robj}")


# --------------------------------------------------------------------- d
def _ensemble_inputs(nsegs, nscen, seed=3):
    phase = cartpole(nsegs)
    phase.transcribe()
    base = np.asarray(phase.makeSolverInput())
    rng = np.random.default_rng(seed)
    perts = [rng.normal(size=base.shape) * 1e-3 for _ in range(nscen)]
    return phase, base, perts


def phase_ensemble(nscen=64, nsegs=40):
    """solve_ensemble on one device vs per-lane optimize()."""
    from asset_asrl_tpu.parallel import solve_ensemble
    phase, base, perts = _ensemble_inputs(nsegs, nscen)
    t0 = time.perf_counter()
    res = solve_ensemble(phase, perturb_states=perts)
    dt = time.perf_counter() - t0
    flags = np.asarray(res["flags"])
    log(f"[d] ensemble of {nscen} CartPoles ({nsegs} segs): "
        f"{int((flags == 0).sum())}/{nscen} converged, iters "
        f"{int(res['iters'].min())}..{int(res['iters'].max())}, {dt:.3f} s "
        "with compile")
    check(bool((flags == 0).all()), f"phase d: flags {flags.tolist()}")
    opt = phase.optimizer
    for i in (0, nscen - 1):
        xi = opt.optimize(base + perts[i])
        r = rel(res["x"][i], xi)
        log(f"[d] lane {i}: optimize() flag {opt.ConvergeFlag}, x rel {r:.3e}")
        check(opt.ConvergeFlag == 0, f"phase d: lane {i} optimize flag")
        check(r <= 1e-8, f"phase d: lane {i} x rel {r}")


# --------------------------------------------------------------------- e
def phase_four(devices, nsegs=40, nscen=64, ens_segs=40):
    """Scenario-sharded ensemble and segment-sharded solve over `devices`
    vs their one-device counterparts (the same one-device programs as
    phases d and c.1, so a warm compile cache serves those)."""
    from jax.sharding import Mesh
    from asset_asrl_tpu.parallel import solve_ensemble
    devs = np.array(devices)

    phase, base, perts = _ensemble_inputs(ens_segs, nscen)
    t0 = time.perf_counter()
    ref = solve_ensemble(phase, perturb_states=perts)
    t1 = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = solve_ensemble(phase, perturb_states=perts,
                         mesh=Mesh(devs, ("scenario",)))
    tn = time.perf_counter() - t0
    flags, ref_flags = np.asarray(res["flags"]), np.asarray(ref["flags"])
    rx = rel(res["x"], ref["x"])
    log(f"[e] ensemble of {nscen} ({ens_segs} segs) sharded over "
        f"{len(devs)} devices vs one: {int((flags == 0).sum())}/{nscen} "
        f"converged, x rel {rx:.3e}, {tn:.3f} s / {t1:.3f} s with compile")
    check(bool((flags == ref_flags).all()), "phase e: ensemble flags differ")
    check(bool((flags == 0).all()), "phase e: ensemble flags not all 0")
    check(rx <= 1e-8, f"phase e: ensemble x rel {rx}")

    t0 = time.perf_counter()
    p1 = cartpole(nsegs, TIGHT)
    f1 = p1.optimize()
    t1 = time.perf_counter() - t0
    t0 = time.perf_counter()
    pn = cartpole(nsegs, TIGHT)
    pn.setKKTBackend("sharded", mesh=Mesh(devs, ("seg",)))
    fn = pn.optimize()
    tn = time.perf_counter() - t0
    rx = rel(pn.makeSolverInput(), p1.makeSolverInput())
    o1, on = p1.optimizer.LastObjVal, pn.optimizer.LastObjVal
    log(f"[e] CartPole {nsegs} segs sharded over {len(devs)} devices vs one: "
        f"flags {fn}/{f1}, iters {pn.optimizer.LastIterNum}/"
        f"{p1.optimizer.LastIterNum}, obj {on:.12f}/{o1:.12f}, x rel "
        f"{rx:.3e}, {tn:.3f} s / {t1:.3f} s with compile")
    check(fn == f1 == 0, f"phase e: flags {fn}/{f1}")
    check(abs(on - o1) / abs(o1) <= 1e-8, "phase e: sharded objective")
    check(rx <= 1e-8, f"phase e: sharded x rel {rx}")


# ------------------------------------------------------------------ main
def _timed(name, fn, *a, **kw):
    t0 = time.perf_counter()
    out = fn(*a, **kw)
    log(f"[{name}] passed in {time.perf_counter() - t0:.3f} s")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the 4-GPU sharded paths (phase e)")
    args = ap.parse_args(argv)

    import jax
    devices = jax.devices()
    if devices[0].platform != "gpu":
        sys.stderr.write(f"chip_smoke: JAX found no GPU (devices: "
                         f"{devices}); nothing was checked\n")
        return 2
    sys.path.insert(0, HERE)
    import jaxlib
    import asset_asrl_tpu  # noqa: F401  (enables x64, compile cache)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    for line in smi.splitlines():
        log(line)
    log(f"jax {jax.__version__} jaxlib {jaxlib.__version__}; device "
        f"{devices[0].device_kind} x {len(devices)}; compile cache "
        f"{jax.config.jax_compilation_cache_dir}")

    t_all = time.perf_counter()
    if args.four:
        check(len(devices) >= 4, f"--four needs 4 GPUs, found {len(devices)}")
        _timed("e", phase_four, devices[:4])
    else:
        phase, out = _timed("a", phase_main)
        _timed("c.2", phase_host_reference, phase, out)
        del phase, out
        _timed("b", phase_multiphase)
        _timed("c.1", phase_dense_reference)
        _timed("c.3", phase_cpu_reference)
        _timed("d", phase_ensemble)
    log(f"all phases passed in {time.perf_counter() - t_all:.3f} s")
    d = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
