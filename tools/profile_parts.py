"""Fine-grained timing of solver sub-components at bench scale.

Times each piece of the per-iteration pipeline separately so
optimization targets facts: Ruiz, GJ inverse (f64 vs f32), BCR level
products, jac vs hess family AD (f64 vs f32),
assembly sub-parts, value-only pass (line search), solve sweeps.
"""
import os
import sys
import time
import numpy as np
import jax
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import importlib.util
spec = importlib.util.spec_from_file_location("bench", os.path.join(ROOT, "bench.py"))
bench = importlib.util.module_from_spec(spec)
spec.loader.exec_module(bench)

from asset_asrl_tpu.Solvers import kkt_block as KB

nsegs = int(sys.argv[1]) if len(sys.argv) > 1 else 5000
t0 = time.time()
phase = bench.build_phase(nsegs)
phase.transcribe()
print("transcribe", round(time.time() - t0, 1), flush=True)
opt = phase.optimizer
kkt = opt.kkt
nlp = kkt.nlp
bs = kkt.bs
print("K", bs.K, "W", bs.W, "b", bs.b, flush=True)
x, s, lamE, lamI = opt._init_state(phase.makeSolverInput(), opt.initMu)
consts = nlp.consts_dev()
sig = jnp.asarray(1.0)


def timed(name, fn, *args, reps=8):
    try:
        t0 = time.time()
        out = jax.block_until_ready(fn(*args))
        tc = time.time() - t0
        t0 = time.time()
        for _ in range(reps):
            out = jax.block_until_ready(fn(*args))
        print(f"{name}: {1000 * (time.time() - t0) / reps:.1f} ms "
              f"(compile {tc:.0f}s)", flush=True)
        return out
    except Exception as e:
        print(f"{name}: FAILED {type(e).__name__}: {str(e)[:120]}",
              flush=True)
        return None


# ---- family AD pieces ----
def jac_only(x):
    outs = []
    for fam, cc in zip(kkt._eq, consts[1]):
        outs.append(fam["vj"](x[fam["Vidx"]], cc)[1])
    return outs


def hess_only(x):
    outs = []
    for fam, cc in zip(kkt._eq, consts[1]):
        if fam["need_hess"]:
            outs.append(fam["hess"](x[fam["Vidx"]], cc,
                                    lamE[fam["rows"]]))
    return outs


def hess_f32(x):
    outs = []
    for fam, cc in zip(kkt._eq, consts[1]):
        if fam["need_hess"]:
            outs.append(fam["hess"](
                x[fam["Vidx"]].astype(jnp.float32),
                jnp.asarray(cc, jnp.float32),
                lamE[fam["rows"]].astype(jnp.float32)))
    return outs


timed("jac_eq_f64", jax.jit(jac_only), x)
timed("hess_eq_f64", jax.jit(hess_only), x)

# value-only pass (line-search cost)
timed("eval_oc", jax.jit(nlp.eval_obj_cons_impl), x, consts)

# ---- assembly pieces ----
_, _, _, _, famvals = jax.jit(kkt._ad_impl)(x, lamE, lamI, sig, consts)
famvals = jax.block_until_ready(famvals)
st = jnp.ones((nlp.numIq,))
blocks = jax.block_until_ready(jax.jit(kkt._blocks_impl)(famvals, st))


def patches_only(famvals, st):
    K, W = bs.K, bs.W
    vparts = []
    for i, fam in enumerate(kkt._eq):
        vparts.append(famvals["jx_eq"][i].ravel())
        if fam["need_hess"]:
            vparts.append(famvals["hx_eq"][i].ravel())
    for i, fam in enumerate(kkt._iq):
        jx = famvals["jx_iq"][i]
        stl = st[fam["rows"]]
        jst = jx * stl[:, :, None]
        h = (jst[:, :, :, None] * jx[:, :, None, :]).sum(1)
        if fam["need_hess"]:
            h = h + famvals["hx_iq"][i]
        vparts.append(h.ravel())
    for i, fam in enumerate(kkt._obj):
        if fam["need_hess"]:
            vparts.append(famvals["hx_obj"][i].ravel())
    diag = jnp.zeros((K, W, W))
    lower = jnp.zeros((K, W, W))
    for vi, plan in kkt._patch_plans:
        vals2d = vparts[vi].reshape(-1, plan["E"])
        diag, lower = KB._apply_patch_plan(plan, vals2d, diag, lower)
    return diag, lower


timed("blocks_patches_only", jax.jit(patches_only), famvals, st)


def scatters_only(famvals, st):
    K, W, b = bs.K, bs.W, bs.b
    vparts = []
    for i, fam in enumerate(kkt._eq):
        vparts.append(famvals["jx_eq"][i].ravel())
        if fam["need_hess"]:
            vparts.append(famvals["hx_eq"][i].ravel())
    for i, fam in enumerate(kkt._iq):
        jx = famvals["jx_iq"][i]
        stl = st[fam["rows"]]
        jst = jx * stl[:, :, None]
        h = (jst[:, :, :, None] * jx[:, :, None, :]).sum(1)
        if fam["need_hess"]:
            h = h + famvals["hx_iq"][i]
        vparts.append(h.ravel())
    for i, fam in enumerate(kkt._obj):
        if fam["need_hess"]:
            vparts.append(famvals["hx_obj"][i].ravel())
    vbuf = jnp.concatenate([p.ravel() for p in vparts]
                           + [jnp.zeros((1,))])
    ds, dt_ = kkt._d_scatter
    diag = jnp.zeros((K * W * W,))
    if len(ds):
        diag = diag.at[dt_].add(vbuf[ds])
    ls_, lt = kkt._l_scatter
    lower = jnp.zeros((K * W * W,))
    if len(ls_):
        lower = lower.at[lt].add(vbuf[ls_])
    B = vbuf[kkt._tB].sum(-1) if b else None
    return diag, lower, B


timed("blocks_scatters+gathers", jax.jit(scatters_only), famvals, st)

# iq condensation alone
def iqcond(famvals, st):
    outs = []
    for i, fam in enumerate(kkt._iq):
        jx = famvals["jx_iq"][i]
        stl = st[fam["rows"]]
        jst = jx * stl[:, :, None]
        outs.append((jst[:, :, :, None] * jx[:, :, None, :]).sum(1))
    return outs


timed("iq_condensation", jax.jit(iqcond), famvals, st)

# ---- factorization pieces ----
diag, lower, B, C = blocks
dreg = diag + jnp.where(kkt._diag_sign > 0, 1e-5,
                        jnp.where(kkt._diag_sign < 0, -1e-10, 0.0)) \
    + kkt._diag_fix
Creg = C + jnp.where(kkt._c_sign > 0, 1e-5,
                     jnp.where(kkt._c_sign < 0, -1e-10, 0.0))

timed("ruiz_f64", jax.jit(KB._ruiz_equilibrate), dreg, lower, B, Creg)
timed("bcr_factor_f64_noruiz",
      jax.jit(lambda d, l, Bm, Cm: KB.bcr_factor(d, l, Bm, Cm)),
      dreg, lower, B, Creg)
timed("gj_inv_f64_xla", jax.jit(KB._inv_gj_pivots), dreg)
d32 = dreg.astype(jnp.float32)
timed("gj_inv_f32_xla",
      jax.jit(lambda D: KB._inv_gj_pivots(D)), d32)

# one BCR level's packed products in f64 vs f32
Ke = bs.K // 2
X32 = jnp.ones((Ke, 3 * bs.W, bs.W), jnp.float32)
R32 = jnp.ones((Ke, bs.W, 3 * bs.W), jnp.float32)
Di32 = jnp.ones((Ke, bs.W, bs.W), jnp.float32)
X64 = X32.astype(jnp.float64)
R64 = R32.astype(jnp.float64)
Di64 = Di32.astype(jnp.float64)
timed("bcr_level0_products_f64",
      jax.jit(lambda a, b_, c: KB._bmm(KB._bmm(a, b_), c)), X64, Di64, R64)
timed("bcr_level0_products_f32",
      jax.jit(lambda a, b_, c: KB._bmm(KB._bmm(a, b_), c)), X32, Di32, R32)

# ---- solve sweeps ----
fac, neigs = jax.block_until_ready(
    jax.jit(kkt._factor_blocks_impl)(blocks, jnp.asarray(1e-5),
                                     jnp.asarray(1e-10)))
rx = jnp.zeros((nlp.numPrimal,))
rE = jnp.ones((nlp.numEq,))


def sweep_only(fac, rx, rE):
    full = jnp.zeros((bs.K * bs.W + bs.b,))
    full = full.at[kkt._perm].set(jnp.concatenate([rx, rE]))
    rblk = full[:bs.K * bs.W].reshape(bs.K, bs.W)
    rbrd = full[bs.K * bs.W:]
    y, z = KB.bcr_solve(fac, rblk, rbrd)
    return y


timed("solve_single_sweep", jax.jit(sweep_only), fac, rx, rE)
mv = KB._block_matvec((dreg, lower, B, Creg))
timed("block_matvec", jax.jit(mv), jnp.ones((bs.K, bs.W)),
      jnp.ones((bs.b,)))
print("PARTS DONE", flush=True)
