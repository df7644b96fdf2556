import os
import sys
import time
import numpy as np
import jax
if os.environ.get("PLAT"):
    jax.config.update("jax_platforms", os.environ["PLAT"])
import jax.numpy as jnp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
nsegs = int(sys.argv[1]) if len(sys.argv) > 1 else 500
sys.argv = [sys.argv[0]]
import importlib.util
spec = importlib.util.spec_from_file_location("bench", os.path.join(ROOT, "bench.py"))
bench = importlib.util.module_from_spec(spec)
spec.loader.exec_module(bench)

print("backend:", jax.default_backend(), "nsegs:", nsegs, flush=True)
t0 = time.perf_counter()
phase = bench.build_phase(nsegs)
phase.transcribe()
print("transcribe:", round(time.perf_counter() - t0, 1), flush=True)
opt = phase.optimizer
kkt = opt.kkt
bs = kkt.bs
print("K", bs.K, "W", bs.W, "b", bs.b, "nlevels", kkt.nlevels, flush=True)

x, s, lamE, lamI = opt._init_state(phase.makeSolverInput(), opt.initMu)
sigma = jnp.asarray(1.0)


def timeit(name, fn, *args):
    t0 = time.perf_counter()
    lo = jax.jit(fn).lower(*args)
    t1 = time.perf_counter()
    comp = lo.compile()
    t2 = time.perf_counter()
    print(f"{name}: lower {t1-t0:.1f}s compile {t2-t1:.1f}s", flush=True)
    return comp


c_ad = timeit("ad_impl", kkt._ad_impl, x, lamE, lamI, sigma)
out = jax.block_until_ready(c_ad(x, lamE, lamI, sigma))
obj, cE, cIraw, rd, famvals = out
sig_tilde = jnp.ones((kkt.nlp.numIq,))

blocks = jax.jit(kkt._blocks_impl)(famvals, sig_tilde)
timeit("blocks_impl", kkt._blocks_impl, famvals, sig_tilde)

delta = jnp.asarray(1e-4)
gammaE = jnp.asarray(1e-8)
c_fac = timeit("factor_blocks", kkt._factor_blocks_impl, blocks, delta,
               gammaE)
fac, neigs = jax.block_until_ready(c_fac(blocks, delta, gammaE))
print("neigs", int(neigs), "mE", kkt.nlp.numEq, flush=True)

rhs_x = jnp.zeros((kkt.nlp.numPrimal,))
rhs_E = -cE
c_solve = timeit("solve", kkt._solve_impl, fac, rhs_x, rhs_E)

# runtime of each piece
for name, fn, args in [("ad", c_ad, (x, lamE, lamI, sigma)),
                       ("factor", c_fac, (blocks, delta, gammaE)),
                       ("solve", c_solve, (fac, rhs_x, rhs_E))]:
    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(5):
        r = jax.block_until_ready(fn(*args))
    print(f"{name} runtime: {(time.perf_counter()-t0)/5*1000:.1f} ms",
          flush=True)

# step quality: dx from a plain solve; check econ reduction linearly
dx, dlamE = c_solve(fac, rhs_x, rhs_E)
print("dx norm", float(jnp.linalg.norm(dx)), "finite",
      bool(jnp.all(jnp.isfinite(dx))), flush=True)
obj2, cE2, cI2 = kkt.nlp.eval_obj_cons(x + dx)
print("econ before", float(jnp.max(jnp.abs(cE))), "after full step",
      float(jnp.max(jnp.abs(cE2))), flush=True)
