import os
import sys
import time
import numpy as np
import jax
if os.environ.get("PLAT"):
    jax.config.update("jax_platforms", os.environ["PLAT"])
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
nsegs = int(sys.argv[1]) if len(sys.argv) > 1 else 500

sys.argv = [sys.argv[0]]
import importlib.util
spec = importlib.util.spec_from_file_location("bench", os.path.join(ROOT, "bench.py"))
bench = importlib.util.module_from_spec(spec)
spec.loader.exec_module(bench)

from asset_asrl_tpu.Solvers.fused import build_fused_alg

print("backend:", jax.default_backend(), "nsegs:", nsegs)
phase = bench.build_phase(nsegs)
phase.transcribe()
opt = phase.optimizer
kkt = opt.kkt
fn = build_fused_alg(kkt, opt._opts_snapshot(), "OPT")
x, s, lamE, lamI = opt._init_state(phase.makeSolverInput(), opt.initMu)
mu0 = jnp.asarray(opt.initMu)
t0 = time.perf_counter()
out = fn(x, s, lamE, lamI, mu0, kkt.nlp.consts_dev())
jax.block_until_ready(out[0])
t1 = time.perf_counter()
print("compile+run1:", t1 - t0, "flag", int(out[5]), "iters", int(out[6]))
t0 = time.perf_counter()
out = fn(x, s, lamE, lamI, mu0, kkt.nlp.consts_dev())
jax.block_until_ready(out[0])
t1 = time.perf_counter()
ni = int(out[6])
print("run2:", t1 - t0, "iters", ni, "it/s", ni / (t1 - t0))
infos = np.asarray(out[7][:ni])
print("obj", infos[-1][0], "kkt", infos[-1][1], "econ", infos[-1][2])
from asset_asrl_tpu.Solvers.fused import INFO_FIELDS
print("   ".join(INFO_FIELDS))
for r in infos[:12]:
    print(" ".join(f"{v:9.2e}" for v in r))
for r in infos[-3:]:
    print(" ".join(f"{v:9.2e}" for v in r))
