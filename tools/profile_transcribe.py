import os
import sys
import time
if os.environ.get("PLAT"):
    os.environ["JAX_PLATFORMS"] = os.environ["PLAT"]
import cProfile
import pstats
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import jax
jax.config.update("jax_enable_x64", True)
import importlib.util
spec = importlib.util.spec_from_file_location("bench", os.path.join(ROOT, "bench.py"))
bench = importlib.util.module_from_spec(spec)
spec.loader.exec_module(bench)
nsegs = int(sys.argv[1]) if len(sys.argv) > 1 else 5000
t0 = time.time()
phase = bench.build_phase(nsegs)
print("build_phase", round(time.time() - t0, 2), flush=True)
pr = cProfile.Profile()
pr.enable()
t0 = time.time()
phase.transcribe()
dt = time.time() - t0
pr.disable()
print("transcribe", round(dt, 2), flush=True)
st = pstats.Stats(pr)
st.sort_stats("cumulative").print_stats(35)
