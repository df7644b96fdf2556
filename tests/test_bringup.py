"""Device bring-up: one precision path on every backend, the compile-cache
location, the profiler, and `chip_smoke.py`'s refusal to run without a
GPU."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _solve(nsegs=16):
    import chip_smoke
    phase = chip_smoke.cartpole(nsegs)
    flag = phase.optimize()
    return flag, phase.optimizer.LastIterNum, phase.makeSolverInput()


def test_backend_name_does_not_change_the_solve(monkeypatch):
    """The solver takes no branch on the backend's name: a solve that
    believes it runs on a GPU gives bit-identical iterates."""
    import jax
    ref = _solve()
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    got = _solve()
    assert ref[0] == got[0] == 0
    assert ref[1] == got[1]
    assert np.array_equal(ref[2], got[2])


@pytest.mark.parametrize("from_env", [True, False])
def test_compile_cache_dir(tmp_path, from_env):
    """JAX_COMPILATION_CACHE_DIR is used verbatim; unset, the cache lives
    at one fixed in-checkout path that .gitignore lists."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    want = os.path.join(ROOT, ".jax_cache")
    if from_env:
        want = str(tmp_path / "cc")
        env["JAX_COMPILATION_CACHE_DIR"] = want
    out = subprocess.run(
        [sys.executable, "-c", "import asset_asrl_tpu, jax; "
         "print(jax.config.jax_compilation_cache_dir)"],
        cwd=str(tmp_path), env=dict(env, PYTHONPATH=ROOT),
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == want
    with open(os.path.join(ROOT, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_refuses_cpu(tmp_path, alone):
    """Without a GPU (and in a directory holding only the script) the
    smoke run exits non-zero and prints no result line."""
    script = os.path.join(ROOT, "chip_smoke.py")
    cwd = ROOT
    if alone:
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script, cwd = str(tmp_path / "chip_smoke.py"), str(tmp_path)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, script], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


@pytest.mark.parametrize("which", ["start_trace", "stop_trace"])
def test_profiler_propagates_failure(monkeypatch, tmp_path, which):
    import jax
    from asset_asrl_tpu.Utils import Profiler

    def boom(*a, **k):
        raise RuntimeError(f"{which} failed")

    started = []
    monkeypatch.setattr(jax.profiler, "start_trace",
                        boom if which == "start_trace"
                        else lambda d: started.append(d))
    monkeypatch.setattr(jax.profiler, "stop_trace",
                        boom if which == "stop_trace" else lambda: None)
    with pytest.raises(RuntimeError, match=which):
        with Profiler(tmp_path):
            pass
    if which == "stop_trace":
        assert started == [str(tmp_path)]


def test_profiler_traces(tmp_path):
    import jax
    import jax.numpy as jnp
    from asset_asrl_tpu.Utils import Profiler
    with Profiler(tmp_path) as prof:
        jax.block_until_ready(jax.jit(lambda x: x * 2.0)(jnp.ones(8)))
    assert prof.elapsed is not None and prof.elapsed >= 0.0
    assert list(tmp_path.rglob("*.xplane.pb"))
