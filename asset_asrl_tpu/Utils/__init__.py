"""asset_asrl_tpu.Utils — misc support (reference `src/Utils/` + `asset.Utils`
bindings: core counts, timers)."""

import os
import time


def get_core_count():
    return os.cpu_count() or 1


class Timer:
    """Perf timer (reference `src/Utils/Timer.h`)."""

    def __init__(self):
        self._t0 = None
        self._acc = 0.0

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self):
        if self._t0 is not None:
            self._acc += time.perf_counter() - self._t0
            self._t0 = None

    def count(self):
        return self._acc

    def reset(self):
        self._acc = 0.0
        self._t0 = None


class Profiler:
    """JAX profiler integration (SURVEY section 5.1): traces device
    execution for TensorBoard / xprof, and records the wall time of the
    traced block in `.elapsed`.

        with ast.Utils.Profiler("/tmp/trace"):
            phase.optimize()

    A failing start_trace/stop_trace raises.
    """

    def __init__(self, logdir=None):
        if logdir is None:
            import tempfile
            logdir = os.path.join(tempfile.gettempdir(), "asset_trace")
        self.logdir = str(logdir)
        self.elapsed = None
        self._t0 = None

    def __enter__(self):
        import jax
        jax.profiler.start_trace(self.logdir)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        import jax
        self.elapsed = time.perf_counter() - self._t0
        jax.profiler.stop_trace()
        return False
