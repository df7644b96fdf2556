"""Tests that need an NVIDIA GPU.  They decide in a fixture, skip
elsewhere, and run on the card with

    JAX_PLATFORMS=cuda,cpu python -m pytest tests -m gpu
"""

import pytest

import chip_smoke as cs

pytestmark = pytest.mark.gpu


@pytest.fixture
def gpu():
    import jax
    devs = [d for d in jax.devices() if d.platform == "gpu"]
    if not devs:
        pytest.skip("needs a GPU (on the card: JAX_PLATFORMS=cuda,cpu)")
    return devs[0]


def test_main_path_on_gpu(gpu):
    """phase.optimize() at 401 nodes with its state on the card, and the
    exact-inertia / host banded-LU references at the converged iterate."""
    phase, out = cs.phase_main(200)
    assert {d.platform for d in out[0].devices()} == {"gpu"}
    cs.phase_host_reference(phase, out)


def test_gpu_matches_cpu(gpu):
    cs.phase_cpu_reference(100)


def test_ensemble_on_gpu(gpu):
    cs.phase_ensemble(nscen=16, nsegs=16)
