"""`chip_smoke.py`'s phases at tiny sizes on the CPU: the same checks the
smoke run makes on the card at full width."""

import pytest

import chip_smoke as cs


@pytest.fixture(scope="module")
def main_phase():
    return cs.phase_main(40)


def test_phase_main(main_phase):
    phase, out = main_phase
    assert int(out[5]) == 0
    assert abs(phase.optimizer.LastObjVal - cs.CARTPOLE_OBJ) < 0.1


def test_phase_host_reference(main_phase):
    cs.phase_host_reference(*main_phase)


def test_phase_dense_reference():
    cs.phase_dense_reference(40)


def test_host_block_inertia_matches_eigvalsh():
    """The host inertia routine against a dense eigendecomposition of the
    assembled matrix (random symmetric blocks, border included)."""
    import numpy as np
    rng = np.random.default_rng(5)
    K, W, b = 6, 4, 3
    diag = rng.normal(size=(K, W, W))
    diag = diag + diag.transpose(0, 2, 1)
    lower = rng.normal(size=(K, W, W)) * 0.3
    B = rng.normal(size=(K, W, b)) * 0.2
    C = rng.normal(size=(b, b))
    C = C + C.T
    A = cs.assemble_sparse(diag, lower, B, C).toarray()
    assert np.allclose(A, A.T)
    assert cs.host_block_inertia(diag, lower, B, C) == \
        int((np.linalg.eigvalsh(A) < 0).sum())
