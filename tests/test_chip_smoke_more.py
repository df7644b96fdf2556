"""`chip_smoke.py`'s CPU-reference and ensemble phases at tiny sizes on
the CPU."""

import chip_smoke as cs


def test_phase_cpu_reference():
    cs.phase_cpu_reference(40)


def test_phase_ensemble():
    cs.phase_ensemble(nscen=8, nsegs=16)
