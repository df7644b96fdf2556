"""`chip_smoke.py`'s multi-phase and multi-device phases at tiny sizes on
the CPU (8 virtual devices)."""

import jax

import chip_smoke as cs


def test_phase_multiphase():
    # 16 segments per phase land within 0.001 kg of the reference too
    cs.phase_multiphase(nsegs=16)


def test_phase_four():
    cs.phase_four(jax.devices()[:4], nsegs=40, nscen=8, ens_segs=16)
