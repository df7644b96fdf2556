"""Generate docs/examples pages with measured timings.

Runs each flagship example as a subprocess on the host CPU backend
(x64), records wall time and the example's printed results, and writes
one markdown page per example plus an index, mirroring the reference's
Sphinx example pages with measured timings (`doc/examples/*.rst`).
"""

import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "docs", "examples")

CASES = [
    ("CartPole", "examples/CartPole.py",
     "Swing-up of an inverted pendulum on a cart, minimum-effort control "
     "with a runtime mass-matrix inversion (64 LGL5 segments).",
     "12 IPM iterations, 28 ms on an i7-9750H "
     "(`doc/examples/CartPole.rst:143`); objective 58.832 "
     "(`test_CartPole.py:38`)."),
    ("Brachistochrone", "examples/Brachistochrone.py",
     "Classic minimum-time bead-on-wire problem.",
     "Analytic optimum ~0.998 s for the (0,0)->(1,-1) drop."),
    ("HyperSensitive", "examples/HyperSens.py",
     "Boundary-layer problem over a tf=10000 horizon; the classic "
     "adaptive-mesh benchmark (LGL7).",
     "8 mesh iterations, 46 ms total CPU on an i7-13700k "
     "(`doc/examples/HyperSensitive.rst:121`)."),
    ("Reentry", "examples/Reentry.py",
     "Space-shuttle reentry, maximum cross-range, with and without a "
     "leading-edge heating-rate constraint.",
     "90 ms total, objective 34.141 deg (Betts) on an i9-12900k; "
     "heat-constrained +24 iters, 60 ms, 30.63 deg "
     "(`doc/examples/ReentryExample.rst:283-285`)."),
    ("Delta3", "examples/Delta3Launch.py",
     "Delta III four-phase launch to GTO, maximum final mass, linked "
     "phases with per-phase thrust models (160 LGL3 segments).",
     "~60 ms on an i9-12900k (`doc/examples/Delta3.rst:340`); final "
     "mass 7529.7499 kg (`test_Delta3Launch.py:152`)."),
    ("MultiPhaseCannon", "examples/UpdatedInterface/MultiPhaseCannon.py",
     "Dymos multi-phase cannonball: choose the ball radius maximizing "
     "range at fixed launch energy (named-variable interface).",
     "Dymos reference optimum: ~3.18 km range at ~4.2 cm radius."),
    ("VanDerPol", "examples/VanDerPol.py",
     "Van der Pol oscillator optimal control (dymos benchmark).",
     "Dymos reference objective ~5.47 over tf=15."),
    ("GoddardRocket", "examples/GoddardRocket.py",
     "Goddard rocket maximum-altitude ascent with a singular thrust arc, "
     "solved single-phase and as a 3-phase problem with an explicit "
     "singular-arc path constraint.",
     "Single- vs 3-phase final altitudes agree to < 0.3 ft "
     "(`tests/test_fullproblems2.py`)."),
    ("BrysonDenham", "examples/BrysonDenham.py",
     "State-constrained double integrator (Bryson & Ho).",
     "Analytic objective 4/(9*l) = 4 at l = 1/9; measured 4.00002 at "
     "32 LGL5 segments (`tests/test_examples_more.py`)."),
    ("AnalyticExample", "examples/AnalyticExample.py",
     "LQR-like problem with closed-form control AND costates; validates "
     "the covector mapping of `returnCostateTraj`.",
     "max |U - U*| = 2.6e-4, max |costate - analytic| = 7e-3 at "
     "20 LGL5 segments."),
    ("MountainCar", "examples/MountainCar.py",
     "Minimum-time mountain-car escape (dymos): the engine is too weak "
     "to climb directly, so the optimal policy oscillates.",
     "Dymos reference escape time ~103; measured 103.98 at 128 LGL3."),
    ("FreeFlyingRobot", "examples/FreeFlyingRobot.py",
     "Minimum-fuel planar free-flying robot slew with 4 one-sided "
     "thrusters (arXiv:1905.11898).",
     "Published J* ~= 7.910; measured 7.9147 at 128 LGL5."),
    ("BikeObstacle", "examples/BikeObstacle.py",
     "Minimum-time bicycle steering around a circular obstacle "
     "(arXiv:2003.00142), elliptic-margin path inequality.",
     "Measured transit 5.045 s at 128 LGL3 (straight-line lower bound "
     "100/29 = 3.45 s)."),
    ("Zermelo", "examples/Zermelo.py",
     "Zermelo's navigation problem over four wind fields.",
     "No-wind time equals straight-line distance/speed exactly "
     "(`tests/test_examples_more.py`)."),
    ("MultiPhaseZermelo", "examples/MultiPhaseZermelo.py",
     "Waypoint navigation as linked phases with forward-link continuity.",
     "Each leg's time is positive and the phases chain continuously."),
    ("SimpleLowThrust", "examples/SimpleLowThrust.py",
     "Planar circular orbit raising r=1 -> r=2 at a=0.02, time- and "
     "mass-optimal, with costate plots.",
     "Time-optimal tof ~= 18.27 canonical units (measured; "
     "`tests/test_examples_fast.py`)."),
    ("BettsLowThrust", "examples/BettsLowThrust.py",
     "Betts' 10-6 low-thrust orbit transfer (Practical Methods 3rd ed.), "
     "modified-equinoctial dynamics with J2.",
     "Betts' published final weight 0.22018 lb (matched; "
     "`tests/test_fullproblems2.py`)."),
    ("MinimumTimeToClimb", "examples/MinimumTimeToClimb.py",
     "Bryson's supersonic minimum time to climb (ICLOCS2 SI "
     "reformulation) with smooth aero/thrust fits.",
     "Published minimum climb time ~324 s; measured 321.7 s at "
     "50 LGL5 segments."),
    ("MinimumTimeToClimbTables", "examples/MinimumTimeToClimbTables.py",
     "Same problem driven by tabulated aero/thrust data through "
     "differentiable InterpTable1D/2D lookups.",
     "Matches the smooth-fit climb time within the table resolution."),
    ("TopputtoLowThrust", "examples/TopputtoLowThrust.py",
     "Planar polar low-thrust raising r=1 -> r=4, time- then "
     "fuel-optimal with terminal coast (Topputto & Zhang 2014).",
     "Measured: time-optimal tof 55.55, fuel-optimal tof 115.8 with "
     "terminal throttle at its floor."),
    ("DionysusLowThrust", "examples/DionysusLowThrust.py",
     "Mass-optimal Earth->Dionysus interplanetary low-thrust transfer "
     "(Junkins & Taheri).",
     "Published optimum ~2718 kg of the 4000 kg stack; measured "
     "2715.93 kg at 150 LGL3 segments."),
    ("OptimalDocking", "examples/OptimalDocking.py",
     "Spacecraft docking with obstacle keep-out (Form 2).",
     "Converges with docking time in the published 120-260 s band."),
    ("ParallelParking", "examples/ParallelParking.py",
     "Time-optimal parallel parking (Li/Wang/Chu 2016 case 7): two "
     "linked phases with obstacle corner constraints.",
     "Published maneuver time 18.426 s; ours within 1%."),
    ("OrbitContinuation", "examples/OrbitContinuation.py",
     "CR3BP L1 Lyapunov and Northern Halo periodic-orbit families by "
     "pseudo-arclength-style continuation through subVariables (no "
     "re-transcription between family members).",
     "Periodicity residuals < 1e-8 along both families."),
    ("Heteroclinic", "examples/Heteroclinic.py",
     "Heteroclinic connection between L1/L2 Lyapunov orbits in the "
     "Earth-Moon CR3BP via invariant-manifold seeding.",
     "Connection closes with Jacobi-constant drift at integrator "
     "tolerance."),
    ("HangingChain", "examples/HangingChain.py",
     "Catenary family: minimum potential energy at fixed chain length, "
     "swept over lengths with a Jet ensemble.",
     "Long chains sag below both anchors; length constraint holds via "
     "an integral static-parameter function."),
    ("MultiSpacecraftOptimization",
     "examples/MultiSpacecraftOptimization.py",
     "N-spacecraft rendezvous with shared link parameters across "
     "phases (the scenario-ensemble flagship; scales to 512 craft "
     "via `parallel.solve_ensemble`).",
     "Reference `examples/MultiSpacecraftOptimization.py:69-121`."),
    ("MeshRefinement-CartPole", "examples/MeshRefinement/CartPole.py",
     "CartPole re-solved under adaptive mesh refinement.",
     "Objective matches the fixed-mesh 58.832 at the mesh tolerance."),
    ("MeshRefinement-HyperSensLong",
     "examples/MeshRefinement/HyperSensLong.py",
     "HyperSensitive with tf=10000: the boundary-layer stress test of "
     "error-equidistributed refinement.",
     "Reference `doc/examples/HyperSensitive.rst:121`: 8 mesh "
     "iterations, 46 ms CPU."),
]


_CASE_ENV = {
    # one sweep of a 3-spacecraft stack keeps the docs run under the
    # per-case timeout; the 512-craft ensembles are the parallel.py tests
    "MultiSpacecraftOptimization": {"MSO_N": "3", "MSO_SWEEPS": "1"},
}


def run_case(name, script, desc, ref):
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    env.update(_CASE_ENV.get(name, {}))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, os.path.join(ROOT, script)],
                          capture_output=True, text=True, env=env,
                          timeout=3000, cwd=ROOT)
    dt = time.perf_counter() - t0
    lines = [ln for ln in proc.stdout.splitlines()
             if ln.strip() and "Platform" not in ln
             and "WARNING" not in ln]
    tail = "\n".join(lines[-14:])
    page = f"""# {name}

{desc}

Source: [`{script}`](../../{script})  |  Reference: the upstream's
`{script}`

## Measured (host CPU backend, x64)

Wall time including transcription and XLA compilation:
**{dt:.1f} s** (first run on the CPU; jit-cached reruns are dominated by
the solve itself).  This is not a GPU speed: those come from runs on the
card (`chip_smoke.py`, `PERF.md`).

```
{tail}
```

## Reference's published numbers

{ref}

The reference timings are hand-measured C++/MKL numbers on desktop
CPUs at these small mesh sizes, where per-iteration work is microseconds
and Pardiso is in-cache; the block-KKT design targets the large-mesh
regime — see `bench.py` (10,001 collocation nodes) and
`docs/tutorials/Architecture.md`.
"""
    with open(os.path.join(OUT, f"{name}.md"), "w") as f:
        f.write(page)
    ok = proc.returncode == 0
    print(f"{name}: {'OK' if ok else 'FAIL rc=' + str(proc.returncode)} "
          f"{dt:.1f}s")
    if not ok:
        print(proc.stdout[-2000:])
        print(proc.stderr[-2000:])
    return name, dt, ok


def main():
    os.makedirs(OUT, exist_ok=True)
    rows = []
    only = sys.argv[1:] if len(sys.argv) > 1 else None
    for name, script, desc, ref in CASES:
        if only and name not in only:
            continue
        rows.append(run_case(name, script, desc, ref))
    if only:
        return   # partial regeneration: keep the full index
    idx = ["# Worked examples (with measured timings)", "",
           "Each page runs the example end-to-end and records the",
           "printed results + wall time; regenerate with",
           "`python tools/gen_example_docs.py`.", "",
           "| Example | total wall (s, CPU backend, incl. compile) |",
           "|---|---|"]
    for name, dt, ok in rows:
        idx.append(f"| [{name}]({name}.md) | {dt:.1f} |")
    with open(os.path.join(OUT, "README.md"), "w") as f:
        f.write("\n".join(idx) + "\n")


if __name__ == "__main__":
    main()
