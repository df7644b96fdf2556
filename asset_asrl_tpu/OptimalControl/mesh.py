"""Adaptive mesh refinement.

Reference: `ODEPhaseBase.cpp:1443-1584` (checkMesh/updateMesh +
error-equidistributed re-binning, `MeshIterateInfo.h`).  Estimators:

* "integrator": re-integrate each segment with the adaptive DOPRI54 stepper
  and compare endpoints (reference get_meshinfo_integrator).
* "deboor"/"polynomial"/"residual": evaluate the collocation residual
  |p'(tau) - h f(p(tau))| of the solved Hermite interpolant at off-collocation
  test points (a defect-residual variant of the reference's polynomial
  derivative-jump estimator).

updateMesh: new segment count from the error^(1/(order+1)) law clamped by
MeshRedFactor/MeshIncFactor/Min/MaxSegments, with error-equidistributed bins.
"""

from __future__ import annotations

import numpy as np

from ..Solvers.psiopt import ConvergenceFlags

_TEST_TAUS = np.array([0.3, 0.7])


def _segment_coefs(phase):
    """Hermite coefficients of every solved segment in ONE pass.

    Returns (coef (S, deg+1, XV), hs (S,), fs_all (N, XV)): per segment the
    degree-(2cs-1) polynomial in local sigma matching (x_j, h f_j) at the
    scheme's cardinal taus.  The node tangents come from one vmapped RHS
    evaluation over all N nodes — the per-segment/per-node host loops this
    replaces cost O(S) device dispatches per mesh iteration at the 10k-node
    scale this framework targets."""
    import jax
    sch = phase._scheme
    cs = phase._cs
    XV = phase.XV
    deg = 2 * cs - 1
    T = phase.tf - phase.t0
    traj = phase._traj
    rows = np.concatenate(
        [traj, np.tile(phase._odeparams, (traj.shape[0], 1))], axis=1)
    fs_all = np.asarray(jax.vmap(phase.ode.vf().trace)(rows))[:, :XV]
    A = np.zeros((2 * cs, deg + 1))
    for j, tc in enumerate(sch.cardinal_tau):
        A[j] = tc ** np.arange(deg + 1)
        r = np.zeros(deg + 1)
        r[1:] = np.arange(1, deg + 1) * tc ** np.arange(deg)
        A[cs + j] = r
    Ainv = np.linalg.inv(A)
    hs = np.diff(phase.seg_bounds) * T                       # (S,)
    xs = traj[phase.seg_nodes, :XV]                          # (S, cs, XV)
    fs = fs_all[phase.seg_nodes]                             # (S, cs, XV)
    rhs = np.concatenate([xs, hs[:, None, None] * fs], axis=1)
    coef = np.einsum("ij,sjx->six", Ainv, rhs)               # (S,deg+1,XV)
    return coef, hs, fs_all


def _residual_errors(phase):
    """Per-segment defect-residual error estimate |p'(sig) - h f(p(sig))|
    at off-collocation test points, vectorized: one vmapped RHS call over
    all (segment, test-point) pairs instead of per-node host dispatches."""
    import jax
    from .lgl import lagrange_weights
    XV, UV = phase.XV, phase.UV
    T = phase.tf - phase.t0
    sch = phase._scheme
    cs = phase._cs
    deg = 2 * cs - 1
    S = phase.numSegs
    coef, hs, _ = _segment_coefs(phase)
    us = phase._traj[phase.seg_nodes, XV + 1:]               # (S, cs, UV)
    t0seg = phase.t0 + phase.seg_bounds[:-1] * T             # (S,)

    sig = _TEST_TAUS                                         # (ntau,)
    pw = sig[:, None] ** np.arange(deg + 1)                  # (ntau, deg+1)
    dpw = np.zeros((len(sig), deg + 1))
    dpw[:, 1:] = np.arange(1, deg + 1) * sig[:, None] ** np.arange(deg)
    x_t = np.einsum("td,sdx->stx", pw, coef)                 # (S, ntau, XV)
    dp_t = np.einsum("td,sdx->stx", dpw, coef)               # (S, ntau, XV)
    wU = np.stack([lagrange_weights(sch.cardinal_tau, sg) for sg in sig])
    u_t = np.einsum("tc,scu->stu", wU, us)                   # (S, ntau, UV)
    t_t = t0seg[:, None] + sig[None, :] * hs[:, None]        # (S, ntau)
    rows = np.concatenate(
        [x_t, t_t[:, :, None], u_t,
         np.broadcast_to(phase._odeparams, (S, len(sig), phase.PV))],
        axis=2).reshape(S * len(sig), -1)
    f = np.asarray(jax.vmap(phase.ode.vf().trace)(rows))[:, :XV]
    f = f.reshape(S, len(sig), XV)
    res = np.abs(dp_t - hs[:, None, None] * f)
    return res.max(axis=(1, 2))


def _integrator_errors(phase):
    """Re-integrate each segment and compare endpoint states
    (reference get_meshinfo_integrator, `ODEPhase.h:592-660`), batched:
    all segments propagate in ONE vmapped adaptive-integrator dispatch
    (`Integrator.integrate_parallel`)."""
    from ..Integrators import Integrator
    XV = phase.XV
    T = phase.tf - phase.t0
    if phase.UV:
        tab = phase.returnTrajTable()
        # control columns of the XtU layout: the integrator closes the
        # loop on the table's interpolated CONTROLS only
        uvars = list(range(XV + 1, XV + 1 + phase.UV))
        integ = Integrator(phase.ode, 0.05 * T / max(phase.numSegs, 1),
                           tab, uvars)
    else:
        integ = Integrator(phase.ode, 0.05 * T / max(phase.numSegs, 1))
    first = phase.seg_nodes[:, 0]
    last = phase.seg_nodes[:, -1]
    rows0 = phase._traj[first]
    rows1 = phase._traj[last]
    x0s = np.concatenate(
        [rows0, np.tile(phase._odeparams, (len(rows0), 1))], axis=1)
    xfs = integ.integrate_parallel(x0s, rows1[:, XV])
    xfs = np.stack([np.asarray(r) for r in xfs])
    return np.max(np.abs(xfs[:, :XV] - rows1[:, :XV]), axis=1)


def _deboor_error_weight(sch, cs):
    """Hermite interpolation error constant for the scheme's cardinal taus:
    max over [0,1] of |prod_j (s - tau_j)^2| / (2cs)! — each cardinal state
    is matched in value and derivative, so the remainder carries the node
    polynomial squared (reference LGLCoeffs<CS>::ErrorWeight; derived here
    numerically instead of hard-coded)."""
    import math
    s = np.linspace(0.0, 1.0, 4001)
    w = np.ones_like(s)
    for tc in sch.cardinal_tau:
        w *= (s - tc) ** 2
    return float(np.max(np.abs(w)) / math.factorial(2 * cs))


def _deboor_errors(phase):
    """De Boor derivative-jump estimator (reference get_meshinfo_deboor,
    `src/OptimalControl/ODEPhase.h:444-560`): per segment, estimate the
    deg-th derivative of the Hermite interpolant from its leading
    coefficient; jumps between neighboring segments estimate the
    (deg+1)-th derivative; error_k = |d^(deg+1)x| * h_k^(deg+1) * C.

    Vectorized: one Vandermonde solve in local sigma-space serves every
    segment; the node tangents come from one vmapped RHS call
    (_segment_coefs).  BlockConstant: the traj rows already carry the
    block control after collectSolverOutput (reference
    ODEPhase.h:533-546)."""
    sch = phase._scheme
    cs = phase._cs
    deg = 2 * cs - 1
    import math
    S = phase.numSegs
    coef, hs, _ = _segment_coefs(phase)
    # deg-th time derivative estimate on each segment
    y = coef[:, deg, :] * math.factorial(deg) / \
        np.abs(hs[:, None]) ** deg                           # (S, XV)

    EW = _deboor_error_weight(sch, cs)
    if S == 1:
        return np.array([np.max(np.abs(y[0]))
                         * np.abs(hs[0]) ** (deg + 1) * EW])
    # derivative jumps across interior boundaries -> (deg+1)-th derivative
    d = np.abs(np.diff(y, axis=0)) / (hs[:-1] + hs[1:])[:, None]
    e = np.zeros_like(y)
    e[1:] += d
    e[:-1] += d
    e[0] *= 2.0
    e[-1] *= 2.0
    return e.max(axis=1) * np.abs(hs) ** (deg + 1) * EW


def detect_switches(phase, jump_tol=0.1):
    """Control-switch detection (reference calcSwitches,
    `ODEPhaseBase.cpp:1544-1584`): normalized segment boundaries where a
    control column jumps by more than jump_tol of its range."""
    UV = phase.UV
    if UV == 0 or phase.numSegs < 3:
        return np.zeros(0)
    cs = phase._cs
    traj = phase._traj
    switches = []
    for j in range(UV):
        u = traj[:, phase.XV + 1 + j]
        rng = np.max(u) - np.min(u)
        if rng <= 0:
            continue
        # jump of control across each interior segment boundary
        for k in range(1, phase.numSegs):
            nl = phase.seg_nodes[k - 1]
            nr = phase.seg_nodes[k]
            du = abs(u[nr[min(1, cs - 1)]] - u[nl[max(cs - 2, 0)]])
            if du / rng > jump_tol:
                switches.append(phase.seg_bounds[k])
    return np.unique(np.asarray(switches))


def segment_errors(phase):
    est = phase.MeshErrorEstimator
    if est in ("deboor", "polynomial"):
        return _deboor_errors(phase)
    if est == "integrator":
        try:
            return _integrator_errors(phase)
        except Exception:
            return _residual_errors(phase)
    return _residual_errors(phase)


def trajectory_error(phase):
    return segment_errors(phase)


def _combine(errs, criteria):
    if criteria in ("max",):
        return float(np.max(errs))
    if criteria in ("avg", "mean"):
        return float(np.mean(errs))
    if criteria in ("geometric",):
        return float(np.exp(np.mean(np.log(np.maximum(errs, 1e-300)))))
    if criteria in ("endtoend",):
        return float(np.sum(errs))
    return float(np.max(errs))


def update_mesh(phase, errs):
    """Error-equidistributed re-binning (reference updateMesh +
    MeshIterateInfo::calc_bins)."""
    order = phase._scheme.order
    tol = phase.MeshTol
    S = phase.numSegs
    err = _combine(errs, phase.MeshErrorCriteria)
    growth = (err * phase.MeshErrFactor / tol) ** (1.0 / (order + 1))
    n_new = int(np.ceil(S * np.clip(growth, phase.MeshRedFactor,
                                    phase.MeshIncFactor)))
    n_new = int(np.clip(n_new, phase.MinSegments, phase.MaxSegments))
    # Segment-count bucketing (SURVEY.md section 7 dynamic-shape
    # mitigation): quantize to a geometric ladder so consecutive mesh
    # iterations land on REPEATED segment counts — transcription's
    # structure key then matches and the whole jit/KKT plan is reused
    # (transcribe() refreshes runtime consts only).  Up to ~30% extra
    # segments per iteration trades for zero XLA recompiles, which
    # dominate adaptive-mesh wall time.
    if getattr(phase, "MeshBucketing", True):
        b = max(4, int(phase.MinSegments))
        while b < n_new:
            b = int(np.ceil(b * 1.3))
        n_new = int(min(b, phase.MaxSegments))

    # density ~ local error^(1/(order+1)), piecewise constant per old segment
    dens = np.maximum(errs, 1e-14) ** (1.0 / (order + 1))
    # control-switch detection: concentrate mesh density around detected
    # control discontinuities (reference calcSwitches)
    if getattr(phase, "DetectControlSwitches", False):
        sw = detect_switches(phase, getattr(phase, "SwitchTol", 0.1))
        for tsw in sw:
            k = np.clip(np.searchsorted(phase.seg_bounds, tsw) - 1, 0,
                        phase.numSegs - 1)
            for kk in (k, min(k + 1, phase.numSegs - 1)):
                dens[kk] = max(dens[kk], np.max(dens) * 2.0)
    widths = np.diff(phase.seg_bounds)
    cum = np.concatenate([[0.0], np.cumsum(dens * widths)])
    cum /= cum[-1]
    targets = np.linspace(0.0, 1.0, n_new + 1)
    new_bounds = np.interp(targets, cum, phase.seg_bounds)
    new_bounds[0], new_bounds[-1] = 0.0, 1.0
    # enforce strictly increasing
    new_bounds = np.maximum.accumulate(new_bounds)
    for i in range(1, len(new_bounds)):
        if new_bounds[i] <= new_bounds[i - 1]:
            new_bounds[i] = new_bounds[i - 1] + 1e-10
    return n_new, new_bounds


def adaptive_mesh_loop(phase, method, flag):
    """Reference `ODEPhaseBase.cpp:1633-1680`: estimate -> refine ->
    re-transcribe -> re-solve until MeshTol or MaxMeshIters.

    Re-solves are warm-started from the previous mesh's multipliers when
    the constraint dimensions carry over (reference collectPostOptInfo,
    `ODEPhaseBase.cpp:1606-1609`; multipliers are interpolated only
    implicitly — a mesh-size change resets them)."""
    phase.MeshConverged = False
    ws_prev = phase.optimizer.WarmStart
    phase.optimizer.WarmStart = True
    try:
        return _mesh_loop_body(phase, method, flag)
    finally:
        phase.optimizer.WarmStart = ws_prev


def _mesh_loop_body(phase, method, flag):
    for itr in range(phase.MaxMeshIters):
        errs = segment_errors(phase)
        err = _combine(errs, phase.MeshErrorCriteria)
        if phase.optimizer.PrintLevel <= 1:
            print(f"  [mesh] iter {itr}: segs {phase.numSegs} "
                  f"err {err:.3e} tol {phase.MeshTol:.1e}")
        if err < phase.MeshTol:
            phase.MeshConverged = True
            return flag
        n_new, bounds = update_mesh(phase, errs)
        # scheme-order re-interpolation onto the new mesh (reference
        # re-samples through LGLInterpTable at transcription order)
        phase.resampleTraj(n_new, seg_bounds=bounds)
        flag = phase._psipot_call(method)
    phase.MeshConverged = False
    return flag
