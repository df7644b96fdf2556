"""Kepler propagation, Lambert solver, and element conversions.

Reference: `src/Astro/KeplerPropagator.h` (universal-variable propagator as a
differentiable function), `src/Astro/KeplerUtils.{h,cpp}` (element
conversions), `src/Astro/LambertSolvers.{h,cpp}` (Izzo single/multi-rev,
batch-threaded).  JAX design: the propagator's universal-anomaly Newton
iteration runs in a `lax.while_loop`; derivatives flow through forward-mode
AD; batch propagation/Lambert are `jax.vmap`s.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ..config import DEFAULT_DTYPE
from ..VectorFunctions.function import VectorFunction

__all__ = ["KeplerPropagator", "propagate_kepler", "lambert_izzo",
           "lambert_izzo_batch", "lambert_izzo_multi",
           "cartesian_to_classic", "classic_to_cartesian",
           "cartesian_to_modified", "modified_to_cartesian",
           "CartesianToClassic", "ClassicToCartesian",
           "CartesianToModified", "ModifiedToCartesian",
           "ModifiedToClassic", "ClassicToModified"]


# ---------------------------------------------------------------- stumpff
def _stumpff_C(z):
    """C(z) = (1-cos(sqrt z))/z for z>0, (cosh(sqrt -z)-1)/(-z) for z<0."""
    eps = 1e-8
    sz = jnp.sqrt(jnp.abs(z) + 1e-300)
    pos = (1.0 - jnp.cos(sz)) / (sz * sz)
    neg = (jnp.cosh(sz) - 1.0) / (sz * sz)
    ser = 0.5 - z / 24.0 + z * z / 720.0
    return jnp.where(jnp.abs(z) < eps, ser, jnp.where(z > 0, pos, neg))


def _stumpff_S(z):
    """S(z) = (sqrt z - sin(sqrt z))/z^1.5 etc."""
    eps = 1e-8
    sz = jnp.sqrt(jnp.abs(z) + 1e-300)
    pos = (sz - jnp.sin(sz)) / sz ** 3
    neg = (jnp.sinh(sz) - sz) / sz ** 3
    ser = 1.0 / 6.0 - z / 120.0 + z * z / 5040.0
    return jnp.where(jnp.abs(z) < eps, ser, jnp.where(z > 0, pos, neg))


def _propagate_rv(rv, dt, mu):
    """Universal-variable Kepler propagation of [r (3), v (3)] by dt."""
    r0 = rv[:3]
    v0 = rv[3:6]
    r0n = jnp.sqrt(r0 @ r0)
    vr0 = (r0 @ v0) / r0n
    alpha = 2.0 / r0n - (v0 @ v0) / mu     # 1/sma
    sqmu = jnp.sqrt(mu)

    chi0 = jnp.where(jnp.abs(alpha) > 1e-12,
                     sqmu * jnp.abs(alpha) * dt,
                     jnp.sign(dt) * jnp.sqrt(r0n) * 0.1)

    def body(carry):
        chi, _, it = carry
        z = alpha * chi * chi
        C = _stumpff_C(z)
        S = _stumpff_S(z)
        F = (r0n * vr0 / sqmu * chi * chi * C
             + (1.0 - alpha * r0n) * chi ** 3 * S + r0n * chi
             - sqmu * dt)
        dF = (r0n * vr0 / sqmu * chi * (1.0 - z * S)
              + (1.0 - alpha * r0n) * chi * chi * C + r0n)
        step = F / dF
        return chi - step, jnp.abs(step), it + 1

    def cond(carry):
        _, err, it = carry
        return (err > 1e-13) & (it < 60)

    chi, _, _ = jax.lax.while_loop(cond, body, (chi0, jnp.inf, 0))

    z = alpha * chi * chi
    C = _stumpff_C(z)
    S = _stumpff_S(z)
    f = 1.0 - chi * chi / r0n * C
    g = dt - chi ** 3 / sqmu * S
    r = f * r0 + g * v0
    rn = jnp.sqrt(r @ r)
    gdot = 1.0 - chi * chi / rn * C
    fdot = sqmu / (rn * r0n) * (z * S - 1.0) * chi
    v = fdot * r0 + gdot * v0
    return jnp.concatenate([r, v])


def propagate_kepler(rv, dt, mu=1.0):
    """Host-callable Kepler propagation; batch if rv is 2-D."""
    rv = np.asarray(rv, dtype=np.float64)
    if rv.ndim == 2:
        f = jax.jit(jax.vmap(lambda s, d: _propagate_rv(s, d, mu)))
        return np.asarray(f(jnp.asarray(rv),
                            jnp.asarray(np.broadcast_to(dt, rv.shape[0]))))
    f = jax.jit(lambda s, d: _propagate_rv(s, d, mu))
    return np.asarray(f(jnp.asarray(rv), jnp.asarray(float(dt))))


def KeplerPropagator(mu=1.0):
    """Differentiable VectorFunction [r, v, dt] -> [r(dt), v(dt)]
    (reference `KeplerPropagator.h:37`)."""
    def impl(x):
        return _propagate_rv(x[:6], x[6], mu)
    return VectorFunction(impl, 7, 6, name="KeplerPropagator")


# ----------------------------------------------------------------- Lambert
def _lambert_core(r1, r2, tof, mu, longway, Nrevs, rightbranch):
    """Traced Izzo-style Lambert (Lancaster-Blanchard x-parameter).

    Branch-free jnp formulation with a fixed-iteration Newton whose slope
    comes from jax.grad of the time-of-flight map — vmappable and
    differentiable (reference `src/Astro/LambertSolvers.cpp:7-34`; the
    reference threads batches, we vmap them)."""
    r1n = jnp.sqrt(r1 @ r1)
    r2n = jnp.sqrt(r2 @ r2)
    c = jnp.sqrt((r2 - r1) @ (r2 - r1))
    s = 0.5 * (r1n + r2n + c)
    lam2 = 1.0 - c / s
    lam0 = jnp.sqrt(jnp.maximum(lam2, 0.0))
    ihr = jnp.cross(r1, r2)
    flip = ihr[2] < 0
    lw = jnp.logical_xor(jnp.asarray(bool(longway)), flip)
    lam = jnp.where(lw, -lam0, lam0)
    T = jnp.sqrt(2.0 * mu / s ** 3) * tof
    N = float(Nrevs)

    def tof_of_x(x):
        # Lancaster-Blanchard time of flight, elliptic/hyperbolic branches
        xs = jnp.clip(x, -0.9999999, None)
        a = 1.0 / (1.0 - xs * xs)
        # elliptic branch (x < 1)
        xe = jnp.clip(xs, -1.0, 0.9999999)
        ae = 1.0 / (1.0 - xe * xe)
        alfa = 2.0 * jnp.arccos(xe)
        beta = 2.0 * jnp.arcsin(jnp.clip(
            jnp.sign(lam) * jnp.sqrt(jnp.abs(lam2 / ae)), -1.0, 1.0))
        te = (ae ** 1.5) * ((alfa - jnp.sin(alfa))
                            - (beta - jnp.sin(beta)) + 2.0 * jnp.pi * N)
        # hyperbolic branch (x > 1)
        xh = jnp.maximum(xs, 1.0000001)
        ah = 1.0 / (1.0 - xh * xh)
        alfah = 2.0 * jnp.arccosh(xh)
        betah = 2.0 * jnp.arcsinh(
            jnp.sign(lam) * jnp.sqrt(jnp.abs(-lam2 / ah)))
        th = (-ah) ** 1.5 * ((betah - jnp.sinh(betah))
                             - (alfah - jnp.sinh(alfah)))
        return jnp.where(xs < 1.0, te, th) / 2.0

    # initial guess (Izzo 2015): single-rev piecewise; multi-rev branch seed
    T0 = jnp.arccos(lam) + lam * jnp.sqrt(jnp.maximum(1 - lam2, 0.0))
    T1 = 2.0 / 3.0 * (1.0 - lam ** 3)
    x0_sr = jnp.where(
        T >= T0, (T0 / T) ** (2.0 / 3.0) - 1.0,
        jnp.where(T < T1,
                  5.0 / 2.0 * T1 / T * (T1 - T) / (1.0 - lam ** 5) + 1.0,
                  (T0 / T) ** (jnp.log(T1 / T0) / jnp.log(2.0)) - 1.0))
    if Nrevs == 0:
        x = jnp.clip(x0_sr, -0.999999, 50.0)
        xmax = 1e3
    else:
        x = jnp.asarray(0.4 if rightbranch else -0.6, r1.dtype)
        xmax = 0.999999
    dtof = jax.grad(tof_of_x)

    def newton(x, _):
        f = tof_of_x(x) - T
        df = dtof(x)
        step = jnp.clip(f / jnp.where(jnp.abs(df) > 1e-300, df, 1.0),
                        -0.5, 0.5)
        x = jnp.clip(x - step, -0.999999, xmax)
        return x, None

    x, _ = jax.lax.scan(newton, x, None, length=40)

    gamma = jnp.sqrt(mu * s / 2.0)
    rho = (r1n - r2n) / c
    sig = jnp.sqrt(jnp.maximum(1.0 - rho ** 2, 0.0))
    y = jnp.sqrt(jnp.maximum(1.0 - lam2 * (1.0 - x * x), 0.0))
    Vr1 = gamma * ((lam * y - x) - rho * (lam * y + x)) / r1n
    Vr2 = -gamma * ((lam * y - x) + rho * (lam * y + x)) / r2n
    Vt1 = gamma * sig * (y + lam * x) / r1n
    Vt2 = gamma * sig * (y + lam * x) / r2n

    ih = ihr / jnp.sqrt(ihr @ ihr)
    ih = jnp.where(lw, -ih, ih)
    it1 = jnp.cross(ih, r1 / r1n)
    it2 = jnp.cross(ih, r2 / r2n)
    v1 = Vr1 * r1 / r1n + Vt1 * it1
    v2 = Vr2 * r2 / r2n + Vt2 * it2
    return v1, v2


def lambert_izzo(r1, r2, tof, mu=1.0, longway=False, Nrevs=0,
                 rightbranch=False):
    """Izzo-style universal Lambert solver (single revolution default).

    Returns (v1, v2) as numpy arrays.  Multi-rev via Nrevs with left/right
    branch selection.  Reference: `src/Astro/LambertSolvers.cpp:7-34`."""
    f = jax.jit(lambda a, b, t: _lambert_core(a, b, t, mu, longway, Nrevs,
                                              rightbranch))
    v1, v2 = f(jnp.asarray(np.asarray(r1, np.float64)),
               jnp.asarray(np.asarray(r2, np.float64)),
               jnp.asarray(float(tof)))
    return np.asarray(v1), np.asarray(v2)


def lambert_izzo_batch(r1s, r2s, tofs, mu=1.0, longway=False, Nrevs=0,
                       rightbranch=False):
    """Vmapped batch Lambert: one fixed-iteration solve per lane on the
    accelerator (the analog of the reference's batch-threaded
    overloads, `LambertSolvers.cpp:21`).  Returns (V1 (n,3), V2 (n,3))."""
    f = jax.jit(jax.vmap(
        lambda a, b, t: _lambert_core(a, b, t, mu, longway, Nrevs,
                                      rightbranch)))
    v1, v2 = f(jnp.asarray(np.asarray(r1s, np.float64)),
               jnp.asarray(np.asarray(r2s, np.float64)),
               jnp.asarray(np.asarray(tofs, np.float64)))
    return np.asarray(v1), np.asarray(v2)


def lambert_izzo_multi(r1s, r2s, tofs, mu=1.0, longway=False, nthreads=None):
    """Batch Lambert returning a list of (v1, v2) pairs (reference
    list-of-pairs convention)."""
    V1, V2 = lambert_izzo_batch(r1s, r2s, tofs, mu, longway)
    return [(V1[i], V2[i]) for i in range(len(V1))]


# --------------------------------------------------------- element convs
# Traced (jnp) cores: usable inside constraint expressions with exact AD —
# the reference exposes all conversions as VectorFunctions
# (`src/Astro/KeplerUtils.cpp:13-59`).  Branch-free formulations; the
# Kepler-equation solve is a fixed-iteration Newton (AD through converged
# Newton gives the exact implicit derivative).

def _true_to_mean_j(ta, e):
    E = 2.0 * jnp.arctan2(jnp.sqrt(jnp.maximum(1 - e, 1e-300))
                          * jnp.sin(ta / 2),
                          jnp.sqrt(1 + e) * jnp.cos(ta / 2))
    return E - e * jnp.sin(E)


def _mean_to_true_j(M, e):
    def body(E, _):
        f = E - e * jnp.sin(E) - M
        return E - f / (1 - e * jnp.cos(E)), None
    E, _ = jax.lax.scan(body, M, None, length=25)
    return 2.0 * jnp.arctan2(jnp.sqrt(1 + e) * jnp.sin(E / 2),
                             jnp.sqrt(jnp.maximum(1 - e, 1e-300))
                             * jnp.cos(E / 2))


def _cart_to_classic_j(rv, mu):
    r = rv[:3]
    v = rv[3:6]
    rn = jnp.sqrt(r @ r)
    h = jnp.cross(r, v)
    hn = jnp.sqrt(h @ h)
    n = jnp.cross(jnp.array([0.0, 0.0, 1.0]), h)
    nn = jnp.sqrt(n @ n)
    nns = jnp.maximum(nn, 1e-300)
    evec = jnp.cross(v, h) / mu - r / rn
    e = jnp.sqrt(evec @ evec)
    es = jnp.maximum(e, 1e-300)
    energy = v @ v / 2 - mu / rn
    a = -mu / (2 * energy)
    i = jnp.arccos(jnp.clip(h[2] / hn, -1, 1))
    raan0 = jnp.arccos(jnp.clip(n[0] / nns, -1, 1))
    raan = jnp.where(nn > 1e-14,
                     jnp.where(n[1] < 0, 2 * jnp.pi - raan0, raan0), 0.0)
    argp0 = jnp.arccos(jnp.clip(n @ evec / (nns * es), -1, 1))
    argp = jnp.where((nn > 1e-14) & (e > 1e-14),
                     jnp.where(evec[2] < 0, 2 * jnp.pi - argp0, argp0), 0.0)
    ta0 = jnp.arccos(jnp.clip(evec @ r / (es * rn), -1, 1))
    ta_e = jnp.where(r @ v < 0, 2 * jnp.pi - ta0, ta0)
    ta_c = jnp.where(nn > 1e-14,
                     jnp.arccos(jnp.clip(n @ r / (nns * rn), -1, 1)),
                     jnp.arctan2(r[1], r[0]))
    ta = jnp.where(e > 1e-14, ta_e, ta_c)
    M = jnp.where(e < 1.0, _true_to_mean_j(ta, jnp.minimum(e, 0.999999)),
                  ta)
    return jnp.stack([a, e, i, raan, argp, M])


def _classic_to_cart_j(oe, mu):
    a, e, i, raan, argp, M = (oe[0], oe[1], oe[2], oe[3], oe[4], oe[5])
    ta = jnp.where(e < 1.0, _mean_to_true_j(M, jnp.minimum(e, 0.999999)),
                   M)
    p = a * (1 - e * e)
    rn = p / (1 + e * jnp.cos(ta))
    r_pf = rn * jnp.stack([jnp.cos(ta), jnp.sin(ta), 0.0 * ta])
    v_pf = jnp.sqrt(mu / p) * jnp.stack([-jnp.sin(ta), e + jnp.cos(ta),
                                         0.0 * ta])
    cO, sO = jnp.cos(raan), jnp.sin(raan)
    co, so = jnp.cos(argp), jnp.sin(argp)
    ci, si = jnp.cos(i), jnp.sin(i)
    R = jnp.stack([
        jnp.stack([cO * co - sO * so * ci, -cO * so - sO * co * ci,
                   sO * si]),
        jnp.stack([sO * co + cO * so * ci, -sO * so + cO * co * ci,
                   -cO * si]),
        jnp.stack([so * si, co * si, ci])])
    return jnp.concatenate([R @ r_pf, R @ v_pf])


def _cart_to_modified_j(rv, mu):
    oe = _cart_to_classic_j(rv, mu)
    a, e, i, raan, argp, M = (oe[0], oe[1], oe[2], oe[3], oe[4], oe[5])
    ta = jnp.where(e < 1.0, _mean_to_true_j(M, jnp.minimum(e, 0.999999)),
                   M)
    p = a * (1 - e * e)
    f = e * jnp.cos(argp + raan)
    g = e * jnp.sin(argp + raan)
    h = jnp.tan(i / 2) * jnp.cos(raan)
    k = jnp.tan(i / 2) * jnp.sin(raan)
    L = raan + argp + ta
    return jnp.stack([p, f, g, h, k, L])


def _modified_to_cart_j(mee, mu):
    p, f, g, h, k, L = (mee[0], mee[1], mee[2], mee[3], mee[4], mee[5])
    s2 = 1 + h * h + k * k
    a2 = h * h - k * k
    cL, sL = jnp.cos(L), jnp.sin(L)
    w = 1 + f * cL + g * sL
    rn = p / w
    r = rn / s2 * jnp.stack([
        cL + a2 * cL + 2 * h * k * sL,
        sL - a2 * sL + 2 * h * k * cL,
        2 * (h * sL - k * cL)])
    sqmu_p = jnp.sqrt(mu / p)
    v = sqmu_p / s2 * jnp.stack([
        -(sL + a2 * sL - 2 * h * k * cL + g - 2 * f * h * k + a2 * g),
        -(-cL + a2 * cL + 2 * h * k * sL - f + 2 * g * h * k + a2 * f),
        2 * (h * cL + k * sL + f * h + g * k)])
    return jnp.concatenate([r, v])


def true_to_mean_anomaly(ta, e):
    return float(_true_to_mean_j(jnp.asarray(float(ta)),
                                 jnp.asarray(float(e))))


def mean_to_true_anomaly(M, e, tol=1e-13):
    return float(_mean_to_true_j(jnp.asarray(float(M)),
                                 jnp.asarray(float(e))))


def cartesian_to_classic(rv, mu=1.0):
    """[r, v] -> [a, e, i, RAAN, argp, mean anomaly] (elliptic), matching
    the reference convention (`KeplerUtils.h:20` solves Kepler's equation in
    classic_to_cartesian, so the 6th element is MEAN anomaly)."""
    return np.asarray(_cart_to_classic_j(
        jnp.asarray(np.asarray(rv, np.float64)[:6]), mu))


def classic_to_cartesian(oe, mu=1.0):
    """[a, e, i, RAAN, argp, mean anomaly] -> [r, v] (reference
    `KeplerUtils.h:20`)."""
    return np.asarray(_classic_to_cart_j(
        jnp.asarray(np.asarray(oe, np.float64)[:6]), mu))


def cartesian_to_modified(rv, mu=1.0):
    """[r, v] -> modified equinoctial [p, f, g, h, k, L]."""
    return np.asarray(_cart_to_modified_j(
        jnp.asarray(np.asarray(rv, np.float64)[:6]), mu))


def modified_to_cartesian(mee, mu=1.0):
    """[p, f, g, h, k, L] -> [r, v]."""
    return np.asarray(_modified_to_cart_j(
        jnp.asarray(np.asarray(mee, np.float64)[:6]), mu))


# VectorFunction wrappers: differentiable element conversions usable inside
# boundary constraints (reference `KeplerUtils.cpp:13-59` binds these as
# VectorFunctions).
def CartesianToClassic(mu=1.0):
    return VectorFunction(lambda x: _cart_to_classic_j(x, mu), 6, 6,
                          name="CartesianToClassic")


def ClassicToCartesian(mu=1.0):
    return VectorFunction(lambda x: _classic_to_cart_j(x, mu), 6, 6,
                          name="ClassicToCartesian")


def CartesianToModified(mu=1.0):
    return VectorFunction(lambda x: _cart_to_modified_j(x, mu), 6, 6,
                          name="CartesianToModified")


def ModifiedToCartesian(mu=1.0):
    return VectorFunction(lambda x: _modified_to_cart_j(x, mu), 6, 6,
                          name="ModifiedToCartesian")


def ModifiedToClassic(mu=1.0):
    return VectorFunction(
        lambda x: _cart_to_classic_j(_modified_to_cart_j(x, mu), mu), 6, 6,
        name="ModifiedToClassic")


def ClassicToModified(mu=1.0):
    return VectorFunction(
        lambda x: _cart_to_modified_j(_classic_to_cart_j(x, mu), mu), 6, 6,
        name="ClassicToModified")
