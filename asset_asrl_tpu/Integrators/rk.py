"""Adaptive Runge-Kutta integrators (RK4 / DOPRI54 / DOPRI87).

JAX replacement for `src/Integrators/` (RKCoeffs.h butcher tableaus,
RKSteppers.h differentiable steppers, Integrator.h adaptive loop with events,
dense output, STM, batch-parallel):

* the adaptive loop is a jitted `lax.while_loop` with static step cap;
* batch propagation (reference integrate_parallel, `Integrator.h:1788`) is
  `jax.vmap` of that loop instead of a thread pool;
* the state-transition matrix (integrate_stm, `Integrator.h:1684`) comes from
  forward-mode AD (`jax.jacfwd`) straight through the adaptive loop;
* events are located by bisection on sign changes (reference EventPack,
  `Integrator.h:538-690`).

The integrator maps a full ODE input row [x, t0, u, p] to the row at tf; with
no control law, u is held constant; a control law (VectorFunction of [x,t] or
an LGLInterpTable) closes the loop u = k(x, t).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from functools import partial

from ..config import DEFAULT_DTYPE
from ..VectorFunctions.function import VectorFunction

__all__ = ["Integrator", "RKCoeffs"]


class RKCoeffs:
    """Butcher tableaus (standard published coefficients)."""

    RK4 = dict(
        a=[[], [0.5], [0.0, 0.5], [0.0, 0.0, 1.0]],
        b=[1 / 6, 1 / 3, 1 / 3, 1 / 6],
        c=[0.0, 0.5, 0.5, 1.0],
        bhat=None, order=4)

    # Dormand-Prince 5(4)
    DOPRI54 = dict(
        a=[[],
           [1 / 5],
           [3 / 40, 9 / 40],
           [44 / 45, -56 / 15, 32 / 9],
           [19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729],
           [9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656],
           [35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84]],
        b=[35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0.0],
        bhat=[5179 / 57600, 0.0, 7571 / 16695, 393 / 640, -92097 / 339200,
              187 / 2100, 1 / 40],
        c=[0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0],
        order=5)

    # Prince-Dormand 8(7) (RK8(7)13M)
    DOPRI87 = dict(
        a=[[],
           [1 / 18],
           [1 / 48, 1 / 16],
           [1 / 32, 0, 3 / 32],
           [5 / 16, 0, -75 / 64, 75 / 64],
           [3 / 80, 0, 0, 3 / 16, 3 / 20],
           [29443841 / 614563906, 0, 0, 77736538 / 692538347,
            -28693883 / 1125000000, 23124283 / 1800000000],
           [16016141 / 946692911, 0, 0, 61564180 / 158732637,
            22789713 / 633445777, 545815736 / 2771057229,
            -180193667 / 1043307555],
           [39632708 / 573591083, 0, 0, -433636366 / 683701615,
            -421739975 / 2616292301, 100302831 / 723423059,
            790204164 / 839813087, 800635310 / 3783071287],
           [246121993 / 1340847787, 0, 0, -37695042795 / 15268766246,
            -309121744 / 1061227803, -12992083 / 490766935,
            6005943493 / 2108947869, 393006217 / 1396673457,
            123872331 / 1001029789],
           [-1028468189 / 846180014, 0, 0, 8478235783 / 508512852,
            1311729495 / 1432422823, -10304129995 / 1701304382,
            -48777925059 / 3047939560, 15336726248 / 1032824649,
            -45442868181 / 3398467696, 3065993473 / 597172653],
           [185892177 / 718116043, 0, 0, -3185094517 / 667107341,
            -477755414 / 1098053517, -703635378 / 230739211,
            5731566787 / 1027545527, 5232866602 / 850066563,
            -4093664535 / 808688257, 3962137247 / 1805957418,
            65686358 / 487910083],
           [403863854 / 491063109, 0, 0, -5068492393 / 434740067,
            -411421997 / 543043805, 652783627 / 914296604,
            11173962825 / 925320556, -13158990841 / 6184727034,
            3936647629 / 1978049680, -160528059 / 685178525,
            248638103 / 1413531060, 0]],
        b=[14005451 / 335480064, 0, 0, 0, 0, -59238493 / 1068277825,
           181606767 / 758867731, 561292985 / 797845732,
           -1041891430 / 1371343529, 760417239 / 1151165299,
           118820643 / 751138087, -528747749 / 2220607170, 1 / 4],
        bhat=[13451932 / 455176623, 0, 0, 0, 0, -808719846 / 976000145,
              1757004468 / 5645159321, 656045339 / 265891186,
              -3867574721 / 1518517206, 465885868 / 322736535,
              53011238 / 667516719, 2 / 45, 0],
        c=[0, 1 / 18, 1 / 12, 1 / 8, 5 / 16, 3 / 8, 59 / 400, 93 / 200,
           5490023248 / 9719169821, 13 / 20, 1201146811 / 1299019798, 1, 1],
        order=8)

    @classmethod
    def get(cls, name):
        return {"RK4": cls.RK4, "RK4Classic": cls.RK4,
                "DOPRI54": cls.DOPRI54, "DOPRI87": cls.DOPRI87}[name]


class Integrator:
    """Adaptive/fixed-step integrator over a full ODE input row."""

    def __init__(self, ode, defstep=0.01, controller=None, uvars=None,
                 method="DOPRI54"):
        # reference overload: Integrator(ode, "DOPRI87", dt[, law, uvars])
        if isinstance(defstep, str):
            if isinstance(controller, (int, float)):
                defstep, controller, uvars, method = (
                    float(controller), uvars,
                    method if not isinstance(method, str) else None,
                    defstep)
            else:
                defstep, method = 0.01, defstep
        self.ode = ode
        self.DefStepSize = float(defstep)
        self.MinStepSize = self.DefStepSize * 1e-6
        self.MaxStepSize = self.DefStepSize * 1e6
        self.Adaptive = True
        self.AbsTols = np.full(ode.XVars(), 1.0e-12)
        self.RelTols = np.full(ode.XVars(), 0.0)
        self.EventTol = 1.0e-10
        self.MaxEventIters = 60
        self.MaxStepsPerCall = 100000
        self.FastAdaptiveSTM = True
        self.VectorizeBatchCalls = True
        self.method = method
        self._controller = controller
        if uvars is not None:
            # Vgroup names resolve through the ODE (reference
            # UpdatedInterface: integ = ode.integrator(dt, law, "m"))
            groups = getattr(ode, "Vgroups", {}) or {}
            if isinstance(uvars, str):
                uvars = list(groups[uvars])
            else:
                out = []
                for v in uvars:
                    if isinstance(v, str):
                        out.extend(groups[v])
                    else:
                        out.append(int(v))
                uvars = out
        self._uvars = None if uvars is None else list(uvars)
        self._jits = {}

    # ------------------------------------------------------------ properties
    def setAbsTol(self, tol):
        self.AbsTols = np.full(self.ode.XVars(), float(tol))
        self._jits.clear()

    def setRelTol(self, tol):
        self.RelTols = np.full(self.ode.XVars(), float(tol))
        self._jits.clear()

    def setAbsTols(self, tols):
        self.AbsTols = np.asarray(tols, dtype=np.float64)
        self._jits.clear()

    def setStepSizes(self, defstep, minstep, maxstep):
        self.DefStepSize = float(defstep)
        self.MinStepSize = float(minstep)
        self.MaxStepSize = float(maxstep)
        self._jits.clear()

    # --------------------------------------------------------------- closure
    def _u_of(self, x, t, u0):
        """Control at (x, t): constant u0, a control-law VectorFunction, or
        an LGLInterpTable."""
        ctrl = self._controller
        UV = self.ode.UVars()
        if ctrl is None or UV == 0:
            return u0
        from ..OptimalControl.interp_table import LGLInterpTable
        if isinstance(ctrl, LGLInterpTable):
            row = ctrl.interp_traced(t)
            if self._uvars is not None:
                # uvars index the table's stored row (time removed)
                sel = np.asarray(
                    [i if i < ctrl.tcol else i - 1 for i in self._uvars])
                return row[sel]
            # default: trailing UV columns of the table
            return row[-UV:]
        if isinstance(ctrl, VectorFunction):
            xt = jnp.concatenate([x, jnp.atleast_1d(t)])
            if self._uvars is not None:
                # uvars select the law's inputs from [x, t] (reference
                # Integrator controller closures, `Integrator.h:51`)
                sel = np.asarray(self._uvars, np.int64)
                return ctrl.trace(xt[sel])
            if ctrl.IRows() == self.ode.XVars() + 1:
                return ctrl.trace(xt)
            if ctrl.IRows() == 1:
                return ctrl.trace(jnp.atleast_1d(t))
            raise ValueError("control law must take [x,t] or [t]")
        raise TypeError("unsupported controller")

    def _rhs(self, x, t, u0, p):
        u = self._u_of(x, t, u0)
        return self.ode.vf().trace(
            jnp.concatenate([x, jnp.atleast_1d(t), u, p]))

    # ------------------------------------------------------------- core step
    def _make_core(self):
        tab = RKCoeffs.get(self.method)
        A = [np.asarray(r, np.float64) for r in tab["a"]]
        b = np.asarray(tab["b"], np.float64)
        bhat = None if tab["bhat"] is None else np.asarray(
            tab["bhat"], np.float64)
        c = np.asarray(tab["c"], np.float64)
        order = tab["order"]
        ns = len(tab["b"])
        XV = self.ode.XVars()
        abst = np.asarray(self.AbsTols)
        relt = np.asarray(self.RelTols)
        hmin, hmax = self.MinStepSize, self.MaxStepSize
        adaptive = self.Adaptive and bhat is not None
        rhs = self._rhs
        max_steps = self.MaxStepsPerCall

        def step(x, t, h, u0, p):
            ks = []
            for i in range(ns):
                xi = x
                if i > 0:
                    xi = x + h * sum(A[i][j] * ks[j] for j in range(i))
                ks.append(rhs(xi, t + c[i] * h, u0, p))
            ks = jnp.stack(ks)
            xn = x + h * (b @ ks)
            err = jnp.zeros(()) if bhat is None else \
                h * ((b - bhat) @ ks)
            return xn, err

        def advance(x0, t0, tf, u0, p):
            """Integrate from t0 to tf (either direction)."""
            sgn = jnp.sign(tf - t0)
            sgn = jnp.where(sgn == 0, 1.0, sgn)

            def cond(carry):
                x, t, h, nst, ok = carry
                return (jnp.abs(tf - t) > 1e-14 * jnp.maximum(
                    1.0, jnp.abs(tf))) & (nst < max_steps) & ok

            def body(carry):
                x, t, h, nst, ok = carry
                hstep = sgn * jnp.minimum(h, jnp.abs(tf - t))
                xn, err = step(x, t, hstep, u0, p)
                if adaptive:
                    tol = abst + jnp.abs(xn) * relt
                    enorm = jnp.sqrt(jnp.mean((err / tol) ** 2))
                    enorm = jnp.maximum(enorm, 1e-16)
                    fac = jnp.clip(0.9 * enorm ** (-1.0 / order), 0.2, 5.0)
                    hnew = jnp.clip(jnp.abs(hstep) * fac, hmin, hmax)
                    accept = (enorm <= 1.0) | (jnp.abs(hstep) <= hmin * 1.01)
                    x = jnp.where(accept, xn, x)
                    t = jnp.where(accept, t + hstep, t)
                    h = hnew
                else:
                    x, t = xn, t + hstep
                ok = jnp.isfinite(jnp.sum(x))
                return (x, t, h, nst + 1, ok)

            x, t, h, nst, ok = jax.lax.while_loop(
                cond, body, (x0, t0, self.DefStepSize, 0, True))
            return x, t

        def integrate_row(row, tf):
            x0 = row[:XV]
            t0 = row[XV]
            u0 = row[XV + 1:XV + 1 + self.ode.UVars()]
            p = row[XV + 1 + self.ode.UVars():]
            xf, tfin = advance(x0, t0, tf, u0, p)
            uf = self._u_of(xf, tfin, u0)
            return jnp.concatenate([xf, tfin[None], uf, p])

        return integrate_row

    def _make_core_events(self, evfuns, directions, stops, max_hits=4):
        """Jittable/vmappable event-locating integrator (reference EventPack,
        `Integrator.h:538-690`, whose detection + bisection runs inside the
        propagation loop; here both live inside the jitted while_loop, so
        batched manifold sweeps vmap cleanly).

        evfuns: list of traced callables over the full row [x, t, u, p]
        (trimmed to each function's input size).  Returns a function
        (row, tf) -> (xf_row, hits (nev, max_hits, rowlen), counts (nev,)).
        Integration stops at the first crossing of any event with stop=1."""
        tab = RKCoeffs.get(self.method)
        A = [np.asarray(r, np.float64) for r in tab["a"]]
        b = np.asarray(tab["b"], np.float64)
        bhat = None if tab["bhat"] is None else np.asarray(
            tab["bhat"], np.float64)
        c = np.asarray(tab["c"], np.float64)
        order = tab["order"]
        ns = len(tab["b"])
        XV = self.ode.XVars()
        UV = self.ode.UVars()
        abst = np.asarray(self.AbsTols)
        relt = np.asarray(self.RelTols)
        hmin, hmax = self.MinStepSize, self.MaxStepSize
        adaptive = self.Adaptive and bhat is not None
        rhs = self._rhs
        max_steps = self.MaxStepsPerCall
        nev = len(evfuns)
        dirs = np.asarray(directions, np.int64)
        stops_np = np.asarray(stops, np.int64)
        nbisect = 40

        def step(x, t, h, u0, p):
            ks = []
            for i in range(ns):
                xi = x
                if i > 0:
                    xi = x + h * sum(A[i][j] * ks[j] for j in range(i))
                ks.append(rhs(xi, t + c[i] * h, u0, p))
            ks = jnp.stack(ks)
            xn = x + h * (b @ ks)
            err = jnp.zeros(()) if bhat is None else h * ((b - bhat) @ ks)
            return xn, err

        def full_row(x, t, u0, p):
            u = self._u_of(x, t, u0)
            return jnp.concatenate([x, jnp.atleast_1d(t), u, p])

        def ev_vals(x, t, u0, p):
            row = full_row(x, t, u0, p)
            return jnp.stack([jnp.atleast_1d(f(row))[0] for f in evfuns])

        def locate(xp, tp, tn, v0s, u0, p, crossed):
            """Bisect each crossed event on [tp, tn] from state xp: one RK
            step per trial midpoint, vmapped over events."""
            def vm_at(tm):
                xm = jax.vmap(
                    lambda tmi: step(xp, tp, tmi - tp, u0, p)[0])(tm)
                return jnp.stack([
                    jnp.atleast_1d(f(full_row(xm[i], tm[i], u0, p)))[0]
                    for i, f in enumerate(evfuns)])

            def bis(_, carry):
                ta, tb = carry
                tm = 0.5 * (ta + tb)
                vm = vm_at(tm)
                lo = v0s * vm <= 0       # crossing in [ta, tm]
                ta2 = jnp.where(lo, ta, tm)
                tb2 = jnp.where(lo, tm, tb)
                keep = crossed
                return (jnp.where(keep, ta2, ta), jnp.where(keep, tb2, tb))

            ta0 = jnp.full((nev,), tp)
            tb0 = jnp.full((nev,), tn)
            ta, tb = jax.lax.fori_loop(0, nbisect, bis, (ta0, tb0))
            return tb

        def run(row, tf):
            x0 = row[:XV]
            t0 = row[XV]
            u0 = row[XV + 1:XV + 1 + UV]
            p = row[XV + 1 + UV:]
            rowlen = row.shape[0]
            sgn = jnp.sign(tf - t0)
            sgn = jnp.where(sgn == 0, 1.0, sgn)
            hits0 = jnp.zeros((nev, max_hits, rowlen))
            counts0 = jnp.zeros((nev,), jnp.int64)
            v00 = ev_vals(x0, t0, u0, p)

            def cond(carry):
                x, t, h, nst, ok, vprev, hits, counts, stop = carry
                return (jnp.abs(tf - t) > 1e-14 * jnp.maximum(
                    1.0, jnp.abs(tf))) & (nst < max_steps) & ok & ~stop

            def body(carry):
                x, t, h, nst, ok, vprev, hits, counts, stop = carry
                hstep = sgn * jnp.minimum(h, jnp.abs(tf - t))
                xn, err = step(x, t, hstep, u0, p)
                if adaptive:
                    tol = abst + jnp.abs(xn) * relt
                    enorm = jnp.sqrt(jnp.mean((err / tol) ** 2))
                    enorm = jnp.maximum(enorm, 1e-16)
                    fac = jnp.clip(0.9 * enorm ** (-1.0 / order), 0.2, 5.0)
                    hnew = jnp.clip(jnp.abs(hstep) * fac, hmin, hmax)
                    accept = (enorm <= 1.0) | (jnp.abs(hstep) <= hmin * 1.01)
                else:
                    hnew = h
                    accept = jnp.asarray(True)
                tn = t + hstep
                vn = ev_vals(xn, tn, u0, p)
                rising = vn > vprev
                dirok = (dirs == 0) | ((dirs > 0) & rising) | \
                    ((dirs < 0) & ~rising)
                crossed = accept & (vprev * vn < 0) & dirok \
                    & (counts < max_hits)
                any_cross = jnp.any(crossed)

                def with_hits(args):
                    hits, counts = args
                    tcs = locate(x, t, tn, vprev, u0, p, crossed)

                    def upd(i, hc):
                        hits, counts = hc
                        xc, _ = step(x, t, tcs[i] - t, u0, p)
                        rowc = full_row(xc, tcs[i], u0, p)
                        hits = jax.lax.cond(
                            crossed[i],
                            lambda h: jax.lax.dynamic_update_slice(
                                h, rowc[None, None, :],
                                (jnp.asarray(i, counts.dtype), counts[i],
                                 jnp.zeros((), counts.dtype))),
                            lambda h: h, hits)
                        counts = counts.at[i].add(
                            jnp.where(crossed[i], 1, 0))
                        return hits, counts
                    return jax.lax.fori_loop(0, nev, upd, (hits, counts))

                hits, counts = jax.lax.cond(
                    any_cross, with_hits, lambda a: a, (hits, counts))
                stop = stop | jnp.any(crossed & (stops_np == 1))
                x2 = jnp.where(accept, xn, x)
                t2 = jnp.where(accept, tn, t)
                v2 = jnp.where(accept, vn, vprev)
                ok = jnp.isfinite(jnp.sum(x2))
                return (x2, t2, hnew, nst + 1, ok, v2, hits, counts, stop)

            init = (x0, t0, jnp.asarray(self.DefStepSize), 0,
                    jnp.asarray(True), v00, hits0, counts0,
                    jnp.asarray(False))
            x, t, h, nst, ok, vp, hits, counts, stop = jax.lax.while_loop(
                cond, body, init)
            final = full_row(x, t, u0, p)
            # when a stop-event fired, the terminal row is the earliest
            # stopping crossing (reference stops AT the event)
            last_rows = jnp.stack([
                hits[i, jnp.maximum(counts[i] - 1, 0)] for i in range(nev)])
            tcand = jnp.where((stops_np == 1) & (counts > 0),
                              sgn * last_rows[:, XV], jnp.inf)
            best = jnp.argmin(tcand)
            use = stop & jnp.isfinite(tcand[best])
            final = jnp.where(use, last_rows[best], final)
            return final, hits, counts

        return run

    def _get(self, key):
        f = self._jits.get(key)
        if f is None:
            core = self._make_core()
            if key == "one":
                f = jax.jit(core)
            elif key == "batch":
                f = jax.jit(jax.vmap(core, in_axes=(0, 0)))
            elif key == "dense":
                def dense(row, ts):
                    def scan_fn(r, t):
                        rn = core(r, t)
                        return rn, rn
                    _, rows = jax.lax.scan(scan_fn, row, ts)
                    return rows
                f = jax.jit(dense)
            elif key == "stm":
                def stm(row, tf):
                    return core(row, tf), jax.jacfwd(core)(row, tf)
                f = jax.jit(stm)
            elif key == "stm_batch":
                def stm1(row, tf):
                    return core(row, tf), jax.jacfwd(core)(row, tf)
                f = jax.jit(jax.vmap(stm1, in_axes=(0, 0)))
            self._jits[key] = f
        return f

    # ------------------------------------------------------------ public API
    def _row(self, x0):
        row = np.asarray(x0, dtype=np.float64).ravel()
        need = self.ode.XtUPVars()
        if row.size == need:
            return row
        if row.size == self.ode.XtVars() and self.ode.UVars() == 0 \
                and self.ode.PVars() == 0:
            return row
        if row.size < need:
            row = np.concatenate([row, np.zeros(need - row.size)])
        return row[:need]

    def integrate(self, x0, tf):
        row = self._row(x0)
        return np.asarray(self._get("one")(jnp.asarray(row),
                                           jnp.asarray(float(tf))))

    def integrate_parallel(self, x0s, tfs):
        rows = jnp.asarray(np.stack([self._row(r) for r in x0s]))
        tfs = jnp.asarray(np.asarray(tfs, dtype=np.float64))
        out = self._get("batch")(rows, tfs)
        return [np.asarray(r) for r in out]

    def _norm_events(self, events):
        """Normalize to [(func, direction, stop)] and classify: 'vf' when
        every event is a VectorFunction (jittable path), else 'host'."""
        if callable(events) or isinstance(events, VectorFunction):
            events = [events]
        evs = []
        all_vf = True
        for ev in events:
            if isinstance(ev, (tuple, list)):
                f, direction, stop = (list(ev) + [0, 0])[:3]
            else:
                f, direction, stop = ev, 0, 1
            if not isinstance(f, VectorFunction):
                all_vf = False
            evs.append((f, int(direction), int(stop)))
        return evs, all_vf

    def _get_events(self, evs, max_hits):
        """Cached jitted event-locating core for a normalized event list."""
        key = ("ev", tuple(id(f) for f, d, s in evs),
               tuple(d for f, d, s in evs), tuple(s for f, d, s in evs),
               max_hits)
        fn = self._jits.get(key)
        if fn is None:
            evfuns = [(lambda row, f=f: f.trace(row[:f.IRows()]))
                      for f, d, s in evs]
            core = self._make_core_events(
                evfuns, [d for f, d, s in evs], [s for f, d, s in evs],
                max_hits=max_hits)
            fn = jax.jit(core)
            self._jits[key] = fn
            self._jits[("evb",) + key[1:]] = jax.jit(
                jax.vmap(core, in_axes=(0, 0)))
        return fn

    def integrate_dense(self, x0, tf, nsteps=None, events=None,
                        max_hits=4):
        """Dense-output integration (+ optional event detection).

        Performance notes: with VectorFunction events the trajectory is
        propagated TWICE (one jittable event sweep + one dense-grid
        pass); with non-VectorFunction (python-callable) events the
        bisection runs host-side per step — a compatibility path that is
        orders of magnitude slower than the jitted sweep.  Prefer
        VectorFunction events, or `integrate_dense_parallel` for
        batches."""
        # reference overloads: integrate_dense(x0, tf, [events...]) — a
        # list/tuple of events (or a bare callable) in the nsteps slot
        if events is None and nsteps is not None and not isinstance(
                nsteps, (int, np.integer)):
            events, nsteps = nsteps, None
        row = self._row(x0)
        t0 = row[self.ode.XVars()]
        if events:
            evs, all_vf = self._norm_events(events)
            tuple_form = isinstance(events, (list, tuple)) and any(
                isinstance(e, (list, tuple)) for e in events)
            if all_vf:
                fn = self._get_events(evs, max_hits)
                xf_row, hits, counts = fn(jnp.asarray(row),
                                          jnp.asarray(float(tf)))
                xf_row = np.asarray(xf_row)
                counts = np.asarray(counts)
                hits = np.asarray(hits)
                tstop = xf_row[self.ode.XVars()]
                n = nsteps or max(
                    int(abs(tstop - t0) / self.DefStepSize) + 1, 2)
                traj = self.integrate_dense(row, tstop, int(n))
                traj[-1] = xf_row
                eventlocs = [[hits[i, k] for k in range(int(counts[i]))]
                             for i in range(len(evs))]
                if tuple_form:
                    return traj, eventlocs
                return traj
            traj = self._integrate_dense_events(row, t0, float(tf),
                                                nsteps, events)
            if tuple_form:
                return traj, [traj[-1]]
            return traj
        if nsteps is None:
            nsteps = max(int(abs(float(tf) - t0) / self.DefStepSize) + 1, 2)
        ts = jnp.asarray(np.linspace(t0, float(tf), int(nsteps))[1:])
        rows = self._get("dense")(jnp.asarray(row), ts)
        row0 = row.copy()
        if self._controller is not None and self.ode.UVars():
            # the control-law closure defines u everywhere, including t0
            # (reference controller integrators overwrite the seed controls)
            XV, UV = self.ode.XVars(), self.ode.UVars()
            u0 = self._u_of(jnp.asarray(row[:XV]), jnp.asarray(row[XV]),
                            jnp.asarray(row[XV + 1:XV + 1 + UV]))
            row0[XV + 1:XV + 1 + UV] = np.asarray(u0)
        return [row0] + [np.asarray(r) for r in rows]

    def integrate_dense_parallel(self, x0s, tfs, events=None, ncores=None,
                                 nsteps=None, max_hits=4):
        # reference: integrate_dense_parallel(IGs, ts, events, nthreads) —
        # the batch event sweep is ONE vmapped jit over all trajectories
        if events is not None and not isinstance(events, (list, tuple)):
            events = [events]
        if events is not None and len(events) and not any(
                isinstance(e, (tuple, list)) or
                isinstance(e, VectorFunction) or callable(e)
                for e in events):
            events = None
        if events:
            evs, all_vf = self._norm_events(events)
            if all_vf:
                self._get_events(evs, max_hits)
                key = ("evb", tuple(id(f) for f, d, s in evs),
                       tuple(d for f, d, s in evs),
                       tuple(s for f, d, s in evs), max_hits)
                fnb = self._jits[key]
                rows = jnp.asarray(np.stack([self._row(r) for r in x0s]))
                tfa = jnp.asarray(np.asarray(tfs, dtype=np.float64))
                xfs, hits, counts = fnb(rows, tfa)
                xfs = np.asarray(xfs)
                hits = np.asarray(hits)
                counts = np.asarray(counts)
                out = []
                XV = self.ode.XVars()
                for bi in range(len(x0s)):
                    row = self._row(x0s[bi])
                    t0 = row[XV]
                    tstop = xfs[bi][XV]
                    n = nsteps or max(
                        int(abs(tstop - t0) / self.DefStepSize) + 1, 2)
                    traj = self.integrate_dense(row, tstop, int(n))
                    traj[-1] = xfs[bi]
                    evlocs = [[hits[bi, i, k]
                               for k in range(int(counts[bi, i]))]
                              for i in range(len(evs))]
                    out.append((traj, evlocs))
                return out
            return [self.integrate_dense(x, t, nsteps, events)
                    for x, t in zip(x0s, tfs)]
        return [self.integrate_dense(x, t, nsteps)
                for x, t in zip(x0s, tfs)]

    def integrate_stm(self, x0, tf):
        row = self._row(x0)
        xf, jac = self._get("stm")(jnp.asarray(row), jnp.asarray(float(tf)))
        return np.asarray(xf), np.asarray(jac)

    def integrate_stm2(self, x0, tf):
        """State-transition matrix AND second-order sensitivities
        d2 x(tf) / d x0^2 by forward-over-forward AD through the adaptive
        loop (reference integrate_stm2, `Integrator.h:1719`)."""
        key = "stm2"
        f = self._jits.get(key)
        if f is None:
            core = self._make_core()

            def stm2(row, tf):
                xf = core(row, tf)
                jac = jax.jacfwd(core)(row, tf)
                hess = jax.jacfwd(jax.jacfwd(core))(row, tf)
                return xf, jac, hess
            f = jax.jit(stm2)
            self._jits[key] = f
        row = self._row(x0)
        xf, jac, hess = f(jnp.asarray(row), jnp.asarray(float(tf)))
        return np.asarray(xf), np.asarray(jac), np.asarray(hess)

    def integrate_stm_parallel(self, x0s, tfs, ncores=None):
        rows = jnp.asarray(np.stack([self._row(r) for r in x0s]))
        tfs = jnp.asarray(np.asarray(tfs, dtype=np.float64))
        xfs, jacs = self._get("stm_batch")(rows, tfs)
        return [(np.asarray(x), np.asarray(j)) for x, j in zip(xfs, jacs)]

    # --------------------------------------------------------------- events
    def _integrate_dense_events(self, row, t0, tf, nsteps, events):
        """Bisection event location on a dense grid (reference EventPack,
        `Integrator.h:538-690`).  events: list of (func, direction, stop)."""
        if callable(events) or isinstance(events, VectorFunction):
            events = [events]
        evs = []
        for ev in events:
            if isinstance(ev, (tuple, list)):
                f, direction, stop = (list(ev) + [0, 0])[:3]
            else:
                # a bare event (reference stop-functions like
                # ``lambda x: x[1] < 0``) is a stopping condition
                f, direction, stop = ev, 0, 1
            evs.append((f, int(direction), int(stop)))
        n = nsteps or max(int(abs(tf - t0) / self.DefStepSize) + 1, 2)
        traj = self.integrate_dense(row, tf, n)
        one = self._get("one")

        def evval(f, r):
            if isinstance(f, VectorFunction):
                return float(np.asarray(f.compute(r[:f.IRows()])).ravel()[0])
            out = f(np.asarray(r))
            if isinstance(out, (bool, np.bool_)):
                return 1.0 if out else -1.0
            return float(np.asarray(out).ravel()[0])

        out = [traj[0]]
        for i in range(1, len(traj)):
            r0, r1 = traj[i - 1], traj[i]
            stop_here = False
            for (f, direction, stop) in evs:
                v0, v1 = evval(f, r0), evval(f, r1)
                crossed = (v0 * v1 < 0) and (
                    direction == 0 or (direction > 0 and v1 > v0)
                    or (direction < 0 and v1 < v0))
                if crossed and stop:
                    ta, tb = r0[self.ode.XVars()], r1[self.ode.XVars()]
                    ra = r0
                    for _ in range(self.MaxEventIters):
                        tm = 0.5 * (ta + tb)
                        rm = np.asarray(one(jnp.asarray(ra),
                                            jnp.asarray(tm)))
                        vm = evval(f, rm)
                        if v0 * vm <= 0:
                            tb = tm
                        else:
                            ta, ra, v0 = tm, rm, vm
                        if abs(tb - ta) < self.EventTol:
                            break
                    rm = np.asarray(one(jnp.asarray(r0), jnp.asarray(tb)))
                    out.append(rm)
                    stop_here = True
                    break
            if stop_here:
                return out
            out.append(r1)
        return out
