"""Phase: collocation transcription of one ODE over a mesh + user API.

JAX redesign of `src/OptimalControl/ODEPhase.h` + `ODEPhaseBase.{h,cpp}`
+ `PhaseIndexer.{h,cpp}`:

* Variable layout per phase: [ (x_i, u_i) for node i ] ++ [t0, tf] ++
  [ODE params] ++ [static params].  Unlike the reference (one time variable
  per cardinal state + MeshSpacingConstraints tying them to t0/tf,
  `MeshSpacingConstraints.h`), node times here are affine in the two border
  variables t0/tf via the fixed normalized mesh tau_i — fewer variables, no
  spacing rows, and the KKT stays block-banded in node index with a tiny
  dense border (the sharding seam for the block solver).
* Every constraint/objective becomes an IndexedFunction family: one traced
  jnp closure + a (napps, nin) gather matrix + per-application constants
  (mesh fractions), evaluated with a single vmap per kind.
* Defects: Hermite-LGL schemes (LGL3/5/7) with coefficients derived in
  lgl.py; Trapezoidal.  Control modes: FirstOrderSpline (default, reference
  `ODEPhaseBase.h:51`), HighestOrderSpline, NoSpline, BlockConstant.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ..config import DEFAULT_DTYPE
from ..VectorFunctions.function import VectorFunction
from ..Solvers.nlp import NonLinearProgram, IndexedFunction
from ..Solvers.psiopt import PSIOPT, ConvergenceFlags
from .lgl import get_scheme

__all__ = ["Phase", "PhaseRegionFlags", "TranscriptionModes", "ControlModes"]


class TranscriptionModes:
    LGL3 = "LGL3"
    LGL5 = "LGL5"
    LGL7 = "LGL7"
    Trapezoidal = "Trapezoidal"
    CentralShooting = "CentralShooting"


class ControlModes:
    HighestOrderSpline = "HighestOrderSpline"
    FirstOrderSpline = "FirstOrderSpline"
    NoSpline = "NoSpline"
    BlockConstant = "BlockConstant"


class PhaseRegionFlags:
    Front = "Front"
    Back = "Back"
    Path = "Path"
    InnerPath = "InnerPath"
    NodalPath = "NodalPath"
    FrontandBack = "FrontandBack"
    BackandFront = "BackandFront"
    PairWisePath = "PairWisePath"
    ODEParams = "ODEParams"
    StaticParams = "StaticParams"


_REGION_ALIASES = {
    "First": "Front", "Last": "Back", "FirstandLast": "FrontandBack",
    "LastandFirst": "BackandFront", "NodalPath": "Path",
}


def _canon_region(reg):
    reg = str(reg)
    return _REGION_ALIASES.get(reg, reg)


def _tracefun(f):
    """Extract a traced callable from a VectorFunction or raw callable."""
    if isinstance(f, VectorFunction):
        return f.trace, f.IRows(), f.ORows()
    raise TypeError("expected a VectorFunction")


class _Spec:
    """One user-added constraint/objective, pre-transcription.

    `data` (optional, np (ndata,)) is runtime-updatable constant data
    (boundary values, lock targets): it rides in the family consts, which
    are threaded through every jitted evaluator as runtime arguments, so
    `subVariables` can change it between solves with no retranscription and
    no retrace (reference LockedValues / subVariables,
    `ODEPhaseBase.cpp:95`).  A data-carrying spec's fun has signature
    fun(full_region_input, data)."""

    def __init__(self, kind, region, fun, nout, name, data=None):
        self.kind = kind          # 'eq' | 'iq' | 'obj' | 'intobj'
        self.region = region
        self.fun = fun            # fun(full_region_input (jnp,)) -> (nout,)
        self.nout = nout
        self.name = name
        self.data = None if data is None else \
            np.asarray(data, np.float64).ravel()


class Phase:

    def __init__(self, ode, tmode, IG=None, numsegs=None, spacefun=None):
        self.ode = ode
        self.TranscriptionMode = str(tmode)
        self.ControlMode = ControlModes.FirstOrderSpline
        self.XV, self.UV, self.PV = ode.XVars(), ode.UVars(), ode.PVars()
        self.SPV = 0                      # static params
        self._static_params = np.zeros(0)
        self.optimizer = PSIOPT()
        self._specs: list[_Spec] = []
        self.AdaptiveMesh = False
        self.MeshTol = 1.0e-6
        self.MaxMeshIters = 10
        self.MeshErrorEstimator = "integrator"
        self.MeshErrorCriteria = "max"
        self.MeshRedFactor = 0.5
        self.MeshIncFactor = 5.0
        self.MinSegments = 4
        self.MaxSegments = 10000
        self.MeshErrFactor = 10.0
        self.MeshConverged = False
        self.DetectControlSwitches = False
        self.SwitchTol = 0.1
        self.NumExtraAddsPerSwitch = 4
        self.AutoScaling = False
        self._units = None
        self.Threads = 1
        self.JetJobMode = "optimize"
        self._numsegs = None
        self._traj = None                  # ActiveTraj rows [x, t, u]
        self._odeparams = np.zeros(self.PV)
        self._nlp = None
        self._need_transcribe = True
        self._eq_mult_slices = {}
        self._defect_rows = None
        self._locks = []            # (spec_idx, region, var index array)
        self._struct_key = None     # last-transcription structure signature
        self._built = None          # [(family, spec_or_None)] of last build
        if numsegs is not None:
            self.setTraj(IG, numsegs)
        elif IG is not None:
            self.setTraj(IG, max(len(IG) - 1, 4))

    # ------------------------------------------------------------------ mesh
    def _node_structure(self, numsegs, seg_bounds=None):
        """Set nodes-per-segment layout and normalized node times.

        seg_bounds: optional (numsegs+1,) non-uniform normalized segment
        boundaries (error-equidistributed meshes from adaptive refinement);
        default uniform."""
        tm = self.TranscriptionMode
        S = int(numsegs)
        if tm in ("LGL3", "Trapezoidal", "CentralShooting"):
            self._cs = 2
        elif tm == "LGL5":
            self._cs = 3
        elif tm == "LGL7":
            self._cs = 4
        else:
            raise NotImplementedError(f"transcription mode {tm}")
        cs = self._cs
        self._scheme = get_scheme("LGL3" if cs == 2 else tm)
        self.numSegs = S
        self.numNodes = S * (cs - 1) + 1
        if seg_bounds is None:
            bounds = np.linspace(0.0, 1.0, S + 1)
        else:
            bounds = np.asarray(seg_bounds, np.float64)
            if bounds.shape != (S + 1,):
                raise ValueError(
                    f"seg_bounds must have {S + 1} entries, got "
                    f"{bounds.shape}")
        taus = [0.0]
        for k in range(S):
            a, b = bounds[k], bounds[k + 1]
            for ct in self._scheme.cardinal_tau[1:]:
                taus.append(a + ct * (b - a))
        self.taus = np.asarray(taus)
        self.seg_bounds = bounds
        # cardinal node indices per segment
        self.seg_nodes = np.stack([
            np.arange(k * (cs - 1), k * (cs - 1) + cs) for k in range(S)])

    # -------------------------------------------------------- variable layout
    @property
    def _m(self):
        return self.XV + self.UV

    def _xvar(self, node, i):
        return node * self._m + i

    def _uvar(self, node, j):
        if self.ControlMode == ControlModes.BlockConstant:
            cs = self._cs
            seg = min(node // (cs - 1), self.numSegs - 1)
            node = seg * (cs - 1)
        return node * self._m + self.XV + j

    @property
    def _t0i(self):
        return self.numNodes * self._m

    @property
    def _tfi(self):
        return self._t0i + 1

    def _opi(self, k):
        return self._tfi + 1 + k

    def _spi(self, k):
        return self._tfi + 1 + self.PV + k

    @property
    def numVars(self):
        return self.numNodes * self._m + 2 + self.PV + self.SPV

    # ------------------------------------------------------------------- IG
    def setTraj(self, IG, numsegs=None, *args, seg_bounds=None):
        # reference overload setTraj(IG, nsegs, SegBins/DistFunc): a
        # non-uniform bounds array may also come positionally
        if args and seg_bounds is None and args[0] is not None \
                and not isinstance(args[0], (bool, int)):
            seg_bounds = np.asarray(args[0], np.float64)
        IG = np.asarray([np.asarray(r, dtype=np.float64).ravel() for r in IG])
        need = self.XV + 1 + self.UV
        if IG.shape[1] < need:
            raise ValueError(
                f"IG rows must have at least {need} entries [x,t,u]")
        if numsegs is None:
            numsegs = self._numsegs or max(len(IG) - 1, 4)
        self._numsegs = int(numsegs)
        self._node_structure(self._numsegs, seg_bounds=seg_bounds)
        tcol = IG[:, self.XV]
        self.t0 = float(tcol[0])
        self.tf = float(tcol[-1])
        span = self.tf - self.t0 if self.tf != self.t0 else 1.0
        tau_ig = (tcol - self.t0) / span
        # guard monotonicity for interp
        tau_ig = np.maximum.accumulate(tau_ig)
        cols = [c for c in range(IG.shape[1]) if c != self.XV]
        node_rows = np.empty((self.numNodes, self.XV + 1 + self.UV))
        for ci, c in enumerate([*range(self.XV)]):
            node_rows[:, c] = np.interp(self.taus, tau_ig, IG[:, c])
        node_rows[:, self.XV] = self.t0 + self.taus * span
        for j in range(self.UV):
            node_rows[:, self.XV + 1 + j] = np.interp(
                self.taus, tau_ig, IG[:, self.XV + 1 + j])
        self._traj = node_rows
        if self.PV > 0 and IG.shape[1] >= need + self.PV:
            self._odeparams = IG[:, need:need + self.PV].mean(axis=0)
        self._need_transcribe = True

    def refineTrajManual(self, numsegs):
        """Re-mesh the current trajectory onto `numsegs` segments
        (reference `ODEPhaseBase.cpp:673`)."""
        self.resampleTraj(numsegs)

    def refineTrajEqual(self, numsegs):
        self.refineTrajManual(numsegs)

    def resampleTraj(self, numsegs, seg_bounds=None):
        """Re-mesh through the scheme-order interpolant: new node states
        from the degree-(2cs-1) segment Hermite, controls from the
        scheme's Lagrange interpolant — keeps the solution's h^(2cs-2)
        accuracy across mesh updates (reference re-interpolates via
        LGLInterpTable at transcription order; plain setTraj on raw rows
        is linear)."""
        from .interp_table import LGLInterpTable
        if self._traj is None:
            raise ValueError("resampleTraj requires an existing trajectory")
        tab = LGLInterpTable.from_phase(self)
        self._numsegs = int(numsegs)
        self._node_structure(self._numsegs, seg_bounds=seg_bounds)
        ts_new = self.t0 + self.taus * (self.tf - self.t0)
        vals = tab.eval_batch(ts_new)                   # (N, XV+UV)
        rows = np.empty((len(ts_new), self.XV + 1 + self.UV))
        rows[:, :self.XV] = vals[:, :self.XV]
        rows[:, self.XV] = ts_new
        rows[:, self.XV + 1:] = vals[:, self.XV:]
        self._traj = rows
        self._need_transcribe = True

    # ------------------------------------------------------------ params API
    def setStaticParams(self, vals, *args):
        self._static_params = np.asarray(vals, dtype=np.float64).ravel()
        self.SPV = self._static_params.size
        self._need_transcribe = True

    def setControlMode(self, mode):
        self.ControlMode = str(mode)
        self._need_transcribe = True

    def setThreads(self, *a):
        pass

    def setUnits(self, *a, **kw):
        """Canonical units per XtUP variable (reference
        `ODEPhaseBase.h:201` setUnits), consumed by auto-scaling."""
        if a and not isinstance(a[0], (int, float)):
            u = np.asarray(a[0], dtype=np.float64).ravel()
        elif a:
            u = np.asarray(a, dtype=np.float64).ravel()
        else:
            u = None
        need = self.XV + 1 + self.UV + self.PV
        if u is not None:
            if u.size < need:
                u = np.concatenate([u, np.ones(need - u.size)])
            self._xtup_units = u[:need]
        if kw:
            units = getattr(self, "_xtup_units", None)
            if units is None:
                units = np.ones(need)
            for name, val in kw.items():
                units[self._resolve_idx(name)] = float(val)
            self._xtup_units = units
        self._units = (a, kw)

    def setAutoScaling(self, flag=True, *a):
        self.AutoScaling = bool(flag)

    def setAdaptiveMesh(self, flag=True, *a):
        self.AdaptiveMesh = bool(flag)

    def setMeshTol(self, tol):
        self.MeshTol = float(tol)

    def setMaxMeshIters(self, n):
        self.MaxMeshIters = int(n)

    def setControlSwitchDetection(self, flag=True, tol=0.1, extra=4):
        """Reference calcSwitches knobs (`ODEPhaseBase.cpp:1544`)."""
        self.DetectControlSwitches = bool(flag)
        self.SwitchTol = float(tol)
        self.NumExtraAddsPerSwitch = int(extra)

    def setMeshErrorEstimator(self, est):
        self.MeshErrorEstimator = str(est)

    def setMeshErrorCriteria(self, c):
        self.MeshErrorCriteria = str(c)

    def setMeshErrFactor(self, f):
        self.MeshErrFactor = float(f)

    def setMeshRedFactor(self, f):
        self.MeshRedFactor = float(f)

    def setMeshIncFactor(self, f):
        self.MeshIncFactor = float(f)

    def setMinSegments(self, n):
        self.MinSegments = int(n)

    def setMaxSegments(self, n):
        self.MaxSegments = int(n)

    def PrintMeshInfo(self, *a):
        pass

    @property
    def integrator(self):
        """Phase-owned integrator (reference `phase.integrator`), used for
        mesh-error re-integration and available for user stepping."""
        if getattr(self, "_integrator", None) is None:
            from ..Integrators import Integrator
            span = abs(self.tf - self.t0) if self._traj is not None else 1.0
            self._integrator = Integrator(
                self.ode, 0.1 * span / max(self.numSegs, 1))
        return self._integrator

    # ------------------------------------------------- region input assembly
    def _region_apps(self, region):
        """Node tuples + taus per application for a node-based region."""
        N = self.numNodes
        region = _canon_region(region)
        if region == "Front":
            return [(0,)], [(0.0,)]
        if region == "Back":
            return [(N - 1,)], [(1.0,)]
        if region == "Path":
            return [(i,) for i in range(N)], [(self.taus[i],)
                                              for i in range(N)]
        if region == "InnerPath":
            return [(i,) for i in range(1, N - 1)], \
                [(self.taus[i],) for i in range(1, N - 1)]
        if region == "FrontandBack":
            return [(0, N - 1)], [(0.0, 1.0)]
        if region == "BackandFront":
            return [(N - 1, 0)], [(1.0, 0.0)]
        if region == "PairWisePath":
            return [(i, i + 1) for i in range(N - 1)], \
                [(self.taus[i], self.taus[i + 1]) for i in range(N - 1)]
        raise ValueError(f"unsupported phase region: {region}")

    def _gather_nodes(self, nodes_per_app, segs=None):
        """Vidx rows: [node vars ... , t0, tf, odeparams, staticparams].

        With ControlMode BlockConstant, control slots are rewired to the
        owning segment's block slot (reference Blocked_ODE_Wrapper.h); when a
        family is built per-segment (`segs` given), ALL its nodes use that
        segment's block — including the cardinal shared with the next
        segment."""
        m = self._m
        block = self.ControlMode == ControlModes.BlockConstant
        cs = getattr(self, "_cs", 2)
        rows = []
        tail = [self._t0i, self._tfi] + \
            [self._opi(k) for k in range(self.PV)] + \
            [self._spi(k) for k in range(self.SPV)]
        for a, nodes in enumerate(nodes_per_app):
            row = []
            for nd in nodes:
                row.extend([self._xvar(nd, i) for i in range(self.XV)])
                if block:
                    seg = segs[a] if segs is not None else \
                        min(nd // (cs - 1), self.numSegs - 1)
                    un = seg * (cs - 1)
                    row.extend([un * m + self.XV + j
                                for j in range(self.UV)])
                else:
                    row.extend([nd * m + self.XV + j
                                for j in range(self.UV)])
            row.extend(tail)
            rows.append(row)
        return np.asarray(rows, dtype=np.int32)

    def _region_input_fun(self, user_fun, nnodes, with_data=False):
        """Wrap user_fun (input [xtu_1,...,xtu_k, op, sp]) over the gathered
        variables [nodevars..., t0, tf, op, sp] with node times affine in
        (t0, tf).  with_data: user_fun also receives the runtime data columns
        of the consts row (c[nnodes:])."""
        XV, UV, PV, SPV = self.XV, self.UV, self.PV, self.SPV
        m = XV + UV

        def fun(g, c):
            t0 = g[nnodes * m]
            tf = g[nnodes * m + 1]
            parts = []
            for j in range(nnodes):
                x = g[j * m:j * m + XV]
                u = g[j * m + XV:(j + 1) * m]
                t = t0 * (1.0 - c[j]) + tf * c[j]
                parts.extend([x, t[None], u])
            parts.append(g[nnodes * m + 2:])   # op ++ sp
            inp = jnp.concatenate(parts)
            if with_data:
                return jnp.atleast_1d(user_fun(inp, c[nnodes:]))
            return jnp.atleast_1d(user_fun(inp))
        return fun

    def _region_family(self, region, user_fun, nout, name, data=None):
        region = _canon_region(region)
        if region in ("ODEParams", "StaticParams"):
            if region == "ODEParams":
                idx = [[self._opi(k) for k in range(self.PV)]]
            else:
                idx = [[self._spi(k) for k in range(self.SPV)]]
            if data is not None:
                fun = lambda g, c: jnp.atleast_1d(user_fun(g, c))
                fam = IndexedFunction(fun, np.asarray(idx, np.int32),
                                      data[None, :], name=name)
                fam._data_cols = (0, data.size)
                return fam
            fun = lambda g, c: jnp.atleast_1d(user_fun(g))
            return IndexedFunction(fun, np.asarray(idx, np.int32),
                                   np.zeros((1, 1)), name=name)
        apps, taus = self._region_apps(region)
        Vidx = self._gather_nodes(apps)
        consts = np.asarray(taus, dtype=np.float64)
        ntau = consts.shape[1]
        if data is not None:
            consts = np.concatenate(
                [consts, np.tile(data, (len(apps), 1))], axis=1)
        fun = self._region_input_fun(user_fun, len(apps[0]),
                                     with_data=data is not None)
        fam = IndexedFunction(fun, Vidx, consts, name=name)
        fam._region = region
        fam._ntau = ntau
        if data is not None:
            fam._data_cols = (ntau, data.size)
        return fam

    def _region_input_width(self, region):
        region = _canon_region(region)
        per = self.XV + 1 + self.UV
        if region == "ODEParams":
            return self.PV
        if region == "StaticParams":
            return self.SPV
        if region in ("FrontandBack", "BackandFront", "PairWisePath"):
            return 2 * per
        return per

    # ------------------------------------------------------------- user API
    def _resolve_idx(self, indices):
        """Normalize variable-index arguments: ints, iterables, or Vgroup
        names (reference VarIndexType, `InterfaceTypes.h:11-25`)."""
        groups = getattr(self.ode, "Vgroups", {}) or {}
        if isinstance(indices, str):
            return np.asarray(groups[indices], dtype=np.int32)
        if isinstance(indices, (int, np.integer)):
            return np.asarray([indices], dtype=np.int32)
        out = []
        for v in indices:
            if isinstance(v, str):
                out.extend(groups[v])
            else:
                out.append(int(v))
        return np.asarray(out, dtype=np.int32)

    def _add(self, kind, region, fun, nout, name, data=None):
        self._specs.append(_Spec(kind, region, fun, nout, name, data=data))
        self._need_transcribe = True
        return len(self._specs) - 1

    def addEqualCon(self, region, func, *args):
        tf_, ir, orr = self._prep_user_func(region, func, args)
        return self._add("eq", region, tf_, orr, "user_eq")

    def addInequalCon(self, region, func, *args):
        tf_, ir, orr = self._prep_user_func(region, func, args)
        return self._add("iq", region, tf_, orr, "user_iq")

    def _prep_user_func(self, region, func, args):
        """Normalize (func, optional index subsets) into a full-region-input
        closure.  Supports addEqualCon(reg, func, XtUVars[, OPVars, SPVars])
        subset forms (reference `OptimizationProblem.h:90-132` analogs)."""
        trace, ir, orr = _tracefun(func)
        width = self._region_input_width(region)
        if not args:
            if ir != width:
                # maybe function over [xtu..., op, sp]
                if ir == width + self.PV + self.SPV and \
                        _canon_region(region) not in ("ODEParams",
                                                      "StaticParams"):
                    per_n = width
                    def f_full(inp):
                        return trace(inp)
                    return f_full, ir, orr
                raise ValueError(
                    f"function input size {ir} != region width {width}")
            reg = _canon_region(region)
            if reg not in ("ODEParams", "StaticParams"):
                per = width
                def f_trim(inp, per=per):
                    return trace(inp[:per])
                return f_trim, ir, orr
            return trace, ir, orr
        # subset index form
        xtuv = self._resolve_idx(args[0])
        opv = np.asarray(args[1], dtype=np.int32).ravel() if len(args) > 1 \
            else np.zeros(0, np.int32)
        spv = np.asarray(args[2], dtype=np.int32).ravel() if len(args) > 2 \
            else np.zeros(0, np.int32)
        per = self.XV + 1 + self.UV
        nnodes = 2 if _canon_region(region) in (
            "FrontandBack", "BackandFront", "PairWisePath") else 1
        sel = np.concatenate([
            xtuv,
            nnodes * per + opv,
            nnodes * per + self.PV + spv]).astype(np.int32)
        if len(sel) != ir:
            raise ValueError(
                f"selected {len(sel)} vars but function takes {ir}")
        selj = np.asarray(sel)

        def f_sub(inp):
            return trace(inp[selj])
        return f_sub, ir, orr

    # boundary values / locks ------------------------------------------------
    def addBoundaryValue(self, region, indices, values):
        idx = np.asarray(self._resolve_idx(indices))
        vals = np.asarray(values, dtype=np.float64).ravel()
        def fun(inp, d):
            return inp[idx] - d
        si = self._add("eq", region, fun, int(idx.shape[0]), "boundary",
                       data=vals)
        self._locks.append((si, _canon_region(region),
                            np.asarray(self._resolve_idx(indices))))
        return si

    def addValueLock(self, region, indices):
        """Pin variables to their current IG values; update the pinned
        values later with subVariables — no retranscription (reference
        `ODEPhaseBase.cpp:95`)."""
        vals = self._values_at_region(region, indices)
        return self.addBoundaryValue(region, indices, vals)

    def subVariables(self, region, indices, values):
        """Substitute new values for variables pinned by addValueLock /
        addBoundaryValue in `region` (reference subVariables,
        `ODEPhaseBase.h`): updates the lock targets AND the trajectory so
        the next solve starts consistent.  Zero-recompile: lock data rides
        in runtime consts."""
        region = _canon_region(region)
        idx = np.asarray(self._resolve_idx(indices))
        values = np.asarray(values, np.float64).ravel()
        hit = False
        for si, reg, lidx in self._locks:
            if reg != region:
                continue
            pos = {int(v): k for k, v in enumerate(lidx)}
            sel = [pos[int(v)] for v in idx if int(v) in pos]
            if len(sel) != len(idx):
                continue
            spec = self._specs[si]
            spec.data[np.asarray(sel)] = values
            hit = True
            break
        if not hit:
            raise ValueError(
                f"subVariables: no value lock covering {region} {idx}")
        # reflect into the active trajectory / params (reference substitutes
        # into ActiveTraj so makeSolverInput is consistent with the lock)
        if region == "StaticParams":
            self._static_params[idx] = values
            return self._push_spec_data(si)
        if region == "ODEParams":
            self._odeparams[idx] = values
            return self._push_spec_data(si)
        row = {"Front": 0, "Back": self.numNodes - 1}.get(region)
        if row is not None and self._traj is not None:
            per = self.XV + 1 + self.UV
            for v, val in zip(idx, values):
                if v < per:
                    self._traj[row, v] = val
                    if v == self.XV:  # time variable
                        if row == 0:
                            self.t0 = float(val)
                        else:
                            self.tf = float(val)
        self._push_spec_data(si)

    def subVariable(self, region, index, value):
        return self.subVariables(region, [index], [value])

    def _push_spec_data(self, si):
        """Propagate an updated spec.data into the live family consts (if
        transcribed), bumping the NLP consts version so the next jitted call
        picks it up without retracing.  Works for both a phase-owned NLP and
        an OCP-owned NLP (the OCP shifts Vidx but shares the consts
        buffers)."""
        nlp = getattr(self, "_active_nlp", None) or self._nlp
        if self._built is None or nlp is None:
            return
        spec = self._specs[si]
        for fam, sp in self._built:
            if sp is spec and getattr(fam, "_data_cols", None) is not None:
                lo, nd = fam._data_cols
                fam.consts[:, lo:lo + nd] = spec.data[None, :]
        nlp.bump_consts()

    def addPeriodicityCon(self, indices):
        idx = np.asarray(indices, dtype=np.int32).ravel()
        per = self.XV + 1 + self.UV
        def fun(inp):
            return inp[idx] - inp[idx + per]
        return self._add("eq", "FrontandBack", fun, int(idx.shape[0]),
                         "periodicity")

    def _values_at_region(self, region, indices):
        region = _canon_region(region)
        idx = np.asarray(indices, dtype=np.int32)
        if region == "StaticParams":
            return self._static_params[idx]
        if region == "ODEParams":
            return self._odeparams[idx]
        row = {"Front": 0, "Back": self.numNodes - 1}.get(region)
        if row is None:
            raise ValueError(
                "addValueLock supports Front/Back/StaticParams/ODEParams")
        full = np.concatenate([self._traj[0 if row == 0 else -1]])
        return full[idx]

    # bounds ----------------------------------------------------------------
    def addLUVarBound(self, region, var, lb, ub, scale=1.0):
        if isinstance(var, str) or not isinstance(var, (int, np.integer)):
            resolved = self._resolve_idx(var)
            if len(resolved) > 1:
                return self.addLUVarBounds(region, resolved, lb, ub, scale)
            var = int(resolved[0])
        var = int(var); lb = float(lb); ub = float(ub); s = float(scale)
        def fun(inp):
            v = inp[var]
            return jnp.stack([(lb - v) * s, (v - ub) * s])
        return self._add("iq", region, fun, 2, "luvarbound")

    def addLUVarBounds(self, region, varlist, lb, ub, scale=1.0):
        out = []
        for v in self._resolve_idx(varlist):
            out.append(self.addLUVarBound(region, int(v), lb, ub, scale))
        return out

    def addLowerVarBound(self, region, var, lb, scale=1.0):
        if isinstance(var, str):
            var = int(self._resolve_idx(var)[0])
        var = int(var); lb = float(lb); s = float(scale)
        def fun(inp):
            return ((lb - inp[var]) * s)[None]
        return self._add("iq", region, fun, 1, "lowerbound")

    def addUpperVarBound(self, region, var, ub, scale=1.0):
        if isinstance(var, str):
            var = int(self._resolve_idx(var)[0])
        var = int(var); ub = float(ub); s = float(scale)
        def fun(inp):
            return ((inp[var] - ub) * s)[None]
        return self._add("iq", region, fun, 1, "upperbound")

    def addLUFuncBound(self, region, func, indices, lb, ub, scale=1.0):
        trace, ir, orr = _tracefun(func)
        if orr != 1:
            raise ValueError("func bound requires scalar function")
        idx = np.asarray(self._resolve_idx(indices), np.int32).ravel()
        lb = float(lb); ub = float(ub); s = float(scale)
        def fun(inp):
            v = trace(inp[idx])[0]
            return jnp.stack([(lb - v) * s, (v - ub) * s])
        return self._add("iq", region, fun, 2, "lufuncbound")

    def addLowerFuncBound(self, region, func, indices, lb, scale=1.0):
        trace, ir, orr = _tracefun(func)
        idx = np.asarray(self._resolve_idx(indices), dtype=np.int32).ravel()
        lb = float(lb); s = float(scale)
        def fun(inp):
            return (lb - trace(inp[idx])[0])[None] * s
        return self._add("iq", region, fun, 1, "lowerfuncbound")

    def addUpperFuncBound(self, region, func, indices, ub, scale=1.0):
        trace, ir, orr = _tracefun(func)
        idx = np.asarray(self._resolve_idx(indices), dtype=np.int32).ravel()
        ub = float(ub); s = float(scale)
        def fun(inp):
            return (trace(inp[idx])[0] - ub)[None] * s
        return self._add("iq", region, fun, 1, "upperfuncbound")

    def addLUNormBound(self, region, indices, lb, ub, scale=1.0):
        idx = np.asarray(self._resolve_idx(indices))
        lb = float(lb); ub = float(ub); s = float(scale)
        def fun(inp):
            nv = jnp.sqrt(jnp.sum(jnp.square(inp[idx])))
            return jnp.stack([(lb - nv) * s, (nv - ub) * s])
        return self._add("iq", region, fun, 2, "lunormbound")

    def addLowerNormBound(self, region, indices, lb, scale=1.0):
        idx = np.asarray(self._resolve_idx(indices))
        lb = float(lb); s = float(scale)
        def fun(inp):
            nv = jnp.sqrt(jnp.sum(jnp.square(inp[idx])))
            return ((lb - nv) * s)[None]
        return self._add("iq", region, fun, 1, "lowernormbound")

    def addUpperNormBound(self, region, indices, ub, scale=1.0):
        idx = np.asarray(self._resolve_idx(indices))
        ub = float(ub); s = float(scale)
        def fun(inp):
            nv = jnp.sqrt(jnp.sum(jnp.square(inp[idx])))
            return ((nv - ub) * s)[None]
        return self._add("iq", region, fun, 1, "uppernormbound")

    def addLUSquaredNormBound(self, region, indices, lb, ub, scale=1.0):
        idx = np.asarray(self._resolve_idx(indices))
        lb = float(lb); ub = float(ub); s = float(scale)
        def fun(inp):
            nv = jnp.sum(jnp.square(inp[idx]))
            return jnp.stack([(lb - nv) * s, (nv - ub) * s])
        return self._add("iq", region, fun, 2, "lusqnormbound")

    def addUpperDeltaTimeBound(self, ub, scale=1.0):
        ub = float(ub); s = float(scale)
        per = self.XV + 1 + self.UV
        tv = self.XV
        def fun(inp):
            return ((inp[per + tv] - inp[tv] - ub) * s)[None]
        return self._add("iq", "FrontandBack", fun, 1, "upperdtbound")

    def addLowerDeltaTimeBound(self, lb, scale=1.0):
        lb = float(lb); s = float(scale)
        per = self.XV + 1 + self.UV
        tv = self.XV
        def fun(inp):
            return ((lb - (inp[per + tv] - inp[tv])) * s)[None]
        return self._add("iq", "FrontandBack", fun, 1, "lowerdtbound")

    def addDeltaVarEqualCon(self, var, value, scale=1.0):
        var = int(var); value = float(value); s = float(scale)
        per = self.XV + 1 + self.UV
        def fun(inp):
            return ((inp[per + var] - inp[var] - value) * s)[None]
        return self._add("eq", "FrontandBack", fun, 1, "deltavareq")

    def addDeltaTimeEqualCon(self, value, scale=1.0):
        return self.addDeltaVarEqualCon(self.XV, value, scale)

    # objectives -------------------------------------------------------------
    def addValueObjective(self, region, var, scale=1.0):
        if isinstance(var, str):
            var = int(self._resolve_idx(var)[0])
        var = int(var); s = float(scale)
        def fun(inp):
            return (inp[var] * s)[None]
        return self._add("obj", region, fun, 1, "valueobj")

    def addStateObjective(self, region, func, *args):
        tf_, ir, orr = self._prep_user_func(region, func, args)
        if orr != 1:
            raise ValueError("objective must be scalar")
        return self._add("obj", region, tf_, 1, "stateobj")

    def addDeltaVarObjective(self, var, scale=1.0):
        if isinstance(var, str):
            var = int(self._resolve_idx(var)[0])
        var = int(var); s = float(scale)
        per = self.XV + 1 + self.UV
        def fun(inp):
            return ((inp[per + var] - inp[var]) * s)[None]
        return self._add("obj", "FrontandBack", fun, 1, "deltavarobj")

    def addDeltaTimeObjective(self, scale=1.0):
        return self.addDeltaVarObjective(self.XV, scale)

    def addIntegralObjective(self, func, indices, *args):
        trace, ir, orr = _tracefun(func)
        if orr != 1:
            raise ValueError("integral objective must be scalar")
        idx = self._resolve_idx(indices)
        if len(idx) != ir:
            raise ValueError("index list width != function input size")
        return self._add("intobj", "Integral", (trace, idx), 1, "intobj")

    def removeStateObjective(self, which=-1):
        self._remove_kind("obj", which)

    def removeIntegralObjective(self, which=-1):
        self._remove_kind("intobj", which)

    def removeEqualCon(self, which=-1):
        self._remove_kind("eq", which)

    def _remove_kind(self, kind, which):
        idxs = [i for i, s in enumerate(self._specs) if s.kind == kind]
        if not idxs:
            return
        del self._specs[idxs[which]]
        self._need_transcribe = True

    def addIntegralParamFunction(self, func, indices, pnum):
        """Accumulate an integral into static param pnum (reference
        `ODEPhaseBase.h` addIntegralParamFunction): implemented as the
        equality  sum_segments quad(f) - sp[pnum] = 0."""
        trace, ir, orr = _tracefun(func)
        idx = np.asarray(indices, dtype=np.int32).ravel()
        self._specs.append(
            _Spec("inteq", "Integral", (trace, idx, int(pnum)), 1,
                  "intparam"))
        self._need_transcribe = True

    # ------------------------------------------------------------ transcribe
    def _defect_family(self):
        cs = self._cs
        sch = self._scheme
        XV, UV, PV = self.XV, self.UV, self.PV
        m = self._m
        ode_rhs = self.ode.vf().trace
        trap = self.TranscriptionMode == "Trapezoidal"
        if self.TranscriptionMode == "CentralShooting":
            return self._shooting_family()

        x_int = np.asarray(sch.x_interp)
        dx_int = np.asarray(sch.dx_interp)
        u_int = np.asarray(sch.u_interp)
        x_def = np.asarray(sch.x_def)
        dx_def = np.asarray(sch.dx_def)
        i_def = np.asarray(sch.int_def)
        ctau = np.asarray(sch.cardinal_tau)
        itau = np.asarray(sch.interior_tau)

        def fun(g, c):
            t0 = g[cs * m]
            tf = g[cs * m + 1]
            p = g[cs * m + 2:cs * m + 2 + PV]
            T = tf - t0
            dtau = c[1] - c[0]
            h = dtau * T
            xs = jnp.stack([g[j * m:j * m + XV] for j in range(cs)])
            us = jnp.stack([g[j * m + XV:(j + 1) * m] for j in range(cs)])
            ts = t0 + (c[0] + ctau * dtau) * T
            fs = jnp.stack([
                ode_rhs(jnp.concatenate([xs[j], ts[j][None], us[j], p]))
                for j in range(cs)])
            if trap:
                d = xs[0] - xs[1] + 0.5 * h * (fs[0] + fs[1])
                return d
            x_i = x_int @ xs + h * (dx_int @ fs)        # (cs-1, XV)
            u_i = u_int @ us                            # (cs-1, UV)
            t_i = t0 + (c[0] + itau * dtau) * T
            f_i = jnp.stack([
                ode_rhs(jnp.concatenate([x_i[i], t_i[i][None], u_i[i], p]))
                for i in range(cs - 1)])
            d = x_def @ xs + h * (dx_def @ fs) + h * (i_def[:, None] * f_i)
            return d.reshape(-1)

        apps = [tuple(self.seg_nodes[k]) for k in range(self.numSegs)]
        Vidx = self._gather_nodes(apps, segs=list(range(self.numSegs)))
        consts = np.stack([self.seg_bounds[:-1], self.seg_bounds[1:]], axis=1)
        return IndexedFunction(fun, Vidx, consts, name="defects")

    def _shooting_family(self):
        """Central-shooting defects: fixed-step RK4 forward from the
        segment start and backward from the segment end meet at the
        midpoint (reference ShootingDefects.h:11-41, built there by
        composing two integrator calls).  Controls are linear in local
        time between the segment's nodes."""
        XV, UV, PV = self.XV, self.UV, self.PV
        m = self._m
        ode_rhs = self.ode.vf().trace
        nsub = int(getattr(self, "ShooterSubSteps", 4))

        def rk4_span(x, u0, u1, t0, h, p, nsteps, udir):
            # integrate nsteps of RK4 over [t0, t0+h*nsteps]; control
            # linear from u0 (local 0) to u1 (local 1) over the HALF span
            def f(xx, tt, s_loc):
                u = u0 * (1.0 - s_loc) + u1 * s_loc
                return ode_rhs(jnp.concatenate([xx, tt[None], u, p]))
            for i in range(nsteps):
                t = t0 + i * h
                s0 = i / nsteps
                sh = (i + 0.5) / nsteps
                s1 = (i + 1.0) / nsteps
                k1 = f(x, t, s0)
                k2 = f(x + 0.5 * h * k1, t + 0.5 * h, sh)
                k3 = f(x + 0.5 * h * k2, t + 0.5 * h, sh)
                k4 = f(x + h * k3, t + h, s1)
                x = x + (h / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)
            return x

        def fun(g, c):
            t0g = g[2 * m]
            tfg = g[2 * m + 1]
            p = g[2 * m + 2:2 * m + 2 + PV]
            T = tfg - t0g
            dtau = c[1] - c[0]
            hseg = dtau * T
            ta = t0g + c[0] * T
            tb = t0g + c[1] * T
            xa = g[0:XV]
            ua = g[XV:m]
            xb = g[m:m + XV]
            ub = g[m + XV:2 * m]
            nh = max(nsub // 2, 1)
            hf = 0.5 * hseg / nh
            xf_mid = rk4_span(xa, ua, 0.5 * (ua + ub), ta, hf, p, nh, +1)
            xb_mid = rk4_span(xb, ub, 0.5 * (ua + ub), tb, -hf, p, nh, -1)
            return xf_mid - xb_mid

        apps = [tuple(self.seg_nodes[k]) for k in range(self.numSegs)]
        Vidx = self._gather_nodes(apps, segs=list(range(self.numSegs)))
        consts = np.stack([self.seg_bounds[:-1], self.seg_bounds[1:]],
                          axis=1)
        return IndexedFunction(fun, Vidx, consts, name="shooting")

    def _control_families(self):
        """Control regularity constraints per ControlMode (reference
        `LGLControlSplines.h`, Blocked_ODE_Wrapper)."""
        fams = []
        cs, UV, m = self._cs, self.UV, self._m
        if UV == 0 or self.TranscriptionMode in ("Trapezoidal",):
            return fams
        sch = self._scheme
        mode = self.ControlMode
        if mode == ControlModes.BlockConstant:
            # pin orphaned per-node control slots (their gather is rewired to
            # the segment block slot) to keep the KKT nonsingular
            orphan_nodes = [i for i in range(self.numNodes)
                            if not (i % (cs - 1) == 0
                                    and i // (cs - 1) < self.numSegs)]
            if orphan_nodes:
                rows = np.asarray(
                    [[nd * m + self.XV + j for j in range(UV)]
                     for nd in orphan_nodes], np.int32)
                def pin(g, c):
                    return g
                fams.append(IndexedFunction(
                    pin, rows, np.zeros((len(orphan_nodes), 1)),
                    name="blockpin"))
            return fams
        if cs == 2:
            return fams  # piecewise-linear control needs no extra rows
        if mode == ControlModes.NoSpline:
            return fams
        if mode == ControlModes.FirstOrderSpline:
            # interior cardinal controls = linear interp of segment endpoints
            interior = list(range(1, cs - 1))
            ct = sch.cardinal_tau
            w = np.asarray([[1.0 - ct[j], ct[j]] for j in interior])
            wj = np.asarray(w)
            def fun(g, c):
                us = jnp.stack([g[j * m + self.XV:(j + 1) * m]
                                for j in range(cs)])
                lin = wj @ jnp.stack([us[0], us[-1]])
                return (us[1:cs - 1] - lin).reshape(-1)
            apps = [tuple(self.seg_nodes[k]) for k in range(self.numSegs)]
            Vidx = self._gather_nodes(apps)
            consts = np.stack([self.seg_bounds[:-1], self.seg_bounds[1:]],
                              axis=1)
            fams.append(IndexedFunction(fun, Vidx, consts, name="uspline1"))
            return fams
        if mode == ControlModes.HighestOrderSpline:
            # derivative continuity across segment junctions
            d0 = np.asarray(sch.u_dtau0)
            d1 = np.asarray(sch.u_dtau1)
            def fun(g, c):
                # g: two adjacent segments' nodes (2*cs-1 distinct nodes)
                t0 = g[(2 * cs - 1) * m]
                tf = g[(2 * cs - 1) * m + 1]
                T = tf - t0
                h0 = (c[1] - c[0]) * T
                h1 = (c[2] - c[1]) * T
                usA = jnp.stack([g[j * m + self.XV:(j + 1) * m]
                                 for j in range(cs)])
                usB = jnp.stack([g[j * m + self.XV:(j + 1) * m]
                                 for j in range(cs - 1, 2 * cs - 1)])
                return ((d1 @ usA) / h0 - (d0 @ usB) / h1).reshape(-1)
            apps = []
            consts = []
            for k in range(self.numSegs - 1):
                nodes = tuple(self.seg_nodes[k]) + \
                    tuple(self.seg_nodes[k + 1][1:])
                apps.append(nodes)
                consts.append([self.seg_bounds[k], self.seg_bounds[k + 1],
                               self.seg_bounds[k + 2]])
            if apps:
                Vidx = self._gather_nodes(apps)
                fams.append(IndexedFunction(
                    fun, Vidx, np.asarray(consts), name="usplineH"))
            return fams
        return fams

    def _integral_family(self, trace, idx, extra_sp=None):
        """Per-segment quadrature family: reduced (cardinal-only) weights.

        Reference: LGLIntegrals/TrapezoidalIntegrals
        (`src/OptimalControl/LGL*.h`)."""
        cs, m, XV, UV, PV = self._cs, self._m, self.XV, self.UV, self.PV
        sch = self._scheme
        wq = np.asarray(sch.quad_reduced)
        ctau = np.asarray(sch.cardinal_tau)
        idxj = np.asarray(idx)
        spsel = None if extra_sp is None else int(extra_sp)

        def fun(g, c):
            t0 = g[cs * m]
            tf = g[cs * m + 1]
            T = tf - t0
            dtau = c[1] - c[0]
            h = dtau * T
            vals = []
            for j in range(cs):
                x = g[j * m:j * m + XV]
                u = g[j * m + XV:(j + 1) * m]
                t = t0 + (c[0] + ctau[j] * dtau) * T
                xtu = jnp.concatenate([x, t[None], u, g[cs * m + 2:]])
                vals.append(trace(xtu[idxj])[0])
            integ = h * (wq @ jnp.stack(vals))
            if spsel is not None:
                # equality: integral share minus sp/numSegs
                sp = g[cs * m + 2 + PV + spsel]
                return (integ - sp * c[2])[None]
            return integ[None]

        apps = [tuple(self.seg_nodes[k]) for k in range(self.numSegs)]
        Vidx = self._gather_nodes(apps, segs=list(range(self.numSegs)))
        if spsel is not None:
            consts = np.stack([self.seg_bounds[:-1], self.seg_bounds[1:],
                               np.full(self.numSegs, 1.0 / self.numSegs)],
                              axis=1)
        else:
            consts = np.stack([self.seg_bounds[:-1], self.seg_bounds[1:]],
                              axis=1)
        return IndexedFunction(fun, Vidx, consts, name="integral")

    def var_units(self):
        """(numVars,) canonical unit per phase variable (1 = unscaled)."""
        need = self.XV + 1 + self.UV + self.PV
        units = getattr(self, "_xtup_units", None)
        if units is None:
            units = np.ones(need)
        U = np.ones(self.numVars)
        m = self._m
        for nd in range(self.numNodes):
            U[nd * m:nd * m + self.XV] = units[:self.XV]
            U[nd * m + self.XV:(nd + 1) * m] = units[self.XV + 1:
                                                     self.XV + 1 + self.UV]
        U[self._t0i] = units[self.XV]
        U[self._tfi] = units[self.XV]
        for k in range(self.PV):
            U[self._opi(k)] = units[self.XV + 1 + self.UV + k]
        return U

    def _apply_autoscale(self, eqs, iqs, objs):
        """Reference calc_auto_scales (`ODEPhaseBase.cpp:1295`): scale
        variables by their units and constraint rows by the probed mean
        norm of the unit-scaled Jacobian row; objective scales are
        synchronized across all objectives
        (`get_objective_scales`/`update_objective_scales`)."""
        import jax
        from ..Solvers.nlp import IndexedFunction, _family_valjac
        U = self.var_units()
        self._scale_vec = U
        V0 = self.makeSolverInput(raw=True)

        # set-up probes: small jits whose results the host reads at once,
        # compiled and run on the host CPU backend
        try:
            cpu = jax.devices("cpu")[0]
            ctx = jax.default_device(cpu)
        except RuntimeError:
            import contextlib
            ctx = contextlib.nullcontext()

        def row_scales(fam):
            with ctx:
                vj = jax.jit(_family_valjac(fam.fun))
                fx, jx = vj(jnp.asarray(V0[fam.Vidx]),
                            jnp.asarray(fam.consts))
            Uin = U[fam.Vidx]
            rown = np.linalg.norm(np.asarray(jx) * Uin[:, None, :], axis=2)
            mean = rown.mean(axis=0)
            return 1.0 / np.clip(mean, 1e-8, 1e8)

        def rescale(fam, rs):
            out = IndexedFunction(
                fam.fun, fam.Vidx, fam.consts, name=fam.name,
                in_scales=U[fam.Vidx],
                out_scales=np.broadcast_to(rs, (fam.napps, fam.nout)))
            # data columns keep their position: the scaling wrapper appends
            # in/out-scale columns after the original consts
            if getattr(fam, "_data_cols", None) is not None:
                out._data_cols = fam._data_cols
            return out

        eqs2 = [rescale(f, row_scales(f)) for f in eqs]
        iqs2 = [rescale(f, row_scales(f)) for f in iqs]
        oscales = [row_scales(f) for f in objs]
        if oscales:
            osync = float(np.mean([sc[0] for sc in oscales]))
            objs2 = [rescale(f, np.full(1, osync)) for f in objs]
            self._obj_scale = osync
        else:
            objs2 = objs
            self._obj_scale = 1.0
        return eqs2, iqs2, objs2

    def _build_families(self):
        """(eqs, iqs, objs) IndexedFunction lists in phase-local indices."""
        eqs, iqs, objs = [], [], []
        eq_specs, iq_specs, obj_specs = [], [], []

        self._defect_fam = self._defect_family()
        eqs.append(self._defect_fam)
        eq_specs.append(None)
        for f in self._control_families():
            eqs.append(f)
            eq_specs.append(None)
        for spec in self._specs:
            if spec.kind == "intobj":
                trace, idx = spec.fun
                objs.append(self._integral_family(trace, idx))
                obj_specs.append(spec)
            elif spec.kind == "inteq":
                trace, idx, pnum = spec.fun
                eqs.append(self._integral_family(trace, idx, pnum))
                eq_specs.append(spec)
            elif spec.kind == "obj":
                objs.append(self._region_family(spec.region, spec.fun, 1,
                                                spec.name, data=spec.data))
                obj_specs.append(spec)
            elif spec.kind == "eq":
                eqs.append(self._region_family(spec.region, spec.fun,
                                               spec.nout, spec.name,
                                               data=spec.data))
                eq_specs.append(spec)
            elif spec.kind == "iq":
                iqs.append(self._region_family(spec.region, spec.fun,
                                               spec.nout, spec.name,
                                               data=spec.data))
                iq_specs.append(spec)
        if self.AutoScaling:
            eqs, iqs, objs = self._apply_autoscale(eqs, iqs, objs)
        else:
            self._scale_vec = None
        self._built = list(zip(eqs + iqs + objs,
                               eq_specs + iq_specs + obj_specs))
        # Persistent probe-cache slots: sparsity masks survive re-meshing
        # (keyed by spec identity / builtin family position), so a new
        # segment count skips the BlockKKT probe jits entirely
        # (SURVEY.md section 7; see kkt_block.probe_cached).
        if not hasattr(self, "_probe_store"):
            self._probe_store = {}
        for i, (fam, sp) in enumerate(self._built):
            # key on the SPEC OBJECT itself (held alive by the store) —
            # an id() key could serve a stale mask after CPython reuses a
            # freed spec's id for a different constraint
            key = ("spec", sp) if sp is not None else \
                ("builtin", i, self.TranscriptionMode, self.ControlMode)
            try:
                fam.fun._probe_cache = (self._probe_store, key)
            except AttributeError:
                pass
        return eqs, iqs, objs

    def node_of_var(self):
        """Node id per phase variable (-1 = border: t0, tf, params) — the
        structure map consumed by the block-tridiagonal KKT backend."""
        nov = np.full(self.numVars, -1, np.int32)
        m = self._m
        nov[:self.numNodes * m] = np.arange(self.numNodes * m) // m
        return nov

    def _structure_key(self):
        return (self._numsegs, self.TranscriptionMode, self.ControlMode,
                self.AutoScaling, self.SPV, self.PV,
                getattr(self, "KKTBackend", "block"),
                id(getattr(self, "KKTMesh", None)),
                tuple(id(s) for s in self._specs))

    def setKKTBackend(self, backend, mesh=None, axis="seg"):
        """Select the KKT factorization backend.

        'block' (default): single-device block-tridiagonal BCR.
        'sharded': ONE problem's KKT distributed segment-axis over a
            device mesh (`Solvers.kkt_sharded.ShardedBlockKKT`) — local
            BCR per shard, border Schur complements exchanged between
            devices.
            `mesh`: a 1-axis `jax.sharding.Mesh` (defaults to all visible
            devices on axis `axis`).  Mesh refinement / setTraj re-runs
            transcription, which re-pads and re-shards the new chain
            automatically (SURVEY.md section 5.8 re-sharding).
        'dense': dense eigendecomposition fallback (debug).
        """
        backend = str(backend)
        if backend not in ("block", "sharded", "dense"):
            raise ValueError(f"unknown KKT backend {backend!r}")
        if backend == "sharded":
            if mesh is None:
                from jax.sharding import Mesh
                mesh = Mesh(np.array(jax.devices()), (axis,))
            self.KKTMesh = mesh
            self.KKTAxis = axis
        self.KKTBackend = backend
        self._need_transcribe = True
        return self

    def _refresh_consts(self, nlp=None):
        """Re-transcription without retracing: when the problem structure is
        unchanged (same segments/specs), only the runtime consts — mesh
        fractions from seg_bounds, lock/boundary data — need updating.
        The jitted evaluator graphs are reused as-is (consts are runtime
        arguments; SURVEY.md section 7 'dynamic shapes' mitigation)."""
        segc2 = np.stack([self.seg_bounds[:-1], self.seg_bounds[1:]], axis=1)
        for fam, spec in self._built:
            if fam.name in ("defects", "shooting", "uspline1", "integral"):
                fam.consts[:, :2] = segc2
                if fam.name == "integral" and spec is not None \
                        and spec.kind == "inteq":
                    fam.consts[:, 2] = 1.0 / self.numSegs
            elif fam.name == "usplineH":
                fam.consts[:, 0] = self.seg_bounds[:-2]
                fam.consts[:, 1] = self.seg_bounds[1:-1]
                fam.consts[:, 2] = self.seg_bounds[2:]
            elif getattr(fam, "_region", None) is not None:
                # region families: node taus move with non-uniform bounds
                apps, taus = self._region_apps(fam._region)
                fam.consts[:, :fam._ntau] = np.asarray(taus, np.float64)
            if spec is not None and spec.data is not None \
                    and getattr(fam, "_data_cols", None) is not None:
                lo, nd = fam._data_cols
                fam.consts[:, lo:lo + nd] = spec.data[None, :]
        (nlp or self._nlp).bump_consts()

    def transcribe(self, *_):
        key = self._structure_key()
        if self._nlp is not None and key == self._struct_key:
            # same structure: refresh runtime consts only (no rebuild, no
            # re-probe, no recompile) — makes mesh sweeps / continuation /
            # subVariables loops cheap (reference re-transcribes fully;
            # C++ transcription is cheap, XLA retraces are not)
            self._refresh_consts()
            self._need_transcribe = False
            return
        nlp = NonLinearProgram(self.numVars)
        eqs, iqs, objs = self._build_families()
        for f in eqs:
            nlp.addEqualCon(f)
        for f in iqs:
            nlp.addInequalCon(f)
        for f in objs:
            nlp.addObjective(f)
        nlp.freeze()
        self._nlp = nlp
        kkt = None
        backend = getattr(self, "KKTBackend", "block")
        if backend in ("block", "sharded"):
            try:
                from ..Solvers.kkt_block import BlockKKT
                kkt = BlockKKT(nlp, self.node_of_var(),
                               x0=self.makeSolverInput())
                if backend == "sharded":
                    from ..Solvers.kkt_sharded import ShardedBlockKKT
                    kkt = ShardedBlockKKT(kkt, self.KKTMesh,
                                          getattr(self, "KKTAxis", "seg"))
            except ValueError as e:
                # non-banded coupling (e.g. nonlinear front-to-back
                # constraints): fall back to the dense backend
                if self.optimizer.PrintLevel <= 1:
                    print(f"  [kkt] falling back to dense backend: {e}")
                kkt = None
        self.optimizer.setNLP(nlp, kkt)
        self._struct_key = key
        self._active_nlp = nlp
        self._need_transcribe = False

    # --------------------------------------------------------- solve entries
    def makeSolverInput(self, raw=False):
        V = np.zeros(self.numVars)
        m = self._m
        for i in range(self.numNodes):
            V[i * m:i * m + self.XV] = self._traj[i, :self.XV]
            V[i * m + self.XV:(i + 1) * m] = self._traj[i, self.XV + 1:]
        V[self._t0i] = self.t0
        V[self._tfi] = self.tf
        for k in range(self.PV):
            V[self._opi(k)] = self._odeparams[k]
        for k in range(self.SPV):
            V[self._spi(k)] = self._static_params[k]
        if not raw and getattr(self, "_scale_vec", None) is not None:
            V = V / self._scale_vec
        return V

    def collectSolverOutput(self, V):
        if getattr(self, "_scale_vec", None) is not None:
            V = V * self._scale_vec
        m = self._m
        self.t0 = float(V[self._t0i])
        self.tf = float(V[self._tfi])
        traj = np.empty((self.numNodes, self.XV + 1 + self.UV))
        for i in range(self.numNodes):
            traj[i, :self.XV] = V[i * m:i * m + self.XV]
            traj[i, self.XV] = self.t0 + self.taus[i] * (self.tf - self.t0)
            traj[i, self.XV + 1:] = V[i * m + self.XV:(i + 1) * m]
        if self.ControlMode == ControlModes.BlockConstant:
            for i in range(self.numNodes):
                traj[i, self.XV + 1:] = V[
                    self._uvar(i, 0):self._uvar(i, 0) + self.UV]
        self._traj = traj
        for k in range(self.PV):
            self._odeparams[k] = V[self._opi(k)]
        if self.SPV:
            self._static_params = np.array(
                [V[self._spi(k)] for k in range(self.SPV)])

    def _psipot_call(self, method):
        if self._need_transcribe or self._nlp is None:
            self.transcribe()
        V0 = self.makeSolverInput()
        V = getattr(self.optimizer, method)(V0)
        self.collectSolverOutput(np.asarray(V))
        osc = getattr(self, "_obj_scale", None)
        if osc:
            # report the physical objective (rows run scaled internally)
            self.optimizer.LastObjVal /= osc
        return self.optimizer.ConvergeFlag

    def _mesh_call(self, method):
        flag = self._psipot_call(method)
        if not self.AdaptiveMesh:
            return flag
        from .mesh import adaptive_mesh_loop
        return adaptive_mesh_loop(self, method, flag)

    def optimize(self):
        return self._mesh_call("optimize")

    def solve(self):
        return self._mesh_call("solve")

    def solve_optimize(self):
        return self._mesh_call("solve_optimize")

    def solve_optimize_solve(self):
        return self._mesh_call("solve_optimize_solve")

    def optimize_solve(self):
        return self._mesh_call("optimize_solve")

    def jet_run(self):
        mode = str(self.JetJobMode)
        canon = {"optimize": "optimize", "solve": "solve",
                 "solve_optimize": "solve_optimize",
                 "solveoptimize": "solve_optimize",
                 "optimize_solve": "optimize_solve",
                 "optimizesolve": "optimize_solve",
                 "solve_optimize_solve": "solve_optimize_solve",
                 "solveoptimizesolve": "solve_optimize_solve"}
        return self._mesh_call(canon.get(mode.lower(), "optimize"))

    # ----------------------------------------------------------- extraction
    def returnTraj(self):
        out = self._traj.copy()
        if self.PV > 0:
            out = np.hstack([out, np.tile(self._odeparams,
                                          (out.shape[0], 1))])
        return [row.copy() for row in out]

    def returnTrajTable(self):
        """Scheme-order interpolation table of the current trajectory
        (reference returnTrajTable, `ODEPhaseBase.cpp:704`; interpolates
        at the transcription's own order, `LGLInterpTable.cpp`)."""
        from .interp_table import LGLInterpTable
        return LGLInterpTable.from_phase(self)

    def returnStaticParams(self):
        return self._static_params.copy()

    def returnTrajError(self):
        from .mesh import trajectory_error
        return trajectory_error(self)

    def returnCostateTraj(self):
        """Costate estimate from defect multipliers (reference
        `ODEPhaseBase.cpp:432-471`): the defect rows already carry the
        w_i*h quadrature scaling, so the RAW multiplier of interior
        collocation point i IS the costate psi(t_i); the samples at the
        interior times are then linearly interpolated (extrapolated at the
        phase ends) onto the cardinal node times, exactly like the
        reference's InteriorSpacings-based mapping."""
        lam = self.optimizer.LastEqLmults
        if lam is None:
            raise RuntimeError("no multipliers: solve first")
        cs = self._cs
        trap = self.TranscriptionMode == "Trapezoidal"
        nI = 1 if trap else cs - 1
        ndef = nI * self.XV
        S = self.numSegs
        lam_def = lam[:S * ndef].reshape(S, nI, self.XV)
        T = self.tf - self.t0
        # interior collocation times per segment (trapezoidal: midpoint)
        itau = np.array([0.5]) if trap else \
            np.asarray(self._scheme.interior_tau)
        a = self.seg_bounds[:-1][:, None]
        dtau = np.diff(self.seg_bounds)[:, None]
        tI = self.t0 + (a + itau[None, :] * dtau) * T        # (S, nI)
        pts_t = tI.ravel()
        pts_l = lam_def.reshape(S * nI, self.XV)
        ts = self.t0 + self.taus * T
        if len(pts_t) == 1:
            cost = np.broadcast_to(pts_l, (self.numNodes, self.XV)).copy()
        else:
            i1 = np.clip(np.searchsorted(pts_t, ts), 1, len(pts_t) - 1)
            i0 = i1 - 1
            w = ((ts - pts_t[i0])
                 / (pts_t[i1] - pts_t[i0]))[:, None]
            cost = pts_l[i0] + w * (pts_l[i1] - pts_l[i0])
        return [np.concatenate([cost[i], [ts[i]]])
                for i in range(self.numNodes)]
