"""EPPRFrame: Ephemeris-Perturbed Pulsating Rotating frame.

Reference: `asset_asrl/Astro/Extensions/EPPRFrame.py:23-501`.  A CR3BP-like
rotating-pulsating frame built from REAL (or analytic) P1/P2 ephemerides:
the x-axis tracks the instantaneous P1->P2 line, lengths pulse with the
instantaneous separation r(t), and the EOMs carry the full non-inertial
corrections (angular velocity W, its derivative, barycenter acceleration,
pulsation terms) interpolated from precomputed tables.

Ephemeris source is pluggable like NBodyFrame: SPICE when available, or
precomputed / analytic Keplerian trajectories (P1Data/P2Data kwargs)."""

from __future__ import annotations

import numpy as np

from ... import VectorFunctions as vf
from ...OptimalControl.interp_table import LGLInterpTable, InterpFunction

from ..Frames import CR3BPFrame
from .. import Constants as c

Args = vf.Arguments
norm = np.linalg.norm

BProps = getattr(c, "SpiceBodyProps", {})


def _normalize(x):
    return np.copy(x) / norm(x)


from .frame_kinematics import BodyRegistry


class EPPRFrame(CR3BPFrame, BodyRegistry):

    def __init__(self, P1name, P1mu, P2name, P2mu, Lstar, JD0, JDF,
                 N=3000, SpiceFrame="J2000", P1Data=None, P2Data=None):
        CR3BPFrame.__init__(self, P1mu, P2mu, Lstar)
        self.P1name, self.P2name = P1name, P2name
        self.JD0, self.JDF = JD0, JDF
        self.SpiceFrame = SpiceFrame
        if P1Data is None or P2Data is None:
            from ..SpiceRead import GetEphemTraj2
            P1Data = GetEphemTraj2(P1name, JD0, JDF, N, self.lstar,
                                   self.tstar, Frame=SpiceFrame)
            P2Data = GetEphemTraj2(P2name, JD0, JDF, N, self.lstar,
                                   self.tstar, Frame=SpiceFrame)
        self.P1Data = [np.asarray(r, np.float64) for r in P1Data]
        self.P2Data = [np.asarray(r, np.float64) for r in P2Data]
        self._init_body_registry()
        self.CalcFrameData()
        self.P1_J2 = False
        self.P2_J2 = False

    @classmethod
    def TwoBodyAnalytic(cls, P1name, P1mu, P2name, P2mu, Lstar, JD0, JDF,
                        ecc=0.0, N=3000):
        """Analytic Keplerian P1/P2 ephemeris about their barycenter with
        eccentricity `ecc` — a self-contained EPPR frame (no kernels)."""
        mustar = P1mu + P2mu
        tstar = np.sqrt(Lstar ** 3 / mustar)
        tf = (JDF - JD0) * 24 * 3600 / tstar
        ts = np.linspace(0.0, tf, int(N) + 1)
        mu = P2mu / mustar
        from ..kepler import classic_to_cartesian, propagate_kepler
        # relative orbit of P2 about P1, a = 1 (canonical)
        X0 = classic_to_cartesian(np.array([1.0, ecc, 0, 0, 0, 0]), 1.0)
        XV = np.asarray(propagate_kepler(
            np.tile(np.asarray(X0, np.float64)[:6], (len(ts), 1)), ts, 1.0))
        P1D = [np.concatenate([-mu * XV[i, :6], [ts[i]]])
               for i in range(len(ts))]
        P2D = [np.concatenate([(1 - mu) * XV[i, :6], [ts[i]]])
               for i in range(len(ts))]
        return cls(P1name, P1mu, P2name, P2mu, Lstar, JD0, JDF,
                   P1Data=P1D, P2Data=P2D)

    # ------------------------------------------------------------- times
    def JD_to_NDTime(self, JD):
        return (JD - self.JD0) * 24.0 * 3600.0 / self.tstar

    def NDTime_to_JD(self, ND):
        return self.JD0 + ND * self.tstar / (24.0 * 3600.0)

    # --------------------------------------------------------- frame data
    def CalcFrameData(self):
        """Derive every frame quantity by jax AD of smooth ephemeris
        interpolants (`frame_kinematics.rotating_frame_samples`) — the
        JAX replacement for the reference's finite-difference
        table pipeline (`EPPRFrame.py` CalcFrameData) — then sample the
        results onto the interp tables the expression layer consumes."""
        from .frame_kinematics import (DifferentiableEphemeris,
                                       rotating_frame_samples)
        P1D, P2D = self.P1Data, self.P2Data
        eph1 = DifferentiableEphemeris(P1D)
        eph2 = DifferentiableEphemeris(P2D)
        m1 = self.P1mu / (self.P1mu + self.P2mu)
        ts = np.asarray([r[6] for r in P1D])
        smp = rotating_frame_samples(eph1, eph2, m1, 1.0 - m1, ts)

        def rows(*cols):
            return [np.concatenate([np.atleast_1d(np.asarray(c)[i])
                                    for c in cols] + [[ts[i]]])
                    for i in range(len(ts))]

        import jax
        self.BCData = rows(smp["BC"])
        rel = np.asarray(jax.vmap(eph2.state)(ts)
                         ) - np.asarray(jax.vmap(eph1.state)(ts))
        self.RelData = rows(rel)
        self.RData = rows(smp["R"], smp["Rdot"], smp["Rddot"])
        self.RotData = rows(smp["rot"])

        T = LGLInterpTable
        self.P1Table = T(6, P1D, len(P1D))
        self.P2Table = T(6, P2D, len(P2D))
        self.BCTable = T(6, self.BCData, len(ts))
        self.RotTable = T(9, self.RotData, len(ts))
        self.RTable = T(3, self.RData, len(ts))
        self.WTable = T(3, rows(smp["W"]), len(ts))
        self.WdotTable = T(3, rows(smp["Wdot"]), len(ts))
        self.BCaccTable = T(3, rows(smp["BCacc"]), len(ts))
        self.GscaleTable = T(1, rows(smp["Gscale"]), len(ts))
        self.VscaleTable = T(1, rows(smp["Vscale"]), len(ts))
        self.RscaleTable = T(1, rows(smp["Rscale"]), len(ts))
        self.AccscaleTable = T(1, rows(smp["Accscale"]), len(ts))

        F = InterpFunction
        self.RotFunc = F(self.RotTable, range(0, 9))
        self.BCFunc = F(self.BCTable, range(0, 6))
        self.RFunc = F(self.RTable, range(0, 3))
        self.WFunc = F(self.WTable, range(0, 3))
        self.WdotFunc = F(self.WdotTable, range(0, 3))
        self.BCaccFunc = F(self.BCaccTable, range(0, 3))
        self.GscaleFunc = F(self.GscaleTable, range(0, 1)).sf()
        self.VscaleFunc = F(self.VscaleTable, range(0, 1)).sf()
        self.RscaleFunc = F(self.RscaleTable, range(0, 1)).sf()
        self.AccscaleFunc = F(self.AccscaleTable, range(0, 1)).sf()

    # -------------------------------------------------------- transforms
    def M_S(self, tnd):
        return 1.0 / (self.RTable.Interpolate(tnd)[0] * self.vstar)

    def GetDCM(self, t):
        rot = self.RotTable.Interpolate(t)
        return np.array([_normalize(rot[0:3]), _normalize(rot[3:6]),
                         _normalize(rot[6:9])]).T

    def _frame_kinematics_at(self, t):
        """(DCM rows expr, W, barycenter state, R row) at expression
        time t — shared by both transform builders.  The trace-time CSE
        cache dedupes the repeated table lookups, so single-stage
        composition costs the same as the reference's two-stage
        argument-packing idiom."""
        rot = self.RotFunc.eval(t)
        W = self.WFunc.eval(t)
        bc = self.BCFunc.eval(t)
        rrow = self.RFunc.eval(t)
        return rot, W, bc, rrow

    def NDInertial_to_Frame_Func(self):
        """(7,) inertial [X, V, t] -> pulsating-rotating [Xrot, Vrot, t]:
        translate to the barycenter, scale lengths by 1/r(t), rotate by
        DCM^T, and remove the frame's rotation + pulsation velocity."""
        S = Args(7)
        X, V, t = S.head3(), S.segment3(3), S[6]
        rot, W, bc, rrow = self._frame_kinematics_at(t)
        rr, rdot = rrow[0], rrow[1]
        DCMT = vf.RowMatrix(rot, 3, 3)
        Xrot = DCMT * ((X - bc.head3()) / rr)
        Vrel = DCMT * ((V - bc.segment3(3)) / rr)
        Vrot = Vrel - vf.cross(W, Xrot) - Xrot * (rdot / rr)
        return vf.stack([Xrot, Vrot, t])

    def Frame_to_NDInertial_Func(self):
        """Inverse of NDInertial_to_Frame_Func: add back the rotation and
        pulsation rates, rotate by DCM, scale by r(t), translate."""
        S = Args(7)
        Xrot, Vrot, t = S.head3(), S.segment3(3), S[6]
        rot, W, bc, rrow = self._frame_kinematics_at(t)
        rr, rdot = rrow[0], rrow[1]
        DCM = vf.ColMatrix(rot, 3, 3)
        Vrel = Vrot + vf.cross(W, Xrot) + Xrot * (rdot / rr)
        Xnd = (DCM * Xrot) * rr + bc.head3()
        Vnd = (DCM * Vrel) * rr + bc.segment3(3)
        return vf.stack([Xnd, Vnd, t])

    def NDInertial_to_EPPR(self, ITraj, axis=6):
        F = self.NDInertial_to_Frame_Func()
        return [np.asarray(F.compute(np.asarray(T)[0:7])) for T in ITraj]

    def EPPR_to_NDInertial(self, PTraj, axis=6):
        F = self.Frame_to_NDInertial_Func()
        return [np.asarray(F.compute(np.asarray(T)[0:7])) for T in PTraj]

    def Transform_Func(self, OtherFrame):
        FrameToND1 = self.Frame_to_NDInertial_Func()
        ND2ToFrame = OtherFrame.NDInertial_to_Frame_Func()
        xscale = self.lstar / OtherFrame.lstar
        vscale = self.vstar / OtherFrame.vstar
        toff = OtherFrame.JD_to_NDTime(self.NDTime_to_JD(0.0))
        tsc = self.tstar / OtherFrame.tstar
        args = Args(7)
        ND1toND2 = vf.stack([args.head3() * xscale,
                             args.segment3(3) * vscale,
                             args[6] * tsc + toff])
        return (ND2ToFrame.eval(ND1toND2)).eval(FrameToND1)

    # ------------------------------------------------------------- bodies
    def AddBodyTable(self, Name, EPPRTraj, mu):
        self.register_body(Name, EPPRTraj, mu / self.mustar)

    def GetSpiceBodyEPPRTraj(self, Name, N):
        from ..SpiceRead import GetEphemTraj2
        ITraj = GetEphemTraj2(Name, self.JD0, self.JDF, N, self.lstar,
                              self.tstar, Frame=self.SpiceFrame)
        return self.NDInertial_to_EPPR(ITraj)

    GetSpiceBodyTraj = GetSpiceBodyEPPRTraj

    def GetSpiceBodyTable(self, Name, N):
        return LGLInterpTable(6, self.GetSpiceBodyEPPRTraj(Name, N), N + 1)

    def AddSpiceBody(self, Name, mu=None, N=5000):
        if mu is None:
            mu = BProps[Name]["Mu"]
        self.AddBodyTable(Name, self.GetSpiceBodyEPPRTraj(Name, N), mu)

    def AddSpiceBodies(self, Names, N=5000):
        for Name in Names:
            self.AddSpiceBody(Name, N=N)

    def Add_P2_J2Effect(self, J2c=None, RadP2=None, pole=(0, 0, 1.0)):
        if J2c is None:
            J2c = BProps[self.P2name]["J2"]
        if RadP2 is None:
            RadP2 = BProps[self.P2name]["Radius"]
        self.P2_Rad = RadP2 / self.lstar
        self.P2_J2 = J2c
        self._p2_pole = np.asarray(pole, np.float64)

    def Add_P1_J2Effect(self, J2c=None, RadP1=None, pole=(0, 0, 1.0)):
        if J2c is None:
            J2c = BProps[self.P1name]["J2"]
        if RadP1 is None:
            RadP1 = BProps[self.P1name]["Radius"]
        self.P1_Rad = RadP1 / self.lstar
        self.P1_J2 = J2c
        self._p1_pole = np.asarray(pole, np.float64)

    # --------------------------------------------------------------- EOMs
    def _gravity(self, r, t, otherGaccs, ActiveAltBodies):
        """Gravity of P1/P2 at their frozen frame locations plus active
        alt bodies, in pulsating units (the 1/r(t)^3 factor restores
        physical gravity after the length pulsation)."""
        terms = [r.normalized_power3(-self.P1, self.mu - 1.0),
                 r.normalized_power3(-self.P2, -self.mu)]
        terms += list(otherGaccs)
        names = self.AltBodyNames if ActiveAltBodies == "All" \
            else ActiveAltBodies
        for nm in names:
            dr = self.AltBodyLocFuncs[nm].eval(t) - r
            terms.append(dr.normalized_power3() * self.AltBodyMuVals[nm])
        return vf.sum(terms) * self.GscaleFunc.eval(t)

    def _frame_corrections(self, r, v, t):
        """Non-inertial accelerations of the pulsating-rotating frame,
        term by term: Coriolis -2 W x v, centrifugal -W x (W x r), Euler
        -Wdot x r, the rotation/pulsation cross term, the barycenter
        correction, and the direct pulsation accelerations.  (Same
        physics as reference EPPREOMs; derived independently from the
        transform kinematics.)"""
        W = self.WFunc.eval(t)
        Wdot = self.WdotFunc.eval(t)
        Vs = self.VscaleFunc.eval(t)
        coriolis = -2.0 * vf.cross(W, v)
        centrifugal = -1.0 * vf.cross(W, vf.cross(W, r))
        euler = vf.cross(r, Wdot)
        rot_pulse = vf.cross(W, r) * Vs
        pulse = r * self.RscaleFunc.eval(t) + v * Vs
        bc = self.BCaccFunc.eval(t)
        return [coriolis, centrifugal, euler, rot_pulse, pulse, bc]

    def EPPREOMs(self, r, v, t, otherGaccs=[], otherAccs=[], otherEOMs=[],
                 ActiveAltBodies="All", Enable_J2=False):
        """Pulsating-rotating EOMs (reference EPPREOMs, same dynamics):
        scaled two-body + alt-body gravity plus the frame corrections of
        `_frame_corrections`."""
        accs = list(otherAccs)
        if Enable_J2:
            accs += self.J2_ACC(r, t)
        acc = vf.sum([self._gravity(r, t, otherGaccs, ActiveAltBodies)]
                     + self._frame_corrections(r, v, t) + accs)
        return vf.stack([v, acc] + list(otherEOMs))

    def J2_ACC(self, r, t):
        from ..J2 import J2Cartesian
        J2Accs = []
        j2sc = self.AccscaleFunc.eval(t) ** 5
        if self.P2_J2:
            j2f = J2Cartesian(self.mu, self.P2_J2, self.P2_Rad)
            J2Accs.append(j2f(vf.stack([r - self.P2,
                                        r * 0.0 + self._p2_pole])))
        if self.P1_J2:
            j2f = J2Cartesian(1 - self.mu, self.P1_J2, self.P1_Rad)
            J2Accs.append(j2f(vf.stack([r - self.P1,
                                        r * 0.0 + self._p1_pole])))
        if J2Accs:
            return [vf.sum(J2Accs) * j2sc]
        return []
