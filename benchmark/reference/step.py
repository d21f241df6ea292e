"""A plain float64 RK step of tlab's incompressible and anelastic
equations on one device, built from a configuration's case alone.

Per substep of the low-storage RK4 of Carpenter & Kennedy (1994), in
tlab's order (rhs_global_incompressible_1.f90, time.f90):

  h  = kco h + sum over x, y, z of  nu d2(q) [/rho_bar] - u_i d1(q)
  h += g b(s) / Fr                        (anelastic AirWater buoyancy)
  solve lap p = div(rho_bar (h + q/dte)), dp/dy = rho_bar h_v at the walls
  h -= grad p [/rho_bar];  the wall rows of h;  q += dte h;  clip scalars

with every operator the dense compact matrix of reference/ops.py and the
pressure from reference/poisson.py.  Everything is computed in `dtype`,
float64 for the reference; the Poisson solve (unless poisson32) and the
thermodynamics always in float64.  The control, the reference put in the
program's place one precision lower, is the same step in float32 with its
derivative products in TF32 (tf32=True: operands rounded to a 10-bit
mantissa).  bg32=True
rounds the AirWater background profiles to float32 before use, as a
program that keeps them in a float32 plan holds them, and poisson32=True
takes the Poisson solve in single precision: witnesses of what each
rounding reads, not controls.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from reference import ops, thermo
from reference.case import Case
from reference.poisson import Poisson

# Carpenter & Kennedy (1994) 4th-order 5-stage low-storage coefficients
RK4_KDT = (1432997174477.0 / 9575080441755.0,
           5161836677717.0 / 13612068292357.0,
           1720146321549.0 / 2090206949498.0,
           3134564353537.0 / 4481467310338.0,
           2277821191437.0 / 14882151754819.0)
RK4_KCO = (-567301805773.0 / 1357537059087.0,
           -2404267990393.0 / 2016746695238.0,
           -3550918686646.0 / 2091501179385.0,
           -1275806237668.0 / 842570457699.0)


def profile(case: Case, section: str, tag: str, y: np.ndarray):
    """A tanh or erf mean profile of the case (tlab's Profiles module):
    mean + delta * amplify((y - ymean) / thick)."""
    kind = case.get(section, f"Profile{tag}", "none").lower()
    mean = case.float(section, f"Mean{tag}", 0.0)
    if section.lower() == "flow":              # [Flow] VelocityX=<mean>
        mean = case.float(section, tag, mean)
    delta = case.float(section, f"Delta{tag}", 0.0)
    thick = case.float(section, f"Thick{tag}", 1.0)
    ymean = y[0] + (y[-1] - y[0]) * case.float(
        section, f"YMeanRelative{tag}", 0.5)
    xi = (y - ymean) / thick
    if kind == "tanh":
        amp = 0.5 * np.tanh(-0.5 * xi)
    elif kind == "erf":
        amp = 0.5 * np.array([math.erf(-0.5 * v) for v in xi])
    elif kind == "none":
        amp = np.zeros_like(y)
    else:
        raise NotImplementedError(f"profile {kind}")
    return mean + delta * amp


class Model:
    """The step, its diagnostics and its operators for one case."""

    def __init__(self, ini: dict, device, dtype=torch.float64,
                 tf32: bool = False, bg32: bool = False,
                 poisson32: bool = False):
        case = Case(ini)
        self.device, self.dtype, self.tf32 = device, dtype, tf32
        self.bg32 = bg32
        self.pdt = torch.float32 if poisson32 else torch.float64
        so1 = case.get("Main", "SpaceOrder1",
                       case.get("Main", "SpaceOrder", "CompactJacobian6"))
        so2 = case.get("Main", "SpaceOrder2", "CompactJacobian6Hyper")
        per = [case.bool("Grid", f"{d}Periodic", d != "Y") for d in "XYZ"]
        self.axes = [ops.Axis(case.int(f"IniGridO{d}", "points_1", 1),
                              case.float(f"IniGridO{d}", "scales_1", 1.0),
                              p, so1, so2) for d, p in zip("xyz", per)]
        if per[1] or not (per[0] and per[2]):
            raise NotImplementedError("walls in y, x and z periodic only")
        if "4" not in case.get("Main", "TimeOrder", "RungeKuttaExplicit4"):
            raise NotImplementedError("RK4 only")

        def t(a):
            return torch.as_tensor(np.asarray(a, np.float64)).to(device,
                                                                 dtype)

        self.d1 = [t(a.d1) for a in self.axes]
        self.d2 = [t(a.d2) for a in self.axes]
        self.iod = [t(1.0 / a.jac) for a in self.axes]
        self.poisson = Poisson(*self.axes, device)
        if poisson32:
            self.poisson = self.poisson.single()
        schmidt = case.floats("Parameters", "Schmidt", (1.0,))
        self.ns = len(schmidt)
        visc = 1.0 / case.float("Parameters", "Reynolds", 100.0)
        self.nu = t([visc] * 3 + [visc / sc for sc in schmidt]).reshape(
            -1, 1, 1, 1)
        # wall rows of the tendencies: freeslip walls (u, w Neumann, v
        # Dirichlet), each scalar as its case says
        for side in ("Jmin", "Jmax"):
            if case.get("BoundaryConditions", f"Velocity{side}",
                        "noslip").lower() != "freeslip":
                raise NotImplementedError("freeslip walls only")
        nb, nt = ops.neumann_rows(self.axes[1])
        self.neumann = (t(nb), t(nt))
        kinds = ["neumann", "dirichlet", "neumann"]
        for i in range(self.ns):
            k = {case.get("BoundaryConditions", f"Scalar{i + 1}{s}",
                          "dirichlet").lower() for s in ("Jmin", "Jmax")}
            if len(k) != 1 or not k <= {"neumann", "dirichlet"}:
                raise NotImplementedError("a scalar's walls alike")
            kinds.append(k.pop())
        self.kinds = kinds
        self.bounds = None
        if case.bool("Control", "ScalLimit", True) and self.ns:
            lo = case.floats("Control", "MinScalar", (0.0,) * self.ns)
            hi = case.floats("Control", "MaxScalar", (1.0,) * self.ns)
            self.bounds = (t(lo).reshape(-1, 1, 1, 1),
                           t(hi).reshape(-1, 1, 1, 1))
        self._thermo(case, t)

    def _thermo(self, case: Case, t):
        """The anelastic AirWater background and buoyancy, where the case
        asks for them; Equations=anelastic also weights the dycore."""
        self.anelastic = case.get("Main", "Equations", "").lower() \
            == "anelastic"
        self.gravity = None
        self.tw = None
        anel_thermo = case.get("Thermodynamics", "Type", "").lower() \
            == "anelastic" or self.anelastic
        if case.get("Rotation", "Type", "none").lower() != "none":
            raise NotImplementedError("rotation")
        gtype = case.get("Gravity", "Type", "none").lower()
        if not anel_thermo:
            if self.anelastic or gtype != "none":
                raise NotImplementedError("buoyancy without AirWater")
            return
        if case.get("Thermodynamics", "Mixture", "").lower() != "airwater" \
                or gtype != "explicit" or self.ns != 2:
            raise NotImplementedError("the explicit AirWater buoyancy only")
        self.tw = thermo.AirWater(case.float("Thermodynamics", "ScaleHeight",
                                             0.0))
        y = self.axes[1].nodes
        y_ref = y[0] + (y[-1] - y[0]) * case.float(
            "Flow", "YMeanRelativePressure", 0.5)
        bg = thermo.background(
            self.tw, y, profile(case, "Scalar", "Scalar1", y),
            profile(case, "Scalar", "Scalar2", y), self.axes[1].d1,
            case.float("Flow", "Pressure", 1.0), y_ref)

        def col(a):
            return torch.as_tensor(a).to(self.device,
                                         torch.float64)[None, :, None]

        if self.bg32:
            bg = {k: v.astype(np.float32).astype(np.float64)
                  for k, v in bg.items()}
        self.bg = {k: col(v) for k, v in bg.items()}
        self.rho = t(bg["rho"])
        self.rho_inv = t(1.0 / bg["rho"])
        froude = case.float("Parameters", "Froude", 1.0)
        self.gravity = tuple(g / froude for g in case.floats(
            "Gravity", "Vector", (0.0, 0.0, 0.0)))

    # -- operators --------------------------------------------------------
    def d1_along(self, a, axis):
        """d/dx_axis of a field (nx, ny, nz) or a stack (F, nx, ny, nz)."""
        off = a.ndim - 3
        return ops.along(self.d1[axis], a, axis + off, self.tf32)

    def buoyancy(self, s):
        return thermo.buoyancy(self.tw, s.to(torch.float64), self.bg).to(
            self.dtype)

    def newton_error(self, s):
        s = s.to(torch.float64)
        return self.tw.equilibrium(s[0], s[1], self.bg["p"], self.bg["ep"],
                                   with_err=True)[2]

    # -- the step ---------------------------------------------------------
    def rhs(self, Q, H, dte):
        """H + the substep's tendencies, in place, and the pressure: field
        by field and term by term, in place where the order of the
        operations allows, so that a grid of a card's size fits beside its
        temporaries."""
        u, v, w = Q[0], Q[1], Q[2]
        for f in range(Q.shape[0]):
            adv = torch.zeros_like(Q[f])
            for axis, conv in enumerate((u, v, w)):
                d1 = ops.along(self.d1[axis], Q[f], axis, self.tf32)
                d2 = ops.along(self.d2[axis], Q[f], axis, self.tf32)
                if self.anelastic:
                    d2.mul_(self.rho_inv[None, :, None])
                d2.mul_(self.nu[f])
                d2.sub_(d1.mul_(conv))          # nu d2 - u_i d1
                adv += d2
                del d1, d2
            H[f] += adv
            del adv
        if self.gravity is not None:
            b = self.buoyancy(Q[3:])
            for i, g in enumerate(self.gravity):
                if g != 0.0:
                    H[i] += g * b
            del b

        def flux(i):
            a = H[i] + Q[i] / dte
            if self.anelastic:
                a.mul_(self.rho[None, :, None])
            return a

        div = self.d1_along(flux(1), 1)
        div.add_(self.d1_along(flux(0), 0))
        div.add_(self.d1_along(flux(2), 2))
        bb, bt = H[1][:, 0, :], H[1][:, -1, :]
        if self.anelastic:
            bb, bt = bb * self.rho[0], bt * self.rho[-1]
        nx = div.shape[0]
        fh = self.poisson.forward(div.to(self.pdt))
        del div
        p, dpdy = self.poisson.solve_modes(fh, nx, bb.to(self.pdt),
                                           bt.to(self.pdt))
        del fh
        p, dpdy = p.to(self.dtype), dpdy.to(self.dtype)
        for i in range(3):
            g = dpdy if i == 1 else self.d1_along(p, i)
            if self.anelastic:
                g = g * self.rho_inv[None, :, None]
            H[i] -= g
            del g
        del dpdy
        nb, nt = self.neumann
        for i, kind in enumerate(self.kinds):
            if kind == "neumann":
                H[i, :, 0, :] = torch.matmul(nb, H[i])
                H[i, :, -1, :] = torch.matmul(nt, H[i])
            else:
                H[i, :, 0, :] = 0.0
                H[i, :, -1, :] = 0.0
        return H, p

    def step(self, q, dt: float):
        """One RK4 step of the stack q (3 + ns, nx, ny, nz): (q_new, the
        last substep's pressure)."""
        # to the device first: a conversion on the host is slow
        Q = q.to(self.device).to(self.dtype, copy=True)
        Q[1, :, 0, :] = 0.0                 # no penetration at the walls
        Q[1, :, -1, :] = 0.0
        H = torch.zeros_like(Q)
        p = None
        for i, k in enumerate(RK4_KDT):
            dte = dt * k
            H, p = self.rhs(Q, H, dte)
            for f in range(Q.shape[0]):
                Q[f] += dte * H[f]
            if self.bounds is not None:
                torch.clamp(Q[3:], min=self.bounds[0], max=self.bounds[1],
                            out=Q[3:])
            if i < len(RK4_KCO):
                H *= RK4_KCO[i]
        return Q, p

    def diagnostics(self, q):
        """[CFL max, dilatation min, dilatation max(, Newton error)] of the
        stack q, and the scale of the dilatation: the max of the sum of
        the magnitudes of its three terms.  A component at a time."""
        def comp(i):
            a = q[i].to(self.device).to(self.dtype)
            if self.anelastic:
                a = a * self.rho[None, :, None]
            return a

        iod = (self.iod[0][:, None, None], self.iod[1][None, :, None],
               self.iod[2][None, None, :])
        cfl = None
        for i in range(3):
            c = torch.abs(q[i].to(self.device).to(self.dtype)) * iod[i]
            cfl = c if cfl is None else cfl.add_(c)
            del c
        cfl = torch.max(cfl)
        div = self.d1_along(comp(0), 0)
        mag = torch.abs(div)
        for i in (1, 2):
            t = self.d1_along(comp(i), i)
            div.add_(t)
            mag.add_(torch.abs(t))
            del t
        scale = torch.max(mag)
        del mag
        out = [cfl, div.min(), div.max()]
        del div
        if self.tw is not None:
            out.append(self.newton_error(q[3:].to(self.device)))
        return [float(a) for a in out], float(scale)
