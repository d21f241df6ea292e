"""A plain float64 RK step of tlab's compressible equations in the
internal-energy formulation ([Main] Equations=internal) on one device,
built from a configuration's case alone.

The equations (tlab rhs_flow_global_2.f90, DNS_EQNS_INTERNAL), made
nondimensional by U0, rho0 and T0, for an ideal gas with
p = rho T / (gamma M^2) and e = T / (gamma (gamma - 1) M^2):

  d rho/dt      = -d_j(rho u_j)
  d(rho u_i)/dt = -d_j(rho u_i u_j + p delta_ij) + d_j tau_ij
  d(rho e)/dt   = -d_j(rho e u_j) - p d_j u_j + Phi + d_j(k d_j T)
  d(rho s)/dt   = -d_j(rho s u_j) + d_j(rho D d_j s)

with tau_ij = mu (d_j u_i + d_i u_j - 2/3 delta_ij d_k u_k), mu = 1/Re,
Phi = tau_ij d_j u_i, k = mu / (Pr (gamma - 1) M^2), D = mu / Sc, every
derivative the dense compact matrix of reference/ops.py (the sixth-order
first derivative, the sixth-order hyperviscous second derivative, each
with its Jacobian).  Departures from the published equations, each as the
program writes them:

- the advection is in divergence form whatever [Main] TermAdvection says:
  the program's internal-energy set has no other form;
- the viscous stress's divergence at constant mu is written
  mu (lap u_i + 1/3 d_i(d_k u_k)), each Laplacian from the compact second
  derivative (tlab's RHS_FLOW_VISCOUS_EXPLICIT), not from two first
  derivatives; the conduction likewise k lap T;
- the scalar's diffusion d_j(rho D d_j s) is expanded to
  D (rho lap s + d_j rho d_j s), its Laplacian from the compact second
  derivative.

Walls in y, free slip and adiabatic: after each substep's tendencies are
added to the RK register, the register's wall rows are set: rho v's to 0,
and those of rho, rho u, rho w, rho e and each Neumann scalar to the value
with a zero wall-normal derivative (the rows of ops.neumann_rows), a
Dirichlet scalar's to 0.  The substep of the low-storage RK4 of Carpenter
& Kennedy (1994) (time.f90 TIME_SUBSTEP_COMPRESSIBLE):

  h = kco h + rhs(U);  the wall rows of h;  U += dte h;
  s = rho s / rho clipped to [MinScalar, MaxScalar] ([Control] ScalLimit)

Everything is computed in `dtype`, float64 for the reference.  The
control, the reference put in the program's place one precision lower,
is the same step in float32 with its derivative products in TF32
(tf32=True: operands rounded to a 10-bit mantissa).  The compressible set
has no background profiles and no Poisson solve, so the bg32 and
poisson32 witnesses of reference/step.py, which harness/cell.py passes to
any reference's control, are taken and ignored.
"""
from __future__ import annotations

import numpy as np
import torch

from reference import ops
from reference.case import Case
from reference.step import RK4_KCO, RK4_KDT


class Model:
    """The step, its diagnostics and its operators for one case."""

    def __init__(self, ini: dict, device, dtype=torch.float64,
                 tf32: bool = False, bg32: bool = False,
                 poisson32: bool = False):
        case = Case(ini)
        self.device, self.dtype, self.tf32 = device, dtype, tf32
        if case.get("Main", "Equations", "").lower() != "internal":
            raise NotImplementedError("Equations=internal only")
        if "4" not in case.get("Main", "TimeOrder", "RungeKuttaExplicit4"):
            raise NotImplementedError("RK4 only")
        if case.get("Main", "TermViscous", "explicit").lower() \
                != "explicit":
            raise NotImplementedError("explicit viscous terms only")
        for section, key in (("Thermodynamics", "Mixture"),
                             ("Thermodynamics", "Transport"),
                             ("Gravity", "Type"), ("Rotation", "Type"),
                             ("BufferZone", "Type")):
            if case.get(section, key, "none").lower() not in ("none", ""):
                raise NotImplementedError(f"[{section}] {key}")
        so1 = case.get("Main", "SpaceOrder1",
                       case.get("Main", "SpaceOrder", "CompactJacobian6"))
        so2 = case.get("Main", "SpaceOrder2", "CompactJacobian6Hyper")
        per = [case.bool("Grid", f"{d}Periodic", d != "Y") for d in "XYZ"]
        if per[1] or not (per[0] and per[2]):
            raise NotImplementedError("walls in y, x and z periodic only")
        self.axes = [ops.Axis(case.int(f"IniGridO{d}", "points_1", 1),
                              case.float(f"IniGridO{d}", "scales_1", 1.0),
                              p, so1, so2) for d, p in zip("xyz", per)]

        def t(a):
            return torch.as_tensor(np.asarray(a, np.float64)).to(device,
                                                                 dtype)

        self.d1 = [t(a.d1) for a in self.axes]
        self.d2 = [t(a.d2) for a in self.axes]
        self.iod = [t(1.0 / a.jac) for a in self.axes]
        self.gamma = case.float("Thermodynamics", "HeatCapacityRatio",
                                case.float("Parameters", "Gamma", 1.4))
        self.mach = case.float("Parameters", "Mach", 0.3)
        prandtl = case.float("Parameters", "Prandtl", 1.0)
        schmidt = case.floats("Parameters", "Schmidt", (1.0,))
        self.ns = len(schmidt)
        self.mu = 1.0 / case.float("Parameters", "Reynolds", 100.0)
        g, m2 = self.gamma, self.mach ** 2
        self.cond = self.mu / (prandtl * (g - 1.0) * m2)
        self.diff = [self.mu / sc for sc in schmidt]
        # TIME_COURANT's compressible diffusion number (time.f90:493)
        self.sfactor = self.mu * max(1.0, 1.0 / prandtl, 1.0 / min(schmidt))
        for side in ("Jmin", "Jmax"):
            if case.get("BoundaryConditions", f"Velocity{side}",
                        "freeslip").lower() != "freeslip":
                raise NotImplementedError("freeslip walls only")
        nb, nt = ops.neumann_rows(self.axes[1])
        self.neumann = (t(nb), t(nt))
        # the wall rows of each field's tendency: rho, rho u, rho v, rho w,
        # rho e, then the scalars as their case says
        kinds = ["neumann", "neumann", "zero", "neumann", "neumann"]
        for i in range(self.ns):
            k = {case.get("BoundaryConditions", f"Scalar{i + 1}{s}",
                          "dirichlet").lower() for s in ("Jmin", "Jmax")}
            if len(k) != 1 or not k <= {"neumann", "dirichlet"}:
                raise NotImplementedError("a scalar's walls alike")
            kinds.append("neumann" if k.pop() == "neumann" else "zero")
        self.kinds = kinds
        self.bounds = None
        if case.bool("Control", "ScalLimit", True) and self.ns:
            lo = case.floats("Control", "MinScalar", (0.0,) * self.ns)
            hi = case.floats("Control", "MaxScalar", (1.0,) * self.ns)
            self.bounds = (t(lo).reshape(-1, 1, 1, 1),
                           t(hi).reshape(-1, 1, 1, 1))

    # -- operators --------------------------------------------------------
    def d1_along(self, a, axis):
        """d/dx_axis of a field (nx, ny, nz) or a stack (F, nx, ny, nz)."""
        return ops.along(self.d1[axis], a, axis + a.ndim - 3, self.tf32)

    def d2_along(self, a, axis):
        return ops.along(self.d2[axis], a, axis + a.ndim - 3, self.tf32)

    def lap(self, a):
        out = self.d2_along(a, 0)
        out += self.d2_along(a, 1)
        out += self.d2_along(a, 2)
        return out

    def div(self, fx, fy, fz):
        out = self.d1_along(fx, 0)
        out += self.d1_along(fy, 1)
        out += self.d1_along(fz, 2)
        return out

    def temperature(self, Q):
        """T = e gamma (gamma - 1) M^2 with e = rho e / rho."""
        g = self.gamma
        return Q[4] / Q[0] * (g * (g - 1.0) * self.mach ** 2)

    def pressure(self, rho, T):
        return rho * T / (self.gamma * self.mach ** 2)

    # -- the step ---------------------------------------------------------
    def rhs(self, Q):
        """The tendencies of the stack Q (rho, rho u, rho v, rho w, rho e,
        rho s..): a new stack, term by term."""
        rho = Q[0]
        vel = [Q[1 + i] / rho for i in range(3)]
        T = self.temperature(Q)
        p = self.pressure(rho, T)
        dh = torch.empty_like(Q)
        mu = self.mu
        dh[0] = -self.div(Q[1], Q[2], Q[3])
        # g[i][j] = d_j u_i
        g = [[self.d1_along(vel[i], j) for j in range(3)] for i in range(3)]
        divu = g[0][0] + g[1][1] + g[2][2]
        for i in range(3):
            flux = [Q[1 + i] * vel[j] for j in range(3)]
            flux[i] = flux[i] + p
            h = -self.div(*flux)
            del flux
            h += mu * (self.lap(vel[i]) + self.d1_along(divu, i) / 3.0)
            dh[1 + i] = h
            del h
        # Phi = tau_ij d_j u_i, tau symmetric
        lam = -2.0 / 3.0
        phi = sum(mu * (2.0 * g[i][i] + lam * divu) * g[i][i]
                  for i in range(3))
        for i, j in ((0, 1), (0, 2), (1, 2)):
            s = g[i][j] + g[j][i]
            phi += mu * s * s
        del g
        e = -self.div(Q[4] * vel[0], Q[4] * vel[1], Q[4] * vel[2])
        e -= p * divu
        e += phi
        e += self.cond * self.lap(T)
        dh[4] = e
        del e, phi, divu, T, p
        if Q.shape[0] > 5:
            grho = [self.d1_along(rho, j) for j in range(3)]
            for k in range(Q.shape[0] - 5):
                rs = Q[5 + k]
                s = rs / rho
                h = -self.div(rs * vel[0], rs * vel[1], rs * vel[2])
                cross = sum(grho[j] * self.d1_along(s, j) for j in range(3))
                h += self.diff[k] * (rho * self.lap(s) + cross)
                dh[5 + k] = h
                del h, cross, s
        return dh

    def wall_rows(self, H):
        """The wall rows of the RK register H, in place (the top row sees
        the bottom one set first, as the compact system's rows do)."""
        nb, nt = self.neumann
        for f, kind in enumerate(self.kinds):
            if kind == "neumann":
                H[f, :, 0, :] = torch.matmul(nb, H[f])
                H[f, :, -1, :] = torch.matmul(nt, H[f])
            else:
                H[f, :, 0, :] = 0.0
                H[f, :, -1, :] = 0.0

    def step(self, q, dt: float):
        """One RK4 step of the stack q: (q_new, None); the set has no
        projection pressure."""
        # to the device first: a conversion on the host is slow
        Q = q.to(self.device).to(self.dtype, copy=True)
        H = torch.zeros_like(Q)
        for i, k in enumerate(RK4_KDT):
            dte = dt * k
            dh = self.rhs(Q)
            H += dh
            del dh
            self.wall_rows(H)
            for f in range(Q.shape[0]):
                Q[f] += dte * H[f]
            if self.bounds is not None:
                s = torch.clamp(Q[5:] / Q[0], min=self.bounds[0],
                                max=self.bounds[1])
                Q[5:] = s * Q[0]
                del s
            if i < len(RK4_KCO):
                H *= RK4_KCO[i]
        return Q, None

    def diagnostics(self, q):
        """([acoustic CFL, PMin, PMax, RMin, RMax, dden], scales) of the
        stack q: the CFL number max sum_i (|u_i| + c) / dx_i with c =
        sqrt(T) / M, the extrema of p and rho, and the diffusion-number
        density dden = sfactor max(sum_i 1/dx_i^2 / rho) (TIME_COURANT's
        compressible branch); scales: the CFL number and dden themselves
        (relative gaps), and each extremum's field's range in the box."""
        Q = q[:5].to(self.device).to(self.dtype)
        rho = Q[0]
        T = self.temperature(Q)
        p = self.pressure(rho, T)
        c = torch.sqrt(torch.clamp(T, min=1e-12)) / self.mach
        del T
        iod = (self.iod[0][:, None, None], self.iod[1][None, :, None],
               self.iod[2][None, None, :])
        cfl = None
        for i in range(3):
            a = (torch.abs(Q[1 + i] / rho) + c) * iod[i]
            cfl = a if cfl is None else cfl.add_(a)
            del a
        cfl = float(torch.max(cfl))
        acc = iod[0] ** 2 + iod[1] ** 2 + iod[2] ** 2
        dden = self.sfactor * float(torch.max(acc / rho))
        pmin, pmax = float(p.min()), float(p.max())
        rmin, rmax = float(rho.min()), float(rho.max())
        vals = [cfl, pmin, pmax, rmin, rmax, dden]
        scales = [cfl, pmax - pmin, pmax - pmin, rmax - rmin, rmax - rmin,
                  dden]
        return vals, scales

    def mass_flux_terms(self, q):
        """max over the box of sum_j |d_j(rho u_j)|: the size of the terms
        of the continuity equation's tendency."""
        out = None
        for j in range(3):
            a = torch.abs(self.d1_along(
                q[1 + j].to(self.device).to(self.dtype), j))
            out = a if out is None else out.add_(a)
            del a
        return float(torch.max(out))
