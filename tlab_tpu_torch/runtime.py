"""Simulation context for the port: grid, plans and device operators from a
CaseSetup, limited to the incompressible main path (port of
tlab_tpu/runtime.py:409-481, 589-675).

Every case option outside that path raises NotImplementedError naming the
ROADMAP item that will port it; none is dropped silently.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from tlab_tpu_torch.config import CaseSetup, consistency_check, load_case
from tlab_tpu_torch.constants import BC
from tlab_tpu_torch.fdm.plan import FdmPlan, build_fdm_plan
from tlab_tpu_torch.grid import Grid, build_axis_from_segments, make_axis
from tlab_tpu_torch.physics.params import NSParams
from tlab_tpu_torch import device as _device
from tlab_tpu_torch.dycore import incompressible as dyn
from tlab_tpu_torch.dycore.state import State
from tlab_tpu_torch.ops import elliptic_factorize as fac


def grid_from_case(case: CaseSetup) -> Grid:
    axes = []
    for i, d in enumerate("xyz"):
        spec = case.grid_segments[d]
        segs = spec["segments"] if isinstance(spec, dict) else spec
        mirrored = spec.get("mirrored", False) if isinstance(spec, dict) \
            else False
        fixed = spec.get("fixed_scale", -1.0) if isinstance(spec, dict) \
            else -1.0
        if segs and segs[0]["n"] > 1:
            axes.append(build_axis_from_segments(segs, case.periodic[i],
                                                 mirrored=mirrored,
                                                 fixed_scale=fixed))
        else:
            axes.append(make_axis(np.zeros(1), False))
    return Grid(*axes)


def _off_path_options(case: CaseSetup, grid: Grid):
    """(option, ROADMAP item) for each option of `case` the port lacks."""
    ini = case.ini

    def on(spec):
        return spec is not None and spec.type not in ("none", "")

    def ini_type(section, default="none", key="Type"):
        return ini.get(section, key, default).lower() if ini is not None \
            else default

    found = []
    if case.equations != "incompressible":
        item = "A9" if case.equations == "anelastic" else "A13"
        found.append((f"Equations={case.equations}", item))
    if (case.thermo or {}).get("type", "").lower() == "anelastic":
        found.append(("[Thermodynamics] Type=anelastic", "A9"))
    buo = case.buoyancy
    if buo is not None and buo.type != "none" and any(buo.active):
        found.append(("buoyancy", "A9"))
    if case.coriolis is not None and case.coriolis.type != "none":
        found.append(("Coriolis", "A9"))
    for section, alt in (("Infrared", "Radiation"),
                         ("Sedimentation", "Microphysics"),
                         ("Chemistry", None), ("SpecialForcing", None)):
        kind = ini_type(section, ini_type(alt) if alt else "none")
        if kind != "none":
            found.append((f"[{section}] Type={kind}", "A9"))
    if ini_type("Subsidence", ini_type("Main", key="TermSubsidence")) \
            not in ("none", ""):
        found.append(("subsidence", "A9"))
    if case.flow_type != "temporal":
        found.append((f"Type={case.flow_type}", "A10"))
    if on(case.buffer):
        found.append(("[BufferZone]", "A10"))
    if ini_type("IBMParameter", key="Status", default="off") == "on":
        found.append(("[IBMParameter]", "A10"))
    if any(d["jmin"] == "linear" or d["jmax"] == "linear"
           for d in (case.surface_bc or ())):
        found.append(("interactive surface BC", "A10"))
    if case.term_advection not in ("convective", ""):
        found.append((f"TermAdvection={case.term_advection}", "A8"))
    if ini_type("Main", key="TermDivergence", default="remove") == "none":
        found.append(("TermDivergence=none", "A8"))
    if case.elliptic_order not in ("", "factorize", "compactjacobian6") \
            or grid.y.size <= 4 or not grid.x.periodic:
        found.append(("direct eigen Poisson", "A8"))
    if getattr(case, "stagger", False):
        found.append(("staggered pressure", "A8"))
    if on(getattr(case, "pressure_filter", None)):
        found.append(("[PressureFilter]", "A8"))
    if on(case.dealias):
        found.append(("dealiasing", "A8"))
    if on(case.filter):
        found.append(("[Filter]", "A8"))
    if "diffusion" in case.time_order.lower():
        found.append((f"TimeOrder={case.time_order}", "A11"))
    return found


@dataclasses.dataclass
class Simulation:
    case: CaseSetup
    grid: Grid
    fdm: FdmPlan
    nsp: NSParams
    P: dict                      # dycore device plans
    dtype: torch.dtype
    device: torch.device

    @classmethod
    def from_case(cls, case_or_path, dtype=torch.float32, device="cuda",
                  grid: Optional[Grid] = None) -> "Simulation":
        case = case_or_path if isinstance(case_or_path, CaseSetup) \
            else load_case(case_or_path)
        consistency_check(case)
        dev = _device.resolve(device)
        if grid is None:
            grid = grid_from_case(case)
        missing = _off_path_options(case, grid)
        if missing:
            raise NotImplementedError(
                "not ported yet: " + "; ".join(
                    f"{opt} (ROADMAP {item})" for opt, item in missing))
        fdm = build_fdm_plan(grid, case.space_order1, case.space_order2)
        nsp = NSParams(reynolds=case.reynolds, schmidt=tuple(case.schmidt),
                       prandtl=case.prandtl, froude=case.froude,
                       rossby=case.rossby)
        scal_bcs = tuple(
            (b if b in ("dirichlet", "neumann") else "dirichlet",
             t if t in ("dirichlet", "neumann") else "dirichlet")
            for b, t in case.scalar_bc)
        bcs = dyn.WallBCs.from_velocity_kind(case.velocity_bc[0],
                                             case.velocity_bc[1],
                                             scalar_bcs=scal_bcs)
        # Dirichlet wall reference values = mean velocity profile at the
        # walls (reference BcsFlowJmin/Jmax%ref)
        yw = np.asarray([grid.y.nodes[0], grid.y.nodes[-1]])
        wall_refs = {
            "u": tuple(float(v) for v in case.vel_profiles[0](yw)),
            "v": (0.0, 0.0),
            "w": tuple(float(v) for v in case.vel_profiles[2](yw)),
        }
        P = dyn.build_device_plans(fdm, nsp, bcs, rk_name=case.time_order,
                                   dtype=dtype, device=dev,
                                   wall_refs=wall_refs)
        ctrl = case.control or {}
        if ctrl.get("scal_limit") and nsp.n_scalars:
            P["scal_bounds"] = dyn.scalar_bounds(
                ctrl["min_scalar"], ctrl["max_scalar"], dtype, dev)
        return cls(case=case, grid=grid, fdm=fdm, nsp=nsp, P=P,
                   dtype=dtype, device=dev)

    # -- convenience ops (the initial conditions' vector calculus) ----------
    def zero_state(self) -> State:
        nx, ny, nz = self.grid.shape
        kw = {"dtype": self.dtype, "device": self.device}
        return State(u=torch.zeros((nx, ny, nz), **kw),
                     v=torch.zeros((nx, ny, nz), **kw),
                     w=torch.zeros((nx, ny, nz), **kw),
                     s=torch.zeros((self.nsp.n_scalars, nx, ny, nz), **kw))

    def curl(self, u, v, w):
        dy_w = dyn._d1(self.P, "y", 1, w)
        dz_v = dyn._d1(self.P, "z", 2, v)
        dz_u = dyn._d1(self.P, "z", 2, u)
        dx_w = dyn._d1(self.P, "x", 0, w)
        dx_v = dyn._d1(self.P, "x", 0, v)
        dy_u = dyn._d1(self.P, "y", 1, u)
        return dy_w - dz_v, dz_u - dx_w, dx_v - dy_u

    def poisson_ref(self, bc, f):
        """The Poisson solve the reference's OPR_Poisson pointer resolves
        to, with homogeneous walls of kind `bc` (BC.NN or BC.DD): the
        factorized formulation, which the initial conditions share with the
        dycore (flow_local.f90:315-337, fi_vectorcalculus.f90:94)."""
        dev = self.P.get("ell_fac")
        if dev is None:
            raise NotImplementedError(
                "poisson_ref without a factorized plan (the direct eigen "
                "Poisson): ROADMAP A8")
        p, _ = fac.poisson_factorize(dev, f,
                                     ibc="nn" if bc == BC.NN else "dd")
        return p

    def solenoidal(self, u, v, w):
        """Remove dilatation: u += grad(phi), lap(phi) = -div(u)
        (cf. reference FI_SOLENOIDAL, fi_vectorcalculus.f90:72-106);
        the y-correction uses OPR_Partial_Y (D1), not the stage dpdy."""
        div = dyn.divergence(self.P, u, v, w)
        phi = self.poisson_ref(BC.NN, -div)
        u = u + dyn._d1(self.P, "x", 0, phi)
        v = v + dyn._d1(self.P, "y", 1, phi)
        w = w + dyn._d1(self.P, "z", 2, phi)
        return u, v, w
