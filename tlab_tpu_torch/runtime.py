"""Simulation context for the port: grid, plans and device operators from a
CaseSetup, for the incompressible (Boussinesq) equation set on one device
(port of tlab_tpu/runtime.py: make_sources restricted to buoyancy,
Coriolis, homogeneous forcing and subsidence, and the incompressible
branch of Simulation).

Every case option not ported yet raises NotImplementedError naming the
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
from tlab_tpu_torch.fdm import stagger as stg
from tlab_tpu_torch.ops import elliptic
from tlab_tpu_torch.ops import elliptic_factorize as fac
from tlab_tpu_torch.ops import filter as filt
from tlab_tpu_torch.physics import forcing as forcmod
from tlab_tpu_torch.physics import gravity as grav
from tlab_tpu_torch.physics import rotation as rot

FACTORIZED_ORDERS = ("", "factorize", "compactjacobian6")


def _unported_sources(case: CaseSetup):
    """(option, ROADMAP item) for each source term or thermodynamic option
    of `case` that make_sources lacks."""
    ini = case.ini

    def ini_type(section, default="none", key="Type"):
        return ini.get(section, key, default).lower() if ini is not None \
            else default

    found = []
    tcfg = case.thermo or {}
    if tcfg.get("type", "").lower() == "anelastic":
        found.append(("[Thermodynamics] Type=anelastic", "A9"))
    if tcfg.get("mixture", "") == "airwaterlinear":
        found.append(("Mixture=airwaterlinear", "A9"))
    buo = case.buoyancy
    if buo is not None and buo.type == "explicit" and any(buo.active):
        found.append(("buoyancy Type=explicit (anelastic)", "A9"))
    for section, alt in (("Infrared", "Radiation"),
                         ("Sedimentation", "Microphysics"),
                         ("Chemistry", None)):
        kind = ini_type(section, ini_type(alt) if alt else "none")
        if kind != "none":
            found.append((f"[{section}] Type={kind}", "A9"))
    kind = ini_type("SpecialForcing")
    if kind not in ("none", "", "homogeneous"):
        found.append((f"[SpecialForcing] Type={kind}", "A9"))
    return found


def _refuse(missing) -> None:
    if missing:
        raise NotImplementedError(
            "not ported yet: " + "; ".join(
                f"{opt} (ROADMAP {item})" for opt, item in missing))


def make_sources(case: CaseSetup, grid: Grid, dtype=torch.float32,
                 device="cuda"):
    """Momentum and scalar source-term hook (buoyancy, Coriolis, constant
    forcing, subsidence), the equivalent of the reference's
    TLab_Sources_Flow dispatcher (src/physics/tlab_sources.f90).  Returns
    None when no source is active (keeps the RHS free of dead ops).

    The hook, sources(P, state, h1, h2, h3, hs, aux=None), ADDS the terms
    into h1, h2, h3 (nx, ny, nz) and hs (ns, nx, ny, nz) in place -- the
    step passes the rows of its stacked tendency -- and returns them.
    Radiation, microphysics, chemistry, the wavemaker and the anelastic and
    linearized-mixture thermodynamics raise NotImplementedError (ROADMAP
    A9)."""
    dev = _device.resolve(device)
    _refuse(_unported_sources(case))
    buo = case.buoyancy
    cor = case.coriolis
    buo_on = buo is not None and buo.type != "none" and any(buo.active)
    cor_on = cor is not None and cor.type != "none"
    ini = case.ini
    sub = forcmod.SubsidenceProps(
        type=ini.get("Subsidence", "Type",
                     ini.get("Main", "TermSubsidence", "none")).lower(),
        divergence=(ini.get_floats("Subsidence", "Parameters", (0.0,))
                    or (0.0,))[0])
    sub_on = sub.type not in ("none", "") and sub.divergence != 0.0
    homog = forcmod.homogeneous_from_ini(ini)
    homog_on = homog is not None and any(abs(f) > 0 for f in homog)
    if not (buo_on or cor_on or sub_on or homog_on):
        return None

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float64)).to(dev, dtype)

    y_dev = t(grid.y.nodes)
    if buo_on:
        bback = t(grav.background_profile(buo, case.scal_profiles,
                                          grid.y.nodes))

    def sources(P, state, h1, h2, h3, hs, aux=None):
        if homog_on:
            # constant body force (channel driving pressure gradient)
            for h, f in zip((h1, h2, h3), homog):
                if abs(f) > 0:
                    h += f
        if cor_on:
            r1, r2, r3 = rot.coriolis_tendency(cor, state.u, state.v,
                                               state.w)
            h1 += r1
            h2 += r2
            h3 += r3
        if buo_on:
            b = grav.buoyancy_field(buo, state.s, bback)
            for h, g in zip((h1, h2, h3), buo.vector):
                if abs(g) > 0:
                    h.add_(b, alpha=g)
        if sub_on:
            # ConstantDivergenceLocal is folded into OPR_Burgers_Y in the
            # reference (opr_burgers.f90:336-340), so it acts on EVERY
            # field advected in y: u, v, w and all scalars
            for isc in range(state.s.shape[0]):
                hs[isc].add_(forcmod.subsidence_source(sub, P, y_dev,
                                                       state.s[isc]))
            h1 += forcmod.subsidence_source(sub, P, y_dev, state.u)
            h2 += forcmod.subsidence_source(sub, P, y_dev, state.v)
            h3 += forcmod.subsidence_source(sub, P, y_dev, state.w)
        return h1, h2, h3, hs

    # isolated-term closures for the pressure-decomposition menu
    # (FI_PRESSURE_BOUSSINESQ DCMP_CORIOLIS/DCMP_BUOYANCY,
    # fi_pressure_boussinesq.f90:158-190)
    if cor_on:
        def coriolis_only(state):
            return rot.coriolis_tendency(cor, state.u, state.v, state.w)
        sources.coriolis_only = coriolis_only
    if buo_on:
        def buoyancy_only(state):
            b = grav.buoyancy_field(buo, state.s, bback)
            z = torch.zeros_like(state.u)
            return tuple(g * b if abs(g) > 0 else z for g in buo.vector)
        sources.buoyancy_only = buoyancy_only
    return sources


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
    found += _unported_sources(case)
    if case.flow_type != "temporal" or not grid.x.periodic:
        found.append((f"Type={case.flow_type}", "A10"))
    if on(case.buffer):
        found.append(("[BufferZone]", "A10"))
    if ini_type("IBMParameter", key="Status", default="off") == "on":
        found.append(("[IBMParameter]", "A10"))
    if any(d["jmin"] == "linear" or d["jmax"] == "linear"
           for d in (case.surface_bc or ())):
        found.append(("interactive surface BC", "A10"))
    if "diffusion" in case.time_order.lower():
        found.append((f"TimeOrder={case.time_order}", "A11"))
    return found


def _staggered_plans(grid: Grid, fdm: FdmPlan, factorized: bool, dtype,
                     dev) -> dict:
    """Plan entries of the horizontally staggered pressure ([Staggering]
    StaggerHorizontalPressure=yes; reference
    tlab_initialize_parameters.f90:112-117): "stag", the dense staggered
    operators along x and z, and the Poisson plan rebuilt on the staggered
    derivative's wavenumbers -- "ell_fac" or, for the direct solver,
    "ell_stag"."""
    def t(a):
        return torch.as_tensor(np.asarray(a, np.float64)).to(dev, dtype)

    sd = {}
    nx = grid.x.size
    for k, M in stg.build_stagger_ops(nx, grid.x.scale / nx).items():
        sd[f"{k}x"] = t(M)
    wx = stg.modified_wavenumber(nx, grid.x.scale)
    wz = None
    if grid.z.size > 1:
        nz = grid.z.size
        for k, M in stg.build_stagger_ops(nz, grid.z.scale / nz).items():
            sd[f"{k}z"] = t(M)
        wz_half = stg.modified_wavenumber(nz, grid.z.scale)
        k = np.arange(nz)
        wz = wz_half[np.minimum(k, nz - k)]          # full-fft ordering
    out = {"stag": sd}
    if factorized:
        # the staggered divergence/gradient operators define the modal
        # eigenvalues, and only the (0,0) mode is singular (reference
        # opr_elliptic.f90:144-147)
        out["ell_fac"] = fac.device_factorize_plan(
            fac.build_factorize_plan(fdm, mwn_x=wx, mwn_z=wz), dtype, dev)
    else:
        # eigen pencil (EllipticOrder=compactdirect*); accurate only on y
        # grids with a well-conditioned pencil
        out["ell_stag"] = elliptic.device_elliptic_plan(
            elliptic.build_elliptic_plan(
                fdm, ibc=BC.NN, lam_x=wx ** 2,
                lam_z=None if wz is None else wz ** 2), dtype, dev)
    return out


@dataclasses.dataclass
class Simulation:
    case: CaseSetup
    grid: Grid
    fdm: FdmPlan
    nsp: NSParams
    P: dict                      # dycore device plans
    ell_plans: dict              # BC -> direct eigen Poisson plan on device
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
        _refuse(_off_path_options(case, grid))
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
        # EllipticOrder: the factorized formulation is the default (as the
        # reference): its D1-consistent integrals make the projection
        # remove the D1-measured divergence to round-off. The direct eigen
        # pencil (EllipticOrder=compactdirect4/6) leaves the D1^2-vs-D2
        # truncation mismatch as residual divergence at grid scales --
        # O(1) on noisy fields.
        factorized = case.elliptic_order in FACTORIZED_ORDERS \
            and grid.y.size > 4
        P = dyn.build_device_plans(
            fdm, nsp, bcs, rk_name=case.time_order, dtype=dtype, device=dev,
            wall_refs=wall_refs,
            bodyforce=make_sources(case, grid, dtype, dev),
            factorize=factorized and not case.stagger)
        # [Main] TermAdvection selects the nonlinear formulation
        # (reference rhs_flow_global_incompressible_1/2/3.f90)
        if case.term_advection in ("divergence", "skewsymmetric"):
            P["adv_form"] = case.term_advection
        # [Main] TermDivergence=none drops the q/dte residual-divergence
        # term from the projection forcing (dns_read_local.f90:79-83)
        if case.ini is not None and case.ini.get(
                "Main", "TermDivergence", "remove").lower() == "none":
            P["remove_divergence"] = False
        pf = case.pressure_filter
        if pf is not None and pf.type != "none":
            if pf.type == "helmholtz":
                # marker dict: the projection routes it through the eigen
                # Helmholtz solve
                width = pf.parameters[0] if pf.parameters else 2.0
                P["pfilter"] = {
                    "helmholtz_alpha": -24.0 / max(width, 1e-30) ** 2}
            else:
                P["pfilter"] = filt.build_filter_matrices(fdm, pf, dtype,
                                                          dev)
        if case.stagger:
            P.update(_staggered_plans(grid, fdm, factorized, dtype, dev))
        if case.dealias is not None and case.dealias.type != "none":
            P["dealias"] = filt.build_filter_matrices(fdm, case.dealias,
                                                      dtype, dev)
        ctrl = case.control or {}
        if ctrl.get("scal_limit") and nsp.n_scalars:
            P["scal_bounds"] = dyn.scalar_bounds(
                ctrl["min_scalar"], ctrl["max_scalar"], dtype, dev)
        return cls(case=case, grid=grid, fdm=fdm, nsp=nsp, P=P,
                   ell_plans={BC.NN: P["ell"]}, dtype=dtype, device=dev)

    # -- optional subsystems ------------------------------------------------
    def filter_matrices(self):
        """The [Filter] of the case as apply_filter takes it (matrices, or
        the Helmholtz filter's function), or None."""
        spec = self.case.filter
        if spec is None or spec.type == "none":
            return None
        if spec.type == "helmholtz":
            width = spec.parameters[0] if spec.parameters else 2.0
            # zero-gradient walls preserve the field at the boundary
            return filt.build_helmholtz_filter(self.P["ell"], width)
        return filt.build_filter_matrices(self.fdm, spec, self.dtype,
                                          self.device)

    # -- convenience ops (the initial conditions' vector calculus) ----------
    def zero_state(self) -> State:
        nx, ny, nz = self.grid.shape
        kw = {"dtype": self.dtype, "device": self.device}
        return State(u=torch.zeros((nx, ny, nz), **kw),
                     v=torch.zeros((nx, ny, nz), **kw),
                     w=torch.zeros((nx, ny, nz), **kw),
                     s=torch.zeros((self.nsp.n_scalars, nx, ny, nz), **kw))

    def ell(self, bc):
        """Direct eigen Poisson plan for the given wall BC, built at first
        use (the Neumann one is the step's P["ell"])."""
        if bc not in self.ell_plans:
            plan = elliptic.build_elliptic_plan(self.fdm, ibc=bc)
            self.ell_plans[bc] = elliptic.device_elliptic_plan(
                plan, self.dtype, self.device)
        return self.ell_plans[bc]

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
        factorized formulation when active (the default), else the direct
        eigen pencil.  The initial conditions share it with the dycore
        (flow_local.f90:315-337, fi_vectorcalculus.f90:94)."""
        dev = self.P.get("ell_fac")
        if dev is not None:
            p, _ = fac.poisson_factorize(dev, f,
                                         ibc="nn" if bc == BC.NN else "dd")
            return p
        return elliptic.poisson(self.ell(bc), f)

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
