"""tlab.ini-compatible configuration.

Case-insensitive [Section] Key=Value files, consumed by every tool, with a
.bak echo of every read (provenance + schema doc), mirroring the reference's
ScanFile_* machinery (src/base/io_ascii.f90:11-92).
"""
from __future__ import annotations

import dataclasses
import os
import re
from typing import Optional

from tlab_tpu_torch.physics.profiles import Profile


class Ini:
    """Minimal case-insensitive INI reader with read-echo provenance."""

    def __init__(self, path: Optional[str] = None, text: Optional[str] = None):
        self.path = path
        self.data: dict = {}
        self._echo: list = []
        if text is None and path is not None:
            with open(path) as fh:
                text = fh.read()
        if text:
            self._parse(text)

    def _parse(self, text: str) -> None:
        section = ""
        for raw in text.splitlines():
            line = raw.split("#", 1)[0].strip()
            if not line:
                continue
            m = re.match(r"\[(.+)\]\s*$", line)
            if m:
                section = m.group(1).strip().lower()
                self.data.setdefault(section, {})
                continue
            if "=" in line:
                key, val = line.split("=", 1)
                self.data.setdefault(section, {})[key.strip().lower()] = val.strip()

    # -- typed getters ------------------------------------------------------
    def get(self, section: str, key: str, default: str = "") -> str:
        val = self.data.get(section.lower(), {}).get(key.lower(), default)
        self._echo.append((section, key, val))
        return val

    def get_int(self, section, key, default=0) -> int:
        v = self.get(section, key, str(default))
        return int(float(v)) if v != "" else default

    @staticmethod
    def _fnum(tok: str) -> float:
        # Fortran d-exponent literals (MaxDilatation=1.0d6)
        return float(re.sub(r"[dD](?=[+-]?\d)", "e", tok.strip()))

    def get_float(self, section, key, default=0.0) -> float:
        v = self.get(section, key, str(default))
        if v == "":
            return default
        # Fortran list-directed ScanFile_Real takes the FIRST value of a
        # comma-separated list (e.g. Case30's ThickIniS=84.,84.)
        return self._fnum(v.split(",")[0])

    def get_bool(self, section, key, default=False) -> bool:
        v = self.get(section, key, "yes" if default else "no").lower()
        return v in ("yes", "true", "on", "1")

    def get_floats(self, section, key, default=()) -> tuple:
        v = self.get(section, key, "")
        if not v:
            return tuple(default)
        return tuple(self._fnum(tok) for tok in re.split(r"[,\s]+", v)
                     if tok)

    def write_bak(self, path: Optional[str] = None) -> None:
        """Echo every read key=value (the reference's tlab.ini.bak)."""
        path = path or ((self.path or "tlab.ini") + ".bak")
        with open(path, "w") as fh:
            last = None
            for section, key, val in self._echo:
                if section != last:
                    fh.write(f"[{section}]\n")
                    last = section
                fh.write(f"{key}={val}\n")


# ---------------------------------------------------------------------------
# Typed case setup
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CaseSetup:
    # [Main]
    flow_type: str                 # temporal | spatial
    calculate_flow: bool
    calculate_scalar: bool
    equations: str
    term_advection: str
    space_order1: str
    space_order2: str
    elliptic_order: str            # '' => same schemes as derivatives
    time_order: str
    time_step: float               # negative => adaptive
    time_cfl: float
    time_cfl_diffusive: float
    # [Iteration]
    it_start: int
    it_end: int
    it_restart: int
    it_stats: int
    it_log: int
    # [Parameters]
    reynolds: float
    schmidt: tuple
    prandtl: float
    mach: float
    gamma: float
    froude: float
    rossby: float
    # [Grid]
    imax: int
    jmax: int
    kmax: int
    periodic: tuple
    uniform: tuple
    # profiles & bcs
    vel_profiles: tuple            # (Profile, Profile, Profile)
    scal_profiles: tuple
    velocity_bc: tuple             # (jmin_kind, jmax_kind): noslip|freeslip
    scalar_bc: tuple               # per scalar ((jmin, jmax) types)
    # [IniFields]
    ini_velocity: str
    ini_scalar: str
    force_dilatation: bool
    normalize_k: float
    profile_ini_k: Profile
    profile_ini_s: tuple           # per-scalar IniS envelope profiles
    normalize_s: tuple             # per-scalar target max plane rms
    broadband: dict
    grid_segments: dict            # per direction list of segment dicts
    buoyancy: object               # BuoyancyProps
    coriolis: object               # CoriolisProps
    buffer: object                 # BufferSpec
    filter: object                 # FilterSpec
    thermo: dict                   # [Thermodynamics] keys
    control: dict                  # [Control] bounds
    planes: dict                   # [SavePlanes]
    towers: dict                   # [SaveTowers]
    dealias: object                # FilterSpec for advection dealiasing
    ini: Ini
    stagger: bool = False          # [Staggering] StaggerHorizontalPressure
    pressure_filter: object = None  # [PressureFilter] FilterSpec
    discrete: dict = None          # [Discrete] mode perturbation spec
    surface_bc: tuple = ()         # per-scalar interactive surface BC spec


def _read_profile(ini: Ini, section: str, tag: str, yscale: float,
                  ystart: float = 0.0) -> Profile:
    ptype = ini.get(section, f"Profile{tag}", "none").lower()
    if ptype == "ekman":
        # reference key 'ekman' selects PROFILE_EKMAN_U (profiles.f90:95)
        ptype = "ekmanu"
    # normalize naming: 'None' -> none
    mean = ini.get_float(section, tag if section == "flow" else f"Mean{tag}", 0.0)
    # reference uses bare key (e.g. VelocityX) for the mean value
    mean = ini.get_float(section, f"Mean{tag}", mean)
    if section == "flow":
        mean = ini.get_float(section, tag, mean)
    delta = ini.get_float(section, f"Delta{tag}", 0.0)
    thick = ini.get_float(section, f"Thick{tag}", 1.0)
    # YMean<tag> = absolute height; YMeanRelative/YCoor = relative
    # (Profiles_ReadBlock, profiles.f90:113-127)
    ymean_abs = ini.get(section, f"YMean{tag}", "")
    if ymean_abs != "":
        ymean = float(ymean_abs.split(",")[0].strip())
    else:
        ycoor = ini.get_float(
            section, f"YCoor{tag}",
            ini.get_float(section, f"YMeanRelative{tag}", 0.5))
        # ymean = y(1) + scale * ymean_rel (tlab_background.f90:181)
        ymean = ystart + ycoor * yscale
    lslope = ini.get_float(section, f"LowerSlope{tag}", 0.0)
    uslope = ini.get_float(section, f"UpperSlope{tag}", 0.0)
    diam = ini.get_float(section, f"Diam{tag}", 0.0)
    s_thick = ini.get_float(section, f"SurfaceThick{tag}", 1.0)
    s_delta = ini.get_float(section, f"SurfaceDelta{tag}", 0.0)
    # Derivative<tag>: thick/delta from the max-derivative value
    # (profiles.f90:131-143)
    der = ini.get(section, f"Derivative{tag}", "")
    if der != "":
        from tlab_tpu_torch.physics.profiles import der_to_thick, der_to_delta
        d = float(der)
        if ini.get(section, f"Thick{tag}", "") == "":
            thick = der_to_thick(ptype, delta, d, uslope)
        if ini.get(section, f"Delta{tag}", "") == "":
            delta = der_to_delta(ptype, thick, d, uslope)
    return Profile(type=ptype, mean=mean, delta=delta, thick=thick,
                   ymean=ymean, lslope=lslope, uslope=uslope, diam=diam,
                   surface_thick=s_thick, surface_delta=s_delta)


def _read_grid_segments(ini: Ini, dirname: str) -> dict:
    """[IniGridOx/y/z] block (reference GRID_READBLOCK,
    grid_main.f90:168-236): scales_N is the physical END of segment N's
    uniform reference grid; opts_N is 'uniform'/'tanh'/'exp' or a numeric
    option list; plus direction-level mirrored / fixed_scale."""
    sec = f"inigrido{dirname}"
    nseg = ini.get_int(sec, "segments", 1)
    segs = []
    for i in range(1, nseg + 1):
        opts_raw = ini.get(sec, f"opts_{i}", "uniform").lower()
        if opts_raw not in ("uniform", "tanh", "exp"):
            try:
                opts = [int(v) for v in opts_raw.replace(",", " ").split()]
            except ValueError:
                opts = opts_raw
        else:
            opts = opts_raw
        end = ini.get_float(sec, f"scales_{i}", -1.0)
        segs.append({
            "n": ini.get_int(sec, f"points_{i}", 1),
            "end": end,
            "scale": end,          # legacy key (single-segment length==end)
            "opts": opts,
            "vals": ini.get_floats(sec, f"vals_{i}", ()),
            "params": ini.get_floats(sec, f"vals_{i}", ()),
        })
    return {"segments": segs,
            "mirrored": ini.get_bool(sec, "mirrored", False),
            "fixed_scale": ini.get_float(sec, "fixed_scale", -1.0)}


def _read_discrete(ini: Ini) -> dict:
    """[Discrete] block (reference Discrete_ReadBlock, discrete.f90:43-99):
    Amplitude (legacy 2DAmpl) sets the mode count; ModeX defaults to
    1..n, ModeZ to 0; PhaseX legacy 2DPhi."""
    amps = ini.get_floats("Discrete", "Amplitude", ())
    if not amps:
        amps = ini.get_floats("Discrete", "2DAmpl", (1e-2,))
    n = len(amps)
    modex = ini.get_floats("Discrete", "ModeX", ())
    modex = tuple(int(v) for v in modex) if modex \
        else tuple(range(1, n + 1))
    modez = ini.get_floats("Discrete", "ModeZ", ())
    modez = tuple(int(v) for v in modez) if modez else (0,) * n
    phasex = ini.get_floats("Discrete", "PhaseX", ())
    if not phasex:
        phasex = ini.get_floats("Discrete", "2DPhi", (0.0,) * n)
    phasez = ini.get_floats("Discrete", "PhaseZ", (0.0,) * n)
    return {"amplitude": tuple(amps), "modex": modex, "modez": modez,
            "phasex": tuple(phasex) + (0.0,) * n,
            "phasez": tuple(phasez) + (0.0,) * n}


def _pad_list(vals, n: int, fill: float = 0.0) -> tuple:
    """Fortran LIST_REAL semantics: a singleton broadcasts to all n
    entries; an empty list becomes `fill` (scal_local.f90:114-127)."""
    vals = list(vals)
    pad = vals[0] if vals else fill
    return tuple((vals + [pad] * n)[:n])


def _ini_s_profile(ini: Ini, i: int, jscale: float, jstart: float):
    """IniS / IniS<i> perturbation envelope for scalar i: per-scalar keys
    win over the shared IniS block; default type gaussiansurface,
    amplitude forced to 1 and mean to 0 (scal_local.f90:96-112)."""
    has_i = ini.get("IniFields", f"ProfileIniS{i+1}",
                    ini.get("IniFields", f"ThickIniS{i+1}", "")) != ""
    p = _read_profile(ini, "inifields", f"IniS{i+1}" if has_i else "IniS",
                      jscale, jstart)
    if p.type == "none":
        p = dataclasses.replace(p, type="gaussiansurface")
    return dataclasses.replace(p, delta=1.0, mean=0.0)


def load_case(path_or_ini) -> CaseSetup:
    ini = path_or_ini if isinstance(path_or_ini, Ini) else Ini(path_or_ini)

    so = ini.get("Main", "SpaceOrder", "CompactJacobian6")
    so1 = ini.get("Main", "SpaceOrder1", so)
    so2 = ini.get("Main", "SpaceOrder2", "CompactJacobian6Hyper")

    schmidt = ini.get_floats("Parameters", "Schmidt", (1.0,))

    segs = {d: _read_grid_segments(ini, d) for d in ("x", "y", "z")}
    # vertical scale for YCoor-relative profile positions: the ACTUAL
    # extent of the built y grid (stretching maps may move the end point
    # past scales_N, cf. BLD_TANH) -- reference profiles use g(2)%scale
    jscale, jstart = 1.0, 0.0
    ysegs = segs["y"]["segments"]
    if ysegs and ysegs[0]["n"] > 1 and ysegs[0]["end"] > 0:
        try:
            from tlab_tpu_torch.grid import build_axis_reference
            yax = build_axis_reference(ysegs, False,
                                       mirrored=segs["y"]["mirrored"],
                                       fixed_scale=segs["y"]["fixed_scale"])
            jscale = float(yax.nodes[-1] - yax.nodes[0]) or 1.0
            # mirrored grids start below zero: relative profile heights
            # are anchored at y(1) (tlab_background.f90:181)
            jstart = float(yax.nodes[0])
        except Exception:
            jscale = ysegs[-1]["end"] or 1.0
    else:
        # fall back to [Grid] Jmax nominal unit scale
        jscale = ysegs[-1]["end"] if ysegs and ysegs[-1]["end"] > 0 else 1.0

    n_scal = len(schmidt)
    vel_tags = ("VelocityX", "VelocityY", "VelocityZ")
    vel_profiles = tuple(_read_profile(ini, "flow", t, jscale, jstart)
                         for t in vel_tags)
    if vel_profiles[0].type in ("ekmanu", "ekmanp"):
        # Ekman consistency rule: the spanwise velocity gets the companion
        # EKMAN_V profile with the same parameters (tlab_background.f90:
        # 96-99, qbg(3) = qbg(1) with type EKMAN_V)
        import dataclasses as _dc
        vel_profiles = (vel_profiles[0], vel_profiles[1],
                        _dc.replace(vel_profiles[0], type="ekmanv"))
    scal_profiles = tuple(_read_profile(ini, "scalar", f"Scalar{i+1}",
                                        jscale, jstart)
                          for i in range(n_scal))

    scalar_bc = tuple(
        (ini.get("BoundaryConditions", f"Scalar{i+1}Jmin", "none").lower(),
         ini.get("BoundaryConditions", f"Scalar{i+1}Jmax", "none").lower())
        for i in range(n_scal))
    # interactive (linear) surface BCs (reference dns_read_local.f90:216-219)
    surface_bc = tuple(
        {"jmin": ini.get("BoundaryConditions", f"Scalar{i+1}SfcTypeJmin",
                         "static").lower(),
         "jmax": ini.get("BoundaryConditions", f"Scalar{i+1}SfcTypeJmax",
                         "static").lower(),
         "cpl_jmin": ini.get_float("BoundaryConditions",
                                   f"Scalar{i+1}CouplingJmin", 0.0),
         "cpl_jmax": ini.get_float("BoundaryConditions",
                                   f"Scalar{i+1}CouplingJmax", 0.0)}
        for i in range(n_scal))

    from tlab_tpu_torch.physics.gravity import BuoyancyProps
    from tlab_tpu_torch.physics.rotation import CoriolisProps

    def _reynolds_from_ini(ini):
        """Reynolds, or 1/Viscosity when Reynolds is absent/nonpositive
        (navierstokes.f90:141-150); final fallback 100 keeps legacy
        minimal INIs runnable."""
        re = ini.get_float("Parameters", "Reynolds", -1.0)
        if re > 0.0:
            return re
        visc = ini.get_float("Parameters", "Viscosity", -1.0)
        return 1.0 / visc if visc > 0.0 else 100.0

    # dimensional alternatives: Froude <= 0/absent -> 1/Gravity,
    # Rossby -> 1/Coriolis (navierstokes.f90:156-168)
    froude = ini.get_float("Parameters", "Froude", -1.0)
    if froude <= 0.0:
        froude = 1.0 / ini.get_float("Parameters", "Gravity", 1.0)
    rossby = ini.get_float("Parameters", "Rossby", -1.0)
    if rossby <= 0.0:
        rossby = 1.0 / ini.get_float("Parameters", "Coriolis", 1.0)
    gsec = "Gravity" if ini.get("Gravity", "Vector", "") else "BodyForce"
    gtype = ini.get(gsec, "Type",
                    ini.get("Main", "TermBodyForce", "none")).lower()
    gvec = ini.get_floats(gsec, "Vector", (0.0, 0.0, 0.0))
    buoyancy = BuoyancyProps(
        type=gtype,
        vector=tuple(v / froude for v in gvec),
        parameters=ini.get_floats(gsec, "Parameters", (0.0,) * 10) or (0.0,))

    ctype = ini.get("Rotation", "Type",
                    ini.get("Main", "TermCoriolis", "none")).lower()
    cvec = ini.get_floats("Rotation", "Vector", (0.0, 1.0, 0.0))
    cpar = ini.get_floats("Rotation", "Parameters", (0.0, 1.0))
    if len(cpar) < 2 or cpar[1] == 0.0:
        cpar = (cpar[0] if cpar else 0.0, 1.0)
    coriolis = CoriolisProps(
        type=ctype,
        vector=tuple(v / rossby for v in cvec),
        parameters=tuple(cpar))

    from tlab_tpu_torch.dycore.buffer import BufferSpec
    from tlab_tpu_torch.ops.filter import FilterSpec

    # reference key layout (dns_read_local.f90): per-group sizes
    # PointsUJmin (flow), PointsEJmin, PointsSJmin (scalars) and
    # Parameters<tag> -> ParametersU/ParametersS fallback (strength,
    # sigma) (boundary_buffer.f90:91-121); we drive all groups from the
    # flow (U) values with the legacy un-suffixed keys as first choice
    bpar = ini.get_floats(
        "BufferZone", "ParametersJmin",
        ini.get_floats("BufferZone", "Parameters",
                       ini.get_floats("BufferZone", "ParametersU",
                                      (1.0, 2.0))))

    def _bufpts(tag):
        return ini.get_int("BufferZone", f"Points{tag}",
                           ini.get_int("BufferZone", f"PointsU{tag}", 0))
    buffer_spec = BufferSpec(
        type=ini.get("BufferZone", "Type", "none").lower(),
        points_jmin=_bufpts("Jmin"),
        points_jmax=_bufpts("Jmax"),
        points_imin=_bufpts("Imin"),
        points_imax=_bufpts("Imax"),
        strength=bpar[0] if bpar else 1.0,
        sigma=bpar[1] if len(bpar) > 1 else 2.0)

    datype = ini.get("Dealiasing", "Type", "none").lower()
    dealias_spec = FilterSpec(
        type=datype,
        parameters=ini.get_floats("Dealiasing", "Parameters", (0.49,)) or (0.49,),
        active=(ini.get_bool("Dealiasing", "ActiveX", True),
                ini.get_bool("Dealiasing", "ActiveY", True),
                ini.get_bool("Dealiasing", "ActiveZ", True)),
        bcs_j=(ini.get("Dealiasing", "BcsJmin", "biased").lower(),
               ini.get("Dealiasing", "BcsJmax", "biased").lower()))

    # [PressureFilter]: filter p and dp/dy after the Poisson solve each
    # substep (rhs_global_incompressible_1.f90:287-291); required to keep
    # the horizontally staggered scheme stable near Nyquist
    pftype = ini.get("PressureFilter", "Type", "none").lower()
    pressure_filter_spec = FilterSpec(
        type=pftype,
        parameters=ini.get_floats("PressureFilter", "Parameters",
                                  (0.49,)) or (0.49,),
        active=(ini.get_bool("PressureFilter", "ActiveX", True),
                ini.get_bool("PressureFilter", "ActiveY", True),
                ini.get_bool("PressureFilter", "ActiveZ", True)),
        bcs_j=(ini.get("PressureFilter", "BcsJmin", "biased").lower(),
               ini.get("PressureFilter", "BcsJmax", "biased").lower()))

    ftype = ini.get("Filter", "Type", "none").lower()
    filter_spec = FilterSpec(
        type=ftype,
        parameters=ini.get_floats("Filter", "Parameters", (0.49,)) or (0.49,),
        active=(ini.get_bool("Filter", "ActiveX", True),
                ini.get_bool("Filter", "ActiveY", True),
                ini.get_bool("Filter", "ActiveZ", True)),
        step=ini.get_int("Filter", "Step",
                         ini.get_int("Iteration", "Filter", 0)),
        bcs_j=(ini.get("Filter", "BcsJmin", "biased").lower(),
               ini.get("Filter", "BcsJmax", "biased").lower()))

    scal_limit = ini.get_bool("Control", "ScalLimit", True)
    control_cfg = {
        "scal_limit": scal_limit,
        "min_scalar": ini.get_floats("Control", "MinScalar",
                                     (0.0,) * n_scal),
        "max_scalar": ini.get_floats("Control", "MaxScalar",
                                     (1.0,) * n_scal),
        "flow_limit": ini.get_bool("Control", "FlowLimit", True),
        # compressible p/rho bounds (dns_read_local.f90:158-161; -1 ->
        # defaults pbg/rbg mean * 1e-/+6, dns_main.f90:211-214)
        "min_pressure": ini.get_float("Control", "MinPressure", -1.0),
        "max_pressure": ini.get_float("Control", "MaxPressure", -1.0),
        "min_density": ini.get_float("Control", "MinDensity", -1.0),
        "max_density": ini.get_float("Control", "MaxDensity", -1.0),
        # incompressible/anelastic dilatation bound (bound_d,
        # dns_read_local.f90:163-173; default unbounded)
        "max_dilatation": ini.get_float("Control", "MaxDilatation", -1.0),
    }

    planes_cfg = {
        "i": tuple(int(v) for v in ini.get_floats("SavePlanes", "PlanesI", ())),
        "j": tuple(int(v) for v in ini.get_floats("SavePlanes", "PlanesJ", ())),
        "k": tuple(int(v) for v in ini.get_floats("SavePlanes", "PlanesK", ())),
        "step": ini.get_int("Iteration", "SavePlanes", -1),
    }
    towers_cfg = {
        "stride": tuple(int(v) for v in
                        ini.get_floats("SaveTowers", "Stride", ())),
        "pressure": ini.get_bool("SaveTowers", "Pressure", False),
    }

    thermo_cfg = {
        "type": ini.get("Thermodynamics", "Type", "none").lower(),
        "transport": ini.get("Thermodynamics", "Transport", "none").lower(),
        "mixture": ini.get("Thermodynamics", "Mixture",
                           ini.get("Main", "Mixture", "none")).lower(),
        "scale_height": ini.get_float("Thermodynamics", "ScaleHeight", 0.0),
        # reference default SmoothFactor=0.1 applies to airwater only
        # (thermodynamics.f90:191-193)
        "smooth": ini.get_float("Thermodynamics", "SmoothFactor", 0.0),
        "parameters": ini.get_floats("Thermodynamics", "Parameters", (1.0,)),
        "chemkin_file": ini.get("Thermodynamics", "ChemkinFile", ""),
        # Nondimensional=no keeps the property tables in SI units
        # (thermodynamics.f90:195-196)
        "nondimensional": ini.get_bool("Thermodynamics", "Nondimensional",
                                       True),
    }

    # [Broadband] (rand_local.f90:52-99): f0 is a list "mean[,fmin,fmax]"
    # (clip window), Sigma defaults to mean/6, Spectrum to quartic
    f0_list = ini.get_floats("Broadband", "f0", (1.0,))
    f0_mean = f0_list[0] if len(f0_list) else 1.0
    bb_sigma = ini.get_float("Broadband", "Sigma", -1.0)
    cov_list = ini.get_floats("Broadband", "Covariance", ())
    bb = {
        "distribution": ini.get("Broadband", "Distribution", "none").lower(),
        "spectrum": ini.get("Broadband", "Spectrum", "quartic").lower(),
        "f0": f0_mean,
        "fclip": (f0_list[1] if len(f0_list) > 1 else 0.0,
                  f0_list[2] if len(f0_list) > 2 else 1e30),
        "sigma": bb_sigma if bb_sigma >= 0.0 else f0_mean / 6.0,
        "seed": ini.get_int("Broadband", "Seed", 7),
        "covariance": (tuple(cov_list) if len(cov_list) == 6
                       else (1.0, 1.0, 1.0, 0.0, 0.0, 0.0)),
    }

    return CaseSetup(
        flow_type=ini.get("Main", "Type", "temporal").lower(),
        calculate_flow=ini.get_bool("Main", "CalculateFlow", True),
        calculate_scalar=ini.get_bool("Main", "CalculateScalar", True),
        equations=ini.get("Main", "Equations", "incompressible").lower(),
        term_advection=ini.get("Main", "TermAdvection", "convective").lower(),
        space_order1=so1,
        space_order2=so2,
        elliptic_order=ini.get("Main", "EllipticOrder", "").lower(),
        time_order=ini.get("Main", "TimeOrder", "RungeKuttaExplicit4"),
        time_step=ini.get_float("Main", "TimeStep", -1.0),
        time_cfl=ini.get_float("Main", "TimeCFL", 1.2),
        time_cfl_diffusive=ini.get_float(
            "Main", "TimeDiffusiveCFL",
            0.25 * ini.get_float("Main", "TimeCFL", 1.2)),
        it_start=ini.get_int("Iteration", "Start", 0),
        it_end=ini.get_int("Iteration", "End", 0),
        it_restart=ini.get_int("Iteration", "Restart", 50),
        it_stats=ini.get_int("Iteration", "Statistics", 50),
        it_log=ini.get_int("Iteration", "IteraLog", 10),
        reynolds=_reynolds_from_ini(ini),
        schmidt=schmidt,
        prandtl=ini.get_float("Parameters", "Prandtl", 1.0),
        mach=ini.get_float("Parameters", "Mach", 0.3),
        # reference key: [Thermodynamics] HeatCapacityRatio
        # (thermodynamics.f90 gama0; overridden by the property tables
        # when a mixture is selected); legacy [Parameters] Gamma kept
        gamma=ini.get_float("Thermodynamics", "HeatCapacityRatio",
                            ini.get_float("Parameters", "Gamma", 1.4)),
        froude=froude,
        rossby=rossby,
        imax=ini.get_int("Grid", "Imax", 1),
        jmax=ini.get_int("Grid", "Jmax", 1),
        kmax=ini.get_int("Grid", "Kmax", 1),
        periodic=(ini.get_bool("Grid", "XPeriodic", True),
                  ini.get_bool("Grid", "YPeriodic", False),
                  ini.get_bool("Grid", "ZPeriodic", True)),
        uniform=(ini.get_bool("Grid", "XUniform", True),
                 ini.get_bool("Grid", "YUniform", True),
                 ini.get_bool("Grid", "ZUniform", True)),
        vel_profiles=vel_profiles,
        scal_profiles=scal_profiles,
        velocity_bc=(ini.get("BoundaryConditions", "VelocityJmin", "freeslip").lower(),
                     ini.get("BoundaryConditions", "VelocityJmax", "freeslip").lower()),
        scalar_bc=scalar_bc,
        surface_bc=surface_bc,
        ini_velocity=ini.get("IniFields", "Velocity", "None").lower(),
        ini_scalar=ini.get("IniFields", "Scalar", "None").lower(),
        force_dilatation=ini.get_bool("IniFields", "ForceDilatation", True),
        normalize_k=ini.get_float("IniFields", "NormalizeK", -1.0),
        # IniK is a pure shape: amplitude forced to 1 and mean to 0
        # (reference flow_local.f90:112-113)
        profile_ini_k=dataclasses.replace(
            _read_profile(ini, "inifields", "IniK", jscale, jstart),
            delta=1.0, mean=0.0),
        # per-scalar perturbation envelope IniS / IniS<i> (default
        # gaussiansurface) + NormalizeS target max plane rms
        # (scal_local.f90:96-127); one NormalizeS value applies to all
        profile_ini_s=tuple(_ini_s_profile(ini, i, jscale, jstart)
                            for i in range(n_scal)),
        normalize_s=_pad_list(
            ini.get_floats("IniFields", "NormalizeS", ()), n_scal),
        broadband=bb,
        grid_segments=segs,
        buoyancy=buoyancy,
        coriolis=coriolis,
        buffer=buffer_spec,
        filter=filter_spec,
        thermo=thermo_cfg,
        control=control_cfg,
        planes=planes_cfg,
        towers=towers_cfg,
        dealias=dealias_spec,
        pressure_filter=pressure_filter_spec,
        ini=ini,
        stagger=ini.get_bool("Staggering", "StaggerHorizontalPressure",
                             False),
        discrete=_read_discrete(ini),
    )


def consistency_check(case: CaseSetup) -> None:
    """Cross-validate INI option combinations before building plans
    (reference TLab_Consistency_Check, tlab_consistency_check.f90 +
    the hard version gate of tlab_initialize_parameters.f90:30-39).
    Raises ValueError with a reference-style message."""
    ini = case.ini
    if ini is not None:
        major = ini.get_int("Version", "Major", 7)
        if major != 7:
            raise ValueError(
                f"[Version] Major={major}: file format version must be 7.")

    if case.flow_type == "temporal" and not case.periodic[0]:
        raise ValueError(
            "Grid must be uniform and periodic in direction X for "
            "temporal simulation (tlab_consistency_check.f90).")

    eqs = case.equations
    adv = case.term_advection
    if getattr(case, "stagger", False):
        if eqs not in ("incompressible", "anelastic"):
            raise ValueError(
                "Horizontal pressure staggering only implemented for "
                "anelastic or incompressible mode.")
        if adv not in ("convective", "skewsymmetric", ""):
            raise ValueError(
                "Horizontal pressure staggering not implemented for "
                "current advection scheme.")
        if "jacobian6" not in case.space_order1.lower():
            raise ValueError(
                "Horizontal pressure staggering only implemented for "
                "compact jacobian 6th-order scheme.")

    ibm_on = ini is not None and \
        ini.get("IBMParameter", "Status", "off").lower() == "on"
    if ibm_on:
        if eqs != "incompressible":
            raise ValueError("IBM only implemented for incompressible "
                             "mode.")
        if adv not in ("convective", "skewsymmetric", ""):
            raise ValueError("IBM not implemented for current advection "
                             "scheme.")

    mixture = (case.thermo or {}).get("mixture", "none")
    if eqs == "anelastic" and mixture not in ("air", "airvapor",
                                              "airwater", "none", ""):
        raise ValueError(
            f"Mixture={mixture}: anelastic mode requires Air/AirVapor/"
            "AirWater (thermodynamics.f90:205-208).")
    from tlab_tpu_torch.physics.mixtures import MIXTURES as _COMB
    if mixture in _COMB or mixture == "chemkin":
        if eqs not in ("compressible", "internal", "total"):
            raise ValueError(
                f"Mixture={mixture}: combustion mixtures require the "
                "compressible solver (thermodynamics.f90:217-430).")
        if mixture == "chemkin" \
                and not (case.thermo or {}).get("chemkin_file"):
            raise ValueError(
                "Mixture=chemkin requires [Thermodynamics] ChemkinFile "
                "(THERMO_READ_CHEMKIN input).")
        nsp = len(_COMB.get(mixture, ()))
        if nsp and len(case.schmidt) != nsp - 1:
            raise ValueError(
                f"Mixture={mixture} transports {nsp - 1} species mass "
                f"fractions, [Parameters] Schmidt gives "
                f"{len(case.schmidt)}.")

    rad_type = ini.get("Infrared", "Type",
                       ini.get("Radiation", "Type", "none")).lower() \
        if ini is not None else "none"
    if rad_type not in ("none", "") and eqs == "anelastic" \
            and mixture not in ("airwater", "airwaterlinear", "none", ""):
        raise ValueError(
            "Infrared radiation only derived for airwater mixtures "
            "(radiation.f90:171-180).")
