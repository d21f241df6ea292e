"""Initial-condition generation: inigrid/inirand/iniflow/iniscal equivalents
(port of tlab_tpu/tools/initialize.py, incompressible part).

Functionally mirrors the reference preprocessing tools
(src/tools/initialize/{grid,rand,flow,scal}): random fields shaped to a
target isotropic PSD, velocity construction from broadband vorticity via
Poisson solves, solenoidal projection, TKE normalization, mean profiles.
The random fields reproduce the reference's realization EXACTLY: the same
Numerical Recipes ran0/rang stream (utils/nrrandom.py), consumed in the
same order as inirand (rand_main.f90: inb_flow fields then inb_scal
fields), with the same spectral shaping (OPR_Fourier_SetPSD,
opr_fourier.f90:660-746) and normalization (RAND_NORMALIZE).

The random fields and their spectral shaping are NumPy on the host in
float64; the curl, the Poisson solves, the solenoidal projection and the
TKE normalisation run as torch on sim.device in sim.dtype; [IniFields]
NormalizeR adds the radiation increment to the active scalar.  The
compressible state (compressible_initial_state) adds the density and
pressure profiles and the NormalizeP pressure fluctuation, the temperature
of a combustion mixture, or, for the AirWater mixture, the hydrostatic
column and the pointwise (p, h) inversion (_airwater_compressible_state).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tlab_tpu_torch.config import _read_profile
from tlab_tpu_torch.constants import BC
from tlab_tpu_torch.dycore import incompressible as dyn
from tlab_tpu_torch.dycore.compressible import (CompState, from_primitive,
                                                from_primitive_airwater)
from tlab_tpu_torch.dycore.state import State
from tlab_tpu_torch.physics import mixtures as mx
from tlab_tpu_torch.physics import thermo as th
from tlab_tpu_torch.runtime import Simulation
from tlab_tpu_torch.utils import trace as _trace
from tlab_tpu_torch.utils.nrrandom import NRStream


def _tensor(sim: Simulation, a):
    """Host array -> tensor on sim.device in sim.dtype."""
    return torch.as_tensor(np.asarray(a, np.float64)).to(sim.device,
                                                          sim.dtype)


# ---------------------------------------------------------------------------
# inirand: spectrally shaped random fields
# ---------------------------------------------------------------------------

def _spectral_shape(kind: str, f, f0: float, sigma: float):
    """Target 1-D spectrum E(f) (reference distributions.f90:38-50)."""
    if kind == "uniform":
        return np.ones_like(f)
    if kind == "quartic":
        return f ** 4 * np.exp(-2.0 * (f / f0) ** 2)
    if kind == "quadratic":
        return f ** 2 * np.exp(-2.0 * f / f0)
    if kind == "gaussian":
        return np.exp(-0.5 * ((f - f0) / sigma) ** 2) / (sigma * np.sqrt(2 * np.pi))
    raise ValueError(kind)


def _psd_amplitude(sim: Simulation) -> np.ndarray:
    """Target |u_hat| over the (nx//2+1, ny, nz) r2c modes.

    Distributions_Compute with the f0-list clip window, then the
    isotropic-shell geometric factor 1/(pi f) in 2-D or 1/(2 pi f^2) in
    3-D, then sqrt (reference OPR_Fourier_SetPSD, opr_fourier.f90:687-722).
    Frequencies are integer wavenumbers over the domain scale."""
    nx, ny, nz = sim.grid.shape
    bb = sim.case.broadband
    fi = (np.arange(nx // 2 + 1) / sim.grid.x.scale)[:, None, None]
    fj = (np.fft.fftfreq(ny, d=1.0) * ny / sim.grid.y.scale)[None, :, None] \
        if ny > 1 else np.zeros((1, 1, 1))
    fk = (np.fft.fftfreq(nz, d=1.0) * nz / sim.grid.z.scale)[None, None, :] \
        if nz > 1 else np.zeros((1, 1, 1))
    f = np.sqrt(fi ** 2 + fj ** 2 + fk ** 2)
    pow_dst = _spectral_shape(bb["spectrum"], f, bb["f0"], bb["sigma"])
    lo, hi = bb.get("fclip", (0.0, 1e30))
    pow_dst = np.where((f - lo) * (hi - f) < 0.0, 0.0, pow_dst)
    two_d = (ny == 1) or (nz == 1)
    with np.errstate(divide="ignore", invalid="ignore"):
        pow_dst = np.where(f == 0.0, 0.0,
                           pow_dst / (np.pi * f) if two_d
                           else pow_dst / (2 * np.pi * f ** 2))
    return np.sqrt(np.maximum(pow_dst, 0.0))


def _rand_normalize(variance: float, a: np.ndarray) -> np.ndarray:
    """RAND_NORMALIZE (rand_local.f90:224-244): remove the 3-D mean, then
    rescale the second raw moment to `variance`."""
    a = a - a.mean()
    msq = (a * a).mean()
    if msq > 0.0:
        a = a * np.sqrt(variance / msq)
    return a


def _rand_field(rng: NRStream, variance: float, sim: Simulation) -> np.ndarray:
    """One RAND_FIELD call (rand_local.f90:116-163), reference-exact.

    Distribution=uniform/gaussian fills the field from the ran0/rang
    stream in Fortran storage order (x fastest) and rescales spectral
    amplitudes to the target PSD keeping phases; Distribution=none draws
    isize_txc_field = (nx+2)*ny*nz uniform values and uses the first
    (nx//2+1)*ny*nz as random phases under the PSD amplitude, with zero
    phase on the kx=0 and Nyquist planes."""
    nx, ny, nz = sim.grid.shape
    bb = sim.case.broadband
    n = nx * ny * nz
    pdf = bb["distribution"]
    if pdf == "uniform":
        vals = rng.uniform(n) - 0.5
    elif pdf == "gaussian":
        vals = rng.gaussian(n)
    else:
        vals = np.zeros(n)
    a = vals.reshape(nz, ny, nx).transpose(2, 1, 0)   # Fortran (i,j,k)

    if bb["spectrum"] != "none":
        amp = _psd_amplitude(sim)
        if pdf != "none":
            uh = np.fft.rfft(a, axis=0)
            if nz > 1:
                uh = np.fft.fft(uh, axis=2)
            if ny > 1:
                uh = np.fft.fft(uh, axis=1)
            mag = np.abs(uh)
            uh = np.where(mag > 0.0,
                          uh * (amp / np.where(mag > 0.0, mag, 1.0)), 0.0)
        else:
            # random phases: the loop fills the PADDED txc array
            # (tlab_memory.f90:184-187) so the stream advances by
            # (nx+2)*ny*nz even though only the r2c block is used
            ph = rng.uniform((nx + 2) * ny * nz)[: (nx // 2 + 1) * ny * nz]
            loc = ph.reshape(nz, ny, nx // 2 + 1).transpose(2, 1, 0)
            phase = (loc - 0.5) * 2.0 * np.pi
            phase[0] = 0.0
            if nx % 2 == 0:
                phase[nx // 2] = 0.0
            uh = amp * (np.cos(phase) + 1j * np.sin(phase))
        if ny > 1:
            uh = np.fft.ifft(uh, axis=1)
        if nz > 1:
            uh = np.fft.ifft(uh, axis=2)
        a = np.fft.irfft(uh, n=nx, axis=0)
    return _rand_normalize(variance, a)


def _rand_covariance(cov, flow, sim: Simulation):
    """RAND_COVARIANCE (rand_local.f90:168-222): renormalize per-component
    variances; off-diagonal Rxy via the 2-D eigenframe rotation."""
    nx, ny, nz = sim.grid.shape
    Rxx, Ryy, Rzz, Rxy, Rxz, Ryz = cov[:6]
    if nz > 1:
        if Rxz != 0.0 or Ryz != 0.0:
            raise NotImplementedError("Rxz/Ryz covariance (reference "
                                      "rand_local.f90:186 undeveloped)")
        flow[2] = _rand_normalize(Rzz, flow[2])
    if Rxy == 0.0:
        flow[0] = _rand_normalize(Rxx, flow[0])
        flow[1] = _rand_normalize(Ryy, flow[1])
    else:
        trace = Rxx + Ryy
        lam1 = 0.5 * (trace + np.sqrt(trace * trace
                                      - 4.0 * (Rxx * Ryy - Rxy * Rxy)))
        lam2 = trace - lam1
        u = _rand_normalize(lam1, flow[0])
        v = _rand_normalize(lam2, flow[1])
        alpha = np.arctan((lam1 - Rxx) / Rxy)
        ca, sa = np.cos(alpha), np.sin(alpha)
        flow[0] = ca * u - sa * v
        flow[1] = sa * u + ca * v
    return flow


def inirand_fields(sim: Simulation, seed: int | None = None):
    """The full inirand program (rand_main.f90:69-88): inb_flow velocity
    fields then inb_scal scalar fields from ONE continuous ran0 stream,
    seeded -abs([Broadband] Seed) (rand_local.f90:53-55).

    Returns (flow_fields, scal_fields) as float64 (nx,ny,nz) arrays --
    the in-memory equivalent of the flow.rand / scal.rand files."""
    bb = sim.case.broadband
    if seed is None:
        seed = bb["seed"]
    rng = NRStream(-abs(int(seed)))
    ucov = list(bb.get("covariance", (1.0, 1.0, 1.0, 0.0, 0.0, 0.0)))
    flow = [_rand_field(rng, ucov[iq], sim) for iq in range(3)]
    if bb["distribution"] == "gaussian":
        _rand_covariance(ucov, flow, sim)
    ns = sim.nsp.n_scalars
    scal = [_rand_field(rng, ucov[i_s] if i_s < 6 else 1.0, sim)
            for i_s in range(ns)]
    return flow, scal


# ---------------------------------------------------------------------------
# iniflow
# ---------------------------------------------------------------------------

def _flow_shape(sim: Simulation):
    """Envelope profiles (f, -f') along y (reference FLOW_SHAPE,
    flow_local.f90:351-400).  For GaussianSurface the envelope is
    multiplied by tanh((y-yw)/2 thick)^2 at each NO-SLIP wall (with the
    product-rule correction on the wall-parallel profile) so both
    velocity components vanish smoothly there; ParabolicSurface squares
    the envelope for the same reason."""
    y = sim.grid.y.nodes
    prof = sim.case.profile_ini_k
    f = prof(y)
    mdf = -(sim.fdm.y.d1[BC.DD] @ f)        # profs(:,2): minus derivative
    noslip_jmin = sim.case.velocity_bc[0] != "freeslip"
    noslip_jmax = sim.case.velocity_bc[1] != "freeslip"
    if prof.type == "parabolicsurface":
        mdf = 2.0 * mdf * f
        f = f ** 2
    elif prof.type == "gaussiansurface":
        if noslip_jmin:
            yr = 0.5 * (y - y[0]) / prof.thick
            th, ch = np.tanh(yr), np.cosh(yr)
            mdf = mdf * th ** 2 - f * th / ch ** 2 / prof.thick
            f = f * th ** 2
        if noslip_jmax:
            yr = 0.5 * (y[-1] - y) / prof.thick
            th, ch = np.tanh(yr), np.cosh(yr)
            mdf = mdf * th ** 2 + f * th / ch ** 2 / prof.thick
            f = f * th ** 2
    return f, mdf


def _normalize_tke(sim: Simulation, u, v, w):
    """Scale so that the largest plane-mean TKE is [IniFields] NormalizeK
    (no scaling when it is negative)."""
    if sim.case.normalize_k < 0.0:
        return u, v, w
    tke_prof = 0.5 * (torch.mean(u ** 2, dim=(0, 2))
                      + torch.mean(v ** 2, dim=(0, 2))
                      + torch.mean(w ** 2, dim=(0, 2)))
    amp = torch.sqrt(sim.case.normalize_k / torch.max(tke_prof))
    return u * amp, v * amp, w * amp


def velocity_broadband_vorticity(sim: Simulation, flow_rand):
    """Velocity from broadband vorticity: lap(u) = -curl(omega)
    (reference VELOCITY_BROADBAND, flow_local.f90:302-340)."""
    nx, ny, nz = sim.grid.shape
    u, v, w = (np.array(flow_rand[0]), np.array(flow_rand[1]),
               np.array(flow_rand[2]))

    # remove horizontal mean per level
    for a in (u, v, w):
        a -= a.mean(axis=(0, 2), keepdims=True)

    fshape, dfshape = _flow_shape(sim)
    uj, vj, wj = _tensor(sim, u), _tensor(sim, v), _tensor(sim, w)
    ox, oy, oz = sim.curl(uj, vj, wj)
    env_t = _tensor(sim, dfshape)[None, :, None]
    env_n = _tensor(sim, fshape)[None, :, None]
    ox = -ox * env_t
    oy = -oy * env_n
    oz = -oz * env_t
    rx, ry, rz = sim.curl(ox, oy, oz)

    # free-slip walls -> NN for tangential, DD for normal component;
    # solved with the reference's OPR_Poisson (factorize by default)
    wall = BC.NN if sim.case.velocity_bc[0] == "freeslip" else BC.DD
    uj = sim.poisson_ref(wall, rx)
    vj = sim.poisson_ref(BC.DD, ry)
    wj = sim.poisson_ref(wall, rz) if nz > 1 else torch.zeros_like(uj)

    if sim.case.force_dilatation:
        uj, vj, wj = sim.solenoidal(uj, vj, wj)
    if nz == 1:
        wj = torch.zeros_like(uj)
    return _normalize_tke(sim, uj, vj, wj)


def velocity_potential_broadband(sim: Simulation, flow_rand):
    """Velocity from a random vector potential: u = curl(A) with A the
    PSD-shaped random fields times the IniK envelope (reference
    PERT_BROADBAND_POTENTIAL, flow_local.f90:279-300) -- solenoidal by
    construction."""
    nx, ny, nz = sim.grid.shape
    # the reference always reads all THREE random potential components
    # (flow_local.f90:256-258); in 2-D (kmax=1) A_z is the stream
    # function and the ONLY one that contributes: u = dA_z/dy,
    # v = -dA_z/dx
    ax, ay, az = (np.array(flow_rand[0]), np.array(flow_rand[1]),
                  np.array(flow_rand[2]))
    for a in (ax, ay, az):
        a -= a.mean(axis=(0, 2), keepdims=True)
    fshape, dfshape = _flow_shape(sim)
    env_n = _tensor(sim, fshape)[None, :, None]
    env_t = _tensor(sim, dfshape)[None, :, None]
    uj, vj, wj = sim.curl(_tensor(sim, ax) * env_n, _tensor(sim, ay) * env_t,
                          _tensor(sim, az) * env_n)
    if nz == 1:
        wj = torch.zeros_like(uj)
    # reference imposes zero tangential velocity at no-slip walls via the
    # derivative BC rows (flow_local.f90:287-292)
    for side, row in ((0, 0), (1, -1)):
        if sim.case.velocity_bc[side] != "freeslip":
            uj[:, row, :] = 0.0
            wj[:, row, :] = 0.0
    return _normalize_tke(sim, uj, vj, wj)


def velocity_discrete(sim: Simulation):
    """Discrete-mode velocity perturbation (reference VELOCITY_DISCRETE,
    flow_local.f90:177-238): wall-normal v = sum_m A_m cos(wx x+px)
    cos(wz z+pz) g(y), wall-parallel components from -g' with the 1/w
    factors imposing the solenoidal constraint."""
    nx, ny, nz = sim.grid.shape
    spec = getattr(sim.case, "discrete", None) or {}
    amps = spec.get("amplitude", (1e-2,))
    n_m = len(amps)

    def pad(key, default):
        vals = tuple(spec.get(key) or ())
        if len(vals) < n_m:
            vals = vals + tuple(default(i) for i in range(len(vals), n_m))
        return vals
    modex = pad("modex", lambda i: i + 1)
    modez = pad("modez", lambda i: 0)
    phasex = pad("phasex", lambda i: 0.0)
    phasez = pad("phasez", lambda i: 0.0)
    x = sim.grid.x.nodes[:, None]
    zc = sim.grid.z.nodes[None, :]
    wx1 = 2.0 * np.pi / sim.grid.x.scale
    wz1 = 2.0 * np.pi / sim.grid.z.scale if nz > 1 else 0.0
    fshape, dfshape = _flow_shape(sim)
    pv = np.zeros((nx, nz))
    pu = np.zeros((nx, nz))
    pw = np.zeros((nx, nz))
    for A, mx, mz, px_, pz_ in zip(amps, modex, modez, phasex, phasez):
        wx = mx * wx1
        wz = mz * wz1
        if mx == 0 and mz == 0:
            break
        elif mz == 0:
            fx, fz = 1.0 / wx, 0.0
        elif mx == 0:
            fx, fz = 0.0, 1.0 / wz
        else:
            fx, fz = 0.5 / wx, 0.5 / wz
        cx = np.cos(wx * x + px_)
        sx = np.sin(wx * x + px_)
        cz = np.cos(wz * zc + pz_)
        sz = np.sin(wz * zc + pz_)
        pv += A * cx * cz
        pu += A * sx * cz * fx
        pw += A * cx * sz * fz
    u = _tensor(sim, pu[:, None, :] * dfshape[None, :, None])
    v = _tensor(sim, pv[:, None, :] * fshape[None, :, None])
    w = _tensor(sim, pw[:, None, :] * dfshape[None, :, None])
    return u, v, w


def initial_state(sim: Simulation, seed: int | None = None) -> State:
    """Full IC: mean profiles + perturbations per [IniFields].

    `seed` overrides [Broadband] Seed (default: the ini value, as the
    reference's inirand reads it)."""
    nx, ny, nz = sim.grid.shape
    y = sim.grid.y.nodes
    ini = getattr(sim.case, "ini", None)

    needs_rand = (sim.case.ini_velocity in
                  ("vorticitybroadband", "velocitybroadband",
                   "potentialbroadband")
                  or "broadband" in sim.case.ini_scalar)
    with _trace.trace("inirand_fields"):        # host work, NumPy
        flow_rand, scal_rand = (inirand_fields(sim, seed=seed) if needs_rand
                                else ([], []))

    if sim.case.ini_velocity in ("vorticitybroadband", "velocitybroadband"):
        u, v, w = velocity_broadband_vorticity(sim, flow_rand)
    elif sim.case.ini_velocity == "velocitydiscrete":
        u, v, w = velocity_discrete(sim)
    elif sim.case.ini_velocity == "potentialbroadband":
        u, v, w = velocity_potential_broadband(sim, flow_rand)
    else:
        u = v = w = torch.zeros((nx, ny, nz), dtype=sim.dtype,
                                device=sim.device)

    # mean profiles
    pu, pv, pw = sim.case.vel_profiles
    u = u + _tensor(sim, pu(y))[None, :, None]
    v = v + _tensor(sim, pv(y))[None, :, None]
    w = w + _tensor(sim, pw(y))[None, :, None]

    scals = []
    for i, prof in enumerate(sim.case.scal_profiles):
        base = _tensor(sim, prof(y))[None, :, None].expand(nx, ny, nz)
        mode = sim.case.ini_scalar
        norm_s = (sim.case.normalize_s[i]
                  if i < len(sim.case.normalize_s) else 0.0)

        def _scal_shape():
            """SCAL_SHAPE (scal_local.f90:146-177): the IniS envelope
            with tanh^2 boundary damping for gaussiansurface."""
            profs = sim.case.profile_ini_s
            ps = profs[i] if i < len(profs) else None
            if ps is None:
                return sim.case.profile_ini_k(y)
            env_ = ps(y)
            if ps.type == "gaussiansurface":
                th = max(ps.thick, 1e-30)
                env_ = env_ * np.tanh(0.5 * (y - y[0]) / th) ** 2 \
                    * np.tanh(-0.5 * (y - y[-1]) / th) ** 2
            return env_

        def _normalized(fld):
            """SCAL_NORMALIZE: scale so max-over-y plane rms = norm_s."""
            ms = torch.max(torch.mean(fld ** 2, dim=(0, 2)))
            return fld * (norm_s / torch.sqrt(torch.clamp(ms, min=1e-300)))

        if mode in ("layerbroadband", "planebroadband"):
            # broadband scalar perturbation shaped by the IniS envelope
            # (reference iniscal LayerBroadband); NormalizeS rescales to
            # the target max plane rms -- legacy INIs without NormalizeS
            # keep the NormalizeK amplitude scaling
            pert = np.array(scal_rand[i]) if i < len(scal_rand) \
                else np.zeros((nx, ny, nz))
            pert -= pert.mean(axis=(0, 2), keepdims=True)
            env = _scal_shape()[None, :, None] if norm_s > 0 \
                else sim.case.profile_ini_k(y)[None, :, None]
            fld = _tensor(sim, env * pert)
            if norm_s > 0:
                fld = _normalized(fld)
            else:
                amp = sim.case.normalize_k if sim.case.normalize_k > 0 \
                    else 1e-2
                fld = amp * fld
            base = base + fld
        elif mode == "layerdiscrete":
            # discrete (x,z) modes times the IniS layer envelope
            # (SCAL_FLUCTUATION_VOLUME PERT_LAYER_DISCRETE,
            # scal_local.f90:212-231)
            spec = sim.case.discrete or {}
            xg = sim.grid.x.nodes[:, None]
            zg = (sim.grid.z.nodes[None, :] if nz > 1
                  else np.zeros((1, 1)))
            wx1 = 2.0 * np.pi / sim.grid.x.scale
            wz1 = 2.0 * np.pi / sim.grid.z.scale if nz > 1 else 0.0
            pat = np.zeros((nx, nz))
            for im, amp_m in enumerate(spec.get("amplitude", ())):
                wx = spec["modex"][im] * wx1
                wz = spec["modez"][im] * wz1 if nz > 1 else 0.0
                pat = pat + amp_m * np.cos(wx * xg + spec["phasex"][im]) \
                    * np.cos(wz * zg + spec["phasez"][im])
            fld = _tensor(sim, pat[:, None, :]
                          * _scal_shape()[None, :, None])
            if norm_s > 0:
                fld = _normalized(fld)
            base = base + fld
        elif mode in ("deltadiscrete", "planediscrete", "fluxdiscrete"):
            # discrete-mode displacement field disp(x, z) (reference
            # SCAL_FLUCTUATION_PLANE, scal_local.f90:275-345):
            # deltadiscrete perturbs the profile THICKNESS, fluxdiscrete
            # the MAGNITUDE at constant derivative, planediscrete
            # shifts the layer position -- both deterministic, so Case10-
            # family runs have no RNG dependence
            spec = sim.case.discrete or {}
            xg = sim.grid.x.nodes[:, None]
            zg = (sim.grid.z.nodes[None, :] if nz > 1
                  else np.zeros((1, 1)))
            wx1 = 2.0 * np.pi / sim.grid.x.scale
            wz1 = 2.0 * np.pi / sim.grid.z.scale if nz > 1 else 0.0
            disp = np.zeros((nx, nz))
            amps = spec.get("amplitude", ())
            for im, amp_m in enumerate(amps):
                wx = spec["modex"][im] * wx1 if im < len(spec["modex"]) \
                    else (im + 1) * wx1
                wz = spec["modez"][im] * wz1 if im < len(spec["modez"]) \
                    else 0.0
                phx = spec["phasex"][im]
                phz = spec["phasez"][im]
                disp = disp + amp_m * np.cos(wx * xg + phx) \
                    * np.cos(wz * zg + phz)
            field = np.empty((nx, ny, nz))
            for ii in range(nx):
                for kk in range(nz):
                    if mode == "deltadiscrete":
                        p = dataclasses.replace(
                            prof, thick=prof.thick + disp[ii, kk])
                    elif mode == "fluxdiscrete":
                        # perturb the magnitude at constant derivative
                        # (scal_local.f90:346-360): delta += disp,
                        # mean = delta/2, thick scaled with delta
                        d_loc = prof.delta + disp[ii, kk]
                        t_loc = (d_loc / prof.delta * prof.thick
                                 if prof.delta > 0 else prof.thick)
                        p = dataclasses.replace(prof, delta=d_loc,
                                                mean=0.5 * d_loc,
                                                thick=t_loc)
                    else:
                        p = None
                    field[ii, :, kk] = p(y) if p is not None \
                        else prof(y - disp[ii, kk])
            base = _tensor(sim, field)
        scals.append(base)
    s = torch.stack(scals) if scals else torch.zeros(
        (0, nx, ny, nz), dtype=sim.dtype, device=sim.device)

    # [IniFields] NormalizeR: accumulated-radiation initial increment on
    # the radiatively active scalar (reference iniscal,
    # scal_main.f90:120-131): the IR source with fluxes rescaled so
    # flux_top -> NormalizeR is ADDED to the scalar IC
    bf = sim.P.get("bodyforce")
    norm_r = ini.get_float("IniFields", "NormalizeR", 0.0) \
        if ini is not None else 0.0
    rad = getattr(bf, "rad_props", None) if bf is not None else None
    if norm_r != 0.0 and rad is not None and s.shape[0]:
        scale = norm_r / rad.flux_top if rad.flux_top else 0.0
        rad2 = dataclasses.replace(rad, flux_top=rad.flux_top * scale,
                                   flux_bottom=rad.flux_bottom * scale)
        s[rad.scalar] += bf.ir_field(State(u=u, v=v, w=w, s=s), rad=rad2)
    return State(u=u, v=v, w=w, s=s)


def _discrete_displacement(sim: Simulation):
    """disp(x, z) of the [Discrete] modes (flow_local.f90:522-540)."""
    nx, _, nz = sim.grid.shape
    spec = sim.case.discrete or {}
    xg = sim.grid.x.nodes[:, None]
    zg = sim.grid.z.nodes[None, :] if nz > 1 else np.zeros((1, 1))
    wx1 = 2.0 * np.pi / sim.grid.x.scale
    wz1 = 2.0 * np.pi / sim.grid.z.scale if nz > 1 else 0.0
    disp = np.zeros((nx, nz))
    for im, amp_m in enumerate(spec.get("amplitude", ())):
        wx = spec["modex"][im] * wx1
        wz = spec["modez"][im] * wz1 if nz > 1 else 0.0
        disp = disp + amp_m * np.cos(wx * xg + spec["phasex"][im]) \
            * np.cos(wz * zg + spec["phasez"][im])
    return disp


def _airwater_compressible_state(sim: Simulation, st: State) -> CompState:
    """Compressible AirWater ICs (reference iniflow, flow_main.f90:106-119
    with Mixture=AirWater + gravity):

    1. PRESSURE_MEAN: hydrostatic p(y), T(y), ql(y) from the [Flow]
       Enthalpy profile + mean qt via Gravity_Hydrostatic_Enthalpy's
       compressible branch (THERMO_AIRWATER_PH_RE iteration).
    2. DENSITY_MEAN: rho = p/(R(q) T) (THERMO_THERMAL_DENSITY).
    3. DENSITY_FLUCTUATION ([IniFields] Temperature=PlaneDiscrete): the
       enthalpy profile displaced per (x,z) by the [Discrete] modes
       (ymean += disp, delta += (uslope-lslope) disp Ly, mean +=
       0.5 (uslope+lslope) disp Ly, flow_local.f90:522-540), re-solving
       PH_RE pointwise with the (already perturbed) scalar field: one
       vectorised float64 pass over every point on sim.device.
    4. e from THERMO_CALORIC_ENERGY; velocities from the standard path.
    """
    aw = sim.comp["aw"]
    ini = sim.case.ini
    nx, ny, nz = sim.grid.shape
    y = sim.grid.y.nodes
    jscale = float(sim.grid.y.scale)
    ystart = float(y[0])
    hbg = _read_profile(ini, "flow", "Enthalpy", jscale, ystart=ystart)
    p_ref = ini.get_float("Flow", "Pressure", 1.0)
    ymean_abs = ini.get("Flow", "YMeanPressure", "")
    rel = ini.get_float("Flow", "YMeanRelativePressure", 0.5)
    y_ref = float(ymean_abs) if ymean_abs else ystart + rel * jscale
    qt_prof = sim.case.scal_profiles[0](y) if sim.case.scal_profiles \
        else np.zeros_like(y)
    g2 = sim.comp["gvec"][1]

    # the host column in float64 with the plan's own D1 (tlab_tpu takes
    # the device copy, in the run's dtype)
    d1y = np.asarray(sim.fdm.y.d1[BC.DD], np.float64) \
        if sim.grid.y.size > 1 else None
    if g2 != 0.0 and hbg.type != "none":
        bg = th.hydrostatic_background_compressible(
            aw, y, hbg(y), qt_prof, p_ref, y_ref, g2, d1y=d1y)
        p_y = bg["p"]
    else:
        p_y = np.full(ny, p_ref)

    def wide(a):                   # host array -> float64 on the device
        return torch.as_tensor(np.asarray(a, np.float64)).to(sim.device)

    p = wide(p_y)[None, :, None].expand(nx, ny, nz)
    qt = st.s[0].to(torch.float64) if st.s.shape[0] \
        else torch.zeros((nx, ny, nz), dtype=torch.float64,
                         device=sim.device)

    # per-point enthalpy with the discrete-mode displacement
    if (ini.get("IniFields", "Temperature", "none").lower()
            == "planediscrete"):
        disp = _discrete_displacement(sim)
    else:
        disp = np.zeros((nx, nz))
    # Profile evaluation is plain NumPy arithmetic, so the displaced
    # parameters broadcast: shape (ncol, 1) fields against y (ny,) give
    # all columns in one vectorized call (the crop families use scalar
    # max() and keep the per-column loop)
    d = disp.reshape(-1)[:, None]               # (nx*nz, 1)
    if hbg.type in ("linearcrop", "mixedlayer"):
        h_cols = np.empty((d.shape[0], ny))
        for i_c in range(d.shape[0]):
            ploc = dataclasses.replace(
                hbg, ymean=hbg.ymean + float(d[i_c, 0]),
                delta=hbg.delta + (hbg.uslope - hbg.lslope)
                * float(d[i_c, 0]) * jscale,
                mean=hbg.mean + 0.5 * (hbg.uslope + hbg.lslope)
                * float(d[i_c, 0]) * jscale)
            h_cols[i_c] = ploc(y)
    else:
        pvec = dataclasses.replace(
            hbg, ymean=hbg.ymean + d,
            delta=hbg.delta + (hbg.uslope - hbg.lslope) * d * jscale,
            mean=hbg.mean + 0.5 * (hbg.uslope + hbg.lslope) * d * jscale)
        h_cols = pvec(y)                        # (nx*nz, ny)
    h_field = wide(h_cols).reshape(nx, nz, ny).permute(0, 2, 1)
    with _trace.trace("airwater pointwise (p, h) inversion"):
        T, ql, _ = th.airwater_ph_re(aw, qt, p, h_field)
        rho = th.thermal_density(aw, qt, ql, p, T)
    dt = sim.dtype
    return from_primitive_airwater(aw, rho.to(dt), st.u, st.v, st.w,
                                   T.to(dt), qt.to(dt), ql.to(dt))


def compressible_initial_state(sim: Simulation,
                               seed: int | None = None) -> CompState:
    """Compressible ICs of the ideal gas (reference iniflow compressible
    branch, flow_main.f90): velocity mean profiles + perturbations as in the
    incompressible path; rho/p from the [Flow] ProfileDensity /
    ProfilePressure mean profiles (p nondimensionalized by rho0 U0^2, so
    a uniform p = 1/(gamma Ma^2) gives T = 1); optional [IniFields]
    NormalizeP adds the pressure fluctuation consistent with the velocity
    field -- lap p' = -d2(rho ui uj)/dxi dxj with p' = 0 at the walls --
    and the isentropic density update rho *= 1 + p'/(gamma p)
    (PRESSURE_FLUCTUATION, flow_local.f90:554-609).  The conservative
    energy matches the set's formulation (sim.comp["energy"]).  A
    combustion mixture takes T from p = rho R(Y) T / (gama0 M^2); the
    AirWater mixture takes _airwater_compressible_state."""
    st = initial_state(sim, seed=seed)
    if sim.comp.get("aw") is not None:
        return _airwater_compressible_state(sim, st)
    gamma, mach = sim.comp["gamma"], sim.comp["mach"]
    nx, ny, nz = sim.grid.shape
    y = sim.grid.y.nodes
    ini = getattr(sim.case, "ini", None)
    rho = torch.ones_like(st.u)
    p = torch.full_like(st.u, 1.0 / (gamma * mach ** 2))
    if ini is not None:
        jscale = float(y[-1] - y[0])
        rprof = _read_profile(ini, "flow", "Density", jscale)
        pprof = _read_profile(ini, "flow", "Pressure", jscale)
        if ini.get("Flow", "Density", ""):
            rho = _tensor(sim, np.broadcast_to(rprof(y)[None, :, None],
                                               (nx, ny, nz)).copy())
        if ini.get("Flow", "Pressure", ""):
            p = _tensor(sim, np.broadcast_to(pprof(y)[None, :, None],
                                             (nx, ny, nz)).copy())
        norm_p = ini.get_float("IniFields", "NormalizeP", -1.0)
        if norm_p >= 0.0:
            P = sim.P
            ru, rv, rw = rho * st.u, rho * st.v, rho * st.w
            tx = dyn._d1(P, "x", 0, ru * st.u) \
                + 2.0 * (dyn._d1(P, "y", 1, ru * st.v)
                         + dyn._d1(P, "z", 2, ru * st.w))
            rhs = dyn._d1(P, "x", 0, tx)
            ty = dyn._d1(P, "y", 1, rv * st.v) \
                + 2.0 * dyn._d1(P, "z", 2, rv * st.w)
            rhs = rhs + dyn._d1(P, "y", 1, ty)
            rhs = rhs + dyn._d1(P, "z", 2, dyn._d1(P, "z", 2, rw * st.w))
            # reference OPR_Poisson ibc=0 = BCS_DD through the factorize
            # solver (flow_local.f90:600-603)
            pprime = sim.poisson_ref(BC.DD, -rhs)
            rho = (norm_p * pprime / p / gamma + 1.0) * rho
            p = p + norm_p * pprime
    s = st.s if st.s.shape[0] else None
    mix = sim.comp.get("mixture")
    if mix is not None and s is not None:
        # multi-species: T from p = rho R(Y) T / (gama0 M^2)
        Y = torch.cat([s, (1.0 - torch.sum(s, dim=0))[None]], dim=0)
        T = mix.gama0 * mach ** 2 * p / (rho * mx.gas_constant(mix, Y))
    else:
        T = gamma * mach ** 2 * p / rho
        mix = None
    return from_primitive(rho, st.u, st.v, st.w, T, gamma, mach, s=s,
                          mix=mix, energy=sim.comp.get("energy", "total"))
