"""Large-scale and special forcing terms (reference
src/physics/largescaleforcing.f90, specialforcing.f90), port of
tlab_tpu/physics/forcing.py.

- Subsidence (ConstantDivergenceLocal): w_LS(y) = D*y; the scalar/momentum
  source is w_LS * d a/dy (reference LargeScaleForcing_Subsidence:79-120).
- Homogeneous forcing: a constant body force.
- Sinusoidal wavemaker (special forcing): time-harmonic body force localized
  by a Gaussian envelope, for internal-wave generation studies; it reads
  the step's time (aux["rtime"]).

The wavemaker's tables are host NumPy (copied from tlab_tpu); the sources
take torch tensors.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tlab_tpu_torch.dycore import incompressible as dyn


@dataclasses.dataclass(frozen=True)
class SubsidenceProps:
    type: str = "none"        # none | constantdivergencelocal
    divergence: float = 0.0   # D (1/time)


def subsidence_source(props: SubsidenceProps, P, y, a):
    """w_LS * da/dy with w_LS = D*y, added to a's tendency.  y: the (ny,)
    node tensor on a's device."""
    w_ls = (props.divergence * y)[None, :, None]
    return w_ls * dyn._d1(P, "y", 1, a)


@dataclasses.dataclass(frozen=True)
class WavemakerProps:
    """Reference [SpecialForcing] Type=WaveMaker (specialforcing.f90:
    105-169,216-223): up to 3 plane waves, each Wave#=(amplitude,
    wavenumber, angle_deg, frequency); force amplitudes perpendicular to
    the wavevector (amp_x = a sin, amp_y = -a cos); Gaussian envelope
    (x0, y0, z0, size); relaxation toward the wave velocity field with
    coefficient Parameters(1)."""
    coeff: float = 1.0
    # per-wave tuples
    amp_x: tuple = ()
    amp_y: tuple = ()
    kx: tuple = ()
    ky: tuple = ()
    freq: tuple = ()
    envelope: tuple = (0.0, 0.0, 0.0, 1.0)


def homogeneous_from_ini(ini):
    """[SpecialForcing] Type=Homogeneous: constant body force
    Parameters(1) on the components with nonzero Vector entries
    (specialforcing.f90:103,215-216; tlab_sources.f90:114-123). Returns
    (fx, fy, fz) or None."""
    if ini.get("SpecialForcing", "Type", "none").lower() != "homogeneous":
        return None
    pars = ini.get_floats("SpecialForcing", "Parameters", (1.0,))
    vec = ini.get_floats("SpecialForcing", "Vector", (1.0, 0.0, 0.0))
    vec = tuple(vec) + (0.0,) * (3 - len(vec))
    return tuple(pars[0] if abs(v) > 0 else 0.0 for v in vec[:3])


def wavemaker_from_ini(ini):
    """Parse [SpecialForcing] -> (WavemakerProps | None)."""
    t = ini.get("SpecialForcing", "Type", "none").lower()
    if t != "wavemaker":
        return None
    pars = ini.get_floats("SpecialForcing", "Parameters", (1.0, 1.0, 0.0))
    ax, ay, kxs, kys, fr = [], [], [], [], []
    for iw in (1, 2, 3):
        row = ini.get_floats("SpecialForcing", f"Wave{iw}", ())
        if not row:
            break
        a, k, ang, om = row[0], row[1], np.deg2rad(row[2]), row[3]
        kxs.append(k * np.cos(ang))
        kys.append(k * np.sin(ang))
        ax.append(a * np.sin(ang))
        ay.append(-a * np.cos(ang))
        fr.append(om)
    env = tuple(ini.get_floats("SpecialForcing", "Envelope",
                               (1.0, 1.0, 1.0, 1.0)))
    env = env + (1.0,) * (4 - len(env))
    env = env[:3] + (abs(env[3]),)
    return WavemakerProps(coeff=pars[0], amp_x=tuple(ax), amp_y=tuple(ay),
                          kx=tuple(kxs), ky=tuple(kys), freq=tuple(fr),
                          envelope=env)


def wavemaker_fields(props: WavemakerProps, grid):
    """Precompute the (nx, ny, nz) Gaussian envelope and the per-wave
    (nx, ny) phase fields (specialforcing.f90:150-168)."""
    x0, y0, z0, size = props.envelope
    x = np.asarray(grid.x.nodes) - x0
    y = np.asarray(grid.y.nodes) - y0
    z = (np.asarray(grid.z.nodes) if grid.z.size > 1
         else np.zeros(1)) - z0
    r2 = (x[:, None, None] ** 2 + y[None, :, None] ** 2
          + z[None, None, :] ** 2)
    env = np.exp(-0.5 * r2 / size ** 2)
    phases = np.stack([x[:, None] * kx + y[None, :] * ky
                       for kx, ky in zip(props.kx, props.ky)])
    return env, phases


def localize_wavemaker(env, phases, comm):
    """The (nx, ny, nz) envelope and (nw, nx, ny) phase tables of this
    rank's block on the pencil mesh (comm, the plan's mesh descriptor);
    the whole tables without one."""
    if comm is None:
        return env, phases
    mesh = comm["mesh"]
    px, pz, ix, iz = mesh.px, mesh.pz, mesh.ix, mesh.iz
    if px == 1 and pz == 1:
        return env, phases
    nx, _, nz = env.shape
    nxl = nx // px
    env = env[ix * nxl:(ix + 1) * nxl]
    if nz > 1 and pz > 1:
        nzl = nz // pz
        env = env[:, :, iz * nzl:(iz + 1) * nzl]
    return env, phases[:, ix * nxl:(ix + 1) * nxl]


def wavemaker_source(props: WavemakerProps, env, phases, iq, q, t):
    """(target_wave - q) * envelope * coeff for momentum component iq
    (0=u, 1=v), the reference relaxation form
    (specialforcing.f90:216-223).  env, phases: tensors on q's device; t:
    the step's time."""
    amps = props.amp_x if iq == 0 else props.amp_y
    tgt = torch.zeros_like(q)
    for w, a in enumerate(amps):
        tgt = tgt + a * torch.sin(phases[w][:, :, None] - props.freq[w] * t)
    return (tgt - q) * env * props.coeff
