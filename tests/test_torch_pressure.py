"""The diagnostic pressure (tlab_tpu_torch/dycore/pressure.py), the derived
fields (mappings.py) and the offline analysis modes (stats/analysis.py)
against tlab_tpu's, float64 on the CPU, on one seeded state of a small
stratified, rotating shear layer (25x32x17).

Limits: the pressure of every decomposition to 1e-10 of max|p|; every
mapping and every analysis column (modes 3-17) to 1e-10 of its max.  Both
packages take the same products in another order, so they differ by
round-off (~1e-14 read)."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from tlab_tpu import mappings as jmp
from tlab_tpu.config import Ini as JIni, load_case as jload_case
from tlab_tpu.dycore.pressure import pressure_boussinesq as jpressure
from tlab_tpu.dycore.state import State as JState
from tlab_tpu.runtime import Simulation as JSimulation
from tlab_tpu.stats import analysis as janalysis
from tlab_tpu_torch import mappings as tmp
from tlab_tpu_torch.config import Ini, load_case
from tlab_tpu_torch.convert import state_from_numpy
from tlab_tpu_torch.dycore.pressure import pressure_boussinesq as tpressure
from tlab_tpu_torch.runtime import Simulation
from tlab_tpu_torch.stats import analysis as tanalysis

F64 = torch.float64
TOL = 1e-10

torch.set_num_threads(2)

INI = """
[Main]
Type=temporal
Equations=incompressible
SpaceOrder=CompactJacobian6
TimeOrder=RungeKuttaExplicit3
TimeCFL=0.8
[Parameters]
Reynolds=500
Schmidt=1.0
Froude=2.0
Rossby=3.0
[BoundaryConditions]
VelocityJmin=freeslip
VelocityJmax=freeslip
Scalar1Jmin=neumann
Scalar1Jmax=neumann
[Scalar]
ProfileScalar1=Tanh
ThickScalar1=0.1
DeltaScalar1=1.0
MeanScalar1=0.5
[BodyForce]
Type=Linear
Vector=0.0,-1.0,0.0
Parameters=1.0
[Rotation]
Type=explicit
Vector=0.0,1.0,0.25
[IniGridOx]
periodic=yes
segments=1
points_1=26
scales_1=2.0
opts_1=uniform
[IniGridOy]
periodic=no
segments=1
points_1=32
scales_1=1.0
opts_1=uniform
[IniGridOz]
periodic=yes
segments=1
points_1=18
scales_1=1.0
opts_1=uniform
"""


def seeded_fields(shape, y, seed=5):
    """u, v, w, s of a perturbed shear layer, float64 NumPy."""
    rng = np.random.default_rng(seed)
    env = (0.3 + np.sin(np.pi * y))[None, :, None]

    def f(a=0.3):
        return a * env * rng.standard_normal(shape)

    u = np.tanh((y[None, :, None] - 0.5) / 0.2) * np.ones(shape) + f()
    return u, f(), f(), (0.5 + f(0.2))[None]


@pytest.fixture(scope="module")
def pair():
    """(tlab_tpu sim, its State, the port's sim, its State) of one state."""
    jsim = JSimulation.from_case(jload_case(JIni(text=INI)))
    tsim = Simulation.from_case(load_case(Ini(text=INI)), dtype=F64,
                                device="cpu")
    u, v, w, s = seeded_fields(tsim.grid.shape, tsim.grid.y.nodes)
    js = JState(u=jnp.asarray(u), v=jnp.asarray(v), w=jnp.asarray(w),
                s=jnp.asarray(s))
    return jsim, js, tsim, state_from_numpy(u, v, w, s, "cpu", F64)


def _close(got, ref, what, tol=TOL):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape and np.isfinite(got).all(), what
    err = np.max(np.abs(got - ref)) if ref.size else 0.0
    assert err <= tol * max(np.max(np.abs(ref)), 1e-300), (what, err)


@pytest.mark.parametrize("dcmp", ["total", "advdiff", "advection",
                                  "diffusion", "coriolis", "buoyancy",
                                  "resolved"])
def test_pressure_matches_jax(pair, dcmp):
    jsim, js, tsim, ts = pair
    p = tpressure(tsim.P, ts, dcmp)
    assert p.dtype == F64 and float(torch.amax(torch.abs(p))) > 1e-6
    _close(p, jpressure(jsim.P, js, dcmp), dcmp)


@pytest.mark.parametrize("dcmp", ["total", "diffusion"])
def test_pressure_solves_the_poisson_problem(pair, dcmp):
    """The discrete problem the direct eigen plan inverts holds for the
    diagnostic pressure: (M0 - lambda M1) p_hat = R f_hat in every
    horizontal mode to 1e-10 of |R f_hat| (round-off; a wrong sign or
    boundary value reads O(1))."""
    from tlab_tpu_torch.dycore.pressure import pressure_forcing
    from tlab_tpu_torch.ops.elliptic import poisson_residual
    _, _, tsim, ts = pair
    div, bcs_b, bcs_t = pressure_forcing(tsim.P, ts, dcmp)
    p = tpressure(tsim.P, ts, dcmp)
    assert poisson_residual(tsim.fdm, p, div, bcs_b, bcs_t) <= 1e-10
    assert poisson_residual(tsim.fdm, -p, div, bcs_b, bcs_t) > 0.1
    assert poisson_residual(tsim.fdm, p, div, -bcs_b, bcs_t) > 1e-3


def _mapping_calls(P, st, pressure):
    u, v, w, s = st.u, st.v, st.w, st.s[0]
    return {
        "_grad": lambda m: m._grad(P, s),
        "velocity_gradient": lambda m: m.velocity_gradient(P, u, v, w),
        "curl": lambda m: m.curl(P, u, v, w),
        "vorticity_magnitude2": lambda m: m.vorticity_magnitude2(P, u, v, w),
        "strain2": lambda m: m.strain2(P, u, v, w),
        "invariants": lambda m: m.invariants(P, u, v, w),
        "gradient_magnitude2": lambda m: m.gradient_magnitude2(P, s),
        "dissipation": lambda m: m.dissipation(P, u, v, w, 2e-3),
        "gate_intermittency": lambda m: m.gate_intermittency(s, 0.5),
        "laplacian": lambda m: m.laplacian(P, s),
        "vorticity_production": lambda m: m.vorticity_production(P, u, v, w),
        "vorticity_diffusion": lambda m: m.vorticity_diffusion(P, u, v, w),
        "strain_production": lambda m: m.strain_production(P, u, v, w),
        "strain_diffusion": lambda m: m.strain_diffusion(P, u, v, w),
        "strain_pressure": lambda m: m.strain_pressure(P, u, v, w,
                                                       pressure),
        "strain_a": lambda m: m.strain_a(P, s, u, v, w),
        "gradient_production": lambda m: m.gradient_production(P, s, u, v,
                                                               w),
        "gradient_diffusion": lambda m: m.gradient_diffusion(P, s),
    }


def _flatten(out):
    if isinstance(out, dict):
        return [out[k] for k in sorted(out)]
    if isinstance(out, (tuple, list)):
        return list(out)
    return [out]


MAPPINGS = ("_grad", "velocity_gradient", "curl", "vorticity_magnitude2",
            "strain2", "invariants", "gradient_magnitude2", "dissipation",
            "gate_intermittency", "laplacian", "vorticity_production",
            "vorticity_diffusion", "strain_production", "strain_diffusion",
            "strain_pressure", "strain_a", "gradient_production",
            "gradient_diffusion")


@pytest.mark.parametrize("name", MAPPINGS)
def test_mappings_match_jax(pair, name):
    jsim, js, tsim, ts = pair
    got = _flatten(_mapping_calls(tsim.P, ts,
                                  tpressure(tsim.P, ts))[name](tmp))
    ref = _flatten(_mapping_calls(jsim.P, js,
                                  jpressure(jsim.P, js))[name](jmp))
    assert len(got) == len(ref)
    for k, (a, b) in enumerate(zip(got, ref)):
        _close(a, b, f"{name}[{k}]")


@pytest.mark.parametrize("mode", range(3, 18))
def test_analysis_modes_match_jax(pair, mode):
    """stats.analysis.run_mode for each ParamAverages mode 3-17: the same
    columns, each to 1e-10 of its max (mode 14 solves the diagnostic
    pressure twice, with and without the velocities)."""
    jsim, js, tsim, ts = pair
    diff = [tsim.nsp.diffusivity(0)]
    got = tanalysis.run_mode(tsim.P, ts, tsim.nsp.visc, mode, diff=diff)
    ref = janalysis.run_mode(jsim.P, js, jsim.nsp.visc, mode, diff=diff)
    assert list(got) == list(ref)
    for k in ref:
        if k == "Lam2Pos":
            continue
        _close(got[k], ref[k], f"mode {mode} {k}")
    if mode == 10:
        # the plane fraction of lambda2 > 0: a point may fall on either
        # side only where lambda2 is round-off of its scale
        g = janalysis._grad9(jsim.P, js.u, js.v, js.w)
        l2 = np.asarray(janalysis._sym_eigenvalues(
            g["ux"], g["vy"], g["wz"], 0.5 * (g["uy"] + g["vx"]),
            0.5 * (g["uz"] + g["wx"]), 0.5 * (g["vz"] + g["wy"]))[1])
        near = np.mean(np.abs(l2) <= 1e-10 * np.max(np.abs(l2)), axis=(0, 2))
        diff = np.abs(np.asarray(got["Lam2Pos"]) - np.asarray(ref["Lam2Pos"]))
        assert np.all(diff <= near + 1e-15)


def test_analysis_mode_errors_match_jax(pair):
    jsim, js, tsim, ts = pair
    no_scalar = ts._replace(s=ts.s[:0])
    for mode, exc in ((2, ValueError), (18, ValueError), (7, ValueError)):
        st = no_scalar if mode == 7 else ts
        with pytest.raises(exc):
            tanalysis.run_mode(tsim.P, st, 1e-3, mode)
