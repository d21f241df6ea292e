"""The port's initial conditions (tlab_tpu_torch/tools/initialize.py)
against tlab_tpu's, float64 on the CPU.

The random stream and its spectral shaping are the same NumPy arithmetic in
both packages; the curl, Poisson solves and normalisations differ in the
order of sums, so fields agree to 1e-11 of max|field| (measured ~1e-12)."""
import os

import numpy as np
import pytest
import torch

from tlab_tpu.config import Ini as JIni, load_case as jload_case
from tlab_tpu.runtime import Simulation as JSimulation
from tlab_tpu.tools import initialize as jinit
from tlab_tpu_torch.config import Ini, load_case
from tlab_tpu_torch.runtime import Simulation
from tlab_tpu_torch.tools import initialize as tinit

DATA = os.path.join(os.path.dirname(__file__), "data")
TOL = 1e-11

# the test workers share the machine's cores: with every worker's products
# on all of them, the threads spin on each other and a step takes 20x longer
torch.set_num_threads(2)

BASE = """
[Main]
Type=temporal
Equations=incompressible
SpaceOrder=CompactJacobian6
TimeOrder=RungeKuttaExplicit4
[Parameters]
Reynolds=500
Schmidt=1.0
[Flow]
ProfileVelocityX=Tanh
ThickVelocityX=0.1
DeltaVelocityX=1.0
[Scalar]
ProfileScalar1=Tanh
ThickScalar1=0.1
DeltaScalar1=1.0
MeanScalar1=0.5
[BoundaryConditions]
VelocityJmin={wall}
VelocityJmax={wall}
Scalar1Jmin=neumann
Scalar1Jmax=neumann
[IniFields]
Velocity={velocity}
Scalar={scalar}
ForceDilatation=yes
NormalizeK=0.001
ProfileIniK=GaussianSurface
ThickIniK=0.15
{inifields}
[Broadband]
{broadband}
[Discrete]
Amplitude=0.02, 0.01
ModeX=1, 2
ModeZ=0, 1
PhaseX=0.0, 0.3
PhaseZ=0.0, 0.7
[IniGridOx]
periodic=yes
segments=1
points_1=33
scales_1=4.0
[IniGridOy]
periodic=no
segments=1
points_1=24
scales_1=2.0
opts_1=uniform
[IniGridOz]
periodic={zper}
segments=1
points_1={nzp}
scales_1=2.0
"""

GAUSS = "Distribution=gaussian\nSpectrum=quadratic\nf0=3.0"
CASES = {
    # velocity modes
    "vorticitybroadband": dict(velocity="VorticityBroadband", scalar="None",
                               broadband=GAUSS),
    "vorticity_covariance": dict(
        velocity="VorticityBroadband", scalar="None",
        broadband=GAUSS + "\nCovariance=1.0,0.5,0.8,0.2,0.0,0.0"),
    "vorticity_noslip": dict(velocity="VorticityBroadband", scalar="None",
                             broadband=GAUSS, wall="noslip"),
    "potentialbroadband": dict(
        velocity="PotentialBroadband", scalar="None",
        broadband="Distribution=uniform\nSpectrum=quartic\nf0=2.0"),
    "potential_noslip_2d": dict(
        velocity="PotentialBroadband", scalar="None", broadband=GAUSS,
        wall="noslip", nzp=1, zper="no"),
    "velocitydiscrete": dict(velocity="VelocityDiscrete", scalar="None",
                             broadband=GAUSS),
    # the random-phase branch ([Broadband] Distribution=none)
    "random_phase": dict(velocity="VorticityBroadband",
                         scalar="LayerBroadband",
                         broadband="Distribution=none\nSpectrum=gaussian\n"
                                   "f0=3.0\nSigma=1.0"),
    # scalar modes
    "layerbroadband": dict(velocity="None", scalar="LayerBroadband",
                           broadband=GAUSS),
    "layerbroadband_normalized": dict(
        velocity="None", scalar="LayerBroadband", broadband=GAUSS,
        inifields="NormalizeS=0.05\nProfileIniS=GaussianSurface\n"
                  "ThickIniS=0.2"),
    "layerdiscrete": dict(velocity="None", scalar="LayerDiscrete",
                          broadband=GAUSS, inifields="NormalizeS=0.05"),
    "layerdiscrete_2d": dict(velocity="None", scalar="LayerDiscrete",
                             broadband=GAUSS, nzp=1, zper="no"),
    "deltadiscrete": dict(velocity="None", scalar="DeltaDiscrete",
                          broadband=GAUSS),
    "planediscrete": dict(velocity="None", scalar="PlaneDiscrete",
                          broadband=GAUSS),
    "fluxdiscrete": dict(velocity="None", scalar="FluxDiscrete",
                         broadband=GAUSS),
}


def _text(**kw):
    spec = dict(wall="freeslip", inifields="", nzp=9, zper="yes")
    spec.update(kw)
    return BASE.format(**spec)


def _both(jcase, tcase, seed):
    sj = jinit.initial_state(JSimulation.from_case(jcase), seed=seed)
    st = tinit.initial_state(
        Simulation.from_case(tcase, dtype=torch.float64, device="cpu"),
        seed=seed)
    return sj, st


def _assert_close(sj, st):
    for name in ("u", "v", "w", "s"):
        a = np.asarray(getattr(sj, name))
        b = getattr(st, name).numpy()
        assert a.shape == b.shape and b.dtype == np.float64
        assert np.max(np.abs(a - b), initial=0.0) <= \
            TOL * max(np.max(np.abs(a), initial=0.0), 1e-300), name


@pytest.mark.parametrize("name", ["case01_small.ini", "case01_small3d.ini"])
def test_case_files_match_jax(name):
    """The reference's Case01 shape in 2-D (nz = 1) and its 3-D variant."""
    path = os.path.join(DATA, name)
    sj, st = _both(jload_case(path), load_case(path), seed=7)
    assert float(st.u.abs().max()) > 0.4 and float(st.v.abs().max()) > 1e-3
    _assert_close(sj, st)


@pytest.mark.parametrize("name", sorted(CASES))
def test_modes_match_jax(name):
    text = _text(**CASES[name])
    sj, st = _both(jload_case(JIni(text=text)), load_case(Ini(text=text)),
                   seed=None)
    if CASES[name]["velocity"] != "None":
        assert float(st.v.abs().max()) > 1e-4      # a perturbation is there
    else:
        s = st.s[0]
        assert float((s - s.mean(dim=(0, 2), keepdim=True)).abs().max()) \
            > 1e-4
    _assert_close(sj, st)


def test_random_fields_equal_jax_exactly():
    """inirand: one continuous stream through 3 velocity fields and the
    scalar field, in Fortran order -- the same NumPy arithmetic, so equal."""
    text = _text(**CASES["random_phase"])
    fj, sj = jinit.inirand_fields(
        JSimulation.from_case(jload_case(JIni(text=text))), seed=11)
    ft, st = tinit.inirand_fields(
        Simulation.from_case(load_case(Ini(text=text)), dtype=torch.float64,
                             device="cpu"), seed=11)
    assert len(ft) == 3 and len(st) == 1
    for a, b in zip(fj + sj, ft + st):
        assert np.array_equal(a, b)


def test_state_follows_dtype_and_seed():
    text = _text(**CASES["vorticitybroadband"])
    sim = Simulation.from_case(load_case(Ini(text=text)),
                               dtype=torch.float32, device="cpu")
    a = tinit.initial_state(sim, seed=3)
    assert all(t.dtype == torch.float32 for t in (a.u, a.v, a.w, a.s))
    b = tinit.initial_state(sim, seed=4)
    assert not torch.equal(a.v, b.v)
    assert torch.equal(a.v, tinit.initial_state(sim, seed=3).v)


def test_normalize_r_without_radiation_changes_nothing():
    """[IniFields] NormalizeR acts through the radiation's source; without
    one the initial state is the plain one, as in tlab_tpu (the increment
    itself: tests/test_torch_sources_extra.py)."""
    text = _text(**dict(CASES["layerbroadband"], inifields="NormalizeR=1.0"))
    sim = Simulation.from_case(load_case(Ini(text=text)),
                               dtype=torch.float64, device="cpu")
    plain = Simulation.from_case(
        load_case(Ini(text=_text(**CASES["layerbroadband"]))),
        dtype=torch.float64, device="cpu")
    a, b = tinit.initial_state(sim, seed=3), tinit.initial_state(plain,
                                                                  seed=3)
    for x, y in zip(a[:4], b[:4]):
        assert torch.equal(x, y)
