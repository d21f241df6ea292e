"""dns.run on the port's rank mesh (four ranks over gloo, float64) against
one device, for tlab_tpu's seven mesh features of
tests/test_mesh_features.py: an unsteady inflow with the Imin/Imax strips
(buffer.localize), the wavemaker (localize_wavemaker, the step's rtime),
tracer particles (owner-sharded slots, migration), bil_cloud droplets (the
Eulerian sources through the transposes, the droplet scalars in the
slots), the compressible spatial statistics (st6.npz), the anelastic
AirWater set, and an inner-steps window; with tlab_tpu's tolerances.  And
three the port adds: the spatial jet with the filter sponge besides its
strips ([BufferZone] Type=both), the Ekman layer with its Jmax sponge and
an interactive
bottom surface (the surface's plane means over the mesh), and with the
SMR91 scheme (its Helmholtz and Poisson solves through the pencil engine,
where tlab_tpu's step hands its blocks to the single-device solves).  The
mesh runs are one spawned job; the single-device runs are in this
process."""
import os

import numpy as np
import pytest

import test_torch_mesh_workers as W
from test_torch_boundary import ekman_case
from test_torch_implicit import _ekman_text
from tlab_tpu_torch.parallel import mesh as pmesh
from tlab_tpu_torch.stats.spatial import SpatialStats

SPATIAL_JET_3D = """
[Main]
Type=spatial
Equations=incompressible
SpaceOrder=CompactJacobian6
TimeOrder=RungeKuttaExplicit3
TimeCFL=0.7
[Parameters]
Reynolds=500
Schmidt=1.0
[Iteration]
Start=0
End=12
Restart=0
Statistics=0
IteraLog=1
[Flow]
ProfileVelocityX=Bickley
ThickVelocityX=0.08
DeltaVelocityX=1.0
VelocityX=0.05
[Scalar]
ProfileScalar1=Gaussian
ThickScalar1=0.08
DeltaScalar1=1.0
[BoundaryConditions]
VelocityJmin=freeslip
VelocityJmax=freeslip
Scalar1Jmin=neumann
Scalar1Jmax=neumann
[BufferZone]
Type=relaxation
PointsImin=8
PointsImax=12
ParametersJmin=2.0,2.0
[IniGridOx]
periodic=yes
segments=1
points_1=65
scales_1=4.0
opts_1=uniform
[IniGridOy]
periodic=no
segments=1
points_1=32
scales_1=2.0
opts_1=uniform
[IniGridOz]
periodic=yes
segments=1
points_1=9
scales_1=1.0
opts_1=uniform
"""

WAVEMAKER_3D = """
[Main]
Type=temporal
Equations=incompressible
SpaceOrder=CompactJacobian6
TimeOrder=RungeKuttaExplicit3
TimeStep=0.02
[Parameters]
Reynolds=1000
Schmidt=1.0
Froude=1.0
[Iteration]
Start=0
End=10
Restart=0
Statistics=0
IteraLog=1
[Scalar]
ProfileScalar1=Linear
DeltaScalar1=-1.0
MeanScalar1=0.5
[BodyForce]
Type=Linear
Vector=0.0,1.0,0.0
Parameters=1.0
[SpecialForcing]
Type=WaveMaker
Parameters=0.159154943
Wave1=0.1, 1.0, -45.0, 0.707106781
Envelope=3.0, 1.0, 0.8, 0.5
[BoundaryConditions]
VelocityJmin=freeslip
VelocityJmax=freeslip
Scalar1Jmin=neumann
Scalar1Jmax=neumann
[IniGridOx]
periodic=yes
segments=1
points_1=33
scales_1=6.0
opts_1=uniform
[IniGridOy]
periodic=no
segments=1
points_1=24
scales_1=2.0
opts_1=uniform
[IniGridOz]
periodic=yes
segments=1
points_1=9
scales_1=1.6
opts_1=uniform
"""

PARTICLE_SHEAR_3D = """
[Main]
Type=temporal
Equations=incompressible
SpaceOrder=CompactJacobian6
TimeOrder=RungeKuttaExplicit4
TimeCFL=1.0
[Parameters]
Reynolds=800
Schmidt=1.0
[Iteration]
Start=0
End=10
Restart=0
Statistics=0
IteraLog=1
[Flow]
ProfileVelocityX=Tanh
ThickVelocityX=0.08
DeltaVelocityX=1.0
[Scalar]
ProfileScalar1=Tanh
ThickScalar1=0.08
DeltaScalar1=-1.0
MeanScalar1=0.5
[BoundaryConditions]
VelocityJmin=freeslip
VelocityJmax=freeslip
Scalar1Jmin=neumann
Scalar1Jmax=neumann
[Particles]
Type=Tracer
Number=240
[IniGridOx]
periodic=yes
segments=1
points_1=33
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
points_1=9
scales_1=1.0
opts_1=uniform
"""

COMP_SPATIAL_3D = """
[Main]
Type=spatial
Equations=compressible
SpaceOrder=CompactJacobian6
TimeOrder=RungeKuttaExplicit3
TimeCFL=0.5
[Control]
ScalLimit=no
[Parameters]
Reynolds=500
Schmidt=1.0
Mach=0.3
Gamma=1.4
Prandtl=0.7
[Iteration]
Start=0
End=6
Restart=6
IteraLog=3
Statistics=3
[Flow]
ProfileVelocityX=Tanh
ThickVelocityX=0.1
DeltaVelocityX=0.5
[Scalar]
ProfileScalar1=Tanh
ThickScalar1=0.1
DeltaScalar1=1.0
[BoundaryConditions]
VelocityJmin=freeslip
VelocityJmax=freeslip
Scalar1Jmin=neumann
Scalar1Jmax=neumann
[IniGridOx]
periodic=yes
segments=1
points_1=25
scales_1=4.0
[IniGridOy]
periodic=no
segments=1
points_1=17
scales_1=2.0
opts_1=uniform
[IniGridOz]
periodic=yes
segments=1
points_1=9
scales_1=1.0
"""

ANELASTIC_CLOUD_3D = """
[Main]
Type=temporal
Equations=incompressible
TermAdvection=convective
SpaceOrder=CompactJacobian6
TimeOrder=RungeKuttaExplicit4
TimeCFL=1.2
[Control]
FlowLimit=no
ScalLimit=no
[Iteration]
Start=0
End=8
Restart=8
IteraLog=2
[Parameters]
Reynolds=1000
Schmidt=1.0,1.0
Froude=0.0254
[Gravity]
Type=explicit
Vector=0.0,1.0,0.0
[Flow]
ProfileVelocityX=None
VelocityX=0.0
YMeanRelativePressure=0.75
Pressure=0.940
[Scalar]
ProfileScalar1=Erf
ThickScalar1=-0.05
DeltaScalar1=0.026589
YMeanRelativeScalar1=0.75
MeanScalar1=0.9686705
ProfileScalar2=Erf
ThickScalar2=0.05
DeltaScalar2=0.00750
YMeanRelativeScalar2=0.75
MeanScalar2=0.00525
[Thermodynamics]
Type=anelastic
Mixture=AirWater
SmoothFactor=0.00
ScaleHeight=8700.
[BoundaryConditions]
VelocityJmin=freeslip
VelocityJmax=freeslip
Scalar1Jmin=dirichlet
Scalar1Jmax=dirichlet
Scalar2Jmin=dirichlet
Scalar2Jmax=dirichlet
[IniGridOx]
periodic=yes
segments=1
points_1=33
scales_1=2.0
[IniGridOy]
periodic=no
segments=1
points_1=32
scales_1=1.0
opts_1=uniform
[IniGridOz]
periodic=yes
segments=1
points_1=17
scales_1=1.0
"""


def _with_bil_cloud(text):
    text = text.replace("Type=Tracer", "Type=BilinearCloudThree")
    text = text.replace("Schmidt=1.0", "Schmidt=1.0,1.0")
    return text.replace("MeanScalar1=0.5", """MeanScalar1=0.5
ProfileScalar2=Tanh
ThickScalar2=0.08
DeltaScalar2=0.4
MeanScalar2=0.3""")


CASE01 = open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "data", "case01_small3d.ini")).read()
FEATURES = {
    "inflow": SPATIAL_JET_3D,
    "wavemaker": WAVEMAKER_3D,
    "particles": PARTICLE_SHEAR_3D,
    "bil_cloud": _with_bil_cloud(PARTICLE_SHEAR_3D),
    "comp_spatial": COMP_SPATIAL_3D,
    "anelastic": ANELASTIC_CLOUD_3D,
    "inner_steps": CASE01,
    "sponge": SPATIAL_JET_3D.replace("Type=relaxation", "Type=both"),
    "surface": ekman_case(),
    "smr91": _ekman_text(steps=4),
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{name: (single-device result, rank 0's mesh result), "dirs": ...}
    of feature_run."""
    top = tmp_path_factory.mktemp("features")
    mesh = pmesh.spawn(W.features_job, 2, 2, "cpu", FEATURES,
                       str(top / "mesh"), store_dir=str(top),
                       timeout_s=600)[0]
    out = {name: (W.feature_run(name, text, str(top / "single" / name)),
                  mesh[name]) for name, text in FEATURES.items()}
    out["dirs"] = (top / "single", top / "mesh")
    return out


def _scale(a):
    return max(1.0, float(np.abs(a).max()))


def _lines_equal_but(la, lb, columns, floor):
    """The logs line by line; where two lines differ, only `columns` (from
    the end) may, each below `floor` on both sides."""
    assert len(la) == len(lb)
    for a, b in zip(la, lb):
        if a == b:
            continue
        ta, tb = a.split(), b.split()
        assert len(ta) == len(tb) and ta[:-columns] == tb[:-columns], (a, b)
        for x, y in zip(ta[-columns:], tb[-columns:]):
            assert abs(float(x)) < floor and abs(float(y)) < floor, (a, b)


def _states_close(sa, sb, tol):
    for k, (a, b) in enumerate(zip(sa, sb)):
        assert a.shape == b.shape, k
        assert np.abs(a - b).max() < tol * _scale(a), k


@pytest.mark.parametrize("name", ["inflow", "wavemaker"])
def test_mesh_flow_features_match_one_device(runs, name):
    (la, sa, _), (lb, sb, _) = runs[name]
    _lines_equal_but(la, lb, 2, 1e-12)      # DilMin DilMax at round-off
    _states_close(sa, sb, 1e-12)
    if name == "inflow":                    # the inflow reached the flow
        assert np.abs(sb[1][:8]).max() > 1e-5
    else:                                   # the wavemaker forced it
        assert np.abs(sb[0]).max() > 1e-6


def _by_tag(ps):
    order = np.argsort(ps[3])
    return [a[order] for a in ps]


def test_mesh_particles_match_one_device(runs):
    (la, sa, pa), (lb, sb, pb) = runs["particles"]
    _states_close(sa[:3], sb[:3], 1e-11)
    pa, pb = _by_tag(pa), _by_tag(pb)
    assert np.array_equal(pa[3], pb[3]) and pa[3].size == 240
    d = np.abs(pa[0] - pb[0])
    d[:, 0] = np.minimum(d[:, 0], 2.0 - d[:, 0])    # periodic distance
    d[:, 2] = np.minimum(d[:, 2], 1.0 - d[:, 2])
    assert d.max() < 1e-9, d.max()


def test_mesh_bil_cloud_matches_one_device(runs):
    (_, _, pa), (_, _, pb) = runs["bil_cloud"]
    pa, pb = _by_tag(pa), _by_tag(pb)
    assert np.array_equal(pa[3], pb[3]) and pa[3].size == 160
    assert pa[2].shape == pb[2].shape == (160, 2)
    assert np.abs(pa[2]).max() > 0.0        # the droplet scalars moved
    assert np.abs(pa[2] - pb[2]).max() < 1e-9 * _scale(pa[2])


def test_mesh_comp_spatial_stats_match_one_device(runs):
    (la, _, _), (lb, _, _) = runs["comp_spatial"]
    assert la == lb
    one, many = runs["dirs"]
    a = SpatialStats.load(str(one / "comp_spatial" / "st6.npz"))
    b = SpatialStats.load(str(many / "comp_spatial" / "st6.npz"))
    assert a.n_samples == b.n_samples == 6
    for attr in ("sums", "pair_sums", "grad_sums", "gradx_sums", "p_sums",
                 "triple_sums", "comp_sums", "reg_sums"):
        va, vb = getattr(a, attr), getattr(b, attr)
        assert np.abs(va - vb).max() < 1e-13 * _scale(va), attr


def test_mesh_anelastic_airwater_matches_one_device(runs):
    """dns.out exact but NewtonRs (a max of the saturation Newton's
    round-off), the state to 1e-9 (the Newton amplifies last-bit
    differences, as tlab_tpu's test notes)."""
    (la, sa, _), (lb, sb, _) = runs["anelastic"]
    _lines_equal_but(la, lb, 1, 1e-9)
    _states_close(sa, sb, 1e-9)
    assert np.abs(sb[1]).max() > 1e-8       # buoyancy drove a flow


def test_mesh_inner_steps_window_matches_one_device(runs):
    (la, sa, _), (lb, sb, _) = runs["inner_steps"]
    assert la == lb
    _states_close(sa, sb, 1e-12)


@pytest.mark.parametrize("name", ["sponge", "surface", "smr91"])
def test_mesh_features_of_the_port_match_one_device(runs, name):
    """dns.out in every printed digit but the dilatation's round-off, the
    state (and the wall scalar the surface moves) to 1e-12."""
    (la, sa, _), (lb, sb, _) = runs[name]
    _lines_equal_but(la, lb, 2, 1e-12)
    _states_close(sa, sb, 1e-12)
