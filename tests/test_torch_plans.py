"""The port's own copies of the NumPy modules (constants, grid, fdm,
physics.params, config) give exactly what tlab_tpu's originals give: the
copies differ from them only in their import lines, so every comparison
is exact (np.array_equal, ==), with no tolerance."""
import dataclasses
import enum
import pathlib

import numpy as np
import pytest

from tlab_tpu import config as jconfig
from tlab_tpu import constants as jconst
from tlab_tpu import grid as jgrid
from tlab_tpu.fdm import plan as jplan
from tlab_tpu.physics import params as jparams
from tlab_tpu_torch import config as tconfig
from tlab_tpu_torch import constants as tconst
from tlab_tpu_torch import grid as tgrid
from tlab_tpu_torch.fdm import plan as tplan
from tlab_tpu_torch.physics import params as tparams

DATA = pathlib.Path(__file__).resolve().parent / "data"
CASES = sorted(p.name for p in DATA.glob("*.ini"))

# a stretched wall-normal axis: a uniform segment, then a tanh-stretched one
SEGMENTS = [{"n": 17, "end": 0.5, "opts": "uniform", "vals": ()},
            {"n": 16, "end": 1.0, "opts": "tanh", "vals": (0.5, 0.1, 0.75)}]


def _same(a, b, where="value"):
    """Assert that `a` (port) and `b` (tlab_tpu) hold the same data; objects
    of the two packages' twin classes compare by class name and fields."""
    if dataclasses.is_dataclass(a) and not isinstance(a, type):
        assert type(a).__name__ == type(b).__name__, where
        fa = [f.name for f in dataclasses.fields(a)]
        assert fa == [f.name for f in dataclasses.fields(b)], where
        for name in fa:
            _same(getattr(a, name), getattr(b, name), f"{where}.{name}")
    elif isinstance(a, tconfig.Ini):
        assert isinstance(b, jconfig.Ini), where
        assert a.data == b.data, where
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype, where
        assert np.array_equal(a, b), where
    elif isinstance(a, dict):
        assert isinstance(b, dict), where
        assert [_key(k) for k in a] == [_key(k) for k in b], where
        for (ka, va), vb in zip(a.items(), b.values()):
            _same(va, vb, f"{where}[{ka!r}]")
    elif isinstance(a, (tuple, list)):
        assert type(a) is type(b) and len(a) == len(b), where
        for i, (va, vb) in enumerate(zip(a, b)):
            _same(va, vb, f"{where}[{i}]")
    elif isinstance(a, enum.Enum):
        assert _key(a) == _key(b), where
    else:
        assert type(a) is type(b) and a == b, (where, a, b)


def _key(k):
    return (type(k).__name__, k.name) if isinstance(k, enum.Enum) else k


def _grids(kind):
    if kind == "uniform":
        args = (24, 17, 12, 2.0 * np.pi, 1.0, np.pi)
        return tgrid.uniform_grid(*args), jgrid.uniform_grid(*args)
    out = []
    for mod in (tgrid, jgrid):
        y = mod.build_axis_from_segments(SEGMENTS, False)
        assert not y.uniform
        out.append(mod.Grid(
            mod.make_axis(np.arange(16) * (2.0 * np.pi / 16), True), y,
            mod.make_axis(np.arange(8) * (np.pi / 8), True)))
    return out


@pytest.mark.parametrize("kind", ["uniform", "stretched"])
def test_grid_matches(kind):
    gt, gj = _grids(kind)
    assert gt.shape == gj.shape
    _same(gt, gj, "grid")


@pytest.mark.parametrize("axis", ["x", "y", "z"])
@pytest.mark.parametrize("kind", ["uniform", "stretched"])
def test_deriv_plan_matches(kind, axis):
    """Every array of DerivPlan, every boundary-condition variant."""
    gt, gj = _grids(kind)
    pt = getattr(tplan.build_fdm_plan(gt), axis)
    pj = getattr(jplan.build_fdm_plan(gj), axis)
    assert len(pt.d12) == len(pj.d12) >= 1
    _same(pt, pj, f"fdm.{axis}")


def test_constants_match():
    for name in ("BC", "Scheme", "EquationSet"):
        et, ej = getattr(tconst, name), getattr(jconst, name)
        assert [(m.name, m.value) for m in et] == \
            [(m.name, m.value) for m in ej]
    assert (tconst.AXIS_X, tconst.AXIS_Y, tconst.AXIS_Z) == \
        (jconst.AXIS_X, jconst.AXIS_Y, jconst.AXIS_Z)


@pytest.mark.parametrize("kwargs", [
    {}, {"reynolds": 5000.0, "schmidt": (1.0, 0.7)},
    {"reynolds": 300.0, "schmidt": (), "prandtl": 0.7, "froude": 2.0,
     "rossby": 3.0}])
def test_nsparams_match(kwargs):
    pt, pj = tparams.NSParams(**kwargs), jparams.NSParams(**kwargs)
    _same(pt, pj, "nsp")
    assert pt.visc == pj.visc and pt.n_scalars == pj.n_scalars
    for i in range(pt.n_scalars):
        assert pt.diffusivity(i) == pj.diffusivity(i)


@pytest.mark.parametrize("name", CASES)
def test_load_case_matches(name):
    """Every case file of tests/data parses to the same CaseSetup, field by
    field, the option dataclasses (buoyancy, Coriolis, buffer, filters)
    included, and passes the same consistency check."""
    ct = tconfig.load_case(str(DATA / name))
    cj = jconfig.load_case(str(DATA / name))
    _same(ct, cj, "case")
    tconfig.consistency_check(ct)
    jconfig.consistency_check(cj)
    yw = np.linspace(0.0, 1.0, 7)
    for pt, pj in zip(ct.vel_profiles + ct.scal_profiles,
                      cj.vel_profiles + cj.scal_profiles):
        assert np.array_equal(pt(yw), pj(yw))


def test_case_list_is_not_empty():
    assert len(CASES) >= 7
