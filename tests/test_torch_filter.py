"""The port's field filters (tlab_tpu_torch/ops/filter.py) against
tlab_tpu's, float64 on the CPU, on the same inputs made from a seed with
NumPy: the matrices of every FilterSpec.type, apply_filter, filter_state
and the Helmholtz filter, each to 1e-12 of the result's max."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from tlab_tpu import grid as jgrid
from tlab_tpu.dycore.state import State as JState
from tlab_tpu.fdm.plan import build_fdm_plan as jbuild_fdm_plan
from tlab_tpu.ops import elliptic as jell
from tlab_tpu.ops import filter as jfilt
from tlab_tpu_torch import grid as tgrid
from tlab_tpu_torch.convert import state_from_numpy, state_to_numpy
from tlab_tpu_torch.fdm.plan import build_fdm_plan
from tlab_tpu_torch.ops import elliptic as tell
from tlab_tpu_torch.ops import filter as tfilt

F64 = torch.float64
TOL = 1e-12
SEGMENTS = [{"n": 13, "end": 0.5, "opts": "uniform", "vals": ()},
            {"n": 12, "end": 1.0, "opts": "tanh", "vals": (0.5, 0.1, 0.75)}]

TYPES = [("compact", (0.49,)), ("compact", (0.3,)), ("explicit6", ()),
         ("explicit4", ()), ("tophat", (2,)), ("tophat", (4,)), ("adm", ()),
         ("spectralband", (0.0, 0.6)), ("spectralerf", (0.5, 0.1)),
         ("none", ())]


def _fdm(mod, build, stretched):
    if stretched:
        grid = mod.Grid(
            mod.make_axis(np.arange(16) * (2.0 / 16), True),
            mod.build_axis_from_segments(SEGMENTS, False),
            mod.make_axis(np.arange(8) * (1.5 / 8), True))
    else:
        grid = mod.uniform_grid(16, 24, 8, 2.0, 1.0, 1.5)
    return build(grid)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.max(np.abs(a - b)) / np.max(np.abs(b))


@pytest.mark.parametrize("stretched", [False, True])
@pytest.mark.parametrize("ftype, params", TYPES)
def test_filter_matrices_match_jax(ftype, params, stretched):
    ft = _fdm(tgrid, build_fdm_plan, stretched)
    fj = _fdm(jgrid, jbuild_fdm_plan, stretched)
    kw = dict(type=ftype, parameters=params or (0.49,))
    mt = tfilt.build_filter_matrices(ft, tfilt.FilterSpec(**kw), F64, "cpu")
    mj = jfilt.build_filter_matrices(fj, jfilt.FilterSpec(**kw), jnp.float64)
    assert sorted(mt) == sorted(mj) == ["x", "y", "z"]
    for ax in "xyz":
        assert (mt[ax] is None) == (mj[ax] is None), ax
        if mt[ax] is not None:
            assert mt[ax].dtype == F64 and _rel(mt[ax], mj[ax]) <= TOL
    a = np.random.default_rng(0).standard_normal(
        tuple(p.size for p in (ft.x, ft.y, ft.z)))
    got = tfilt.apply_filter(mt, torch.from_numpy(a))
    want = jfilt.apply_filter(mj, jnp.asarray(a))
    assert _rel(got, want) <= TOL
    if ftype in ("spectralband", "spectralerf"):
        assert mt["y"] is None and mt["x"] is not None   # periodic axes only


def test_inactive_directions_and_wall_closure():
    ft = _fdm(tgrid, build_fdm_plan, False)
    fj = _fdm(jgrid, jbuild_fdm_plan, False)
    kw = dict(type="compact", parameters=(0.45,),
              active=(True, True, False), bcs_j=("zero", "biased"))
    mt = tfilt.build_filter_matrices(ft, tfilt.FilterSpec(**kw), F64, "cpu")
    mj = jfilt.build_filter_matrices(fj, jfilt.FilterSpec(**kw), jnp.float64)
    assert mt["z"] is None and mj["z"] is None
    assert _rel(mt["y"], mj["y"]) <= TOL
    with pytest.raises(NotImplementedError, match="filter type"):
        tfilt.build_filter_matrices(ft, tfilt.FilterSpec(type="nosuch"),
                                    F64, "cpu")


def test_adm_matrix_matches_jax():
    nodes = np.linspace(0.0, 1.0, 17)
    for periodic in (False, True):
        assert np.array_equal(tfilt.adm_matrix(nodes, periodic),
                              jfilt.adm_matrix(nodes, periodic))


def test_filter_state_matches_jax():
    ft = _fdm(tgrid, build_fdm_plan, False)
    fj = _fdm(jgrid, jbuild_fdm_plan, False)
    mt = tfilt.build_filter_matrices(ft, tfilt.FilterSpec(type="compact"),
                                     F64, "cpu")
    mj = jfilt.build_filter_matrices(fj, jfilt.FilterSpec(type="compact"),
                                     jnp.float64)
    rng = np.random.default_rng(1)
    u, v, w = rng.standard_normal((3, 16, 24, 8))
    s = rng.standard_normal((2, 16, 24, 8))
    st = state_from_numpy(u, v, w, s, "cpu", F64)
    got = tfilt.filter_state(mt, st)
    want = jfilt.filter_state(mj, JState(u=jnp.asarray(u), v=jnp.asarray(v),
                                         w=jnp.asarray(w), s=jnp.asarray(s)))
    assert torch.equal(st.u, torch.from_numpy(u))    # input left as it was
    for a, b in zip(state_to_numpy(got), state_to_numpy(want)):
        assert _rel(a, b) <= TOL
    none = state_from_numpy(u, v, w, np.zeros((0, 16, 24, 8)), "cpu", F64)
    assert tfilt.filter_state(mt, none).s.shape == (0, 16, 24, 8)


@pytest.mark.parametrize("width", [2.0, 0.5])
def test_helmholtz_filter_matches_jax(width):
    ft = _fdm(tgrid, build_fdm_plan, False)
    fj = _fdm(jgrid, jbuild_fdm_plan, False)
    dt = tell.device_elliptic_plan(tell.build_elliptic_plan(ft), F64, "cpu")
    dj = jell.device_elliptic_plan(jell.build_elliptic_plan(fj), jnp.float64)
    a = np.random.default_rng(2).standard_normal((16, 24, 8))
    ht = tfilt.build_helmholtz_filter(dt, width)
    hj = jfilt.build_helmholtz_filter(dj, width)
    got = tfilt.apply_filter(ht, torch.from_numpy(a))
    assert _rel(got, jfilt.apply_filter(hj, jnp.asarray(a))) <= TOL
    # a low-pass filter: it takes energy out
    assert float(got.square().sum()) < float(np.sum(a * a))
