"""Remeshing (ops/interpolate.py) and the commands that use it, `transfields`
and `transgrid`, against tlab_tpu, float64 on the CPU.

Limits: remesh_field 1e-12 of max|field| against tlab_tpu's (the same
matrices, products summed in another order); transfields' files 1e-12 of
each field's max; transgrid's grid file byte for byte.  The matrix itself is
held exactly by tests/test_torch_plans.py.  Cubic Lagrange is exact on
cubics: a cubic in the wall-normal y comes back to 1e-12."""
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tlab_tpu import grid as jgrid
from tlab_tpu.ops import interpolate as jinterp
from tlab_tpu.tools import cli as jcli
from tlab_tpu_torch import grid as tgrid
from tlab_tpu_torch.io import fields_io as tio
from tlab_tpu_torch.ops import interpolate as tinterp
from tlab_tpu_torch.tools import cli as tcli

DATA = os.path.join(os.path.dirname(__file__), "data")
F64 = torch.float64
TOL = 1e-12

torch.set_num_threads(2)


def _pair(shape, lengths=(2 * np.pi, 1.0, np.pi)):
    return (tgrid.uniform_grid(*shape, *lengths),
            jgrid.uniform_grid(*shape, *lengths))


def _field(grid, seed=0):
    rng = np.random.default_rng(seed)
    x = grid.x.nodes[:, None, None]
    y = grid.y.nodes[None, :, None]
    z = grid.z.nodes[None, None, :]
    return (np.sin(x) * np.cos(2 * np.pi * y) * np.cos(2 * z)
            + 0.1 * rng.standard_normal(grid.shape))


@pytest.mark.parametrize("old, new", [((32, 33, 16), (48, 49, 24)),
                                      ((32, 33, 16), (16, 17, 8)),
                                      ((24, 20, 1), (36, 31, 1)),
                                      ((16, 17, 8), (16, 25, 8))])
def test_remesh_field_matches(old, new):
    (t1, j1), (t2, j2) = _pair(old), _pair(new)
    f = _field(t1)
    got = tinterp.remesh_field(torch.as_tensor(f), t1, t2).numpy()
    want = np.asarray(jinterp.remesh_field(jnp.asarray(f), j1, j2))
    assert got.shape == new
    assert np.max(np.abs(got - want)) <= TOL * np.max(np.abs(want))


def test_remesh_keeps_dtype_and_skips_same_axes():
    t1, _ = _pair((16, 17, 8))
    t2, _ = _pair((16, 25, 8))
    f = torch.as_tensor(_field(t1), dtype=torch.float32)
    out = tinterp.remesh_field(f, t1, t2)
    assert out.dtype == torch.float32 and out.shape == (16, 25, 8)
    assert tinterp.remesh_field(f, t1, t1) is f


def test_remesh_accuracy_and_constants():
    """tests/test_io.py's two properties on the port: a smooth field at
    4th order, a constant to round-off."""
    g1 = tgrid.uniform_grid(32, 33, 1, 2 * np.pi, 1.0, 1.0)
    g2 = tgrid.uniform_grid(48, 49, 1, 2 * np.pi, 1.0, 1.0)

    def exact(g):
        return np.sin(g.x.nodes[:, None, None]) \
            * np.cos(2 * np.pi * g.y.nodes[None, :, None]) * np.ones(g.shape)

    f2 = tinterp.remesh_field(torch.as_tensor(exact(g1)), g1, g2).numpy()
    assert np.max(np.abs(f2 - exact(g2))) < 5e-4
    g1 = tgrid.uniform_grid(16, 17, 8, 1.0, 1.0, 1.0)
    g2 = tgrid.uniform_grid(24, 21, 12, 1.0, 1.0, 1.0)
    out = tinterp.remesh_field(torch.ones(g1.shape, dtype=F64), g1, g2)
    assert float((out - 1.0).abs().max()) < 1e-12


def test_cubic_in_y_is_exact():
    """A cubic in the non-periodic y onto a stretched y: exact to
    round-off, the ends included."""
    g1 = tgrid.uniform_grid(8, 17, 4, 1.0, 1.0, 1.0)
    y2 = tgrid.build_axis_from_segments(
        [{"n": 30, "end": 1.0, "opts": "tanh", "vals": (0.5, 0.1, 0.75)}],
        False)
    g2 = tgrid.Grid(g1.x, y2, g1.z)

    def cubic(y):
        return (1.0 - 2.0 * y + 0.5 * y ** 2 - 3.0 * y ** 3)[None, :, None] \
            * np.ones((8, 1, 4))

    out = tinterp.remesh_field(torch.as_tensor(cubic(g1.y.nodes)), g1, g2)
    want = cubic(y2.nodes)
    assert np.max(np.abs(out.numpy() - want)) <= TOL * np.max(np.abs(want))


def _case(path, edits):
    with open(path) as fh:
        text = fh.read()
    for old, new in edits:
        assert old in text, old
        text = text.replace(old, new, 1)
    return text


SMALL = [("Imax=128", "Imax=32"), ("Jmax=64", "Jmax=24"),
         ("points_1=129", "points_1=33"), ("points_1=64", "points_1=24")]
TARGET = [("Imax=128", "Imax=48"), ("Jmax=64", "Jmax=31"),
          ("Kmax=16", "Kmax=12"), ("points_1=129", "points_1=49"),
          ("points_1=64", "points_1=31"), ("points_1=17", "points_1=13")]


def test_transfields_matches(tmp_path):
    """`transfields` of the port's initial fields of a 32x24x16 case onto
    48x31x12 through both CLIs: flow_rm/scal_rm equal to 1e-12 of each
    field's max, with the restart's time and viscosity."""
    case = os.path.join(DATA, "case01_small3d.ini")
    (tmp_path / "tlab.ini").write_text(_case(case, SMALL))
    (tmp_path / "target.ini").write_text(_case(case, TARGET))
    t, j = tmp_path / "t", tmp_path / "j"
    t.mkdir()
    common = ["--ini", str(tmp_path / "tlab.ini"),
              "--ini2", str(tmp_path / "target.ini"), "--files", "0"]
    assert tcli.main(["ini", *common, "--outdir", str(t), "--device", "cpu",
                      "--x64"]) == 0
    shutil.copytree(t, j)
    assert tcli.main(["transfields", *common, "--outdir", str(t),
                      "--device", "cpu", "--x64"]) == 0
    assert jcli.main(["transfields", *common, "--outdir", str(j), "--cpu",
                      "--x64"]) == 0
    names = ("flow_rm.0.1", "flow_rm.0.2", "flow_rm.0.3", "scal_rm.0.1")
    for n in names:
        a, pa, _ = tio.read_field(str(t / n))
        b, pb, _ = tio.read_field(str(j / n))
        assert a.shape == (48, 31, 12), n
        assert np.max(np.abs(a - b)) <= TOL * np.max(np.abs(b)), n
        assert np.array_equal(pa, pb), n


@pytest.mark.parametrize("refine", [2, 3, -2])
def test_transgrid_matches(tmp_path, refine):
    """`transgrid` of the case's grid file (no case file read): the grid
    file byte for byte, and the refined axes the old ones' endpoints."""
    case = os.path.join(DATA, "case01_small3d.ini")
    (tmp_path / "tlab.ini").write_text(_case(case, SMALL))
    assert tcli.main(["inigrid", "--ini", str(tmp_path / "tlab.ini"),
                      "--outdir", str(tmp_path), "--device", "cpu"]) == 0
    flags = ["--outdir", str(tmp_path), "--refine", str(refine),
             "--ini", str(tmp_path / "absent.ini")]
    assert tcli.main(["transgrid", *flags, "--grid-out", "t.grid",
                      "--device", "cpu"]) == 0
    assert jcli.main(["transgrid", *flags, "--grid-out", "j.grid",
                      "--cpu"]) == 0
    got = (tmp_path / "t.grid").read_bytes()
    assert got == (tmp_path / "j.grid").read_bytes()
    g0 = tgrid.read_reference_grid(str(tmp_path / "grid"))
    g1 = tgrid.read_reference_grid(str(tmp_path / "t.grid"))
    for a, b in zip((g0.x, g0.y, g0.z), (g1.x, g1.y, g1.z)):
        n = a.size * refine if refine > 0 else a.size // -refine
        assert b.size == n and b.nodes[0] == a.nodes[0]
        assert b.nodes[-1] == a.nodes[-1] and b.periodic == a.periodic
