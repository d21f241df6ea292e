"""The port's field files (tlab_tpu_torch/io/fields_io.py) against
tlab_tpu's: the same bytes on disk, and each package reads the other's.
Everything here is exact: the files hold the arrays' own bits."""
import numpy as np
import pytest
import torch

from tlab_tpu.dycore.state import State as JState
from tlab_tpu.io import fields_io as jio
from tlab_tpu_torch.convert import state_from_numpy, state_to_numpy
from tlab_tpu_torch.io import fields_io as tio

SHAPE = (6, 5, 4)


def _field(seed=0):
    return np.random.default_rng(seed).standard_normal(SHAPE)


@pytest.mark.parametrize("dtype, byteorder", [("<f8", "<"), ("<f4", "<"),
                                              ("<f8", ">"), ("<f4", ">")])
def test_files_are_byte_identical(tmp_path, dtype, byteorder):
    a = _field()
    kw = dict(itime=7, params=(0.25, 1e-3), dtype=dtype, byteorder=byteorder)
    jio.write_field(str(tmp_path / "j"), a, **kw)
    tio.write_field(str(tmp_path / "t"), a, **kw)
    assert (tmp_path / "j").read_bytes() == (tmp_path / "t").read_bytes()


@pytest.mark.parametrize("dtype, byteorder", [("<f8", "<"), ("<f4", "<"),
                                              ("<f8", ">")])
@pytest.mark.parametrize("writer, reader", [(jio, tio), (tio, jio),
                                            (tio, tio)])
def test_each_package_reads_the_other(tmp_path, writer, reader, dtype,
                                      byteorder):
    a = _field(1)
    path = str(tmp_path / "f")
    writer.write_field(path, a, itime=3, params=(1.5, 2e-3), dtype=dtype,
                       byteorder=byteorder)
    arr, params, it = reader.read_field(path)
    want = a.astype(np.float32).astype(np.float64) if dtype == "<f4" else a
    assert arr.shape == SHAPE and np.array_equal(arr, want)
    assert it == 3 and tuple(params) == (1.5, 2e-3)


def test_disk_order_is_z_outermost(tmp_path):
    """x is the innermost index on disk: the bytes after the header are the
    (nz, ny, nx) transpose."""
    a = _field(2)
    tio.write_field(str(tmp_path / "f"), a, params=(0.0, 0.0))
    raw = np.frombuffer((tmp_path / "f").read_bytes()[20 + 16:], "<f8")
    assert np.array_equal(raw.reshape(4, 5, 6), a.transpose(2, 1, 0))


@pytest.mark.parametrize("dtype", ["<f8", "<f4"])
def test_state_crosses_between_the_packages(tmp_path, dtype):
    """A restart written by either package is read by the other; float32
    tensors are written as <f8 without loss."""
    rng = np.random.default_rng(3)
    u, v, w = (rng.standard_normal(SHAPE) for _ in range(3))
    s = rng.standard_normal((2,) + SHAPE)
    st32 = state_from_numpy(u, v, w, s, "cpu", torch.float32)
    pre = (str(tmp_path / "flow"), str(tmp_path / "scal"))
    tio.write_state(*pre, 4, st32, 0.5, 1e-3, dtype=dtype)
    got = jio.read_state(*pre, 4, 2)
    for a, b in zip(got[:4], state_to_numpy(st32)):
        assert np.array_equal(a, b)
    assert got[4:] == (0.5, 1e-3)
    # and back: tlab_tpu writes, the port reads into a State
    pre2 = (str(tmp_path / "flow2"), str(tmp_path / "scal2"))
    jio.write_state(*pre2, 9, JState(u=u, v=v, w=w, s=s), 0.75, 2e-3,
                    dtype=dtype)
    u2, v2, w2, s2, rtime, visc = tio.read_state(*pre2, 9, 2)
    st = state_from_numpy(u2, v2, w2, s2, "cpu", torch.float64)
    cast = (lambda a: a.astype(np.float32).astype(np.float64)) \
        if dtype == "<f4" else (lambda a: a)
    for a, b in zip(state_to_numpy(st), (u, v, w, s)):
        assert np.array_equal(a, cast(b))
    assert (rtime, visc) == (0.75, 2e-3)
    for i in (1, 2, 3):
        assert (tmp_path / f"flow.4.{i}").stat().st_size == \
            20 + 16 + 120 * int(dtype[2])


def test_state_to_numpy_inverts_state_from_numpy():
    rng = np.random.default_rng(4)
    arrays = tuple(rng.standard_normal(SHAPE) for _ in range(3)) + \
        (rng.standard_normal((1,) + SHAPE),)
    back = state_to_numpy(state_from_numpy(*arrays, "cpu", torch.float64))
    for a, b in zip(back, arrays):
        assert a.dtype == np.float64 and np.array_equal(a, b)
