"""Restart/field file I/O in the reference's on-disk format (port of
tlab_tpu/io/fields_io.py).

Layout (cf. reference src/base/io_fields.f90:534-596, stream access, no
record markers): header of 5 int32 (offset, nx, ny, nz, nt) followed by
float64 params (count = (offset - 20)/8; params[0] = rtime, params[1] = visc
for flow fields), then the full 3-D field with x innermost, z outermost.

The in-memory convention is C-ordered (nx, ny, nz); on disk that is the
transpose (nz, ny, nx) written contiguously.  A State's tensors come to the
host through convert.state_to_numpy (float64, which holds a float32 value
exactly), so a restart written by this package is read by tlab_tpu and the
other way round.  The compressible restart (write_comp_state) holds the
five conservative fields and the rho*s scalars.

A little-endian float64 field goes through the threaded engine of
native/tlabio.cpp (cache-blocked transpose on every core, then one write or
read), built with g++ on first use (ops/_build.host_extension) where
tlab_tpu uses it; a failed build raises.  write_field_plain and
read_field_plain, the NumPy path, take the other formats (float32,
big-endian) and are the engine's plain version.  write_visual/read_visual
are the visualization files ([PostProcessing] Format).
"""
from __future__ import annotations

import os
import struct

import numpy as np
import torch

from tlab_tpu_torch.convert import state_to_numpy
from tlab_tpu_torch.dycore.compressible import CompState
from tlab_tpu_torch.ops import _build

_HDR = struct.Struct("<5i")
_HDR_BE = struct.Struct(">5i")


def _header_sane(offset, nx, ny, nz, nt) -> bool:
    return (20 <= offset <= 20 + 8 * 64
            and 0 < nx < 2 ** 24 and 0 < ny < 2 ** 24 and 0 < nz < 2 ** 24
            and 0 <= nt < 2 ** 30)


def _engine():
    """The native restart-file engine (native/tlabio.cpp), built on first
    use."""
    return _build.host_extension("tlabio")


def write_field(path: str, arr: np.ndarray, itime: int = 0,
                params=(0.0, 0.0), dtype="<f8", byteorder: str = "<") -> None:
    """byteorder '>' writes the big-endian layout of the reference's
    -fconvert=big builds (config/mpipc.cmake BIG).  A little-endian float64
    file goes through the native engine, any other through NumPy."""
    if dtype == "<f8" and byteorder == "<":
        a = np.ascontiguousarray(arr, dtype=np.float64)
        nx, ny, nz = a.shape
        _engine().write_field(path, a, nx, ny, nz, int(itime),
                              np.asarray(params, "<f8").tobytes())
        return
    write_field_plain(path, arr, itime, params, dtype, byteorder)


def write_field_plain(path: str, arr: np.ndarray, itime: int = 0,
                      params=(0.0, 0.0), dtype="<f8",
                      byteorder: str = "<") -> None:
    """write_field through NumPy: a strided transpose on one core."""
    arr = np.asarray(arr)
    nx, ny, nz = arr.shape
    params = np.asarray(params, dtype=byteorder + "f8")
    hdr = _HDR if byteorder == "<" else _HDR_BE
    dt = byteorder + dtype[1:]
    offset = hdr.size + params.nbytes
    with open(path, "wb") as fh:
        fh.write(hdr.pack(offset, nx, ny, nz, itime))
        fh.write(params.tobytes())
        fh.write(np.ascontiguousarray(arr.transpose(2, 1, 0)).astype(dt)
                 .tobytes())


def _header(path: str):
    """(byteorder, offset, nx, ny, nz, nt) of a field file's header."""
    with open(path, "rb") as fh:
        head = fh.read(_HDR.size)
    offset, nx, ny, nz, nt = _HDR.unpack(head)
    if not _header_sane(offset, nx, ny, nz, nt):
        vals = _HDR_BE.unpack(head)
        if _header_sane(*vals):
            return (">",) + vals
    return "<", offset, nx, ny, nz, nt


def read_field(path: str, dtype="<f8"):
    """Returns (arr (nx, ny, nz) float64, params array, itime).

    Endianness is AUTODETECTED from the 5-int32 header sanity check
    (offset/shape ranges): the reference's example fixtures were written
    by per-machine -fconvert builds in either byte order.  A little-endian
    double-precision file is read by the native engine."""
    byteorder, offset, nx, ny, nz, _ = _header(path)
    if dtype == "<f8" and byteorder == "<" \
            and os.path.getsize(path) - offset == nx * ny * nz * 8:
        out = np.empty((nx, ny, nz), np.float64)
        _, _, _, it, praw = _engine().read_field(path, out)
        return out, np.frombuffer(praw, dtype="<f8"), it
    return read_field_plain(path, dtype)


def read_field_plain(path: str, dtype="<f8"):
    """read_field through NumPy (any byte order, float32 or float64)."""
    with open(path, "rb") as fh:
        data = fh.read()
    byteorder, offset, nx, ny, nz, nt = _header(path)
    nparams = (offset - _HDR.size) // 8
    params = np.frombuffer(data, dtype=byteorder + "f8", count=nparams,
                           offset=_HDR.size)
    dt = byteorder + dtype[1:]
    itemsize = np.dtype(dt).itemsize
    n = nx * ny * nz
    expected = offset + n * itemsize
    if len(data) < expected and itemsize == 8:
        dt = byteorder + "f4"  # single-precision restart file
        itemsize = 4
    raw = np.frombuffer(data, dtype=dt, count=n, offset=offset)
    arr = raw.reshape(nz, ny, nx).transpose(2, 1, 0).astype(np.float64)
    return arr, params, nt


def write_state(prefix_flow: str, prefix_scal: str, itime: int, state,
                rtime: float, visc: float, dtype: str = "<f8") -> None:
    """Checkpoint: flow.<it>.1..3 = u,v,w; scal.<it>.1..N.
    dtype '<f4' writes single-precision restarts ([Main] FileType=single,
    io_fields.f90:37-40); read_field autodetects from the file size."""
    params = (rtime, visc)
    u, v, w, s = state_to_numpy(state)
    for i, comp in enumerate((u, v, w)):
        write_field(f"{prefix_flow}.{itime}.{i + 1}", comp, itime, params,
                    dtype=dtype)
    for i in range(s.shape[0]):
        write_field(f"{prefix_scal}.{itime}.{i + 1}", s[i], itime, params,
                    dtype=dtype)


def read_state(prefix_flow: str, prefix_scal: str, itime: int, n_scalars: int):
    """Returns (u, v, w, s, rtime, visc), float64 arrays on the host
    (convert.state_from_numpy makes the State)."""
    u, params, _ = read_field(f"{prefix_flow}.{itime}.1")
    v, _, _ = read_field(f"{prefix_flow}.{itime}.2")
    w, _, _ = read_field(f"{prefix_flow}.{itime}.3")
    s = [read_field(f"{prefix_scal}.{itime}.{i + 1}")[0]
         for i in range(n_scalars)]
    s = np.stack(s) if s else np.zeros((0,) + u.shape)
    rtime = params[0] if len(params) > 0 else 0.0
    visc = params[1] if len(params) > 1 else 0.0
    return u, v, w, s, rtime, visc


def _host(a) -> np.ndarray:
    """A tensor (any device) or array-like as a float64 host array."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, np.float64)


def write_comp_state(prefix_flow: str, itime: int, U, rtime: float,
                     visc: float, dtype: str = "<f8") -> None:
    """Compressible restart: conservative components as flow.<it>.1..5
    (reference file-per-variable convention; 4=rho, 5=rhoE follow the
    q-array ordering rho u, rho v, rho w, rho, rho e), the transported
    rho*s as flow.<it>.s<i>."""
    comps = (U.rhou, U.rhov, U.rhow, U.rho, U.rhoE)
    for tag, comp in zip("12345", comps):
        write_field(f"{prefix_flow}.{itime}.{tag}", _host(comp), itime,
                    (rtime, visc), dtype=dtype)
    if getattr(U, "rhos", None) is not None:
        for i in range(U.rhos.shape[0]):
            write_field(f"{prefix_flow}.{itime}.s{i + 1}", _host(U.rhos[i]),
                        itime, (rtime, visc), dtype=dtype)


def read_comp_state(prefix_flow: str, itime: int):
    """Inverse of write_comp_state: (CompState of float64 host arrays,
    rtime, visc); rhos is None without scalar files."""
    arrs = []
    rtime = visc = 0.0
    for tag in "12345":
        a, params, _ = read_field(f"{prefix_flow}.{itime}.{tag}")
        arrs.append(a)
        if len(params) >= 2:
            rtime, visc = float(params[0]), float(params[1])
    rhos = []
    i = 1
    while os.path.exists(f"{prefix_flow}.{itime}.s{i}"):
        rhos.append(read_field(f"{prefix_flow}.{itime}.s{i}")[0])
        i += 1
    return CompState(rhou=arrs[0], rhov=arrs[1], rhow=arrs[2],
                     rho=arrs[3], rhoE=arrs[4],
                     rhos=np.stack(rhos) if rhos else None), rtime, visc


def write_visual(path: str, arr, itime: int = 0, params=(0.0,),
                 fmt: str = "single") -> None:
    """Visualization field ([PostProcessing] Format, visuals.f90
    FORMAT_SINGLE default): 'single' = RAW float32, no header, x
    innermost (what the reference's xdmf/python readers mmap);
    'general' = the restart stream format.  arr: an (nx, ny, nz) array or
    tensor (any device)."""
    if fmt == "general":
        write_field(path, _host(arr), itime, params)
        return
    # rounded to f4 and transposed on its device: one copy of 4 bytes a
    # point (the same rounding as NumPy's astype)
    torch.as_tensor(arr).detach().to(torch.float32).permute(2, 1, 0) \
        .contiguous().cpu().numpy().tofile(path)


def read_visual(path: str, shape):
    """Read a visualization field written by write_visual: raw f32 when
    the file size matches shape exactly, else the restart format."""
    nx, ny, nz = shape
    if os.path.getsize(path) == nx * ny * nz * 4:
        raw = np.fromfile(path, "<f4")
        return raw.reshape(nz, ny, nx).transpose(2, 1, 0).astype(
            np.float64)
    return read_field(path)[0]
