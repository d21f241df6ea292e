"""Reference-compatible binary output formats + readers.

The reference ecosystem (scripts/python/{Planes2nc,PlotTowers,tower2nc,
PlotSpectra,PlotPdfs}.py) consumes raw stream binaries written by
IO_Write_Subarray / dns_tower.f90 / PDF1V_N / PDF2V.  This module writes
those exact layouts so the reference's plotting pipeline works unmodified
on this framework's outputs, and ships readers for tests and our own
postprocessing.

Layouts (native little-endian; the reference build on this class of
machines uses little-endian too, config/*.cmake LITTLE):

planes  (planes.f90:292-340 + IO_Write_Subarray, <f4, no header)
  planesK.<it>: (nx, ny, nvars*np) Fortran order -- per variable, its np
                k-planes consecutive; planesJ.<it>: (nx, nvars*np, nz);
                planesI.<it>: (ny, nvars*np, nz) (j fastest!).
towers  (dns_tower.f90:414-470, f8 stream)
  tower.{i:06d}x{k:06d}.{start:06d}-{end:06d}.{v}: nsave records of
  (2 + tower_jmax) doubles [t, it, var(y strided)]; v = 1..5 for
  u,v,w,p,s1.  tower.mean.{start:06d}-{end:06d}.{v}: same records with
  the horizontal-mean profile.
spectra (spectra.f90:730-746 + IO_Write_Subarray, <f4)
  xsp<it>.E<a><b>: (nx/2, ny) Fortran order (kx fastest); zsp<it>.E<a><b>:
  (nz/2, ny); rsp<it>.E<a><b>: (kr, ny).
pdfs    (pdf.f90 PDF1V_N/PDF2V, <f4 stream)
  pdf<it>.<tag>: [time, int32 ny, int32 nbins(ndim), y(ny),
  pdf((prod(nbins)+2+2*(ndim-1)*nbins[0]), ny+1)] -- per-plane rows plus
  a whole-volume row; 1-D rows are [counts(nbins), ucenter_min,
  ucenter_max]; 2-D rows append the per-u-bin v centers (2*nbins1).
"""
from __future__ import annotations

import os

import numpy as np


# ---------------------------------------------------------------------------
# planes
# ---------------------------------------------------------------------------

def write_planes_file(outdir: str, itime: int, axis: str, fields,
                      indices) -> str:
    """One reference planesI/J/K.<it> file.

    fields: ordered list of (nx, ny, nz) arrays (u, v, w, scalars...,
    pressure -- the reference's var order, planes.f90:236-247);
    indices: 0-based plane node indices along `axis`."""
    idx = list(indices)
    stacks = []
    for f in fields:
        f = np.asarray(f)
        if axis == "k":
            stacks.append(f[:, :, idx])                  # (nx, ny, np)
        elif axis == "j":
            stacks.append(f[:, idx, :])                  # (nx, np, nz)
        else:                                            # 'i'
            stacks.append(f[idx, :, :].transpose(1, 0, 2))  # (ny, np, nz)
    data = np.concatenate(stacks, axis=2 if axis == "k" else 1)
    path = os.path.join(outdir, f"planes{axis.upper()}.{itime}")
    # Fortran storage order (first index fastest)
    data.astype("<f4").T.tofile(path)
    return path


def read_planes_file(path: str, axis: str, shape3, nvars: int,
                     nplanes: int) -> np.ndarray:
    """Inverse of write_planes_file -> (nvars, nplanes, ...) float32."""
    nx, ny, nz = shape3
    raw = np.fromfile(path, dtype="<f4")
    if axis == "k":
        a = raw.reshape(nvars * nplanes, ny, nx).T       # (nx, ny, nv*np)
        a = a.reshape(nx, ny, nvars, nplanes)            # stack: var-major
        return np.moveaxis(a, (2, 3), (0, 1))
    if axis == "j":
        a = raw.reshape(nz, nvars * nplanes, nx).T
        a = a.reshape(nx, nvars, nplanes, nz)
        return np.moveaxis(a, (1, 2), (0, 1))
    a = raw.reshape(nz, nvars * nplanes, ny).T           # (ny, nv*np, nz)
    a = a.reshape(ny, nvars, nplanes, nz)
    return np.moveaxis(a, (1, 2), (0, 1))


# ---------------------------------------------------------------------------
# towers
# ---------------------------------------------------------------------------

def write_tower_files(outdir: str, times, itimes, columns, means,
                      ipos, kpos) -> list:
    """Reference raw tower flush (dns_tower.f90:414-470).

    times/itimes: per-record arrays (nsave,);
    columns: {var_index: (nsave, n_i, n_jt, n_k)} strided column series
    (var_index 1..5 = u,v,w,p,s1); means: {var_index: (nsave, n_jt)}
    horizontal means; ipos/kpos: 1-based GLOBAL grid indices of the
    tower columns."""
    nsave = len(times)
    start, end = int(itimes[0]) + 1, int(itimes[-1])
    paths = []
    head = np.stack([np.asarray(times, np.float64),
                     np.asarray(itimes, np.float64)], axis=1)  # (nsave, 2)
    for iv, series in columns.items():
        for ii, ig in enumerate(ipos):
            for kk, kg in enumerate(kpos):
                rec = np.concatenate([head, series[:, ii, :, kk]], axis=1)
                path = os.path.join(
                    outdir, f"tower.{ig:06d}x{kg:06d}."
                            f"{start:06d}-{end:06d}.{iv}")
                rec.astype("<f8").tofile(path)
                paths.append(path)
    for iv, mseries in means.items():
        rec = np.concatenate([head, mseries], axis=1)
        path = os.path.join(outdir,
                            f"tower.mean.{start:06d}-{end:06d}.{iv}")
        rec.astype("<f8").tofile(path)
        paths.append(path)
    return paths


def read_tower_file(path: str, n_jt: int):
    """-> (times, itimes, data (nsave, n_jt))."""
    raw = np.fromfile(path, dtype="<f8").reshape(-1, n_jt + 2)
    return raw[:, 0], raw[:, 1].astype(int), raw[:, 2:]


# ---------------------------------------------------------------------------
# spectra
# ---------------------------------------------------------------------------

def write_spectrum_file(outdir: str, prefix: str, itime: int, varname: str,
                        data: np.ndarray) -> str:
    """One xsp/zsp/rsp<it>.<varname> file (varname e.g. 'Euu', 'Cuv'):
    data (nk, ny), k fastest (spectra.f90:730-746; PlotSpectra.py
    reshape (ny, nk))."""
    path = os.path.join(outdir, f"{prefix}{itime}.{varname}")
    np.asarray(data).astype("<f4").T.tofile(path)
    return path


def read_spectrum_file(path: str, nk: int) -> np.ndarray:
    """-> (ny, nk) float32, as PlotSpectra.py consumes it."""
    return np.fromfile(path, dtype="<f4").reshape(-1, nk)


# ---------------------------------------------------------------------------
# pdfs: exact NR histogram semantics (utils/pdfs.f90) + file format
# ---------------------------------------------------------------------------

def pdf1v2d(u2d: np.ndarray, nbins: int, ilim: int = 1,
            umin_ext: float = 0.0, umax_ext: float = 0.0):
    """PDF1V2D (pdfs.f90:28-111) on one plane's samples: counts(nbins) +
    the two bin-center coordinates.  ilim=0 uses the external range and
    DROPS outliers; ilim=1 uses the sample range with the last point
    folded into the last bin."""
    out = np.zeros(nbins + 2)
    u = np.asarray(u2d, np.float64).ravel()
    if ilim == 0:
        umin, umax = umin_ext, umax_ext
    else:
        umin, umax = float(u.min()), float(u.max())
    ustep = (umax - umin) / nbins
    out[nbins] = umin + 0.5 * ustep
    out[nbins + 1] = umax - 0.5 * ustep
    if ustep == 0.0:
        ustep = 1.0
    up = ((u - umin) / ustep).astype(np.int64)           # int() truncation
    if ilim == 0:
        keep = (up >= 0) & (up <= nbins - 1)
        np.add.at(out, up[keep], 1.0)
    else:
        np.add.at(out, np.minimum(up, nbins - 1), 1.0)
    return out


def pdf_analize(nbins: int, pdf_row: np.ndarray, plim: float = 1.0e-4):
    """PDF_ANALIZE (pdfs.f90:329-375) with ibc=0: shrink the range to the
    bins whose count exceeds plim * max-count, returning the new
    (umin, umax) edges for the second pass."""
    counts = pdf_row[:nbins]
    ustep = (pdf_row[nbins + 1] - pdf_row[nbins]) / (nbins - 1) \
        if nbins > 1 else 1.0
    umin = pdf_row[nbins] - 0.5 * ustep
    umax = pdf_row[nbins + 1] + 0.5 * ustep
    if ustep == 0.0:
        return umin, umax
    pmin = plim * counts.max()
    nz = np.nonzero(counts > pmin)[0]
    if nz.size:
        new_min = umin + nz[0] * ustep
        new_max = umin + (nz[-1] + 1) * ustep
        return new_min, new_max
    return umin, umax


def pdf1v_plane_table(field: np.ndarray, nbins: int, ibc: int = 2):
    """Per-plane + whole-volume PDF rows (PDF1V_N, pdf.f90:47-92):
    ibc=2 -> adaptive two-pass (PDF_ANALIZE) like the in-run dns pdfs.

    field: (nx, ny, nz). Returns (ny+1, nbins+2)."""
    nx, ny, nz = field.shape
    rows = np.zeros((ny + 1, nbins + 2))
    planes = [field[:, j, :] for j in range(ny)] + [field]
    for j, sample in enumerate(planes):
        row = pdf1v2d(sample, nbins, ilim=1)
        if ibc > 1:
            lo, hi = pdf_analize(nbins, row)
            row = pdf1v2d(sample, nbins, ilim=0, umin_ext=lo, umax_ext=hi)
        rows[j] = row
    return rows


def cavg1v2d(u2d: np.ndarray, a2d: np.ndarray, nbins: int, ilim: int = 1,
             umin_ext: float = 0.0, umax_ext: float = 0.0):
    """PDF1V2D's optional conditional-average accumulation (cavg.f90
    CAVG1V_N): the row carries mean(a | u-bin) instead of counts (zero
    where the bin is empty), same range slots."""
    out = np.zeros(nbins + 2)
    u = np.asarray(u2d, np.float64).ravel()
    a = np.asarray(a2d, np.float64).ravel()
    if ilim == 0:
        umin, umax = umin_ext, umax_ext
    else:
        umin, umax = float(u.min()), float(u.max())
    ustep = (umax - umin) / nbins
    out[nbins] = umin + 0.5 * ustep
    out[nbins + 1] = umax - 0.5 * ustep
    if ustep == 0.0:
        ustep = 1.0
    up = ((u - umin) / ustep).astype(np.int64)
    counts = np.zeros(nbins)
    sums = np.zeros(nbins)
    if ilim == 0:
        keep = (up >= 0) & (up <= nbins - 1)
        np.add.at(counts, up[keep], 1.0)
        np.add.at(sums, up[keep], a[keep])
    else:
        upc = np.minimum(up, nbins - 1)
        np.add.at(counts, upc, 1.0)
        np.add.at(sums, upc, a)
    nz = counts > 0.0
    out[:nbins][nz] = sums[nz] / counts[nz]
    return out


def cavg1v_plane_table(cond: np.ndarray, a: np.ndarray, nbins: int,
                       ibc: int = 2):
    """Per-plane + whole-volume conditional-average rows (CAVG1V_N,
    cavg.f90:7-89): ibc>1 -> adaptive range from the first-pass COUNT
    histogram (PDF_ANALIZE), then the conditional means on the trimmed
    range with outliers dropped."""
    nx, ny, nz = cond.shape
    rows = np.zeros((ny + 1, nbins + 2))
    planes = [(cond[:, j, :], a[:, j, :]) for j in range(ny)] + [(cond, a)]
    for j, (cj, aj) in enumerate(planes):
        if ibc > 1:
            row = pdf1v2d(cj, nbins, ilim=1)
            lo, hi = pdf_analize(nbins, row)
            rows[j] = cavg1v2d(cj, aj, nbins, ilim=0, umin_ext=lo,
                               umax_ext=hi)
        else:
            rows[j] = cavg1v2d(cj, aj, nbins, ilim=ibc)
    return rows


def cavg2v2d(u2d: np.ndarray, v2d: np.ndarray, a2d: np.ndarray, nbins):
    """PDF2V2D's conditional-average variant (CAVG2V, cavg.f90:93-131):
    mean(a | joint (u,v) bin) in place of the counts; same adaptive
    per-u-bin v ranges and coordinate slots."""
    nb1, nb2 = int(nbins[0]), int(nbins[1])
    u = np.asarray(u2d, np.float64).ravel()
    v = np.asarray(v2d, np.float64).ravel()
    a = np.asarray(a2d, np.float64).ravel()
    out = np.zeros(nb1 * nb2 + 2 + 2 * nb1)
    offset = nb1 * nb2 + 2

    umin, umax = float(u.min()), float(u.max())
    ustep = (umax - umin) / nb1
    out[nb1 * nb2] = umin + 0.5 * ustep
    out[nb1 * nb2 + 1] = umax - 0.5 * ustep
    if ustep == 0.0:
        ustep = 1.0
    up = np.minimum(((u - umin) / ustep).astype(np.int64), nb1 - 1)

    vmin = np.full(nb1, np.inf)
    vmax = np.full(nb1, -np.inf)
    np.minimum.at(vmin, up, v)
    np.maximum.at(vmax, up, v)
    vmin[~np.isfinite(vmin)] = 0.0
    vmax[~np.isfinite(vmax)] = 0.0
    vstep = (vmax - vmin) / nb2
    out[offset:offset + nb1] = vmin + 0.5 * vstep
    out[offset + nb1:offset + 2 * nb1] = vmax - 0.5 * vstep
    vstep = np.where(vstep == 0.0, 1.0, vstep)

    vp = np.minimum(((v - vmin[up]) / vstep[up]).astype(np.int64), nb2 - 1)
    ip = vp * nb1 + up
    counts = np.zeros(nb1 * nb2)
    sums = np.zeros(nb1 * nb2)
    np.add.at(counts, ip, 1.0)
    np.add.at(sums, ip, a)
    nz = counts > 0.0
    out[:nb1 * nb2][nz] = sums[nz] / counts[nz]
    return out


def cavg2v_table(u: np.ndarray, v: np.ndarray, a: np.ndarray, nbins):
    """Per-plane + volume CAVG2V rows."""
    nx, ny, nz = u.shape
    nb1, nb2 = int(nbins[0]), int(nbins[1])
    rows = np.zeros((ny + 1, nb1 * nb2 + 2 + 2 * nb1))
    for j in range(ny):
        rows[j] = cavg2v2d(u[:, j, :], v[:, j, :], a[:, j, :], nbins)
    rows[ny] = cavg2v2d(u, v, a, nbins)
    return rows


def pdf2v2d(u2d: np.ndarray, v2d: np.ndarray, nbins):
    """PDF2V2D (pdfs.f90:215-322): joint histogram with a per-u-bin
    ADAPTIVE v range.  Returns the row of length
    nb1*nb2 + 2 + 2*nb1: [counts (v-major), u centers (2), v centers
    per u-bin (2*nb1)]."""
    nb1, nb2 = int(nbins[0]), int(nbins[1])
    u = np.asarray(u2d, np.float64).ravel()
    v = np.asarray(v2d, np.float64).ravel()
    out = np.zeros(nb1 * nb2 + 2 + 2 * nb1)
    offset = nb1 * nb2 + 2

    umin, umax = float(u.min()), float(u.max())
    ustep = (umax - umin) / nb1
    out[nb1 * nb2] = umin + 0.5 * ustep
    out[nb1 * nb2 + 1] = umax - 0.5 * ustep
    if ustep == 0.0:
        ustep = 1.0
    up = np.minimum(((u - umin) / ustep).astype(np.int64), nb1 - 1)

    vmin = np.full(nb1, np.inf)
    vmax = np.full(nb1, -np.inf)
    np.minimum.at(vmin, up, v)
    np.maximum.at(vmax, up, v)
    vmin[~np.isfinite(vmin)] = 0.0
    vmax[~np.isfinite(vmax)] = 0.0
    vstep = (vmax - vmin) / nb2
    out[offset:offset + nb1] = vmin + 0.5 * vstep
    out[offset + nb1:offset + 2 * nb1] = vmax - 0.5 * vstep
    vstep = np.where(vstep == 0.0, 1.0, vstep)

    vp = np.minimum(((v - vmin[up]) / vstep[up]).astype(np.int64), nb2 - 1)
    ip = vp * nb1 + up
    np.add.at(out, ip, 1.0)
    return out


def pdf2v_table(u: np.ndarray, v: np.ndarray, nbins):
    """PDF2V (pdf.f90:123-240): per-plane rows + whole-volume row."""
    nx, ny, nz = u.shape
    nb1, nb2 = int(nbins[0]), int(nbins[1])
    rows = np.zeros((ny + 1, nb1 * nb2 + 2 + 2 * nb1))
    for j in range(ny):
        rows[j] = pdf2v2d(u[:, j, :], v[:, j, :], nbins)
    rows[ny] = pdf2v2d(u, v, nbins)
    return rows


def write_pdf_file(outdir: str, fname: str, time: float, y: np.ndarray,
                   rows: np.ndarray, nbins) -> str:
    """PDF1V_N / PDF2V stream layout (pdf.f90:104-118,168-177):
    [f4 time, i4 ny, i4 nbins..., f4 y, f4 rows (bin index fastest)]."""
    ny = len(y)
    path = os.path.join(outdir, fname)
    with open(path, "wb") as fh:
        np.asarray([time], "<f4").tofile(fh)
        np.asarray([ny], "<i4").tofile(fh)
        np.asarray(np.atleast_1d(nbins), "<i4").tofile(fh)
        np.asarray(y, "<f4").tofile(fh)
        np.asarray(rows, "<f4").tofile(fh)     # (ny+1, size): row-major =
        # Fortran (size, ny+1) column-major, bin index fastest
    return path


def read_pdf_file(path: str, ndim: int = 1):
    """-> (time, y, rows (ny+1, nb_size)) as PlotPdfs.py reads it."""
    with open(path, "rb") as fh:
        time = np.fromfile(fh, "<f4", 1)[0]
        ny = int(np.fromfile(fh, "<i4", 1)[0])
        nbins = np.fromfile(fh, "<i4", ndim)
        y = np.fromfile(fh, "<f4", ny)
        nb_size = int(np.prod(nbins)) + 2 + 2 * (ndim - 1) * int(nbins[0])
        rows = np.fromfile(fh, "<f4").reshape(ny + 1, nb_size)
    return float(time), y, rows, nbins
