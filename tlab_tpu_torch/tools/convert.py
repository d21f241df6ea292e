"""Output-file converters (port of tlab_tpu/tools/convert.py; the
reference's scripts/python ecosystem: Planes2nc.py, tower2nc.py,
stats2nc.py): reference binary outputs -> NetCDF3-classic files any nc tool
reads, through scipy.io.netcdf_file.

All converters work from the SAME tlab.ini the run used (shapes, plane
indices, tower strides come from there), mirroring how the reference
scripts ask for grid sizes interactively.  `sim` needs only .case, .grid
and .nsp.n_scalars: host work, no device plans.
"""
from __future__ import annotations

import glob
import os
import re

import numpy as np

from tlab_tpu_torch.io import reference_formats as rf
from tlab_tpu_torch.stats import averages as avg


def _plane_var_names(ns: int):
    names = ["VelocityX", "VelocityY", "VelocityZ"]
    names += [f"Scalar{i + 1}" for i in range(ns)]
    names.append("Pressure")
    return names


def planes_to_nc(sim, outdir: str, iterations) -> list:
    """planesI/J/K.<it> -> planesI/J/K.<it>.nc (Planes2nc.py analog).

    One variable per field with the two in-plane coordinates and the
    plane positions as dimensions."""
    from scipy.io import netcdf_file
    case = sim.case
    planes_cfg = getattr(case, "planes", None) or {}
    grid = sim.grid
    shape3 = grid.shape
    ns = sim.nsp.n_scalars
    names = _plane_var_names(ns)
    coords = {"x": np.asarray(grid.x.nodes), "y": np.asarray(grid.y.nodes),
              "z": np.asarray(grid.z.nodes)}
    # in-plane dims per extraction axis
    inplane = {"i": ("y", "z"), "j": ("x", "z"), "k": ("x", "y")}
    written = []
    for axis in ("i", "j", "k"):
        idx = planes_cfg.get(axis)
        if not idx:
            continue
        npl = len(idx)
        for it in iterations:
            path = os.path.join(outdir, f"planes{axis.upper()}.{it}")
            if not os.path.exists(path):
                continue
            data = rf.read_planes_file(path, axis, shape3, len(names), npl)
            d1, d2 = inplane[axis]
            ncpath = path + ".nc"
            with netcdf_file(ncpath, "w") as f:
                f.createDimension("plane", npl)
                f.createDimension(d1, len(coords[d1]))
                f.createDimension(d2, len(coords[d2]))
                vpos = f.createVariable("plane", "f4", ("plane",))
                ax_nodes = coords[{"i": "x", "j": "y", "k": "z"}[axis]]
                vpos[:] = np.asarray([ax_nodes[i] for i in idx], np.float32)
                for dn in (d1, d2):
                    v = f.createVariable(dn, "f4", (dn,))
                    v[:] = np.asarray(coords[dn], np.float32)
                for iv, nm in enumerate(names):
                    v = f.createVariable(nm, "f4", ("plane", d1, d2))
                    v[:] = np.asarray(data[iv], np.float32)
            written.append(ncpath)
    return written


_TOWER_RE = re.compile(
    r"tower\.(\d{6})x(\d{6})\.(\d{6})-(\d{6})\.(\w+)$")


def towers_to_nc(sim, outdir: str) -> str | None:
    """tower.<i>x<k>.<s>-<e>.<v> (+ tower.mean) -> towers.nc
    (tower2nc.py / tower_time_merge.py analog): dims (t, y, tower) with
    the subsampled y nodes and the tower (x, z) positions."""
    from scipy.io import netcdf_file
    case = sim.case
    towers_cfg = getattr(case, "towers", None) or {}
    st = tuple(int(v) for v in towers_cfg.get("stride", (1, 1, 1)))
    sj = st[1] if len(st) > 1 else 1
    y = np.asarray(sim.grid.y.nodes)[::sj]
    n_jt = len(y)
    groups: dict = {}
    for path in sorted(glob.glob(os.path.join(outdir, "tower.*"))):
        m = _TOWER_RE.match(os.path.basename(path))
        if not m:
            continue
        i, k, s, e, var = (int(m.group(1)), int(m.group(2)),
                           int(m.group(3)), int(m.group(4)), m.group(5))
        groups.setdefault((i, k), {}).setdefault(var, []).append(path)
    if not groups:
        return None
    cols = sorted(groups)
    # read one (column, var) series, concatenating restart segments
    def read_series(paths):
        ts, its, ds = [], [], []
        for p in sorted(paths):
            t, it, d = rf.read_tower_file(p, n_jt)
            ts.append(t)
            its.append(it)
            ds.append(d)
        return (np.concatenate(ts), np.concatenate(its),
                np.concatenate(ds, axis=0))
    varnames = sorted({v for g in groups.values() for v in g})
    t0, it0, _ = read_series(groups[cols[0]][varnames[0]])
    nt = len(t0)
    ncpath = os.path.join(outdir, "towers.nc")
    vmap = {"1": "VelocityX", "2": "VelocityY", "3": "VelocityZ",
            "4": "Pressure", "5": "Scalar1"}
    x = np.asarray(sim.grid.x.nodes)
    z = np.asarray(sim.grid.z.nodes)
    with netcdf_file(ncpath, "w") as f:
        f.createDimension("t", nt)
        f.createDimension("y", n_jt)
        f.createDimension("tower", len(cols))
        vt = f.createVariable("t", "f8", ("t",))
        vt[:] = t0
        vit = f.createVariable("it", "i4", ("t",))
        vit[:] = it0.astype(np.int32)
        vy = f.createVariable("y", "f4", ("y",))
        vy[:] = y.astype(np.float32)
        vx = f.createVariable("tower_x", "f4", ("tower",))
        vx[:] = np.asarray([x[i - 1] for i, _ in cols], np.float32)
        vz = f.createVariable("tower_z", "f4", ("tower",))
        vz[:] = np.asarray([z[k - 1] for _, k in cols], np.float32)
        for var in varnames:
            nm = vmap.get(var, f"Var{var}")
            v = f.createVariable(nm, "f4", ("t", "y", "tower"))
            buf = np.zeros((nt, n_jt, len(cols)), np.float32)
            for ci, col in enumerate(cols):
                if var in groups[col]:
                    _, _, d = read_series(groups[col][var])
                    buf[:, :, ci] = d[:nt]
            v[:] = buf
    return ncpath




def stats_to_nc(outdir: str, iterations, prefix: str = "avg") -> list:
    """ASCII avg<it> tables -> avg<it>.nc (stats2nc.py analog), reusing
    the in-run NetCDF layout (stats/averages.py write_avg_nc)."""
    written = []
    for it in iterations:
        path = os.path.join(outdir, f"{prefix}{it}")
        if not os.path.exists(path):
            continue
        rtime, groups, out = avg.read_avg(path)
        y = out["Y"]
        table = {k: v for k, v in out.items() if k != "Y"}
        avg.write_avg_nc(path + ".nc", y, table, groups, it, rtime)
        written.append(path + ".nc")
    return written
