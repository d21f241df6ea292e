"""Immersed boundary method, direct forcing with the spline fill (port of
tlab_tpu/ibm.py, after the reference's src/ibm/*).

Geometry is a solid mask eps(x,y,z) in {0,1} built from generators
(xbars/box/hill/valley, reference ibm_generate_geometry*.f90; NumPy copies
of tlab_tpu's).  Before the Burgers term of each direction the solid points
of the advected stack and of the advecting velocity are replaced by a cubic
Lagrange interpolant through the fluid points around them (reference
ibm_spline.f90); after each RK substep the state is forced in the solids
(reference dns_main.f90:254-257).

The fill's tables: build_spline_fill is tlab_tpu's, copied.  The port builds
the same numbers once per distinct solid mask of a line (the bars make
every line of a direction one of a few patterns; spline_tables, host NumPy)
and keeps only the solid points on the device: their flat indices, 4 source
indices, 4 weights and the wall anchors' constant (device_fills,
build_ibm_spline), or the indices alone where a direction's tables are zero
(a line of the bars all solid along x; tlab_tpu's y tables of a 3-D grid,
which its moveaxis-then-reshape never writes: the fill sets those solid
points to 0).  apply_spline_fill gathers, sums in tlab_tpu's order and
scatters into a copy.
"""
from __future__ import annotations

import numpy as np
import torch

from tlab_tpu_torch import device as _device
from tlab_tpu_torch.dycore.state import State, stack, unstack


def geometry_xbars(grid, nbars: int, height: int, width: int,
                   mirrored: bool = False) -> np.ndarray:
    """Streamwise-aligned square bars on the bottom wall, spanwise-periodic
    (reference ibm_generate_geometry_xbars); mirrored=True repeats the
    bars on the upper wall (ibm_generate_geometry_xbars.f90:124-136,
    [IBMParameter] Mirrored=yes)."""
    nx, ny, nz = grid.shape
    eps = np.zeros((nx, ny, nz), dtype=np.float64)
    if nz == 1:
        return eps
    period = nz // max(nbars, 1)
    for b in range(nbars):
        k0 = b * period
        eps[:, :height, k0:k0 + width] = 1.0
        if mirrored:
            eps[:, ny - height:, k0:k0 + width] = 1.0
    return eps


def geometry_box(grid, i0, i1, j0, j1, k0, k1) -> np.ndarray:
    nx, ny, nz = grid.shape
    eps = np.zeros((nx, ny, nz), dtype=np.float64)
    eps[i0:i1, j0:j1, k0:k1] = 1.0
    return eps


def geometry_hill(grid, height: float, width: float, center: float) -> np.ndarray:
    """Smooth 2-D hill on the bottom wall: y < h exp(-((x-c)/w)^2)."""
    nx, ny, nz = grid.shape
    X = grid.x.nodes[:, None, None]
    Y = grid.y.nodes[None, :, None]
    surface = height * np.exp(-(((X - center) / width) ** 2))
    return (Y < surface).astype(np.float64) * np.ones((nx, ny, nz))


def geometry_valley(grid, height_pts: int, slope: int = 1) -> np.ndarray:
    """Cosine valley/hill profile on the bottom wall (reference
    ibm_generate_geometry_valley.f90:  solid where
    j < (h/2^s)(1 + cos(2 pi x / Lx))^s)."""
    nx, ny, nz = grid.shape
    eps = np.zeros((nx, ny, nz), bool)
    dx = 2.0 * np.pi / nx
    i = np.arange(nx)[:, None]
    j = np.arange(ny)[None, :]
    prof = (height_pts / 2 ** slope) * (1.0 + np.cos(dx * i)) ** slope
    eps2d = j < prof
    eps[:] = eps2d[:, :, None]
    return eps


def build_spline_fill(eps: np.ndarray, axis: int, nodes: np.ndarray,
                      periodic: bool = False, scale: float = None,
                      wall_values=(0.0, 0.0)):
    """Per-direction solid-region fill (reference IBM_SPLINE_XYZ,
    src/ibm/ibm_spline.f90): before taking derivatives along `axis`, solid
    points are replaced by a cubic Lagrange interpolant through the two
    fluid points on each side of the interval.

    Special cases matching the reference's interval taxonomy
    (ibm_spline.f90:155-260):
    - PERIODIC axis: a solid run touching the line's edge takes its
      support from the opposite end with wrapped abscissae (cases 2/5).
    - NON-periodic axis: a solid run touching the wall anchors the
      interpolant at the wall coordinate with the prescribed wall value
      (case 3: zero for velocity, ibmscaljmin/jmax for scalars); the
      anchor value enters through the additive `const` array.

    Returns (idx, w, const): filled = where(solid,
        sum_m w[..., m] * u[gather idx[..., m]] + const, u).
    """
    shape = eps.shape
    n = shape[axis]
    idx = np.zeros(shape + (4,), dtype=np.int32)
    w = np.zeros(shape + (4,))
    const = np.zeros(shape)
    solid = eps > 0.5
    if scale is None and periodic:
        scale = nodes[-1] - nodes[0] + (nodes[1] - nodes[0])

    lines = np.moveaxis(solid, axis, -1).reshape(-1, n)
    idx_l = np.moveaxis(idx, axis, -2).reshape(-1, n, 4)
    w_l = np.moveaxis(w, axis, -2).reshape(-1, n, 4)
    c_l = np.moveaxis(const, axis, -1).reshape(-1, n)
    for li in range(lines.shape[0]):
        s = lines[li]
        if not s.any():
            continue
        fluid = np.where(~s)[0]
        i = 0
        while i < n:
            if not s[i]:
                i += 1
                continue
            j = i
            while j < n and s[j]:
                j += 1
            # solid run [i, j); support = up to 2 fluid points per side,
            # plus wrap (periodic) or wall anchors (non-periodic)
            below = list(fluid[fluid < i][-2:])
            above = list(fluid[fluid >= j][:2])
            sup = below + above
            xs = list(nodes[below]) + list(nodes[above])
            anchors = []                       # (x, value) fixed points
            if not below:
                if periodic and len(fluid) >= 2:
                    wrap = fluid[-2:]
                    sup = list(wrap) + sup
                    xs = [nodes[kf] - scale for kf in wrap] + xs
                elif not periodic:
                    anchors.append((nodes[0], wall_values[0]))
            if not above:
                if periodic and len(fluid) >= 2:
                    wrap = fluid[:2]
                    sup = sup + list(wrap)
                    xs = xs + [nodes[kf] + scale for kf in wrap]
                elif not periodic:
                    anchors.append((nodes[-1], wall_values[1]))
            if not sup and not anchors:
                i = j                           # fully solid line -> 0
                continue
            all_x = xs + [a[0] for a in anchors]
            sup = sup[:4]
            for p in range(i, j):
                xp = nodes[p]
                for a in range(len(all_x)):
                    wa = 1.0
                    for b in range(len(all_x)):
                        if b != a:
                            wa *= (xp - all_x[b]) / (all_x[a] - all_x[b])
                    if a < len(sup):
                        w_l[li, p, a] = wa
                        idx_l[li, p, a] = sup[a]
                    elif a >= len(xs):
                        c_l[li, p] += wa * anchors[a - len(xs)][1]
            i = j
    return idx, w, const


# ---------------------------------------------------------------------------
# The same tables, built once per distinct line mask
# ---------------------------------------------------------------------------

def _writes_through(shape, axis: int, trailing: tuple) -> bool:
    """Whether build_spline_fill's moveaxis-then-reshape of an array of
    `shape` + `trailing` is a view of it, so that its writes land.  Where
    the reshape copies (along y on a 3-D grid), tlab_tpu's tables keep their
    zeros: the fill then sets those solid points to 0.  A view depends only
    on which extents are 1, so a proxy of extents 1 and 2 answers it."""
    proxy = np.zeros(tuple(1 if n == 1 else 2 for n in shape) + trailing)
    moved = np.moveaxis(proxy, axis, -1 - len(trailing))
    return np.shares_memory(
        moved.reshape((-1, proxy.shape[axis]) + trailing), proxy)


def _fill_patterns(eps: np.ndarray, axis: int, nodes: np.ndarray,
                         periodic: bool = False, scale: float = None,
                         wall_values=(0.0, 0.0)):
    """build_spline_fill's numbers per distinct solid mask of a line.

    Returns (rows, pattern, masks, tables): rows, the indices of the lines
    (in build_spline_fill's line order) that hold a solid point;
    pattern[r], the index of row r's mask in masks; tables[k] = (idx (n, 4),
    w (n, 4), const (n,)) of masks[k], from build_spline_fill of that one
    line, with the writes that tlab_tpu's reshape loses zeroed as there."""
    n = eps.shape[axis]
    lines = np.moveaxis(eps > 0.5, axis, -1).reshape(-1, n)
    rows = np.flatnonzero(lines.any(axis=1))
    # one entry per distinct mask, keyed by its packed bits (np.unique on
    # rows sorts them as opaque records: seconds at 512x256x256)
    first = {}
    pattern = np.empty(rows.size, np.int64)
    for r, key in enumerate(np.packbits(lines[rows], axis=1)):
        pattern[r] = first.setdefault(key.tobytes(), len(first))
    masks = [lines[rows[r]] for r in
             np.unique(pattern, return_index=True)[1]]
    keep_iw = _writes_through(eps.shape, axis, (4,))
    keep_c = _writes_through(eps.shape, axis, ())
    tables = []
    for mask in masks:
        idx, w, const = build_spline_fill(mask[None].astype(np.float64), 1,
                                          nodes, periodic=periodic,
                                          scale=scale,
                                          wall_values=wall_values)
        tables.append((idx[0] if keep_iw else np.zeros_like(idx[0]),
                       w[0] if keep_iw else np.zeros_like(w[0]),
                       const[0] if keep_c else np.zeros_like(const[0])))
    return rows, pattern, masks, tables


def _sparse_fill(eps: np.ndarray, axis: int, nodes, periodic, scale,
                 wall_values):
    """(flat indices of the solid points, (4, nsolid) flat source indices,
    (4, nsolid) weights, (nsolid,) constants) of one direction's fill, in
    ascending flat order, without the dense tables."""
    shape = eps.shape
    rows, pattern, masks, tables = _fill_patterns(
        eps, axis, nodes, periodic, scale, wall_values)
    stride = int(np.prod(shape[axis + 1:], dtype=np.int64))
    others = tuple(s for a, s in enumerate(shape) if a != axis)
    coords = list(np.unravel_index(rows, others))
    coords.insert(axis, np.zeros_like(rows))
    base = np.ravel_multi_index(coords, shape).astype(np.int64)
    index, src, w, const = [], [], [], []
    for k, (ti, tw, tc) in enumerate(tables):
        b = base[pattern == k][:, None]
        pos = np.flatnonzero(masks[k])
        nl = b.shape[0]
        index.append((b + pos * stride).reshape(-1))
        src.append(np.stack([(b + ti[pos, m].astype(np.int64) * stride)
                             .reshape(-1) for m in range(4)]))
        w.append(np.stack([np.broadcast_to(tw[pos, m], (nl, pos.size))
                           .reshape(-1) for m in range(4)]))
        const.append(np.broadcast_to(tc[pos], (nl, pos.size)).reshape(-1))
    if not tables:
        return (np.zeros(0, np.int64), np.zeros((4, 0), np.int64),
                np.zeros((4, 0)), np.zeros(0))
    index = np.concatenate(index)
    order = np.argsort(index)               # the indices are distinct
    return (index[order], np.concatenate(src, axis=1)[:, order],
            np.concatenate(w, axis=1)[:, order],
            np.concatenate(const)[order])


def apply_spline_fill(u, fill):
    """A new tensor: u (..., nx, ny, nz) with the solid points of `fill`
    (one direction of build_ibm_spline) replaced by
    const + sum_m w_m u[src_m], summed in tlab_tpu's order, or by 0 where
    the direction's tables are all zero (no "src": 0 + sum 0 u is +0.0 for
    every finite u); the other points as they are.  u itself is not
    written."""
    lead = u.shape[:-3]
    out = u.reshape(*lead, -1).clone()
    if "src" not in fill:
        out.index_fill_(-1, fill["index"], 0.0)
        return out.reshape(u.shape)
    got = out.index_select(-1, fill["src"]).reshape(*lead, 4, -1)
    w = fill["w"]
    parts = fill["const"] + w[0] * got[..., 0, :]
    for m in range(1, 4):
        parts = parts + w[m] * got[..., m, :]
    out.index_copy_(-1, fill["index"], parts)
    return out.reshape(u.shape)


def _device_fill(index, src, w, const, dtype, dev) -> dict:
    """One direction's fill on the device; only the solid points' indices
    where its weights and constants are all zero."""
    fill = {"index": torch.as_tensor(index, dtype=torch.int64).to(dev)}
    if np.any(w) or np.any(const):
        fill.update(
            src=torch.as_tensor(np.asarray(src).reshape(-1),
                                dtype=torch.int64).to(dev),
            w=torch.as_tensor(np.asarray(w, np.float64)).to(dev, dtype),
            const=torch.as_tensor(np.asarray(const, np.float64)).to(dev,
                                                                    dtype))
    return fill


def sparse_from_dense(fill_np: dict, axis: int):
    """_sparse_fill's (index, src, w, const) from one direction of
    tlab_tpu's build_ibm_spline ({"idx", "w", "const", "solid"}, dense
    (nx, ny, nz[, 4]) tables)."""
    solid = np.asarray(fill_np["solid"])
    idx = np.asarray(fill_np["idx"]).astype(np.int64)
    shape = solid.shape
    index = np.flatnonzero(solid)
    coords = list(np.unravel_index(index, shape))
    src = []
    for m in range(4):
        coords[axis] = idx[..., m].reshape(-1)[index]
        src.append(np.ravel_multi_index(coords, shape))
    w = np.stack([np.asarray(fill_np["w"])[..., m].reshape(-1)[index]
                  for m in range(4)])
    const = np.asarray(fill_np["const"]).reshape(-1)[index]
    return index, np.stack(src), w, const


def fill_from_dense(fill_np: dict, axis: int, dtype=torch.float64,
                    device="cuda") -> dict:
    """One direction of a tlab_tpu plan's fills in the port's layout
    (convert.plans_from_jax)."""
    return _device_fill(*sparse_from_dense(fill_np, axis), dtype,
                        _device.resolve(device))


def spline_tables(eps: np.ndarray, grid, wall_values=(0.0, 0.0)) -> dict:
    """The fill tables of every direction with an extent, on the host:
    name -> (index, src, w, const) of _sparse_fill (the set-up's host
    work; build_ibm_spline puts them on a device)."""
    return {name: _sparse_fill(np.asarray(eps), axis, ax.nodes, ax.periodic,
                               ax.scale, wall_values)
            for name, axis, ax in (("x", 0, grid.x), ("y", 1, grid.y),
                                   ("z", 2, grid.z)) if ax.size > 1}


def device_fills(tables: dict, dtype=torch.float64, device="cuda") -> dict:
    """spline_tables' tables on `device` in the fills' layout."""
    dev = _device.resolve(device)
    return {name: _device_fill(*t, dtype, dev) for name, t in tables.items()}


def build_ibm_spline(eps: np.ndarray, grid, dtype=torch.float64,
                     device="cuda", wall_values=(0.0, 0.0)) -> dict:
    """Fill plans for all three directions (consumed by the Burgers terms),
    each {"index": (nsolid,) flat indices of the solid points, "src":
    (4 nsolid,) flat source indices, "w": (4, nsolid), "const":
    (nsolid,)} on `device` ("index" alone where the direction's tables are
    zero).  wall_values anchors semi-immersed intervals on the non-periodic
    walls (velocity: 0)."""
    return device_fills(spline_tables(eps, grid, wall_values), dtype,
                        device)


def fill_bytes(fills: dict) -> int:
    """Device bytes of the fill tables."""
    return sum(t.numel() * t.element_size() for f in fills.values()
               for t in f.values())


def build_ibm(eps: np.ndarray, dtype=torch.float64, device="cuda",
              scalar_values=None) -> dict:
    """The plan's "ibm" entry without its fills: the solid mask "eps", its
    complement "fluid" and, where given, the scalars' values in the solids
    (else 0)."""
    dev = _device.resolve(device)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float64)).to(dev, dtype)

    d = {"eps": t(eps), "fluid": t(1.0 - np.asarray(eps, np.float64))}
    if scalar_values is not None:
        d["scalar_values"] = t(scalar_values)
    return d


# ---------------------------------------------------------------------------
# The rank's views on the pencil mesh: its block (nx/px, ny, nz/pz), and the
# x/z Burgers stacks GATHERED to full lines with a further split of the other
# horizontal axis (parallel/pencil.py gather_x/gather_z).  The global tables
# are cut to exactly the points each rank holds, as the reference runs its
# spline fill on the gathered MPI pencils (ibm_spline.f90:30 inside
# OPR_Burgers, opr_burgers.f90:468).
# ---------------------------------------------------------------------------

def _block_indices(comm):
    """(px, pz, ix, iz) of the rank of the mesh descriptor `comm`."""
    mesh = comm["mesh"]
    return mesh.px, mesh.pz, mesh.ix, mesh.iz


def _view(comm, axis_name: str, shape, gathered: bool):
    """(x0, xs, z0, zs): the rank's x and z ranges of a global field of
    `shape`, after the gather along axis_name (gathered) or in its block."""
    px, pz, ix, iz = _block_indices(comm)
    nx, _, nz = shape
    if gathered and axis_name == "x":
        chunk = nz // (px * pz)
        return 0, nx, iz * (nz // pz) + ix * chunk, chunk
    if gathered and axis_name == "z":
        chunk = nx // (px * pz)
        return ix * (nx // px) + iz * chunk, chunk, 0, nz
    return ix * (nx // px), nx // px, iz * (nz // pz), nz // pz


def localize_fill(fill, axis_name: str, comm, shape, gathered: bool) -> dict:
    """One direction's fill (build_ibm_spline) cut to this rank's view of a
    global field of `shape`: its solid points there, their sources and
    weights, at flat indices of the view.  gathered=True: the layout after
    the gather along axis_name (x: (nx, ny, nz/(px pz)); z:
    (nx/(px pz), ny, nz)); gathered=False: the block (nx/px, ny, nz/pz), for
    the y fill and for an x or z axis that is not split.  A line's sources
    lie on the line, so a view that holds a solid point holds its
    sources."""
    px, pz, _, _ = _block_indices(comm)
    if px == 1 and pz == 1:
        return fill
    x0, xs, z0, zs = _view(comm, axis_name, shape, gathered)
    _, ny, nz = shape

    def local(flat):
        x, rem = flat // (ny * nz), flat % (ny * nz)
        y, z = rem // nz, rem % nz
        keep = (x >= x0) & (x < x0 + xs) & (z >= z0) & (z < z0 + zs)
        return keep, ((x - x0) * ny + y) * zs + (z - z0)

    keep, index = local(fill["index"])
    out = {"index": index[keep]}
    if "src" in fill:
        n = fill["index"].numel()
        _, src = local(fill["src"].reshape(4, n)[:, keep])
        out.update(src=src.reshape(-1), w=fill["w"][:, keep],
                   const=fill["const"][keep])
    return out


def localize_block(arr, comm):
    """A global (nx, ny, nz) table cut to this rank's block."""
    px, pz, ix, iz = _block_indices(comm)
    if px == 1 and pz == 1:
        return arr
    nx, _, nz = arr.shape
    nxl, nzl = nx // px, nz // pz
    return arr[ix * nxl:(ix + 1) * nxl, :, iz * nzl:(iz + 1) * nzl]


def force_stack(ibm, Q) -> None:
    """Direct forcing on the stacked carry Q (3+ns, nx, ny, nz), in place:
    zero velocity and pin scalars inside the solids (tlab_tpu's
    apply_ibm_state)."""
    fluid = ibm["fluid"]
    Q[:3].mul_(fluid)
    if Q.shape[0] > 3:
        sval = ibm.get("scalar_values")
        if sval is not None:
            Q[3:] = Q[3:] * fluid[None] + (1 - fluid)[None] \
                * sval[:, None, None, None]
        else:
            Q[3:].mul_(fluid[None])


def apply_ibm_state(ibm, state: State, comm=None) -> State:
    """Zero velocity and pin scalars inside solids (direct forcing); a new
    State (force_stack on a stacked copy).  comm: the mesh descriptor where
    `state` is this rank's block of a global plan's `ibm`."""
    if ibm is None:
        return state
    if comm is not None:
        ibm = dict(ibm, fluid=localize_block(ibm["fluid"], comm))
    Q = stack(state)
    force_stack(ibm, Q)
    return unstack(Q, state.sfc)
