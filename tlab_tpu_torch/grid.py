"""Grid container and generation.

One-dimensional node arrays per direction (x streamwise, y vertical,
z spanwise), possibly nonuniform in y. Equivalent role to the reference's
grid_dt + inigrid tool (src/base/tlab_grid.f90, src/tools/initialize/grid).
"""
from __future__ import annotations

import dataclasses
import struct

import numpy as np


@dataclasses.dataclass(frozen=True)
class Axis:
    nodes: np.ndarray        # float64 node positions, shape (n,)
    periodic: bool
    uniform: bool
    scale: float             # domain length (periodic: includes wrap spacing)

    @property
    def size(self) -> int:
        return int(self.nodes.shape[0])


@dataclasses.dataclass(frozen=True)
class Grid:
    x: Axis
    y: Axis
    z: Axis

    @property
    def shape(self):
        return (self.x.size, self.y.size, self.z.size)

    def axis(self, i: int) -> Axis:
        return (self.x, self.y, self.z)[i]


def make_axis(nodes: np.ndarray, periodic: bool) -> Axis:
    nodes = np.asarray(nodes, dtype=np.float64)
    n = nodes.shape[0]
    if n > 1:
        scale = float(nodes[-1] - nodes[0])
        if periodic:
            # periodic domain includes the wrap-around spacing
            # (cf. reference fdm.f90:164)
            scale = scale * (1.0 + 1.0 / (n - 1))
    else:
        scale = 1.0
    uniform = True
    if n > 2:
        d = np.diff(nodes)
        uniform = bool(np.max(np.abs(d - d[0])) <= 1e-10 * np.abs(d[0]))
    return Axis(nodes=nodes, periodic=periodic, uniform=uniform, scale=scale)


# ---------------------------------------------------------------------------
# Segment-based grid generation -- faithful port of the reference inigrid
# (src/tools/initialize/grid/grid_main.f90:36-120, grid_local.f90).
# Each direction is a list of segments; `scales_N` in the INI is the
# physical END of segment N on the uniform reference grid; the stretching
# maps may move the actual end point (as in the reference).
# ---------------------------------------------------------------------------

def _bld_tanh(x: np.ndarray, vals) -> np.ndarray:
    """GTYPE_TANH (opts=5/'tanh'): dx/ds = 1 + sum (f_i-1) sigmoid((s-s_i)/d_i)
    integrated analytically: x += sum (f_i-1) d_i softplus((x-s_i)/d_i),
    anchored at the segment start (grid_local.f90:34-69). vals is strided
    (st, f, delta) triples, up to 3 modes."""
    work = np.zeros_like(x)
    for im in range(3):
        if 3 * im + 2 >= len(vals):
            break
        st, f, delta = vals[3 * im], vals[3 * im + 1], vals[3 * im + 2]
        if abs(delta) > 0.0:
            work = work + (f - 1.0) * delta * np.logaddexp(
                (x - st) / delta, 0.0)
    work = work - work[0]
    return x + work


def _bld_exp(x: np.ndarray, vals) -> np.ndarray:
    """GTYPE_EXP (opts=6/'exp'): dx/ds = prod [1+exp((s-s_i)/d_i)]^(d_i f_i/h0)
    integrated with the 6th-order compact Int1 system, matching the
    reference's FDM_Int1_Solve-based construction (grid_local.f90:71-133)."""
    n = x.shape[0]
    ds = (x[-1] - x[0]) / (n - 1)
    rhs = np.ones_like(x)
    for im in range(3):
        if 3 * im + 2 >= len(vals):
            break
        st, f, delta = vals[3 * im], vals[3 * im + 1], vals[3 * im + 2]
        df = f / ds
        if abs(delta) > 0.0:
            rhs = rhs * np.exp(df * delta * np.logaddexp((x - st) / delta,
                                                         0.0))
    # compact 6th-order cumulative integral: solve u' = rhs, u(0) = x[0]
    from tlab_tpu_torch.fdm.plan import build_deriv_plan
    from tlab_tpu_torch.ops.elliptic_factorize import build_int1_pencil
    plan = build_deriv_plan(make_axis(x, False))
    M0, _, R = build_int1_pencil(plan, "min")
    f_vec = R @ rhs
    f_vec[0] = x[0]
    return np.linalg.solve(M0, f_vec)


def _bld_therest(x: np.ndarray, opts, vals) -> np.ndarray:
    """Options 1 (Colonius-Lele-Moin), 2/3 (polynomial), 4 (geometric)
    (grid_local.f90:137-320 BLD_THEREST + BLD_CONSTANTS)."""
    n = x.shape[0]
    vbeg, vend = x[0], x[-1]
    iopt1 = opts[0]
    iopt2 = opts[1] if len(opts) > 1 else 1
    v = list(vals) + [0.0] * (4 - len(vals))
    eta = np.arange(n, dtype=np.float64) / max(n - 1, 1)
    if iopt1 == 1:                      # Colonius, Lele & Moin
        x3 = vend - vbeg
        x2 = v[3] - vbeg
        a = float(n - 1) * v[0]
        b = (a * (1.0 + v[1] / v[0]) - x3) / (v[1] / v[0])
        c = v[2] / v[0] - 1.0
        c = np.log(v[1] / (c * v[0])) / (b - x2)
        d = v[1] / (c * v[0])
        e = vbeg
        valmx = a + d * np.log(np.exp(c * (a - b)) + 1.0 - np.exp(-b * c))
        a *= x3 / valmx
        b *= x3 / valmx
        c /= x3 / valmx
        d *= x3 / valmx
        out = e + a * eta + d * np.log(
            np.exp(c * (a * eta - b)) + 1.0 - np.exp(-b * c))
        out[0] = vbeg
        return out
    if iopt1 == 2:                      # 2nd-order polynomial
        if iopt2 == 1:                  # cluster at i=1
            pts = [(vbeg, 1), (vbeg + v[0], 2), (vend, n)]
        else:                           # cluster at i=imax
            pts = [(vbeg, 1), (vend - v[0], n - 1), (vend, n)]
        (x1, i1), (x2, i2), (x3, i3) = pts
        z1, z2, z3 = [(i - 1) / (n - 1) for i in (i1, i2, i3)]
        den = (-z1 + z2) * (-z1 + z3) * (-z2 + z3)
        a = (-(x3 * z1 ** 2 * z2) + x3 * z1 * z2 ** 2 + x2 * z1 ** 2 * z3
             - x1 * z2 ** 2 * z3 - x2 * z1 * z3 ** 2
             + x1 * z2 * z3 ** 2) / den
        b = (-(x2 * z1 ** 2) + x3 * z1 ** 2 + x1 * z2 ** 2 - x3 * z2 ** 2
             - x1 * z3 ** 2 + x2 * z3 ** 2) / den
        c = (x2 * z1 - x3 * z1 - x1 * z2 + x3 * z2 + x1 * z3
             - x2 * z3) / den
        a = a - (a + b * z1 + c * z1 * z1 - x1)
        out = a + b * eta + c * eta * eta
        out[0] = vbeg
        return out
    if iopt1 == 3:                      # 3rd-order polynomial
        if iopt2 == 1:                  # cluster at both ends
            pts = [(vbeg, 1), (vbeg + v[0], 2), (vend - v[1], n - 1),
                   (vend, n)]
        else:                           # cluster at an internal point
            pts = [(vbeg, 1), (v[1] - v[0] / 2.0, int(v[2] * n)),
                   (v[1] + v[0] / 2.0, int(v[2] * n) + 1), (vend, n)]
        zs = np.array([(i - 1) / (n - 1) for _, i in pts])
        xs_p = np.array([p for p, _ in pts])
        # cubic through 4 (z, x) points (Vandermonde; algebraically the
        # closed forms in BLD_CONSTANTS iopt1=3)
        coef = np.linalg.solve(np.vander(zs, 4, increasing=True), xs_p)
        a, b, c, d = coef
        a = a - (a + b * zs[0] + c * zs[0] ** 2 + d * zs[0] ** 3 - xs_p[0])
        out = a + b * eta + c * eta ** 2 + d * eta ** 3
        out[0] = vbeg
        return out
    if iopt1 == 4:                      # geometric progression
        out = x.copy()
        dx = 1.0
        for i in range(1, n):
            dx *= v[0]
            out[i] = out[i - 1] + dx
        return out
    raise ValueError(f"unknown grid segment option {iopt1}")


def _grid_mirror(x: np.ndarray) -> np.ndarray:
    """GRID_MIRROR (grid_main.f90:245-270): shift so the midpoint interval
    straddles 0, then reflect the upper half onto the lower."""
    n = x.shape[0]
    out = x.copy()
    offset = (out[n // 2] - out[n // 2 - 1]) / 2.0
    out[n // 2 - 1:] -= offset
    # fortran: do i = 1, imax/2 - 1: x(i) = -x(imax + 1 - i)
    for i in range(n // 2 - 1):
        out[i] = -out[n - 1 - i]
    return out


def build_axis_reference(segments, periodic: bool, mirrored: bool = False,
                         fixed_scale: float = -1.0) -> Axis:
    """Reference inigrid construction for one direction.

    segments: list of dicts with keys n (points), end (physical end of the
    segment's uniform reference grid), opts (string 'uniform'/'tanh'/'exp'
    or list of ints), vals (stretching parameters). A periodic axis drops
    the last (wrap-duplicate) node, and mirrored grids are reflected about
    the half-interval (grid_main.f90:56-112)."""
    total = segments[0]["n"]
    for seg in segments[1:]:
        total += seg["n"] - 1
    if mirrored:
        total = 2 * total - 2
    nodes = np.zeros(total)
    iloc = total // 2 - 1 if mirrored else 0
    nodes[iloc] = 0.0
    for seg in segments:
        n = seg["n"]
        if n <= 1:
            continue
        part = np.linspace(nodes[iloc], seg["end"], n)
        opts = seg.get("opts", "uniform")
        vals = seg.get("vals", seg.get("params", ()))
        if opts in ("uniform", 0, [0]):
            pass
        elif opts in ("tanh", 5) or opts == [5]:
            part = _bld_tanh(part, vals)
        elif opts in ("exp", "exponential", 6) or opts == [6]:
            part = _bld_exp(part, vals)
        else:
            iopts = opts if isinstance(opts, (list, tuple)) else [int(opts)]
            part = _bld_therest(part, [int(o) for o in iopts], vals)
        nodes[iloc: iloc + n] = part
        iloc += n - 1
    if mirrored:
        nodes = _grid_mirror(nodes)
    if fixed_scale > 0.0:
        old = nodes[-1] - nodes[0]
        nodes = nodes / old * fixed_scale
        if nodes[0] == 0.0:
            # pin the end node exactly (reference grid_main.f90:103-108);
            # the reference applies this pin unconditionally, which
            # DEFORMS mirrored grids (nodes(1) != 0, e.g. its Case43:
            # top node jumps 0.99 -> 2.0) -- deliberate deviation: only
            # pin when the axis starts at the origin
            nodes[-1] = fixed_scale
    if periodic:
        nodes = nodes[:-1]
    return make_axis(nodes, periodic)


def build_axis_from_segments(segments, periodic: bool, mirrored: bool = False,
                             fixed_scale: float = -1.0) -> Axis:
    """Compatibility wrapper: accepts segments keyed by either the legacy
    'scale' (segment length) or the reference 'end' (uniform-grid end)."""
    segs = []
    x_end = 0.0
    for seg in segments:
        end = seg.get("end")
        if end is None:
            x_end += seg["scale"]
            end = x_end
        else:
            x_end = end
        segs.append({"n": seg["n"], "end": end,
                     "opts": seg.get("opts", "uniform"),
                     "vals": seg.get("vals", seg.get("params", ()))})
    return build_axis_reference(segs, periodic, mirrored=mirrored,
                                fixed_scale=fixed_scale)


def uniform_grid(nx, ny, nz, lx, ly, lz,
                 periodic=(True, False, True)) -> Grid:
    """Convenience constructor for uniform box grids."""
    def ax(n, length, per):
        if per:
            nodes = np.arange(n) * (length / n)
        else:
            nodes = np.linspace(0.0, length, n) if n > 1 else np.zeros(1)
        return make_axis(nodes, per)
    return Grid(ax(nx, lx, periodic[0]), ax(ny, ly, periodic[1]),
                ax(nz, lz, periodic[2]))


# ---------------------------------------------------------------------------
# Reference-format grid file I/O (Fortran sequential unformatted, cf.
# src/base/tlab_grid.f90:26-90: 3 record groups of sizes, scales, nodes).
# ---------------------------------------------------------------------------

def read_reference_grid(path: str, byteorder: str = "<") -> Grid:
    with open(path, "rb") as fh:
        data = fh.read()
    off = [0]

    def rec():
        n = struct.unpack_from(byteorder + "i", data, off[0])[0]
        payload = data[off[0] + 4: off[0] + 4 + n]
        tail = struct.unpack_from(byteorder + "i", data, off[0] + 4 + n)[0]
        assert tail == n, "corrupt Fortran record"
        off[0] += 8 + n
        return payload

    sizes = np.frombuffer(rec(), dtype=byteorder + "i4")
    scales = np.frombuffer(rec(), dtype=byteorder + "f8")
    nodes = [np.frombuffer(rec(), dtype=byteorder + "f8") for _ in range(3)]
    axes = []
    for i in range(3):
        assert nodes[i].shape[0] == sizes[i]
        # periodicity is not stored in the file; infer from scale vs extent
        extent = nodes[i][-1] - nodes[i][0] if sizes[i] > 1 else 0.0
        per = sizes[i] > 1 and abs(scales[i] - extent) > 1e-12 * max(scales[i], 1.0)
        axes.append(make_axis(nodes[i], per))
    return Grid(*axes)


def write_reference_grid(path: str, grid: Grid, byteorder: str = "<") -> None:
    def rec(payload: bytes) -> bytes:
        n = struct.pack(byteorder + "i", len(payload))
        return n + payload + n

    with open(path, "wb") as fh:
        sizes = np.array([grid.x.size, grid.y.size, grid.z.size],
                         dtype=byteorder + "i4")
        scales = np.array([grid.x.scale, grid.y.scale, grid.z.scale],
                          dtype=byteorder + "f8")
        fh.write(rec(sizes.tobytes()))
        fh.write(rec(scales.tobytes()))
        for ax in (grid.x, grid.y, grid.z):
            fh.write(rec(ax.nodes.astype(byteorder + "f8").tobytes()))
