"""Spatial-mode running statistics, the incompressible half (port of
tlab_tpu/stats/spatial.py, after the reference's
src/statistics/avg_spatial.f90 + tools/dns/avg_flow_zt_reduce.f90).

For spatially developing flows, statistics are accumulated over (z, t) at
every (x, y) point: running sums of the moments, flushed/restarted with the
simulation (the reference's st<itime> files).  Each accumulation is one
reduction on the run's device; only the stacked (K, nx, ny) z-means come to
the host, where they add into float64 sums.  The sums, the station tables
and the files are tlab_tpu's NumPy code, copied.

The density-weighted (Favre) families, the MA_* register set and their
station tables belong to the compressible set (ROADMAP A13b).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


_DEFAULT_PAIRS = (("u", "v"), ("u", "w"), ("v", "w"))


@dataclasses.dataclass
class SpatialStats:
    """Running (z,t) moment sums, shape (nvar, nmom, nx, ny); cross-moment
    sums (npair, nx, ny) give the Reynolds stresses / turbulent fluxes at
    every x-station (reference avg_flow_zt_reduce.f90 running sums)."""

    names: tuple
    sums: np.ndarray
    pairs: tuple = ()
    pair_sums: np.ndarray = None
    n_samples: int = 0

    # gradient-correlation sums (reference MA_Ux..MA_Wz2 + the cross
    # products MA_VxUy.., avgij_map.h:14-37): (9, 2, nx, ny) + (15, nx, ny)
    grad_sums: np.ndarray = None
    gradx_sums: np.ndarray = None
    # pressure correlations (MA_P, MA_PP, MA_PU.., + the nine p*grad
    # products feeding the pressure-strain, avgij_map.h:51-53,62-69):
    # (14, nx, ny)
    p_sums: np.ndarray = None
    # third moments for Rij turbulent transport: the six <ui uj v> and the
    # six <ui uj u> raw products (y- and x-direction fluxes): (12, nx, ny)
    triple_sums: np.ndarray = None

    GRAD_NAMES = ("ux", "uy", "uz", "vx", "vy", "vz", "wx", "wy", "wz")
    # first 6: vorticity/dilatation pairs; last 9: dissipation pairs
    # <gi_a gj_a> for (i,j) in (uv, uw, vw), a in (x, y, z)
    GRADX_PAIRS = ((3, 1), (6, 2), (7, 5), (0, 4), (0, 8), (4, 8),
                   (0, 3), (1, 4), (2, 5),
                   (0, 6), (1, 7), (2, 8),
                   (3, 6), (4, 7), (5, 8))
    COMP_PAIRS = (("u", "u"), ("v", "v"), ("w", "w"),
                  ("u", "v"), ("u", "w"), ("v", "w"))
    TRIPLES = tuple((a, b, "v") for a, b in COMP_PAIRS) \
        + tuple((a, b, "u") for a, b in COMP_PAIRS)

    @classmethod
    def create(cls, nx: int, ny: int, names=("u", "v", "w", "s1"),
               pairs=None):
        names = tuple(names)
        if pairs is None:
            pairs = tuple(p for p in _DEFAULT_PAIRS
                          if p[0] in names and p[1] in names)
            pairs = pairs + tuple(("v", n) for n in names
                                  if n.startswith("s"))
        return cls(names=names,
                   sums=np.zeros((len(names), 4, nx, ny)),
                   pairs=tuple(pairs),
                   pair_sums=np.zeros((len(pairs), nx, ny)), n_samples=0,
                   grad_sums=np.zeros((9, 2, nx, ny)),
                   gradx_sums=np.zeros((len(cls.GRADX_PAIRS), nx, ny)),
                   p_sums=np.zeros((14, nx, ny)),
                   triple_sums=np.zeros((len(cls.TRIPLES), nx, ny)))

    def reduce_device(self, fields: dict, grads: dict = None,
                      p=None) -> torch.Tensor:
        """The (K, nx, ny) z-means of one accumulation, computed where the
        fields are, in tlab_tpu's family order: moments 1..4 of each field,
        the pairs, the gradients and their squares and cross products, the
        pressure correlations, the triple products."""
        names, pairs = self.names, self.pairs

        def zm(a):
            return torch.mean(a, dim=2)

        outs = []
        za = {n: fields[n] for n in names}
        for n in names:
            a = za[n]
            a2 = a * a
            outs += [zm(a), zm(a2), zm(a2 * a), zm(a2 * a2)]
        for na, nb in pairs:
            outs.append(zm(za[na] * za[nb]))
        g = None
        if grads is not None:
            g = [grads[n] for n in self.GRAD_NAMES]
            for k in range(9):
                outs += [zm(g[k]), zm(g[k] * g[k])]
            for ka, kb in self.GRADX_PAIRS:
                outs.append(zm(g[ka] * g[kb]))
        if p is not None:
            outs += [zm(p), zm(p * p)]
            for n in ("u", "v", "w"):
                outs.append(zm(p * za[n]) if n in za
                            else torch.zeros_like(outs[0]))
            if g is not None:
                for k in range(9):
                    outs.append(zm(p * g[k]))
        if all(n in za for n in ("u", "v", "w")):
            for na, nb, nc in self.TRIPLES:
                outs.append(zm(za[na] * za[nb] * za[nc]))
        return torch.stack(outs)

    def accumulate_device(self, fields: dict, grads: dict = None,
                          p=None) -> None:
        """Add one sample: the z-mean reductions run on the fields' device
        (reduce_device) and only the stacked (K, nx, ny) result comes to the
        host -- the reference reduces in place, avg_flow_zt_reduce.f90.
        fields: name -> (nx, ny, nz); grads: GRAD_NAMES -> field; p: the
        pressure."""
        stacked = self.reduce_device(fields, grads, p).to(
            "cpu", torch.float64).numpy()          # ONE (K, nx, ny) copy
        k = 0
        for i in range(len(self.names)):
            self.sums[i] += stacked[k:k + 4]
            k += 4
        self.pair_sums += stacked[k:k + len(self.pairs)]
        k += len(self.pairs)
        if grads is not None and self.grad_sums is not None:
            for j in range(9):
                self.grad_sums[j] += stacked[k:k + 2]
                k += 2
            ngx = self.gradx_sums.shape[0]
            self.gradx_sums += stacked[k:k + ngx]
            k += len(self.GRADX_PAIRS)
        if p is not None and self.p_sums is not None:
            ncols = 5 + (9 if grads is not None else 0)
            self.p_sums[:min(ncols, self.p_sums.shape[0])] += \
                stacked[k:k + min(ncols, self.p_sums.shape[0])]
            k += ncols
        if all(n in self.names for n in ("u", "v", "w")) \
                and self.triple_sums is not None:
            nt = self.triple_sums.shape[0]
            self.triple_sums += stacked[k:k + nt]
            k += len(self.TRIPLES)
        self.n_samples += 1

    def mean(self, name: str) -> np.ndarray:
        i = self.names.index(name)
        return self.sums[i, 0] / max(self.n_samples, 1)

    def covariance(self, na: str, nb: str) -> np.ndarray:
        """<a'b'> = <ab> - <a><b> at every (x, y)."""
        j = self.pairs.index((na, nb))
        n = max(self.n_samples, 1)
        return (self.pair_sums[j] / n
                - self.mean(na) * self.mean(nb))

    def skewness(self, name: str) -> np.ndarray:
        i = self.names.index(name)
        n = max(self.n_samples, 1)
        m = self.sums[i, 0] / n
        m2 = self.sums[i, 1] / n - m ** 2
        m3 = self.sums[i, 2] / n - 3 * m * self.sums[i, 1] / n + 2 * m ** 3
        # guard AFTER the power (tiny**1.5 underflows to 0 -> 0/0 NaN)
        return m3 / np.maximum(np.maximum(m2, 0.0) ** 1.5, 1e-300)

    def station_table(self, x_nodes, y_nodes, stations) -> dict:
        """Per-station profile tables (reference avg_spatial.f90 stations):
        stations is a list of x indices; returns {i_x: {col: (ny,)}}."""
        out = {}
        for ix in stations:
            cols = {}
            for name in self.names:
                cols[f"r{name.upper()}"] = self.mean(name)[ix]
                cols[f"R{name}{name}"] = self.variance(name)[ix]
            for (na, nb) in self.pairs:
                cols[f"R{na}{nb}"] = self.covariance(na, nb)[ix]
            out[ix] = cols
        return out

    def reduce_station_table(self, stations, visc: float, d1y=None) -> dict:
        """Derived per-station tables, the avg_flow_zt_reduce.f90 analog:
        means, Reynolds stresses, skewness/flatness, pseudo-dissipation
        (from the gradient-square sums), vorticity variances, pressure
        variance/velocity correlations, TKE turbulent transport."""
        n = max(self.n_samples, 1)
        out = {}
        gm = self.grad_sums[:, 0] / n if self.grad_sums is not None else None
        g2 = self.grad_sums[:, 1] / n if self.grad_sums is not None else None
        gx = self.gradx_sums / n if self.gradx_sums is not None else None
        for ix in stations:
            cols = {}
            for name in self.names:
                cols[f"r{name.upper()}"] = self.mean(name)[ix]
                cols[f"R{name}{name}"] = self.variance(name)[ix]
                cols[f"S{name.upper()}"] = self.skewness(name)[ix]
            for (na, nb) in self.pairs:
                cols[f"R{na}{nb}"] = self.covariance(na, nb)[ix]
            if gm is not None:
                # pseudo-dissipation: nu sum <g'^2> = nu sum (<g^2>-<g>^2)
                eps = sum(g2[k][ix] - gm[k][ix] ** 2 for k in range(9))
                cols["Eps"] = visc * eps
                # vorticity variances: e.g. <w_z'^2> with w_z = vx - uy
                # <(vx-uy)'^2> = var(vx) + var(uy) - 2 cov(vx, uy)
                vv = {k: g2[k][ix] - gm[k][ix] ** 2 for k in range(9)}
                cov_vxuy = gx[0][ix] - gm[3][ix] * gm[1][ix]
                cov_wxuz = gx[1][ix] - gm[6][ix] * gm[2][ix]
                cov_wyvz = gx[2][ix] - gm[7][ix] * gm[5][ix]
                cols["WZ2"] = vv[3] + vv[1] - 2.0 * cov_vxuy
                cols["WY2"] = vv[2] + vv[6] - 2.0 * cov_wxuz
                cols["WX2"] = vv[7] + vv[5] - 2.0 * cov_wyvz
            if self.p_sums is not None and self.n_samples:
                pm = self.p_sums[0][ix] / n
                cols["rP"] = pm
                cols["Rpp"] = self.p_sums[1][ix] / n - pm * pm
                for j, nm in enumerate(("u", "v", "w")):
                    if nm in self.names:
                        cols[f"Rp{nm}"] = self.p_sums[2 + j][ix] / n \
                            - pm * self.mean(nm)[ix]
            if self.triple_sums is not None and all(
                    nm in self.names for nm in ("u", "v", "w")) \
                    and d1y is not None:
                # turbulent transport of TKE: -d/dy <v'(u'^2+v'^2+w'^2)/2>
                t_u = self._triple_fluct("u", "u", "v")
                t_v = self._triple_fluct("v", "v", "v")
                t_w = self._triple_fluct("w", "w", "v")
                flux = 0.5 * (t_u + t_v + t_w)
                cols["Trp"] = -(np.asarray(d1y) @ flux[ix])
            out[ix] = cols
        return out

    # -- full per-station Rij budgets (avg_flow_zt_reduce.f90 analog) ------
    def _raw_pair(self, na: str, nb: str) -> np.ndarray:
        """<a b> raw second-moment map."""
        n = max(self.n_samples, 1)
        if na == nb:
            return self.sums[self.names.index(na), 1] / n
        if (na, nb) in self.pairs:
            return self.pair_sums[self.pairs.index((na, nb))] / n
        return self.pair_sums[self.pairs.index((nb, na))] / n

    def _triple_fluct(self, na: str, nb: str, nc: str) -> np.ndarray:
        """<a'b'c'> = <abc> - A<bc> - B<ac> - C<ab> + 2ABC from the raw
        accumulated triple products."""
        n = max(self.n_samples, 1)
        key = (na, nb, nc)
        if key not in self.TRIPLES:       # symmetric in the first two
            key = (nb, na, nc)
        abc = self.triple_sums[self.TRIPLES.index(key)] / n
        A, B, C = self.mean(na), self.mean(nb), self.mean(nc)
        return abc - A * self._raw_pair(nb, nc) - B * self._raw_pair(na, nc) \
            - C * self._raw_pair(na, nb) + 2.0 * A * B * C

    def station_budgets(self, stations, visc: float, d1x=None,
                        d1y=None) -> dict:
        """Full incompressible Rij budgets at the x-stations from the
        (z,t)-accumulated families (the avg_flow_zt_reduce.f90 station
        tables, pseudo-dissipation form):

          dRij/dt = Cij + Pij + PIij - Eij + Dij - Tijx_x - Tijy_y
                    - Gijx_x - Gijy_y

        Cij = -(U d/dx + V d/dy) Rij;  Pij = -(R_ik dUj/dxk + R_jk dUi/dxk);
        PIij = <p'(dui/dxj + duj/dxi)'>;  Eij = 2 nu <dui/dxk' duj/dxk'>;
        Dij = nu (d2/dx2 + d2/dy2) Rij;  Tij = <ui'uj'uk'> flux;
        Gij = <p'ui'> d_jk + <p'uj'> d_ik flux.  All derivatives are
        applied to the accumulated (nx, ny) maps at reduce time (d1x, d1y:
        dense derivative matrices), so only pointwise products are
        accumulated in-run."""
        n = max(self.n_samples, 1)
        dirs = ("x", "y", "z")
        gm = {}
        for k, gname in enumerate(self.GRAD_NAMES):
            gm[gname] = self.grad_sums[k, 0] / n
        pm = self.p_sums[0] / n
        pvel = {c: self.p_sums[2 + j] / n - pm * self.mean(c)
                for j, c in enumerate(("u", "v", "w"))}
        pgrad = {g: self.p_sums[5 + k] / n - pm * gm[g]
                 for k, g in enumerate(self.GRAD_NAMES)}

        def gradcov(ci, cj, a):
            """<gi_a' gj_a'>"""
            ki = self.GRAD_NAMES.index(ci + a)
            kj = self.GRAD_NAMES.index(cj + a)
            if ki == kj:
                raw = self.grad_sums[ki, 1] / n
            else:
                pair = (ki, kj) if (ki, kj) in self.GRADX_PAIRS else (kj, ki)
                raw = self.gradx_sums[self.GRADX_PAIRS.index(pair)] / n
            return raw - gm[ci + a] * gm[cj + a]

        def ddx(m):
            return np.asarray(d1x) @ m if d1x is not None \
                else np.zeros_like(m)

        def ddy(m):
            return m @ np.asarray(d1y).T if d1y is not None \
                else np.zeros_like(m)

        U, V = self.mean("u"), self.mean("v")
        Rmap = {(a, b): self._raw_pair(a, b) - self.mean(a) * self.mean(b)
                for a, b in self.COMP_PAIRS}

        def R(a, b):
            return Rmap[(a, b)] if (a, b) in Rmap else Rmap[(b, a)]

        axis_of = {"u": "x", "v": "y", "w": "z"}
        cols_map = {}
        for ci, cj in self.COMP_PAIRS:
            tag = axis_of[ci] + axis_of[cj]
            Rij = R(ci, cj)
            Cij = -(U * ddx(Rij) + V * ddy(Rij))
            # production contracts R_ik with dUj/dxk: the velocity index
            # of R pairs with the gradient DIRECTION via the k-sum
            Pij = np.zeros_like(Rij)
            for a, ck in zip(dirs, ("u", "v", "w")):
                Pij = Pij - R(ci, ck) * gm[cj + a] - R(cj, ck) * gm[ci + a]
            PIij = pgrad[ci + axis_of[cj]] + pgrad[cj + axis_of[ci]]
            Eij = np.zeros_like(Rij)
            for a in dirs:
                Eij = Eij + gradcov(ci, cj, a)
            Eij = 2.0 * visc * Eij
            Dij = visc * (ddx(ddx(Rij)) + ddy(ddy(Rij)))
            Tx = self._triple_fluct(ci, cj, "u")
            Ty = self._triple_fluct(ci, cj, "v")
            zero = np.zeros_like(Rij)
            Gx = (pvel[ci] if cj == "u" else zero) \
                + (pvel[cj] if ci == "u" else zero)
            Gy = (pvel[ci] if cj == "v" else zero) \
                + (pvel[cj] if ci == "v" else zero)
            Tflux = -ddx(Tx) - ddy(Ty)
            Gflux = -ddx(Gx) - ddy(Gy)
            cols_map[tag] = {
                f"R{tag}": Rij, f"C{tag}": Cij, f"P{tag}": Pij,
                f"PI{tag}": PIij, f"E{tag}": Eij, f"D{tag}": Dij,
                f"T{tag}x": Tx, f"T{tag}y": Ty, f"T{tag}_flux": Tflux,
                f"G{tag}_flux": Gflux,
                f"R{tag}_t": Cij + Pij + PIij - Eij + Dij + Tflux + Gflux,
            }
        out = {}
        for ix in stations:
            cols = {}
            for tag, cmap in cols_map.items():
                for name, m in cmap.items():
                    cols[name] = m[ix]
            out[ix] = cols
        return out

    def variance(self, name: str) -> np.ndarray:
        i = self.names.index(name)
        m = self.mean(name)
        return self.sums[i, 1] / max(self.n_samples, 1) - m * m

    # -- restart (reference st<itime>, avg_spatial.f90:19-29) ---------------
    def save(self, path: str, itime: int) -> None:
        extra = {}
        for key in ("grad_sums", "gradx_sums", "p_sums", "triple_sums"):
            v = getattr(self, key)
            if v is not None:
                extra[key] = v
        np.savez(path, names=np.asarray(self.names), sums=self.sums,
                 pairs=np.asarray(["|".join(p) for p in self.pairs]),
                 pair_sums=self.pair_sums,
                 n_samples=self.n_samples, itime=itime, **extra)

    @classmethod
    def load(cls, path: str) -> "SpatialStats":
        """A SpatialStats from a st<itime>.npz of either package (the
        compressible families of tlab_tpu's files are not read)."""
        d = np.load(path, allow_pickle=False)
        pairs = tuple(tuple(s.split("|")) for s in d["pairs"]) \
            if "pairs" in d else ()
        opt = {k: d[k] if k in d else None
               for k in ("grad_sums", "gradx_sums", "p_sums",
                         "triple_sums")}
        return cls(names=tuple(str(n) for n in d["names"]), sums=d["sums"],
                   pairs=pairs,
                   pair_sums=d["pair_sums"] if "pair_sums" in d else None,
                   n_samples=int(d["n_samples"]), **opt)


def write_station_budgets(path: str, x_nodes, y_nodes, tables: dict,
                          itime: int, rtime: float) -> None:
    """Reference-style station table file (the I column is the x-station
    index, as in IO_WRITE_AVERAGES' `I J Y` layout): one row per
    (station, y-node) with the full budget columns."""
    stations = sorted(tables.keys())
    if not stations:
        return
    names = list(tables[stations[0]].keys())
    with open(path, "w") as fh:
        fh.write(f"RTIME = {rtime:14.7E}\n")
        fh.write("GROUP = StationBudgets " + " ".join(names) + "\n")
        fh.write("I J Y X " + " ".join(names) + "\n")
        for ix in stations:
            cols = tables[ix]
            for j in range(len(y_nodes)):
                vals = " ".join(f"{np.asarray(cols[n])[j]: .8E}"
                                for n in names)
                fh.write(f"{ix + 1:5d} {j + 1:5d} {y_nodes[j]: .8E} "
                         f"{x_nodes[ix]: .8E} {vals}\n")


def state_fields(state) -> dict:
    out = {"u": state.u, "v": state.v, "w": state.w}
    for i in range(state.s.shape[0]):
        out[f"s{i + 1}"] = state.s[i]
    return out
