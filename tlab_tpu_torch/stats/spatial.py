"""Spatial-mode running statistics (port of
tlab_tpu/stats/spatial.py, after the reference's
src/statistics/avg_spatial.f90 + tools/dns/avg_flow_zt_reduce.f90).

For spatially developing flows, statistics are accumulated over (z, t) at
every (x, y) point: running sums of the moments, flushed/restarted with the
simulation (the reference's st<itime> files).  Each accumulation is one
reduction on the run's device; only the stacked (K, nx, ny) z-means come to
the host, where they add into float64 sums.  The sums, the station tables
and the files are tlab_tpu's NumPy code, copied.

The compressible set adds the density-weighted (Favre) families and the
full MA_* register set (stats/spatial_registers.py): one device reduction
of a conservative state (make_comp_spatial_reducer) gives every family's
z-means as one (K, nx, ny) stack, which accumulate_comp_stack copies to the
host once; favre_station_table and register_station_table read the sums.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tlab_tpu_torch.stats import spatial_registers as sreg


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
    # density-weighted (Favre) accumulators for the compressible spatial
    # mode: the MA_R/RR/R3/R4, MA_T..T4, MA_VIS/VIS2, MA_RU.., MA_RUU..,
    # MA_RTT, MA_TU.. families of avgij_map.h:5-58,70,231-242 as raw
    # (z,t)-sums: (len(COMP_NAMES), nx, ny)
    comp_sums: np.ndarray = None
    # the FULL reference register set (238 MA_* sums, avgij_map.h;
    # stats/spatial_registers.py): (len(NAMES), nx, ny)
    reg_sums: np.ndarray = None

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
    COMP_NAMES = ("r", "r2", "r3", "r4", "T", "T2", "T3", "T4",
                  "vis", "vis2",
                  "ru", "rv", "rw", "rT", "p", "p2",
                  "ruu", "rvv", "rww", "ruv", "ruw", "rvw",
                  "rTT", "ruT", "rvT", "rwT",
                  "ruuv", "rvvv", "rwwv", "ruvv", "ruwv", "rvwv")

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

    def accumulate_comp_stack(self, stacked) -> None:
        """Add one make_comp_spatial_reducer stack (a device tensor, copied
        to the host here in one piece, or a host array) into the running
        sums, in the family order the reducer fills."""
        if isinstance(stacked, torch.Tensor):
            stacked = stacked.to("cpu", torch.float64).numpy()
        nxy = self.sums.shape[2:]
        k = 0
        nv = len(self.names)
        self.sums += stacked[k:k + 4 * nv].reshape((nv, 4) + nxy)
        k += 4 * nv
        self.pair_sums += stacked[k:k + len(self.pairs)]
        k += len(self.pairs)
        self.grad_sums += stacked[k:k + 18].reshape((9, 2) + nxy)
        k += 18
        self.gradx_sums += stacked[k:k + len(self.GRADX_PAIRS)]
        k += len(self.GRADX_PAIRS)
        self.p_sums += stacked[k:k + 14]
        k += 14
        self.triple_sums += stacked[k:k + len(self.TRIPLES)]
        k += len(self.TRIPLES)
        if self.comp_sums is None:
            self.comp_sums = np.zeros((len(self.COMP_NAMES),) + nxy)
        self.comp_sums += stacked[k:k + len(self.COMP_NAMES)]
        k += len(self.COMP_NAMES)
        if self.reg_sums is None:
            self.reg_sums = np.zeros((len(sreg.NAMES),) + nxy)
        self.reg_sums += stacked[k:k + len(sreg.NAMES)]
        k += len(sreg.NAMES)
        assert k == stacked.shape[0], (k, stacked.shape)
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

    # -- density-weighted (Favre) station tables ---------------------------
    def _c(self, nm: str) -> np.ndarray:
        return self.comp_sums[self.COMP_NAMES.index(nm)] \
            / max(self.n_samples, 1)

    def favre_station_table(self, stations) -> dict:
        """Per-station Favre tables from the density-weighted sums, the
        compressible AVG_FLOW_ZT_REDUCE analog (avg_flow_zt_reduce.f90:
        mean/fluctuation blocks built on the avgij_map.h MA_R*/MA_RU*/
        MA_RUU* accumulators): mean density moments, Favre velocities,
        Favre Reynolds stresses, Favre temperature stats, turbulent heat
        fluxes, Favre turbulent-transport fluxes of the stresses."""
        if self.comp_sums is None:
            return {}
        rR = self._c("r")
        rR2 = self._c("r2") - rR * rR
        rR3 = self._c("r3") - 3 * rR * self._c("r2") + 2 * rR ** 3
        rR4 = self._c("r4") - 4 * rR * self._c("r3") \
            + 6 * rR ** 2 * self._c("r2") - 3 * rR ** 4
        fU = self._c("ru") / rR
        fV = self._c("rv") / rR
        fW = self._c("rw") / rR
        fT = self._c("rT") / rR
        rT = self._c("T")
        rT2 = self._c("T2") - rT * rT
        rP = self._c("p")
        rP2 = self._c("p2") - rP * rP
        fmean = {"u": fU, "v": fV, "w": fW}
        Rf = {}
        for (a, b), nm in zip(self.COMP_PAIRS,
                              ("ruu", "rvv", "rww", "ruv", "ruw", "rvw")):
            Rf[a + b] = self._c(nm) / rR - fmean[a] * fmean[b]
        fT2 = self._c("rTT") / rR - fT * fT
        heat = {c: self._c("r" + c + "T") / rR - fmean[c] * fT
                for c in ("u", "v", "w")}
        # Favre turbulent transport <rho ui'' uj'' v''> from the raw
        # quartic sums (expansion around the Favre means)
        quart = {"uu": "ruuv", "vv": "rvvv", "ww": "rwwv",
                 "uv": "ruvv", "uw": "ruwv", "vw": "rvwv"}
        Tf = {}
        for (a, b), _ in zip(self.COMP_PAIRS, quart):
            tag = a + b
            raw = self._c(quart[tag])
            rab = self._c("r" + tag)
            rav = self._c({"u": "ruv", "v": "rvv", "w": "rvw"}[a])
            rbv = self._c({"u": "ruv", "v": "rvv", "w": "rvw"}[b])
            A, B, Vm = fmean[a], fmean[b], fV
            Tf[tag] = raw - A * rbv - B * rav - Vm * rab \
                + 2.0 * rR * A * B * Vm
        out = {}
        for ix in stations:
            cols = {"rR": rR[ix], "rR2": rR2[ix], "rR3": rR3[ix],
                    "rR4": rR4[ix],
                    "fU": fU[ix], "fV": fV[ix], "fW": fW[ix],
                    "rT": rT[ix], "fT": fT[ix], "rT2": rT2[ix],
                    "fT2": fT2[ix], "rP": rP[ix], "rP2": rP2[ix],
                    "rVis": self._c("vis")[ix]}
            for tag, m in Rf.items():
                cols[f"fR{tag}"] = m[ix]
            for c, m in heat.items():
                cols[f"fR{c}T"] = m[ix]
            for tag, m in Tf.items():
                cols[f"fT{tag}y"] = m[ix]
            out[ix] = cols
        return out

    # -- restart (reference st<itime>, avg_spatial.f90:19-29) ---------------
    def save(self, path: str, itime: int) -> None:
        extra = {}
        for key in ("grad_sums", "gradx_sums", "p_sums", "triple_sums",
                    "comp_sums", "reg_sums"):
            v = getattr(self, key)
            if v is not None:
                extra[key] = v
        np.savez(path, names=np.asarray(self.names), sums=self.sums,
                 pairs=np.asarray(["|".join(p) for p in self.pairs]),
                 pair_sums=self.pair_sums,
                 n_samples=self.n_samples, itime=itime, **extra)

    @classmethod
    def load(cls, path: str) -> "SpatialStats":
        """A SpatialStats from a st<itime>.npz of either package."""
        d = np.load(path, allow_pickle=False)
        pairs = tuple(tuple(s.split("|")) for s in d["pairs"]) \
            if "pairs" in d else ()
        opt = {k: d[k] if k in d else None
               for k in ("grad_sums", "gradx_sums", "p_sums",
                         "triple_sums", "comp_sums", "reg_sums")}
        return cls(names=tuple(str(n) for n in d["names"]), sums=d["sums"],
                   pairs=pairs,
                   pair_sums=d["pair_sums"] if "pair_sums" in d else None,
                   n_samples=int(d["n_samples"]), **opt)


def make_comp_spatial_reducer(sim, stats: "SpatialStats"):
    """CompState -> (K, nx, ny) stacked z-means for the COMPRESSIBLE spatial
    mode, on the state's device: the primitive decomposition (the mixture's
    or AirWater's where the set has one), the nine velocity and nine scalar
    gradients, the stress tensor, and EVERY running-sum family (moments,
    pairs, grad/gradx, p, triples, the Favre COMP_NAMES products, and the
    full MA_* register set); only the stack comes to the host, through
    stats.accumulate_comp_stack (the reference reduces rank-local with no
    gather, avg_flow_zt_reduce.f90:1-60 + avg_spatial.f90:19-29)."""
    from tlab_tpu_torch.dycore import compressible as comp_mod
    from tlab_tpu_torch.dycore import incompressible as dyn
    from tlab_tpu_torch.physics import eos

    P = sim.P
    c = sim.comp
    visc = sim.nsp.visc
    names = stats.names
    pairs = stats.pairs
    gnames = stats.GRAD_NAMES
    gx_pairs = stats.GRADX_PAIRS
    triples = stats.TRIPLES
    comp_names = stats.COMP_NAMES

    def d1(axis_name, ax, f):
        return dyn._d1(P, axis_name, ax, f)

    def zm(a):
        return torch.mean(a, dim=2)

    def compute(U):
        rho = U.rho
        if c.get("aw") is not None:
            u, v, w, T, p, _, _ = comp_mod.primitive_airwater(U, c["aw"])
        else:
            mix = c.get("mixture")
            fn = comp_mod.primitive if c["energy"] == "total" \
                else comp_mod.primitive_internal
            u, v, w, T, p = fn(P, U, c["gamma"], c["mach"], mix=mix)
        ns = U.rhos.shape[0] if U.rhos is not None else 0
        za = {"u": u, "v": v, "w": w}
        for i in range(ns):
            za[f"s{i + 1}"] = U.rhos[i] / rho
        vis = None
        gas = c.get("gas")
        if gas is not None and getattr(gas, "transport", "none") != "none":
            vis = eos.viscosity(gas, T)
        g = {}
        for cname, comp_f in (("u", u), ("v", v), ("w", w)):
            for aname, ax in (("x", 0), ("y", 1), ("z", 2)):
                g[cname + aname] = d1(aname, ax, comp_f)
        sg = {}
        for nm, fld in (("r", rho), ("p", p), ("T", T)):
            for aname, ax in (("x", 0), ("y", 1), ("z", 2)):
                sg[nm + aname] = d1(aname, ax, fld)
        tkk = (d1("x", 0, sg["Tx"]) + d1("y", 1, sg["Ty"])
               + d1("z", 2, sg["Tz"]))
        base = sreg.build_base(u, v, w, p, rho, T, g, sg, vis=vis,
                               visc=visc, z1=za.get("s1"), Tkk=tkk)
        base["tauxkk"] = (d1("x", 0, base["tauxx"])
                          + d1("y", 1, base["tauxy"])
                          + d1("z", 2, base["tauxz"]))
        base["tauykk"] = (d1("x", 0, base["tauxy"])
                          + d1("y", 1, base["tauyy"])
                          + d1("z", 2, base["tauyz"]))
        base["tauzkk"] = (d1("x", 0, base["tauxz"])
                          + d1("y", 1, base["tauyz"])
                          + d1("z", 2, base["tauzz"]))

        outs = []
        for n in names:                      # moments, host-accumulate order
            a = za[n]
            a2 = a * a
            outs += [zm(a), zm(a2), zm(a2 * a), zm(a2 * a2)]
        for na, nb in pairs:
            outs.append(zm(za[na] * za[nb]))
        gl = [g[n] for n in gnames]
        for k in range(9):
            outs += [zm(gl[k]), zm(gl[k] * gl[k])]
        for ka, kb in gx_pairs:
            outs.append(zm(gl[ka] * gl[kb]))
        outs += [zm(p), zm(p * p)]
        for n in ("u", "v", "w"):
            outs.append(zm(p * za[n]))
        for k in range(9):
            outs.append(zm(p * gl[k]))
        for na, nb, nc in triples:
            outs.append(zm(za[na] * za[nb] * za[nc]))
        vis_f = base["vis"]
        uf, vf, wf = za["u"], za["v"], za["w"]
        prods = {
            "r": rho, "r2": rho * rho, "r3": rho ** 3, "r4": rho ** 4,
            "T": T, "T2": T * T, "T3": T ** 3, "T4": T ** 4,
            "vis": vis_f, "vis2": vis_f * vis_f,
            "ru": rho * uf, "rv": rho * vf, "rw": rho * wf,
            "rT": rho * T, "p": p, "p2": p * p,
            "ruu": rho * uf * uf, "rvv": rho * vf * vf,
            "rww": rho * wf * wf,
            "ruv": rho * uf * vf, "ruw": rho * uf * wf,
            "rvw": rho * vf * wf,
            "rTT": rho * T * T,
            "ruT": rho * uf * T, "rvT": rho * vf * T, "rwT": rho * wf * T,
            "ruuv": rho * uf * uf * vf, "rvvv": rho * vf ** 3,
            "rwwv": rho * wf * wf * vf, "ruvv": rho * uf * vf * vf,
            "ruwv": rho * uf * wf * vf, "rvwv": rho * vf * wf * vf,
        }
        for nm in comp_names:
            outs.append(zm(prods[nm]))
        for name in sreg.NAMES:
            acc = None
            for addend in sreg.REGISTERS[name]:
                prod = None
                for key in addend:
                    f = base[key]
                    prod = f if prod is None else prod * f
                acc = prod if acc is None else acc + prod
            outs.append(zm(acc))
        return torch.stack(outs)

    return compute


def register_station_table(stats: "SpatialStats", stations) -> dict:
    """The full MA_* register table at the x-stations, keyed by station
    for write_station_budgets: {station: {MA_name: (ny,)}} -- the
    AVG_FLOW_ZT raw-register output with the reference's names
    (avgij_map.h)."""
    if stats.reg_sums is None:
        return {}
    tab = sreg.as_table(stats.reg_sums, stats.n_samples)
    return {int(ix): {name: v[int(ix)] for name, v in tab.items()}
            for ix in stations}


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
