"""Phase-locked averaging of z-mean planes (port of tlab_tpu/stats/
phaseavg.py).

The reference's PhAvg machinery
(src/statistics/avg_phase.f90, enabled by [Iteration] PhaseAvg=<stride>):
every `stride` steps the z-averaged (x, y) planes of velocity, pressure,
scalars and the velocity stresses are accumulated into the phase slot
(itime // stride) mod n_slots, building the phase-locked mean over
repeated cycles (n_slots = restart_interval // stride planes per cycle,
avg_phase.f90:72-83).  The z-means are taken on the fields' device and
copied to the host as one (nplane, nx, ny) stack; the sums and counts are
float64 NumPy.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

_STRESSES = (("u", "u"), ("v", "v"), ("w", "w"),
             ("u", "v"), ("u", "w"), ("v", "w"))


@dataclasses.dataclass
class PhaseAverage:
    stride: int
    n_slots: int
    names: tuple
    sums: np.ndarray            # (n_slots, nfield, nx, ny)
    stress_sums: np.ndarray     # (n_slots, 6, nx, ny)
    counts: np.ndarray          # (n_slots,)

    @classmethod
    def create(cls, stride: int, restart: int, nx: int, ny: int,
               n_scalars: int = 0, with_pressure: bool = True):
        n_slots = max(restart // stride, 1)
        names = ["u", "v", "w"]
        if with_pressure:
            names.append("p")
        names += [f"s{i + 1}" for i in range(n_scalars)]
        return cls(stride=stride, n_slots=n_slots, names=tuple(names),
                   sums=np.zeros((n_slots, len(names), nx, ny)),
                   stress_sums=np.zeros((n_slots, 6, nx, ny)),
                   counts=np.zeros(n_slots, dtype=np.int64))

    def wants(self, itime: int) -> bool:
        return itime % self.stride == 0

    def accumulate(self, itime: int, fields: dict) -> None:
        """fields: name -> (nx, ny, nz); z-means land in the phase slot."""
        if not self.wants(itime):
            return
        slot = (itime // self.stride) % self.n_slots
        means = [i for i, name in enumerate(self.names) if name in fields]
        pairs = [j for j, (na, nb) in enumerate(_STRESSES)
                 if na in fields and nb in fields]
        planes = [torch.mean(fields[self.names[i]], dim=2) for i in means]
        planes += [torch.mean(fields[_STRESSES[j][0]]
                              * fields[_STRESSES[j][1]], dim=2)
                   for j in pairs]
        zm = torch.stack(planes).cpu().numpy() if planes else ()
        for k, i in enumerate(means):
            self.sums[slot, i] += zm[k]
        for k, j in enumerate(pairs):
            self.stress_sums[slot, j] += zm[len(means) + k]
        self.counts[slot] += 1

    def mean(self, name: str, slot: int) -> np.ndarray:
        i = self.names.index(name)
        return self.sums[slot, i] / max(self.counts[slot], 1)

    def stress(self, na: str, nb: str, slot: int) -> np.ndarray:
        """Phase-locked Reynolds stress <ab> - <a><b> at the slot."""
        j = _STRESSES.index((na, nb))
        n = max(self.counts[slot], 1)
        return (self.stress_sums[slot, j] / n
                - self.mean(na, slot) * self.mean(nb, slot))

    def save(self, path: str, itime: int) -> None:
        np.savez(path, names=np.asarray(self.names), sums=self.sums,
                 stress_sums=self.stress_sums, counts=self.counts,
                 stride=self.stride, itime=itime)

    @classmethod
    def load(cls, path: str) -> "PhaseAverage":
        d = np.load(path)
        return cls(stride=int(d["stride"]), n_slots=d["sums"].shape[0],
                   names=tuple(str(n) for n in d["names"]),
                   sums=d["sums"], stress_sums=d["stress_sums"],
                   counts=d["counts"])
