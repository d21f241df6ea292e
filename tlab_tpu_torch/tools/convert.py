"""Output-file converters (the reference's scripts/python stats2nc.py; port
of stats_to_nc of tlab_tpu/tools/convert.py): ASCII avg<it> tables ->
NetCDF3-classic files any nc tool reads.  planes_to_nc and towers_to_nc
(Planes2nc.py, tower2nc.py) convert the [SavePlanes]/[SaveTowers] files,
ROADMAP A15.
"""
from __future__ import annotations

import os

from tlab_tpu_torch.stats import averages as avg


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
