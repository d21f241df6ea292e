"""What a cell is made of, found by name.

BENCHMARK.json names each cell's configuration and traffic mix; this module
finds them as files of their own (configs/<config>.json,
traffic/<traffic>.json), each metric's reader (metrics/<name>.py), each
cell's limits (limits/<cell>.json) and each roofline count
(roofline/<layer>.py) under the benchmark's folder.  A later change adds a
configuration, a mix, a metric or a cell by adding files and entries; no
file here names one.
"""
from __future__ import annotations

import copy
import dataclasses
import importlib.util
import json
import pathlib

BENCH_DIR = pathlib.Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list          # the BENCHMARK.json entries this cell reports
    per_layer: list
    limits: dict
    bench_dir: pathlib.Path = BENCH_DIR


def load_json(path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def reports(metric: dict, cell: str, e2e_names: set) -> bool:
    """Whether `cell` reports `metric`: its `workloads` list where it has
    one, else every cell that reports the end-to-end metric it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves") is None or metric["moves"] in e2e_names


def find_cell(name: str, bench: dict = None,
              bench_dir: pathlib.Path = BENCH_DIR) -> Cell:
    """The cell `name` of BENCHMARK.json with its files."""
    if bench is None:
        bench = load_json(bench_dir.parent / "BENCHMARK.json")
    by_name = {w["name"]: w for w in bench["workloads"]}
    if name not in by_name:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = by_name[name]
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if reports(m, name, names)]
    return Cell(name=name, chips=int(w["chips"]),
                config=load_json(bench_dir / "configs"
                                 / f"{w['config']}.json"),
                traffic=load_json(bench_dir / "traffic"
                                  / f"{w['traffic']}.json"),
                end_to_end=e2e, per_layer=per_layer,
                limits=load_json(bench_dir / "limits" / f"{name}.json"),
                bench_dir=bench_dir)


def load_module(path: pathlib.Path, tag: str):
    """The module of the file at `path`, imported under a private name."""
    spec = importlib.util.spec_from_file_location(
        f"_bench_{tag}_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric(name: str, bench_dir: pathlib.Path = BENCH_DIR):
    """The module metrics/<name>.py: read(ctx), which returns the number
    or None where the run has nothing to read it from, and SPANS where the
    metric reads CUDA-event spans."""
    return load_module(bench_dir / "metrics" / f"{name}.py", "metric")


def roofline(layer: str, bench_dir: pathlib.Path = BENCH_DIR):
    """The module roofline/<layer>.py (its bound(...) function)."""
    return load_module(bench_dir / "roofline" / f"{layer}.py", "roofline")


def ini_text(ini: dict) -> str:
    """The case {section: {key: value}} as the text of a tlab case file."""
    lines = []
    for section, keys in ini.items():
        lines.append(f"[{section}]")
        lines.extend(f"{k}={v}" for k, v in keys.items())
    return "\n".join(lines) + "\n"


def resized(ini: dict, shape) -> dict:
    """A copy of the case at grid `shape` (nx, ny, nz), the [IniGrid*]
    points set with [Grid] (a periodic axis lists its wrap node)."""
    out = copy.deepcopy(ini)
    for d, n, key in zip("xyz", shape, ("Imax", "Jmax", "Kmax")):
        out["Grid"][key] = str(n)
        periodic = out["Grid"].get(f"{d.upper()}Periodic", "no").lower() \
            in ("yes", "true", "1")
        out[f"IniGridO{d}"]["points_1"] = str(n + 1 if periodic else n)
    return out


def shape_of(ini: dict) -> tuple:
    return tuple(int(ini["Grid"][k]) for k in ("Imax", "Jmax", "Kmax"))
