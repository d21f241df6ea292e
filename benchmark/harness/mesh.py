"""One run of a cell on more than one card: the ranks of its
configuration's [Parallel] Mesh, one process a card, through the port's
mesh path.

run() refuses a mesh whose px pz is not the cell's `chips`, or whose grid
parallel.pencil.check_decomposition refuses, and starts the ranks with
parallel.mesh.spawn (NCCL where every rank has a card of its own; gloo on
the CPU).  Each rank (_rank):

- rank 0 makes the whole initial stack from --seed with the recipe's
  generator on its card, keeps it on the host and frees the card before
  the program starts, so that the transient sets no peak;
- builds Simulation.from_case and takes dns.make_step_functions(sim,
  mesh=mesh), as tools/dns.py's run takes them under `dns --mesh`;
- receives its block of each field from rank 0 (Mesh.scatter) and takes
  the warm step, whose output it keeps on its host;
- steps the window (harness/window.py).  Rank 0's clock decides the stop:
  its decision reaches the other ranks by one broadcast a step over a
  gloo group, on the host, outside the timed step, so that every rank
  runs the same steps;
- gathers the last step's input and output, and the warm step's output,
  to rank 0 (Mesh.gather) and frees its state.  Rank 0 then judges them and the warm step with the
  configuration's float64 reference at the whole grid, on its card
  (harness/cell.py's judge), and reads the metrics.

peak_mem_gib is the fullest card's program peak from the warm step to the
window's end (the set-up's plans stay resident through it; the harness's
scatters and gathers are left out).  A traced run profiles the same steps
on every rank; busy_s and window_s are the ranks' means, the breakdown and
the per-layer metrics rank 0's.
"""
from __future__ import annotations

import gc
import tempfile
import time

from harness import spec

# a job that runs past this is ended (its first run builds the kernels)
JOB_TIMEOUT_S = 1150.0


def mesh_shape(ini: dict) -> tuple:
    """(px, pz) of the case's [Parallel] Mesh; (1, 1) without one."""
    text = ini.get("Parallel", {}).get("Mesh", "")
    if not text.strip():
        return 1, 1
    px, pz = (int(v) for v in text.split(","))
    return px, pz


def check_cell(cell: spec.Cell, ini: dict) -> tuple:
    """(px, pz) of the cell's mesh, or ValueError where px pz is not the
    cell's `chips` or the decomposition refuses the grid."""
    from tlab_tpu_torch.parallel import pencil
    px, pz = mesh_shape(ini)
    if px * pz != cell.chips:
        raise ValueError(f"{cell.name}: [Parallel] Mesh {px}x{pz} is "
                         f"{px * pz} ranks, the cell asks for {cell.chips} "
                         "chips")
    nx, _, nz = spec.shape_of(ini)
    pencil.check_decomposition(px, pz, nx, nz)
    return px, pz


def run(cell: spec.Cell, seed: int, seconds: float, trace: bool,
        device: str = "cuda", shape=None, t_start: float = None, log=print,
        patch=None, control: str = "", patch_rank: int = -1) -> dict:
    """harness/cell.py's run for a mesh cell: the result of rank 0, with
    the forbidden modules the ranks loaded under "ranks_forbidden" (which
    run.py takes out before it prints the result).
    patch is planted on rank patch_rank alone (the last by default), or
    on every rank where patch_rank is None."""
    from tlab_tpu_torch.parallel import mesh as pmesh

    t_start = time.time() if t_start is None else t_start
    ini = cell.config["ini"] if shape is None \
        else spec.resized(cell.config["ini"], shape)
    if cell.traffic.get("statistics_every", 0):
        raise NotImplementedError(f"{cell.name}: statistics writes on a "
                                  "mesh")
    px, pz = check_cell(cell, ini)
    if patch_rank is not None:
        patch_rank %= px * pz
    args = (cell, ini, seed, seconds, trace, t_start, patch, patch_rank,
            control)
    outs = pmesh.spawn(_rank, px, pz, device, *args,
                       store_dir=tempfile.gettempdir(),
                       timeout_s=JOB_TIMEOUT_S)
    for line in outs[0]["lines"]:
        log(line)
    result = outs[0]["result"]
    checks = result.pop("checks")
    result["ranks_forbidden"] = sorted({n for o in outs
                                        for n in o["forbidden"]})
    result["checks"] = checks                       # the last key
    return result


def _agree(group, stop: bool) -> bool:
    """Rank 0's stop decision, on every rank (a host broadcast)."""
    import torch
    import torch.distributed as dist
    flag = torch.tensor([int(stop)], dtype=torch.int32)
    dist.broadcast(flag, src=0, group=group)
    return bool(flag.item())


def _gather(mesh, fields):
    """The global stack of the blocks `fields` on rank 0's host, a field
    at a time (None on the other ranks)."""
    import torch
    out = []
    for f in fields:
        full = mesh.gather(f)
        out.append(None if full is None else full.cpu())
        del full
    return torch.stack(out) if mesh.root else None


def _components(state):
    return [state.u, state.v, state.w] + list(state.s)


def _rank(mesh, cell, ini, seed, seconds, trace, t_start, patch,
          patch_rank, control):
    """One rank of the run: {"lines", "result", "forbidden"} on rank 0,
    {"forbidden"} on the others."""
    import torch
    import torch.distributed as dist
    from tlab_tpu_torch.config import Ini, load_case
    from tlab_tpu_torch.dycore import incompressible as dyn
    from tlab_tpu_torch.dycore.state import unstack
    from tlab_tpu_torch.ops import _build, burgers
    from tlab_tpu_torch.runtime import Simulation
    from tlab_tpu_torch.tools import dns
    from harness import cell as cellmod
    from harness import devtrace, fields, guard, window
    from harness.spans import Spans

    lines = []
    stages = [("ranks up", time.time())]

    def log(msg):
        if mesh.root:
            lines.append(msg)

    def stage(name):
        stages.append((name, time.time()))

    host = dist.new_group(backend="gloo")       # every rank, in this order
    dev = mesh.device
    cuda = dev.type == "cuda"
    dtype = getattr(torch, cell.config["dtype"])
    q0 = None
    if mesh.root:
        q = fields.initial_stack(cell.config, ini, seed, dev, dtype,
                                 cell.bench_dir)
        q0 = q.cpu()
        del q
        if cuda:
            torch.cuda.empty_cache()
    stage("initial fields")

    def skip():
        """End a stretch of the harness's own: its peak is not the
        program's."""
        if cuda:
            torch.cuda.reset_peak_memory_stats()

    peak = window._Peak(cuda)           # close(): fold a program stretch
    skip()
    sim = Simulation.from_case(load_case(Ini(text=spec.ini_text(ini))),
                               dtype=dtype, device=dev)
    stage("Simulation.from_case")
    step, diagnostics = dns.make_step_functions(sim, mesh=mesh)
    stage("make_step_functions")
    if patch is not None and patch_rank in (None, mesh.rank):
        step = patch(step)
    setup_peak = torch.cuda.max_memory_allocated() if cuda else 0
    nx, ny, nz = sim.grid.shape
    nfields = 3 + sim.nsp.n_scalars
    blocks = []
    for f in range(nfields):
        full = q0[f].to(dev) if mesh.root else None
        like = torch.empty((nx // mesh.px, ny, nz // mesh.pz), dtype=dtype,
                           device=dev)
        blocks.append(mesh.scatter(full, like))
        del full, like
    state = unstack(torch.stack(blocks))
    del blocks
    if cuda:
        torch.cuda.synchronize()
    stage("scatter")
    skip()
    cfla, cfld = sim.case.time_cfl, sim.case.time_cfl_diffusive
    dt0 = dyn.next_dt(sim.P, diagnostics(state).tolist()[0], cfla, cfld)
    out1, p1, diag1 = step(state, dt0)
    diag1 = diag1.tolist()
    del state, p1
    peak.close()
    stage("warm step")
    # each rank keeps its blocks of the warm step's output on its host;
    # rank 0 gathers them once the window has closed
    out1_host = [c.cpu() for c in _components(out1)]
    stage("warm output to the host")
    per_layer = {m["name"]: spec.metric(m["name"], cell.bench_dir)
                 for m in cell.per_layer} if trace else {}
    spans = None
    if trace and cuda:
        spans = Spans()
        spans.install([s for mod in per_layer.values()
                       for s in getattr(mod, "SPANS", ())])
    if trace:
        devtrace.warm(dev)
    burgers.reset_launches()
    if cuda:
        torch.cuda.synchronize()
    skip()
    setup_s = time.time() - t_start
    stage("trace and metrics")
    tr = cell.traffic
    carry = {"state": out1}
    del out1
    win = window.run(sim, step, carry, dyn.next_dt(sim.P, diag1[0], cfla,
                                                   cfld), 1, dt0, seconds,
                     0, "", trace_at=(tr["trace_first_step"],
                                      tr["trace_steps"]) if trace else None,
                     agree=lambda stop: _agree(host, stop))
    peak.peak = max(peak.peak, win.peak_bytes)
    launches = {k: list(v) for k, v in burgers.contract_launches.items()}
    span_ms = None
    if spans is not None:
        torch.cuda.synchronize()
        span_ms = spans.totals_ms()
        spans.remove()
    last = None
    if win.last is not None and not win.failed:
        last = {"old": _gather(mesh, _components(win.last["state"])),
                "new": _gather(mesh, _components(win.last["new"])),
                "dt": win.last["dt"], "diag": win.last["diag"]}
    win.last = None
    start = {"new": _gather(mesh, (b.to(dev) for b in out1_host)),
             "dt": dt0, "diag": diag1}
    del out1_host
    n_sub = len(sim.P["rk"]["kdt"])
    built = {k: round(v["seconds"], 3) for k, v in _build.builds.items()}
    del sim, step, diagnostics, carry
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    mine = {"steps": win.steps, "peak": peak.peak, "setup_peak": setup_peak,
            "trace": win.trace, "launches": launches,
            "forbidden": guard.loaded_forbidden()}
    every = [None] * mesh.size
    dist.all_gather_object(every, mine, group=host)
    if not mesh.root:
        return {"forbidden": guard.loaded_forbidden()}

    steps = [r["steps"] for r in every]
    top = max(r["peak"] for r in every)
    card = torch.cuda.get_device_name(dev) if cuda else "cpu"
    ctx_card = card
    if cuda:
        ctx_card = cellmod._card()
        log(f"[bench] card: {ctx_card}")
        log("[bench] topology (nvidia-smi topo -m):\n" + cellmod._topology())
    log(f"[bench] {cell.name} seed {seed}: {mesh.describe()}; {card}; grid "
        f"{(nx, ny, nz)}; set-up {setup_s:.3f} s (builds {built}); window "
        f"{win.seconds:.3f} s, steps by rank {steps}; program peak by rank "
        f"{[r['peak'] for r in every]} B; set-up peak by rank "
        f"{[r['setup_peak'] for r in every]} B")
    marks = [t_start] + [t for _, t in stages]
    log("[bench] set-up on rank 0, s: " + ", ".join(
        f"{name} {t - t0:.3f}" for (name, t), t0 in zip(stages, marks)))
    if win.step_s:
        ms = sorted(1e3 * t for t in win.step_s)
        log(f"[bench] step ms (rank 0): min {ms[0]:.3f} median "
            f"{ms[len(ms) // 2]:.3f} max {ms[-1]:.3f}")
    log(f"[bench] burgers.contract_launches by rank "
        f"{[r['launches'] for r in every]} ({win.steps * n_sub} substeps)")
    failed = win.failed
    if len(set(steps)) != 1:
        failed = f"the ranks ran different steps: {steps}"
    traces = [r["trace"] for r in every]
    shared = None
    if all(traces):
        shared = dict(traces[0],
                      busy_s=sum(t["busy_s"] for t in traces) / len(traces),
                      window_s=sum(t["window_s"] for t in traces)
                      / len(traces))
        log("[bench] traced stretch by rank: busy "
            + " ".join(f"{t['busy_s']:.6f}" for t in traces) + " s of "
            + " ".join(f"{t['window_s']:.6f}" for t in traces) + " s")
    ctx = {"window": win, "points": nx * ny * nz,
           "substeps_per_step": n_sub, "substeps": win.steps * n_sub,
           "setup_s": setup_s, "peak_bytes": top, "spans": span_ms,
           "trace": shared, "shape": (nx, ny, nz), "fields": nfields,
           "word_bytes": torch.finfo(dtype).bits // 8, "card": ctx_card,
           "mesh": (mesh.px, mesh.pz), "bench_dir": cell.bench_dir,
           "log": log}
    metrics = cellmod.read_metrics(cell, trace, per_layer, ctx)
    readings = {}
    if last is not None and not failed:
        readings = cellmod.judge(cell, ini, dev, q0, start, last, None, "",
                                 0, log, control)
    result = cellmod.result_of(cell, readings, win.steps, failed, metrics,
                               cuda, card, mesh.size, top,
                               shared if trace else None, log)
    return {"lines": lines, "result": result,
            "forbidden": guard.loaded_forbidden()}
