"""The device's busy time a substep over the traced stretch: the union of
the device operations' intervals (torch.profiler's trace, harness/
devtrace.py) over the stretch's substeps.  It leaves out the host's launch
gaps, which differ between processes on a shared host, so it moves by a
change of the device's work alone."""


def read(ctx):
    t = ctx.get("trace")
    if not t or t["device_events"] == 0 or t.get("steps", 0) <= 0:
        return None
    return 1e3 * t["busy_s"] / (t["steps"] * ctx["substeps_per_step"])
