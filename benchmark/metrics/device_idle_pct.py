"""The device's idle share over a steady stretch of the traced window:
1 - (the union of the device operations' intervals) / (the stretch),
from torch.profiler's trace (harness/devtrace.py)."""


def read(ctx):
    t = ctx.get("trace")
    if not t or t["device_events"] == 0 or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
