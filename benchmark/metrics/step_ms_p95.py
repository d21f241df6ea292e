"""The 95th percentile of every step's wall time in the window (host
clock): from the step's start to the end of its host read, and of its
statistics write where there is one."""
from harness import numbers


def read(ctx):
    value, beyond = numbers.percentile([1e3 * s for s in ctx["window"].step_s],
                                       95.0)
    ctx["log"](f"step_ms_p95: {len(ctx['window'].step_s)} samples, "
               f"{beyond} beyond the percentile")
    return value
