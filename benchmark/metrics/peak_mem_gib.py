"""torch.cuda.max_memory_allocated() from the process's start to the end
of the window, in GiB."""


def read(ctx):
    return ctx["peak_bytes"] / 2.0 ** 30
