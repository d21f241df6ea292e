"""torch.cuda.max_memory_allocated() from the process's start to the end
of the window, in GiB; on a mesh the fullest card's, from the warm step to
the end of the window (harness/mesh.py)."""


def read(ctx):
    return ctx["peak_bytes"] / 2.0 ** 30
