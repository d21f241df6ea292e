"""From the process's start to the first timed step (host clock): CUDA's
start, the plans, the initial fields, the kernels' build where it is not
cached, and the warm step."""


def read(ctx):
    return ctx["setup_s"]
