"""From the process's start to the first timed step (host clock): CUDA's
start, the plans, the initial fields, the kernels' build where it is not
cached, and the warm step.  On a mesh from the parent's start to rank 0's
first timed step: the ranks' start, rank 0's initial fields, each rank's
plans, the scatter of the blocks, the warm step and its gather."""


def read(ctx):
    return ctx["setup_s"]
