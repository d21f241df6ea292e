"""The (x, z) pencil decomposition on torch.distributed (port of
tlab_tpu/parallel): mesh.py holds the ranks, their groups and the
collectives; pencil.py the transposes, the distributed Poisson solves and
the step builders."""
