"""PyTorch/CUDA port of the tlab_tpu incompressible DNS main path and of
the single-device run around it (tools.cli: inigrid, ini, dns).

The package mirrors ``tlab_tpu``'s layout: each module sits at the path of
its JAX counterpart, which stays the reference it is tested against.
Nothing here imports JAX or ``tlab_tpu``: the NumPy modules the port needs
(constants, grid, config, fdm, physics.params/profiles, and the case file's
option dataclasses) are the port's own copies, with only their imports
changed.

Tensors are float64 on the CPU (the parity tests) and float32 on a CUDA
card (the production slice).  Every entry point takes its ``device`` and
``dtype``; the default is the card, and asking for a card where there is
none raises (see ``device.py``).
"""
