"""PyTorch/CUDA port of the tlab_tpu incompressible DNS main path.

The package mirrors ``tlab_tpu``'s layout: each module sits at the path of
its JAX counterpart, which stays the reference it is tested against.  The
NumPy plan builders of ``tlab_tpu`` that import no JAX (grid, constants,
config, fdm, physics.params/profiles) are reused read-only; nothing here
imports JAX.

Tensors are float64 on the CPU (the parity tests) and float32 on a CUDA
card (the production slice).  Every entry point takes its ``device`` and
``dtype`` explicitly (see ``device.py``).
"""
