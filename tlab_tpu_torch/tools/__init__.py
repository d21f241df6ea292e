"""Command-line tools of the port (run as ``python -m tlab_tpu_torch.tools.<name>``)."""
