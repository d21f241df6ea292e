"""utils of the port (counterpart of tlab_tpu/utils)."""
