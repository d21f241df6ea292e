"""stats of the port (counterpart of tlab_tpu/stats)."""
