"""io of the port (counterpart of tlab_tpu/io)."""
