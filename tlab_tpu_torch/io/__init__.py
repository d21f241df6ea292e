"""io of the port (counterpart of tlab_tpu/io)."""
from tlab_tpu_torch.io.fields_io import read_field, write_field  # noqa: F401
