from . import bitstream, nal, syntax  # noqa: F401
