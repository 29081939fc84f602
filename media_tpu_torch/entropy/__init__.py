"""On-device CAVLC packing."""
