"""Device selection for the port's entry points.

Entry points run on the GPU unless the caller asks for the CPU: their
`device` argument defaults to "cuda", and a CUDA device that is not there is
an error, never a silent fall-back to the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """torch.device(device); raises RuntimeError for a CUDA device when
    torch.cuda.is_available() is False."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {str(dev)!r} requested but "
                           "torch.cuda.is_available() is False; pass "
                           "device='cpu' to run on the CPU")
    return dev
