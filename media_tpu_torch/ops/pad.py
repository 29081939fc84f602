"""Edge (replicate) padding of 2-D integer planes by clamped indexing.

Stands in for `jnp.pad(..., mode="edge")`; works for every integer dtype on
every device, which `torch.nn.functional.pad(mode="replicate")` does not
promise.
"""

from __future__ import annotations

import torch


def edge_pad(x, top: int, bottom: int, left: int, right: int):
    """Pad a (H, W) plane by replicating its border rows and columns."""
    h, w = x.shape
    rows = torch.arange(-top, h + bottom, device=x.device).clamp(0, h - 1)
    cols = torch.arange(-left, w + right, device=x.device).clamp(0, w - 1)
    return x[rows[:, None], cols[None, :]]
