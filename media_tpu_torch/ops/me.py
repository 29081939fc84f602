"""Full-pel motion estimation: exhaustive SAD search over per-MB windows.

PyTorch twin of media_tpu/ops/me.py:full_search. The window gather and the
full-pel MC helpers of the JAX module are not on the encode path and are not
ported.
"""

from __future__ import annotations

import torch


def full_search(cur_mbs, windows, radius: int, lambda_mv: int = 4):
    """Full-pel exhaustive SAD search.

    cur_mbs: (N, 16, 16) int current MBs; windows: (N, 16+2R, 16+2R) int
    reference windows. Returns (mv (N, 2) int32 (mvx, mvy), cost (N,) int32),
    cost = SAD + lambda * |mv|_1. Ties go to the first minimum in (dy, dx)
    raster order, as in the JAX package (argmin keeps the first minimum).
    """
    K = 2 * radius + 1
    dev = cur_mbs.device
    cur16 = cur_mbs.to(torch.int16)
    win16 = windows.to(torch.int16)
    mvx_cost = lambda_mv * (torch.arange(K, device=dev, dtype=torch.int32)
                            - radius).abs()
    rows = []
    for dy in range(K):
        # (N, 16, K, 16) candidate blocks of this row, a view of the window.
        cand = win16[:, dy : dy + 16, :].unfold(2, 16, 1)
        sad = (cand - cur16[:, :, None, :]).abs().sum(
            dim=(1, 3), dtype=torch.int32)
        rows.append(sad + mvx_cost[None, :] + lambda_mv * abs(dy - radius))
    flat = torch.stack(rows, dim=1).reshape(-1, K * K)
    idx = torch.argmin(flat, dim=1)
    cost = torch.gather(flat, 1, idx[:, None])[:, 0]
    idx = idx.to(torch.int32)
    mv = torch.stack([idx % K - radius, idx // K - radius], dim=-1)
    return mv, cost
