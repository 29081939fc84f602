"""Luma half-pel interpolation planes (spec 8.4.2.2.1).

PyTorch twin of media_tpu/ops/interp.py:half_pel_planes. Half-pel samples
come from the 6-tap (1,-5,20,20,-5,1) filter; the centre position j is
filtered from unrounded horizontal intermediates.
"""

from __future__ import annotations

import torch

from .pad import edge_pad


def _hfilter(a):
    w = a.shape[1]
    return (a[:, 0 : w - 5] - 5 * a[:, 1 : w - 4] + 20 * a[:, 2 : w - 3]
            + 20 * a[:, 3 : w - 2] - 5 * a[:, 4 : w - 1] + a[:, 5:w])


def _vfilter(a):
    h = a.shape[0]
    return (a[0 : h - 5] - 5 * a[1 : h - 4] + 20 * a[2 : h - 3]
            + 20 * a[3 : h - 2] - 5 * a[4 : h - 1] + a[5:h])


def half_pel_planes(ref):
    """ref: (H, W) integer plane. Returns int32 (b, h, j) planes of the same
    shape: b[y,x] = half-pel at (x+1/2, y); h[y,x] = (x, y+1/2);
    j[y,x] = (x+1/2, y+1/2). Taps past the border replicate the edge."""
    H, W = ref.shape
    p = edge_pad(ref.to(torch.int32), 3, 3, 3, 3)  # taps reach -2..+3
    b1_rows = _hfilter(p)  # (H+6, W+1): col i -> x = i - 1
    b = ((b1_rows[3 : 3 + H, 1 : 1 + W] + 16) >> 5).clamp(0, 255)
    h1 = _vfilter(p)[1 : 1 + H, 3 : 3 + W]  # row i -> y = i - 1
    h = ((h1 + 16) >> 5).clamp(0, 255)
    j1 = _vfilter(b1_rows)[1 : 1 + H, 1 : 1 + W]
    j = ((j1 + 512) >> 10).clamp(0, 255)
    return b, h, j
