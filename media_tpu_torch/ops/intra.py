"""H.264 intra prediction (spec 8.3.1 luma 4x4, 8.3.3 luma 16x16, 8.3.4
chroma 8x8), batched.

PyTorch twin of media_tpu/ops/intra.py. Inputs are neighbour vectors
(reconstructed top row / left column) plus availability flags; outputs are
predicted blocks.

Mode numbering (luma 16x16, spec 8.3.3): 0=V, 1=H, 2=DC, 3=Plane.
Mode numbering (chroma, spec 8.3.4):     0=DC, 1=H, 2=V, 3=Plane.
Mode numbering (luma 4x4, spec 8.3.1.2): 0=V, 1=H, 2=DC, 3=DDL, 4=DDR, 5=VR,
6=HD, 7=VL, 8=HU.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import transform as T

I16_VERTICAL = 0
I16_HORIZONTAL = 1
I16_DC = 2
I16_PLANE = 3

CHROMA_DC = 0
CHROMA_HORIZONTAL = 1
CHROMA_VERTICAL = 2
CHROMA_PLANE = 3


def _isum(x, dim):
    return x.sum(dim=dim, dtype=torch.int32)


def pred_16x16_vertical(top):
    """top: (N, 16) int32 -> (N, 16, 16)."""
    return top[:, None, :].expand(top.shape[0], 16, 16)


def pred_16x16_horizontal(left):
    return left[:, :, None].expand(left.shape[0], 16, 16)


def _dc_select(both, only_t, only_l, avail_top, avail_left):
    return torch.where(
        avail_top & avail_left, both,
        torch.where(avail_top, only_t,
                    torch.where(avail_left, only_l, torch.full_like(both, 128))))


def pred_16x16_dc(top, left, avail_top, avail_left):
    """DC prediction with availability rules (spec 8.3.3.3)."""
    sum_t = _isum(top, -1)
    sum_l = _isum(left, -1)
    dc = _dc_select((sum_t + sum_l + 16) >> 5, (sum_t + 8) >> 4,
                    (sum_l + 8) >> 4, avail_top, avail_left)
    return dc[:, None, None].expand(dc.shape[0], 16, 16)


def _plane(top, left, top_left, n: int, bmul: int, bround: int, bshift: int):
    """Plane prediction shared by luma (n=16) and chroma (n=8)."""
    h2 = n // 2
    i = torch.arange(1, h2 + 1, device=top.device)
    x = i.to(torch.int32)
    top_ext = torch.cat([top_left[:, None], top], dim=-1)  # i -> p[-1, i-1]
    left_ext = torch.cat([top_left[:, None], left], dim=-1)
    h = _isum(x * (top_ext[:, h2 + i] - top_ext[:, h2 - i]), -1)
    v = _isum(x * (left_ext[:, h2 + i] - left_ext[:, h2 - i]), -1)
    a = 16 * (top[:, n - 1] + left[:, n - 1])
    b = (bmul * h + bround) >> bshift
    c = (bmul * v + bround) >> bshift
    ar = torch.arange(n, dtype=torch.int32, device=top.device) - (h2 - 1)
    pred = (a[:, None, None] + b[:, None, None] * ar[None, None, :]
            + c[:, None, None] * ar[None, :, None] + 16) >> 5
    return pred.clamp(0, 255)


def pred_16x16_plane(top, left, top_left):
    """Plane prediction (spec 8.3.3.4). top/left: (N,16), top_left: (N,)."""
    return _plane(top, left, top_left, 16, 5, 32, 6)


def pred_16x16_all(top, left, top_left, avail_top, avail_left):
    """All four 16x16 modes stacked: (N, 4, 16, 16) in mode order V,H,DC,Plane."""
    return torch.stack(
        [
            pred_16x16_vertical(top),
            pred_16x16_horizontal(left),
            pred_16x16_dc(top, left, avail_top, avail_left),
            pred_16x16_plane(top, left, top_left),
        ],
        dim=1,
    )


def mode_available_16x16(avail_top, avail_left):
    """(N, 4) bool: which 16x16 modes may be signalled (spec 8.3.3)."""
    return torch.stack(
        [avail_top, avail_left, torch.ones_like(avail_top),
         avail_top & avail_left], dim=-1)


# --- Chroma 8x8 --------------------------------------------------------------


def pred_chroma_dc(top, left, avail_top, avail_left):
    """Chroma DC per spec 8.3.4.1: each 4x4 quadrant has its own DC rule."""
    sum_t0 = _isum(top[:, 0:4], -1)
    sum_t1 = _isum(top[:, 4:8], -1)
    sum_l0 = _isum(left[:, 0:4], -1)
    sum_l1 = _isum(left[:, 4:8], -1)
    k128 = torch.full_like(sum_t0, 128)

    def corner(sum_t, sum_l, prefer_top):
        both = (sum_t + sum_l + 4) >> 3
        only_t = (sum_t + 2) >> 2
        only_l = (sum_l + 2) >> 2
        if prefer_top is None:  # corners (0,0) and (4,4)
            return _dc_select(both, only_t, only_l, avail_top, avail_left)
        if prefer_top:  # block (4,0): top half preferred
            return torch.where(avail_top, only_t,
                               torch.where(avail_left, only_l, k128))
        return torch.where(avail_left, only_l,
                           torch.where(avail_top, only_t, k128))

    dc00 = corner(sum_t0, sum_l0, None)
    dc10 = corner(sum_t1, sum_l0, True)  # x=4..7, y=0..3
    dc01 = corner(sum_t0, sum_l1, False)  # x=0..3, y=4..7
    dc11 = corner(sum_t1, sum_l1, None)
    quad = torch.stack([torch.stack([dc00, dc10], dim=-1),
                        torch.stack([dc01, dc11], dim=-1)], dim=-2)
    return quad.repeat_interleave(4, dim=-2).repeat_interleave(4, dim=-1)


def pred_chroma_horizontal(left):
    return left[:, :, None].expand(left.shape[0], 8, 8)


def pred_chroma_vertical(top):
    return top[:, None, :].expand(top.shape[0], 8, 8)


def pred_chroma_plane(top, left, top_left):
    """Chroma plane prediction (spec 8.3.4.4)."""
    return _plane(top, left, top_left, 8, 17, 16, 5)


def pred_chroma_all(top, left, top_left, avail_top, avail_left):
    """(N, 4, 8, 8) in chroma mode order DC,H,V,Plane."""
    return torch.stack(
        [
            pred_chroma_dc(top, left, avail_top, avail_left),
            pred_chroma_horizontal(left),
            pred_chroma_vertical(top),
            pred_chroma_plane(top, left, top_left),
        ],
        dim=1,
    )


def mode_available_chroma(avail_top, avail_left):
    """(N, 4) bool in chroma mode order DC,H,V,Plane."""
    return torch.stack(
        [torch.ones_like(avail_top), avail_left, avail_top,
         avail_top & avail_left], dim=-1)


# --- Luma 4x4 (spec 8.3.1.2): 9 modes ----------------------------------------

I4_V, I4_H, I4_DC, I4_DDL, I4_DDR, I4_VR, I4_HD, I4_VL, I4_HU = range(9)

# Every sample of every mode but DC is (a*s[i] + b*s[j] + c*s[k] + rnd) >> sh
# over the 13 neighbour samples s = [l3, l2, l1, l0, corner, t0 .. t7]
# (p[-1, 3] .. p[-1, 0], p[-1, -1], p[0, -1] .. p[7, -1]): index 5 + i is
# p[i, -1] and index 3 - i is p[-1, i], so that the corner sits where both
# runs meet and an index of -1 on either side lands on it.


def _i4_terms(mode: int, x: int, y: int):
    """The (sample index, weight) terms, the rounding and the shift of the
    sample at (x, y) of a directional 4x4 mode (spec 8.3.1.2.1-9)."""

    def t(i):  # p[i, -1]; i == -1 is the corner
        return 5 + i

    def l(i):  # p[-1, i]; i == -1 is the corner
        return 3 - i

    def avg2(a, b):
        return [(a, 1), (b, 1)], 1, 1

    def avg3(a, b, c):
        return [(a, 1), (b, 2), (c, 1)], 2, 2

    if mode == I4_V:
        return [(t(x), 1)], 0, 0
    if mode == I4_H:
        return [(l(y), 1)], 0, 0
    if mode == I4_DDL:
        if x == 3 and y == 3:
            return [(t(6), 1), (t(7), 3)], 2, 2
        return avg3(t(x + y), t(x + y + 1), t(x + y + 2))
    if mode == I4_DDR:
        if x > y:
            return avg3(t(x - y - 2), t(x - y - 1), t(x - y))
        if x < y:
            return avg3(l(y - x - 2), l(y - x - 1), l(y - x))
        return avg3(t(0), t(-1), l(0))
    if mode == I4_VR:
        z = 2 * x - y
        if z >= 0 and z % 2 == 0:
            return avg2(t(x - (y >> 1) - 1), t(x - (y >> 1)))
        if z >= 0:
            return avg3(t(x - (y >> 1) - 2), t(x - (y >> 1) - 1),
                        t(x - (y >> 1)))
        if z == -1:
            return avg3(l(0), l(-1), t(0))
        return avg3(l(y - 2 * x - 1), l(y - 2 * x - 2), l(y - 2 * x - 3))
    if mode == I4_HD:
        z = 2 * y - x
        if z >= 0 and z % 2 == 0:
            return avg2(l(y - (x >> 1) - 1), l(y - (x >> 1)))
        if z >= 0:
            return avg3(l(y - (x >> 1) - 2), l(y - (x >> 1) - 1),
                        l(y - (x >> 1)))
        if z == -1:
            return avg3(l(0), l(-1), t(0))
        return avg3(t(x - 2 * y - 1), t(x - 2 * y - 2), t(x - 2 * y - 3))
    if mode == I4_VL:
        if y % 2 == 0:
            return avg2(t(x + (y >> 1)), t(x + (y >> 1) + 1))
        return avg3(t(x + (y >> 1)), t(x + (y >> 1) + 1), t(x + (y >> 1) + 2))
    if mode == I4_HU:
        z = x + 2 * y
        if z > 5:
            return [(l(3), 1)], 0, 0
        if z == 5:
            return [(l(2), 1), (l(3), 3)], 2, 2
        if z % 2 == 0:
            return avg2(l(y + (x >> 1)), l(y + (x >> 1) + 1))
        return avg3(l(y + (x >> 1)), l(y + (x >> 1) + 1), l(y + (x >> 1) + 2))
    raise ValueError(f"mode {mode}")


@functools.lru_cache(maxsize=None)
def _i4_table(device: torch.device):
    """(idx (9*16*3,) long, weight (9, 16, 3), rnd (9, 16), sh (9, 16)) of
    the nine modes' 16 samples in raster order; the DC row is all zero and
    is filled in by pred_4x4_all."""
    idx = np.zeros((9, 16, 3), np.int64)
    wgt = np.zeros((9, 16, 3), np.int32)
    rnd = np.zeros((9, 16), np.int32)
    sh = np.zeros((9, 16), np.int32)
    for mode in range(9):
        if mode == I4_DC:
            continue
        for y in range(4):
            for x in range(4):
                terms, r, s = _i4_terms(mode, x, y)
                for k, (i, w) in enumerate(terms):
                    idx[mode, 4 * y + x, k] = i
                    wgt[mode, 4 * y + x, k] = w
                rnd[mode, 4 * y + x] = r
                sh[mode, 4 * y + x] = s
    return (torch.as_tensor(idx.reshape(-1), device=device),
            torch.as_tensor(wgt, device=device),
            torch.as_tensor(rnd, device=device),
            torch.as_tensor(sh, device=device))


def pred_4x4_all(top8, left4, corner, avail_top, avail_left, avail_tr):
    """All nine 4x4 intra modes, batched.

    top8: (N, 8) p[0..7, -1]; the caller has already substituted p[3, -1]
    into x = 4..7 when the top-right is unavailable (spec 8.3.1.2; avail_tr
    is accepted for the JAX package's signature and gates nothing here).
    left4: (N, 4) p[-1, 0..3]; corner: (N,) p[-1, -1]. avail_*: (N,) bool.
    Returns (preds (N, 9, 4, 4) int32, ok (N, 9) bool).
    """
    n = top8.shape[0]
    idx, wgt, rnd, sh = _i4_table(top8.device)
    s = torch.cat([left4.flip(1), corner[:, None], top8], dim=1)  # (N, 13)
    taps = s[:, idx].reshape(n, 9, 16, 3)
    preds = ((taps * wgt).sum(dim=3, dtype=torch.int32) + rnd) >> sh
    sum_t = _isum(top8[:, :4], -1)
    sum_l = _isum(left4, -1)
    dc = _dc_select((sum_t + sum_l + 4) >> 3, (sum_t + 2) >> 2,
                    (sum_l + 2) >> 2, avail_top, avail_left)
    preds[:, I4_DC] = dc[:, None]
    tl = avail_top & avail_left
    ok = torch.stack([avail_top, avail_left, torch.ones_like(avail_top),
                      avail_top, tl, tl, tl, avail_top, avail_left], dim=-1)
    return preds.reshape(n, 9, 4, 4), ok


def sad_cost(pred_modes, original):
    """SAD of each candidate mode: (N, M, H, W), (N, H, W) -> (N, M) int32."""
    diff = (pred_modes - original[:, None, :, :]).abs()
    return _isum(diff, (-1, -2))


def satd_cost(pred_modes, original):
    """SATD (4x4 Hadamard-transformed SAD) >> 1: (N, M) int32."""
    res = pred_modes - original[:, None, :, :]
    n, m, hh, ww = res.shape
    blocks = (res.reshape(n, m, hh // 4, 4, ww // 4, 4)
              .permute(0, 1, 2, 4, 3, 5))
    h = T.hadamard_4x4(blocks)
    return _isum(h.abs(), (-1, -2, -3, -4)) >> 1
