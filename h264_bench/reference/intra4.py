"""The IDR's intra wavefront with the per-MB choice between I_4x4 and
I_16x16 (spec 8.3.1, 8.3.3, 8.3.4): mode decisions, transform, quantisation
and reconstruction before deblocking, in plain PyTorch.

The decision is the program's documented one (media_tpu_torch/pipeline/
encoder.py:intra_encode_plain with i4x4): an MB's I_16x16 candidate takes
the SATD-best of its available modes, as intra.py does; its I_4x4
candidate codes its 16 blocks in z-scan order, each predicted from the
reconstruction of the blocks before it and taking the SATD-best of its
available modes among the nine; ties go to the lowest mode number. The MB
is I_4x4 where the summed costs of its blocks plus 40 << (qp // 6), a
stand-in for the mode bits, stay below its I_16x16 cost, and the side that
lost carries no levels. Chroma is decided and coded as in intra.py.

A block's prediction reads its top-right neighbour, so MB (r, c) follows MB
(r - 1, c + 1): the MBs with 2 r + c == k (wave k) are independent, and the
2 (R - 1) + C waves run in order, each MB's 16 blocks a chain within its
wave. The wavefront runs on the CPU, the chain in NumPy (a few us an
operation where a small torch operation costs ten or more, and the chain
is 16 steps of some hundred operations a wave). Imports nothing of the
program.
"""

from __future__ import annotations

import numpy as np
import torch

from . import intra_ops
from . import transform as T
from .intra import _blocks8_mb, _blocks_mb, _mb_blocks, _mb_blocks8
from .vlc import ZSCAN

I4_V, I4_H, I4_DC, I4_DDL, I4_DDR, I4_VR, I4_HD, I4_VL, I4_HU = range(9)

# Whether the top-right 4x4 block of raster block (by, bx), by > 0, inside
# the MB is decoded before it (6.4.11.4: blocks 3, 7, 11, 13 and 15 in
# z-scan order have none).
_TOP_RIGHT_DECODED = {
    (1, 0): True, (1, 1): False, (1, 2): True, (1, 3): False,
    (2, 0): True, (2, 1): True, (2, 2): True, (2, 3): False,
    (3, 0): True, (3, 1): False, (3, 2): True, (3, 3): False}


def _sample_rule(mode: int, x: int, y: int):
    """Sample (x, y) of a directional mode (8.3.1.2.1-9) as its taps and
    shift: ([(neighbour, weight), ...], shift), the sample being (sum of
    weight * neighbour + (1 << shift >> 1)) >> shift. A neighbour is
    ("t", i), p[i, -1], or ("l", j), p[-1, j]; index -1 on either side is
    the corner p[-1, -1]."""
    def t(i):
        return ("t", i)

    def l(j):  # noqa: E743
        return ("l", j)

    def two(a, b):
        return [(a, 1), (b, 1)], 1

    def three(a, b, c):
        return [(a, 1), (b, 2), (c, 1)], 2

    if mode == I4_V:
        return [(t(x), 1)], 0
    if mode == I4_H:
        return [(l(y), 1)], 0
    if mode == I4_DDL:
        if x == 3 and y == 3:
            return [(t(6), 1), (t(7), 3)], 2
        return three(t(x + y), t(x + y + 1), t(x + y + 2))
    if mode == I4_DDR:
        if x > y:
            return three(t(x - y - 2), t(x - y - 1), t(x - y))
        if x < y:
            return three(l(y - x - 2), l(y - x - 1), l(y - x))
        return three(t(0), t(-1), l(0))
    if mode == I4_VR:
        z = 2 * x - y
        if z >= 0:
            i = x - (y >> 1)
            return (two(t(i - 1), t(i)) if z % 2 == 0
                    else three(t(i - 2), t(i - 1), t(i)))
        if z == -1:
            return three(l(0), l(-1), t(0))
        return three(l(y - 1), l(y - 2), l(y - 3))
    if mode == I4_HD:
        z = 2 * y - x
        if z >= 0:
            j = y - (x >> 1)
            return (two(l(j - 1), l(j)) if z % 2 == 0
                    else three(l(j - 2), l(j - 1), l(j)))
        if z == -1:
            return three(l(0), l(-1), t(0))
        return three(t(x - 1), t(x - 2), t(x - 3))
    if mode == I4_VL:
        i = x + (y >> 1)
        return (two(t(i), t(i + 1)) if y % 2 == 0
                else three(t(i), t(i + 1), t(i + 2)))
    if mode == I4_HU:
        z = x + 2 * y
        j = y + (x >> 1)
        if z > 5:
            return [(l(3), 1)], 0
        if z == 5:
            return [(l(2), 1), (l(3), 3)], 2
        return (two(l(j), l(j + 1)) if z % 2 == 0
                else three(l(j), l(j + 1), l(j + 2)))
    raise ValueError(mode)


def _rules():
    """(gather index (9 * 16 * 3,), weights (9, 16, 3), rounding and shift
    (9, 16)) of every mode's 16 samples over the neighbour row [p[-1, -1],
    p[0..7, -1], p[-1, 0..3]]; DC's row is zero (pred4x4 fills it in)."""
    def col(n):
        side, i = n
        if i == -1:
            return 0
        return 1 + i if side == "t" else 9 + i

    idx = np.zeros((9, 16, 3), np.int64)
    wgt = np.zeros((9, 16, 3), np.int64)
    sh = np.zeros((9, 16), np.int64)
    for mode in range(9):
        if mode == I4_DC:
            continue
        for y in range(4):
            for x in range(4):
                taps, s = _sample_rule(mode, x, y)
                for k, (n, w) in enumerate(taps):
                    idx[mode, 4 * y + x, k] = col(n)
                    wgt[mode, 4 * y + x, k] = w
                sh[mode, 4 * y + x] = s
    return idx.reshape(-1), wgt, (1 << sh) >> 1, sh


_IDX, _WGT, _RND, _SH = _rules()
# The forward core transform and the SATD cost's Hadamard transform of a
# 4x4 block, as matrices: X -> M X M^T.
_CF = np.array([[1, 1, 1, 1], [2, 1, -1, -2], [1, -1, -1, 1],
                [1, -2, 2, -1]], np.int64)
_HAD = np.array([[1, 1, 1, 1], [1, 1, -1, -1], [1, -1, -1, 1],
                 [1, -1, 1, -1]], np.int64)


def pred4x4(top8, left4, corner, avail_top, avail_left):
    """The nine 4x4 predictions of N blocks: top8 (N, 8) p[0..7, -1], in
    which the caller has put p[3, -1] where the top-right samples are not
    available (8.3.1.2); left4 (N, 4) p[-1, 0..3]; corner (N,) p[-1, -1];
    avail_top, avail_left (N,) bool. Returns the predictions (N, 9, 4, 4)
    and which modes may be used (N, 9) bool, NumPy int64 and bool."""
    n = top8.shape[0]
    s = np.concatenate([corner[:, None], top8, left4], axis=1)
    taps = s[:, _IDX].reshape(n, 9, 16, 3)
    preds = ((taps * _WGT).sum(axis=3) + _RND) >> _SH
    sum_t = top8[:, :4].sum(axis=1)
    sum_l = left4.sum(axis=1)
    preds[:, I4_DC] = np.where(
        avail_top & avail_left, (sum_t + sum_l + 4) >> 3,
        np.where(avail_top, (sum_t + 2) >> 2,
                 np.where(avail_left, (sum_l + 2) >> 2, 128)))[:, None]
    both = avail_top & avail_left
    ok = np.stack([avail_top, avail_left, np.ones_like(avail_top), avail_top,
                   both, both, both, avail_top, avail_left], axis=1)
    return preds.reshape(n, 9, 4, 4), ok


def _inverse_stage(v):
    """One pass of the inverse core transform (8.5.12.2) along axis -2."""
    e0 = v[..., 0, :] + v[..., 2, :]
    e1 = v[..., 0, :] - v[..., 2, :]
    e2 = (v[..., 1, :] >> 1) - v[..., 3, :]
    e3 = v[..., 1, :] + (v[..., 3, :] >> 1)
    return np.stack([e0 + e3, e1 + e2, e1 - e2, e0 - e3], axis=-2)


def _code4x4(res, qp: int):
    """A block's residual transformed and quantised as intra (the JM rule,
    levels clamped as transform.quant_4x4 clamps them), and the residual
    its levels reconstruct: (levels, recon residual), (N, 4, 4) each."""
    w = _CF @ res @ _CF.T
    qbits = 15 + qp // 6
    level = (np.abs(w) * T.MF_4x4[qp % 6] + (1 << qbits) // 3) >> qbits
    z = np.sign(w) * np.minimum(level, T.MAX_LEVEL)
    d = (z * T.V_4x4[qp % 6]) << (qp // 6)
    h = _inverse_stage(np.swapaxes(_inverse_stage(np.swapaxes(d, -1, -2)),
                                   -1, -2))
    return z, (h + 32) >> 6


def _i4_candidate(o, top, left, top_left, top_right4, avail_top, avail_left,
                  avail_top_right, qp: int):
    """The I_4x4 candidate of a wave's N MBs, NumPy int64 throughout: o
    (N, 16, 16) the source; top, left (N, 16) the reconstructed row above
    and column to the left; top_left (N,); top_right4 (N, 4) the first
    bottom samples of the MB above and to the right. Returns (recon
    (N, 16, 16), modes (N, 16) in z-scan order, levels (N, 16, 16) zig-zag
    by raster block, cost (N,))."""
    n = o.shape[0]
    lanes = np.arange(n)
    yes = np.ones(n, bool)
    cur = np.zeros((n, 16, 16), np.int64)
    modes = np.zeros((n, 16), np.int64)
    levels = np.zeros((n, 16, 16), np.int64)
    cost = np.zeros(n, np.int64)
    for z in range(16):
        b = ZSCAN[z]
        by, bx = divmod(b, 4)
        y0, x0 = 4 * by, 4 * bx
        top4 = top[:, x0:x0 + 4] if by == 0 else cur[:, y0 - 1, x0:x0 + 4]
        left4 = left[:, y0:y0 + 4] if bx == 0 else cur[:, y0:y0 + 4, x0 - 1]
        if by == 0:
            corner = top_left if bx == 0 else top[:, x0 - 1]
        else:
            corner = left[:, y0 - 1] if bx == 0 else cur[:, y0 - 1, x0 - 1]
        if by == 0 and bx < 3:
            tr, tr_ok = top[:, x0 + 4:x0 + 8], avail_top
        elif by == 0:
            tr, tr_ok = top_right4, avail_top_right
        elif _TOP_RIGHT_DECODED[(by, bx)]:
            tr, tr_ok = cur[:, y0 - 1, x0 + 4:x0 + 8], yes
        else:
            tr, tr_ok = top4, ~yes
        tr = np.where(tr_ok[:, None], tr, top4[:, 3:4])
        preds, ok = pred4x4(np.concatenate([top4, tr], axis=1), left4,
                            corner, avail_top if by == 0 else yes,
                            avail_left if bx == 0 else yes)
        ob = o[:, y0:y0 + 4, x0:x0 + 4]
        satd = np.abs(_HAD @ (preds - ob[:, None]) @ _HAD.T).sum(
            axis=(2, 3)) >> 1
        c4 = np.where(ok, satd, 1 << 30)
        m = np.argmin(c4, axis=1)
        p = preds[lanes, m]
        zl, res = _code4x4(ob - p, qp)
        cur[:, y0:y0 + 4, x0:x0 + 4] = np.clip(p + res, 0, 255)
        modes[:, z] = m
        levels[:, b] = zl.reshape(n, 16)[:, T.ZIGZAG_FLAT]
        cost += c4[lanes, m]
    return cur, modes, levels, cost


def intra_encode_i4(y, u, v, qp: int, qp_c: int, row_has_top):
    """y (16R, 16C), u, v (8R, 8C) int32 planes; row_has_top (R,) bool,
    false at row 0. Returns {mode16, chroma_mode, dc_levels, ac_levels,
    cdc_levels, cac_levels, is_i4, modes4, luma4_levels; recon_y, recon_u,
    recon_v uint8 planes before deblocking}, the layout of intra.py's
    intra_encode_plain with the I_4x4 fields added, on the CPU wherever
    the planes were."""
    y, u, v, row_has_top = (t.cpu() for t in (y, u, v, row_has_top))
    R, C = y.shape[0] // 16, y.shape[1] // 16
    dev = y.device
    i32 = torch.int32
    orig_y = y.reshape(R, 16, C, 16).transpose(1, 2)
    orig_u = u.reshape(R, 8, C, 8).transpose(1, 2)
    orig_v = v.reshape(R, 8, C, 8).transpose(1, 2)

    def zeros(*shape, dtype=i32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    st = {"recon_y": zeros(R, C, 16, 16), "recon_u": zeros(R, C, 8, 8),
          "recon_v": zeros(R, C, 8, 8), "mode16": zeros(R, C),
          "chroma_mode": zeros(R, C), "dc_levels": zeros(R, C, 16),
          "ac_levels": zeros(R, C, 16, 15), "cdc_levels": zeros(R, C, 2, 4),
          "cac_levels": zeros(R, C, 2, 4, 15),
          "is_i4": zeros(R, C, dtype=torch.bool), "modes4": zeros(R, C, 16),
          "luma4_levels": zeros(R, C, 16, 16)}
    unavailable = torch.tensor(1 << 30, dtype=i32, device=dev)
    bias = 40 << (qp // 6)

    def chroma_code(o_c, pred_c):
        w_c = T.forward_4x4(_mb_blocks8(o_c - pred_c))
        z2 = T.quant_dc_2x2(T.hadamard_2x2(w_c[:, :, 0, 0].reshape(-1, 2, 2)),
                            qp_c, intra=True)
        d2 = T.dequant_dc_2x2(T.hadamard_2x2(z2), qp_c)
        z_ac = T.quant_4x4(w_c, qp_c, intra=True)
        z_ac[:, :, 0, 0] = 0
        d = T.dequant_4x4(z_ac, qp_c)
        d[:, :, 0, 0] = d2.reshape(-1, 4)
        recon = (pred_c + _blocks8_mb(T.inverse_4x4(d))).clamp(0, 255)
        return z2.reshape(-1, 4), z_ac, recon

    for k in range(2 * (R - 1) + C):
        lo = max(0, -(-(k - (C - 1)) // 2))
        r = torch.arange(lo, min(R - 1, k // 2) + 1, device=dev)
        c = k - 2 * r
        lanes = torch.arange(len(r), device=dev)
        avail_top = row_has_top[r]
        avail_left = c > 0
        rm1, cm1 = (r - 1).clamp(min=0), (c - 1).clamp(min=0)

        ry = st["recon_y"]
        o = orig_y[r, c]
        top, left = ry[rm1, c, 15, :], ry[r, cm1, :, 15]
        top_left = ry[rm1, cm1, 15, 15]
        preds = intra_ops.pred_16x16_all(top, left, top_left, avail_top,
                                         avail_left)
        cost16 = torch.where(
            intra_ops.mode_available_16x16(avail_top, avail_left),
            intra_ops.satd_cost(preds, o), unavailable)
        mode = torch.argmin(cost16, dim=1)
        pred = preds[lanes, mode]
        w = T.forward_4x4(_mb_blocks(o - pred))
        z_dc = T.quant_dc_4x4(T.hadamard_4x4(w[:, :, 0, 0].reshape(-1, 4, 4)),
                              qp)
        d_dc = T.dequant_dc_4x4(T.hadamard_4x4(z_dc), qp)
        z_ac = T.quant_4x4(w, qp, intra=True)
        z_ac[:, :, 0, 0] = 0
        d = T.dequant_4x4(z_ac, qp)
        d[:, :, 0, 0] = d_dc.reshape(-1, 16)
        recon16 = (pred + _blocks_mb(T.inverse_4x4(d))).clamp(0, 255)

        cur, modes4, lev4, cost4 = (torch.from_numpy(a).to(i32) for a in (
            _i4_candidate(*(t.numpy().astype(np.int64) for t in (
                o, top, left, top_left,
                ry[rm1, (c + 1).clamp(max=C - 1), 15, 0:4])),
                avail_top.numpy(), avail_left.numpy(),
                (avail_top & (c < C - 1)).numpy(), qp)))
        i4 = cost4 + bias < cost16.min(dim=1).values
        recon = torch.where(i4[:, None, None], cur, recon16)
        z_dc = z_dc.masked_fill(i4[:, None, None], 0)
        z_ac = z_ac.masked_fill(i4[:, None, None, None], 0)

        ru, rv = st["recon_u"], st["recon_v"]
        ou, ov = orig_u[r, c], orig_v[r, c]
        preds_u = intra_ops.pred_chroma_all(
            ru[rm1, c, 7, :], ru[r, cm1, :, 7], ru[rm1, cm1, 7, 7],
            avail_top, avail_left)
        preds_v = intra_ops.pred_chroma_all(
            rv[rm1, c, 7, :], rv[r, cm1, :, 7], rv[rm1, cm1, 7, 7],
            avail_top, avail_left)
        ccost = torch.where(
            intra_ops.mode_available_chroma(avail_top, avail_left),
            intra_ops.sad_cost(preds_u, ou) + intra_ops.sad_cost(preds_v, ov),
            unavailable)
        cmode = torch.argmin(ccost, dim=1)
        zdc_u, zac_u, recon_u = chroma_code(ou, preds_u[lanes, cmode])
        zdc_v, zac_v, recon_v = chroma_code(ov, preds_v[lanes, cmode])

        st["recon_y"][r, c] = recon
        st["recon_u"][r, c] = recon_u
        st["recon_v"][r, c] = recon_v
        st["mode16"][r, c] = mode.to(i32)
        st["chroma_mode"][r, c] = cmode.to(i32)
        st["dc_levels"][r, c] = T.zigzag(z_dc)
        st["ac_levels"][r, c] = T.zigzag(z_ac)[..., 1:]
        st["cdc_levels"][r, c] = torch.stack([zdc_u, zdc_v], dim=1)
        st["cac_levels"][r, c] = torch.stack(
            [T.zigzag(zac_u)[..., 1:], T.zigzag(zac_v)[..., 1:]], dim=1)
        st["is_i4"][r, c] = i4
        st["modes4"][r, c] = modes4.masked_fill(~i4[:, None], 0)
        st["luma4_levels"][r, c] = lev4.masked_fill(~i4[:, None, None], 0)

    H, W = y.shape
    for key, shape in (("recon_y", (H, W)), ("recon_u", (H // 2, W // 2)),
                       ("recon_v", (H // 2, W // 2))):
        st[key] = st[key].transpose(1, 2).reshape(shape).to(torch.uint8)
    return st
