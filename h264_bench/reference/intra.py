"""The IDR's intra wavefront (I_16x16 and chroma mode decisions, transform,
quantisation, reconstruction before deblocking) in plain PyTorch.

A frozen copy of media_tpu_torch/pipeline/encoder.py:intra_encode_plain
(the I_4x4 branch left out: the benchmark's configurations code I_16x16
only), with the block helpers of pipeline/pframe_core.py. Intra prediction
reads the reconstructed left and top neighbours, so the MBs of one
anti-diagonal (wave k = r + c) are independent and the R + C - 1 waves run
in order.
"""

from __future__ import annotations

import torch

from . import intra_ops
from . import transform as T


def _mb_blocks(mb):
    """(N, 16, 16) -> (N, 16, 4, 4): raster-ordered 4x4 blocks."""
    n = mb.shape[0]
    return mb.reshape(n, 4, 4, 4, 4).transpose(2, 3).reshape(n, 16, 4, 4)


def _blocks_mb(blocks):
    """(N, 16, 4, 4) -> (N, 16, 16)."""
    n = blocks.shape[0]
    return blocks.reshape(n, 4, 4, 4, 4).transpose(2, 3).reshape(n, 16, 16)


def _mb_blocks8(mb):
    """(N, 8, 8) -> (N, 4, 4, 4): raster-ordered 4x4 blocks of an 8x8."""
    n = mb.shape[0]
    return mb.reshape(n, 2, 4, 2, 4).transpose(2, 3).reshape(n, 4, 4, 4)


def _blocks8_mb(blocks):
    n = blocks.shape[0]
    return blocks.reshape(n, 2, 2, 4, 4).transpose(2, 3).reshape(n, 8, 8)


def to_mbs(plane, R: int, C: int, size: int):
    """(R*size, C*size) plane -> (R*C, size, size) raster-ordered MBs."""
    return (plane.reshape(R, size, C, size).transpose(1, 2)
            .reshape(R * C, size, size))


def from_mbs(x, R: int, C: int, size: int):
    """(R*C, size, size) MBs -> (R*size, C*size) plane."""
    return (x.reshape(R, C, size, size).transpose(1, 2)
            .reshape(R * size, C * size))


def wave_lanes(k: int, R: int, C: int, device):
    """The (r, c) index tensors of wave k: all MBs with r + c == k, by
    rising row."""
    lo = max(0, k - (C - 1))
    r = torch.arange(lo, min(R - 1, k) + 1, device=device)
    return r, k - r


def intra_encode_plain(y, u, v, qp: int, qp_c: int, row_has_top):
    """y (16R, 16C), u, v (8R, 8C) int32 planes; row_has_top (R,) bool,
    false at row 0 and every slice start. Returns {mode16, chroma_mode,
    dc_levels, ac_levels, cdc_levels, cac_levels (int32); recon_y, recon_u,
    recon_v uint8 planes, before deblocking}."""
    R, C = y.shape[0] // 16, y.shape[1] // 16
    dev = y.device
    i32 = torch.int32
    orig_y = y.reshape(R, 16, C, 16).transpose(1, 2)  # (R, C, 16, 16)
    orig_u = u.reshape(R, 8, C, 8).transpose(1, 2)
    orig_v = v.reshape(R, 8, C, 8).transpose(1, 2)
    st = {
        "recon_y": torch.zeros((R, C, 16, 16), dtype=i32, device=dev),
        "recon_u": torch.zeros((R, C, 8, 8), dtype=i32, device=dev),
        "recon_v": torch.zeros((R, C, 8, 8), dtype=i32, device=dev),
        "mode16": torch.zeros((R, C), dtype=i32, device=dev),
        "chroma_mode": torch.zeros((R, C), dtype=i32, device=dev),
        "dc_levels": torch.zeros((R, C, 16), dtype=i32, device=dev),
        "ac_levels": torch.zeros((R, C, 16, 15), dtype=i32, device=dev),
        "cdc_levels": torch.zeros((R, C, 2, 4), dtype=i32, device=dev),
        "cac_levels": torch.zeros((R, C, 2, 4, 15), dtype=i32, device=dev),
    }
    unavailable = torch.tensor(1 << 30, dtype=i32, device=dev)

    def chroma_code(o_c, pred_c):
        w_c = T.forward_4x4(_mb_blocks8(o_c - pred_c))  # (N, 4, 4, 4)
        dc2 = w_c[:, :, 0, 0].reshape(-1, 2, 2)
        z2 = T.quant_dc_2x2(T.hadamard_2x2(dc2), qp_c, intra=True)
        d2 = T.dequant_dc_2x2(T.hadamard_2x2(z2), qp_c)
        z_cac = T.quant_4x4(w_c, qp_c, intra=True)
        z_cac[:, :, 0, 0] = 0
        d_c = T.dequant_4x4(z_cac, qp_c)
        d_c[:, :, 0, 0] = d2.reshape(-1, 4)
        recon_c = (pred_c + _blocks8_mb(T.inverse_4x4(d_c))).clamp(0, 255)
        return z2.reshape(-1, 4), z_cac, recon_c

    for k in range(R - 1 + C):
        r, c = wave_lanes(k, R, C, dev)
        lanes = torch.arange(len(r), device=dev)
        avail_top = row_has_top[r]
        avail_left = c > 0
        rm1 = (r - 1).clamp(min=0)
        cm1 = (c - 1).clamp(min=0)

        # ---- luma: I_16x16 mode decision by SATD, first minimum ----
        ry = st["recon_y"]
        o = orig_y[r, c]  # (N, 16, 16)
        top, left = ry[rm1, c, 15, :], ry[r, cm1, :, 15]
        top_left = ry[rm1, cm1, 15, 15]
        preds = intra_ops.pred_16x16_all(top, left, top_left, avail_top,
                                         avail_left)
        cost = torch.where(
            intra_ops.mode_available_16x16(avail_top, avail_left),
            intra_ops.satd_cost(preds, o), unavailable)
        mode = torch.argmin(cost, dim=-1)
        pred = preds[lanes, mode]

        w = T.forward_4x4(_mb_blocks(o - pred))  # (N, 16, 4, 4)
        z_dc = T.quant_dc_4x4(T.hadamard_4x4(w[:, :, 0, 0].reshape(-1, 4, 4)),
                              qp)
        d_dc = T.dequant_dc_4x4(T.hadamard_4x4(z_dc), qp)
        z_ac = T.quant_4x4(w, qp, intra=True)
        z_ac[:, :, 0, 0] = 0
        d = T.dequant_4x4(z_ac, qp)
        d[:, :, 0, 0] = d_dc.reshape(-1, 16)
        recon = (pred + _blocks_mb(T.inverse_4x4(d))).clamp(0, 255)

        # ---- chroma: joint U+V mode decision by SAD ----
        ru_, rv_ = st["recon_u"], st["recon_v"]
        ou, ov = orig_u[r, c], orig_v[r, c]
        preds_u = intra_ops.pred_chroma_all(
            ru_[rm1, c, 7, :], ru_[r, cm1, :, 7], ru_[rm1, cm1, 7, 7],
            avail_top, avail_left)
        preds_v = intra_ops.pred_chroma_all(
            rv_[rm1, c, 7, :], rv_[r, cm1, :, 7], rv_[rm1, cm1, 7, 7],
            avail_top, avail_left)
        ccost = torch.where(
            intra_ops.mode_available_chroma(avail_top, avail_left),
            intra_ops.sad_cost(preds_u, ou) + intra_ops.sad_cost(preds_v, ov),
            unavailable)
        cmode = torch.argmin(ccost, dim=-1)
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

    H, W = y.shape
    for k, shape in (("recon_y", (H, W)), ("recon_u", (H // 2, W // 2)),
                     ("recon_v", (H // 2, W // 2))):
        st[k] = st[k].transpose(1, 2).reshape(shape).to(torch.uint8)
    return st
