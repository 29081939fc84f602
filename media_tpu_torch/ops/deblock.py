"""In-loop deblocking filter (Rec. ITU-T H.264 8.7): tables, edge filters,
boundary strengths.

PyTorch twin of media_tpu/ops/deblock.py. The tap-wise filters here are the
plain form of the per-edge math that csrc/deblock_wave.cu runs per line.

Boundary strengths: intra frames use bS=4 on MB edges / 3 inside; inter
(P_L0_16x16) edges use bS=2 where either side has coefficients, else bS=1
when the MV difference reaches a full sample, else 0.
"""

from __future__ import annotations

import numpy as np
import torch

ALPHA_TABLE = np.array(
    [0] * 16
    + [4, 4, 5, 6, 7, 8, 9, 10, 12, 13, 15, 17, 20, 22, 25, 28, 32, 36,
       40, 45, 50, 56, 63, 71, 80, 90, 101, 113, 127, 144, 162, 182, 203,
       226, 255, 255],
    dtype=np.int32,
)
BETA_TABLE = np.array(
    [0] * 16
    + [2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 6, 6, 7, 7, 8, 8, 9, 9, 10, 10, 11,
       11, 12, 12, 13, 13, 14, 14, 15, 15, 16, 16, 17, 17, 18, 18],
    dtype=np.int32,
)
# tc0[idx][bS-1] for bS in 1..3
TC0_TABLE = np.array(
    [[0, 0, 0]] * 17
    + [
        [0, 0, 1], [0, 0, 1], [0, 0, 1], [0, 0, 1], [0, 1, 1], [0, 1, 1],
        [1, 1, 1], [1, 1, 1], [1, 1, 1], [1, 1, 1], [1, 1, 2], [1, 1, 2],
        [1, 1, 2], [1, 1, 2], [1, 2, 3], [1, 2, 3], [2, 2, 3], [2, 2, 4],
        [2, 3, 4], [2, 3, 4], [3, 3, 5], [3, 4, 6], [3, 4, 6], [4, 5, 7],
        [4, 5, 8], [4, 6, 9], [5, 7, 10], [6, 8, 11], [6, 8, 13], [7, 10, 14],
        [8, 11, 16], [9, 12, 18], [10, 13, 20], [11, 15, 23], [13, 17, 25],
    ],
    dtype=np.int32,
)


# Per-MB meta columns (int32, raster MB order):
#   0:16   bS of vertical luma edges   [edge e, 4x4 block row b]
#   16:32  bS of horizontal luma edges [edge e, 4x4 block column b]
#   32:48  tc0 of vertical luma edges, 48:64 tc0 of horizontal luma edges
#   64:72  bS of chroma vertical edges [edge 0/1 = luma edge 0/2, block b]
#   72:80  bS of chroma horizontal edges, 80:88 / 88:96 their tc0
#   96:112 luma (alpha, beta) per edge: vertical 0-3, then horizontal 0-3
#   112:120 chroma (alpha, beta) per edge: v0, v1, h0, h1
META_COLS = 120


def check_planes(y, u, v, meta, R: int, C: int) -> None:
    """Raise unless y (16R, 16C) and u/v (8R, 8C) are contiguous uint8 planes
    and meta is a contiguous int32 (R*C, META_COLS) tensor, all on y's
    device: what the deblocking kernels take."""
    for name, p, size in (("y", y, 16), ("u", u, 8), ("v", v, 8)):
        if p.dtype != torch.uint8 or p.shape != (R * size, C * size):
            raise ValueError(f"{name}: expected uint8 ({R * size}, "
                             f"{C * size}), got {p.dtype} {tuple(p.shape)}")
        if not p.is_contiguous() or p.device != y.device:
            raise ValueError(f"{name}: must be contiguous on {y.device}")
    if (meta.dtype != torch.int32 or meta.shape != (R * C, META_COLS)
            or not meta.is_contiguous() or meta.device != y.device):
        raise ValueError(f"meta: expected contiguous int32 ({R * C}, "
                         f"{META_COLS}) on {y.device}")


def check_aligned(y, u, v, meta) -> None:
    """Raise unless the tensors start at multiples of 16 bytes, as the CUDA
    kernels' vector loads need (every tensor that owns its storage does)."""
    for name, p in (("y", y), ("u", u), ("v", v), ("meta", meta)):
        if p.data_ptr() % 16:
            raise ValueError(f"{name}: storage must be 16-byte aligned")


def filter_luma_taps(p3, p2, p1, p0, q0, q1, q2, q3, bs, alpha, beta, tc0):
    """Tap-wise luma edge filter (spec 8.7.2.3/8.7.2.4). All args are
    broadcastable int32 tensors (or ints); returns (p2', p1', p0', q0', q1',
    q2')."""
    filt = ((bs > 0) & ((p0 - q0).abs() < alpha) & ((p1 - p0).abs() < beta)
            & ((q1 - q0).abs() < beta))
    ap = (p2 - p0).abs()
    aq = (q2 - q0).abs()

    # --- normal filter (bS < 4) ---
    tc = tc0 + (ap < beta).to(torch.int32) + (aq < beta).to(torch.int32)
    delta = torch.clamp(((q0 - p0) * 4 + (p1 - q1) + 4) >> 3, -tc, tc)
    p0_n = (p0 + delta).clamp(0, 255)
    q0_n = (q0 - delta).clamp(0, 255)
    tc0_t = torch.as_tensor(tc0, dtype=torch.int32, device=p0.device)
    dp1 = torch.clamp((p2 + ((p0 + q0 + 1) >> 1) - 2 * p1) >> 1, -tc0_t, tc0_t)
    dq1 = torch.clamp((q2 + ((p0 + q0 + 1) >> 1) - 2 * q1) >> 1, -tc0_t, tc0_t)
    p1_n = torch.where(ap < beta, p1 + dp1, p1)
    q1_n = torch.where(aq < beta, q1 + dq1, q1)

    # --- strong filter (bS == 4) ---
    strong = (p0 - q0).abs() < ((alpha >> 2) + 2)
    sp = strong & (ap < beta)
    sq = strong & (aq < beta)
    p0_s = torch.where(sp, (p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3,
                       (2 * p1 + p0 + q1 + 2) >> 2)
    p1_s = torch.where(sp, (p2 + p1 + p0 + q0 + 2) >> 2, p1)
    p2_s = torch.where(sp, (2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3, p2)
    q0_s = torch.where(sq, (q2 + 2 * q1 + 2 * q0 + 2 * p0 + p1 + 4) >> 3,
                       (2 * q1 + q0 + p1 + 2) >> 2)
    q1_s = torch.where(sq, (q2 + q1 + q0 + p0 + 2) >> 2, q1)
    q2_s = torch.where(sq, (2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3, q2)

    is4 = bs >= 4
    f4 = filt & is4
    fn = filt & ~is4
    return (
        torch.where(f4, p2_s, p2),
        torch.where(fn, p1_n, torch.where(f4, p1_s, p1)),
        torch.where(filt, torch.where(is4, p0_s, p0_n), p0),
        torch.where(filt, torch.where(is4, q0_s, q0_n), q0),
        torch.where(fn, q1_n, torch.where(f4, q1_s, q1)),
        torch.where(f4, q2_s, q2),
    )


def filter_chroma_taps(p1, p0, q0, q1, bs, alpha, beta, tc0):
    """Tap-wise chroma edge filter; returns (p0', q0')."""
    filt = ((bs > 0) & ((p0 - q0).abs() < alpha) & ((p1 - p0).abs() < beta)
            & ((q1 - q0).abs() < beta))
    tc = tc0 + 1
    delta = torch.clamp(((q0 - p0) * 4 + (p1 - q1) + 4) >> 3, -tc, tc)
    p0_n = (p0 + delta).clamp(0, 255)
    q0_n = (q0 - delta).clamp(0, 255)
    p0_s = (2 * p1 + p0 + q1 + 2) >> 2
    q0_s = (2 * q1 + q0 + p1 + 2) >> 2
    is4 = bs >= 4
    return (torch.where(filt, torch.where(is4, p0_s, p0_n), p0),
            torch.where(filt, torch.where(is4, q0_s, q0_n), q0))


def inter_bs_grids(nnz_blk, mv_qpel, R: int, C: int):
    """Boundary strengths for an all-inter P frame.

    nnz_blk: (R*4, C*4) per-4x4 nonzero-coefficient counts; mv_qpel: (R, C, 2)
    per-MB quarter-pel MVs. Returns int32 (bs_v, bs_h): strengths of the
    vertical edge left of / horizontal edge above each 4x4 block (frame
    border edges 0).
    """
    nz = (nnz_blk > 0).to(torch.int32)
    mv_blk = mv_qpel.repeat_interleave(4, dim=0).repeat_interleave(4, dim=1)

    def bs_dir(axis):
        coded = (nz | torch.roll(nz, 1, dims=axis)) > 0
        mv_n = torch.roll(mv_blk, 1, dims=axis)
        far = ((mv_blk - mv_n).abs() >= 4).any(dim=-1)
        bs = torch.where(coded, 2, torch.where(far, 1, 0)).to(torch.int32)
        if axis == 1:
            bs[:, 0] = 0
        else:
            bs[0, :] = 0
        return bs

    return bs_dir(1), bs_dir(0)


def intra_bs_grids(R: int, C: int, device=None):
    """bS for an all-intra frame: 4 on MB edges, 3 on internal edges."""
    col = torch.arange(C * 4, device=device) % 4
    row = torch.arange(R * 4, device=device) % 4
    bs_v = torch.where(col[None, :] == 0, 4, 3).to(torch.int32).expand(
        R * 4, C * 4).clone()
    bs_h = torch.where(row[:, None] == 0, 4, 3).to(torch.int32).expand(
        R * 4, C * 4).clone()
    bs_v[:, 0] = 0
    bs_h[0, :] = 0
    return bs_v, bs_h
