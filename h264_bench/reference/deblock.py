"""In-loop deblocking (spec 8.7) in NumPy: the boundary strengths of an I
or a P picture, the per-MB meta of strengths and thresholds, and the MB
wavefront that filters the planes.

The tables, the edge filters, the bS rules and the meta's layout are frozen
copies of media_tpu_torch/ops/deblock.py and
pipeline/deblock_apply.py:build_meta, in NumPy; the wavefront follows
ops/deblock_pallas.py's plain wave step. MB (r, c) filters its own vertical
edges, then its horizontal ones, over its block and the 4 columns left of
it and the 4 rows above it; so it waits for (r, c-1), (r-1, c) and
(r-1, c+1), and the MBs of one wave k = 2r + c, whose patches are
disjoint, are filtered at once. `deblock_two_pass` is the control's
departure from that order (see control.py).
"""

from __future__ import annotations

import numpy as np

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


def _clip(x, lo, hi):
    return np.minimum(np.maximum(x, lo), hi)


def filter_luma_taps(p3, p2, p1, p0, q0, q1, q2, q3, bs, alpha, beta, tc0):
    """Tap-wise luma edge filter (spec 8.7.2.3/8.7.2.4) on broadcastable
    int32 arrays; returns (p2', p1', p0', q0', q1', q2'), or None where no
    sample of the edge is filtered. The normal (bS < 4) and the strong
    (bS == 4) filters are worked out only where some sample takes them."""
    filt = ((bs > 0) & (np.abs(p0 - q0) < alpha) & (np.abs(p1 - p0) < beta)
            & (np.abs(q1 - q0) < beta))
    if not filt.any():
        return None
    is4 = bs >= 4
    f4 = filt & is4
    fn = filt & ~is4
    ap = np.abs(p2 - p0)
    aq = np.abs(q2 - q0)
    p2_o, p1_o, p0_o, q0_o, q1_o, q2_o = p2, p1, p0, q0, q1, q2
    if fn.any():  # normal filter (bS < 4)
        tc = tc0 + (ap < beta) + (aq < beta)
        delta = _clip(((q0 - p0) * 4 + (p1 - q1) + 4) >> 3, -tc, tc)
        avg = (p0 + q0 + 1) >> 1
        p0_o = np.where(fn, _clip(p0 + delta, 0, 255), p0_o)
        q0_o = np.where(fn, _clip(q0 - delta, 0, 255), q0_o)
        p1_o = np.where(fn & (ap < beta),
                        p1 + _clip((p2 + avg - 2 * p1) >> 1, -tc0, tc0), p1_o)
        q1_o = np.where(fn & (aq < beta),
                        q1 + _clip((q2 + avg - 2 * q1) >> 1, -tc0, tc0), q1_o)
    if f4.any():  # strong filter (bS == 4)
        strong = np.abs(p0 - q0) < ((alpha >> 2) + 2)
        sp = f4 & strong & (ap < beta)
        sq = f4 & strong & (aq < beta)
        p0_o = np.where(sp, (p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3,
                        np.where(f4, (2 * p1 + p0 + q1 + 2) >> 2, p0_o))
        q0_o = np.where(sq, (q2 + 2 * q1 + 2 * q0 + 2 * p0 + p1 + 4) >> 3,
                        np.where(f4, (2 * q1 + q0 + p1 + 2) >> 2, q0_o))
        p1_o = np.where(sp, (p2 + p1 + p0 + q0 + 2) >> 2, p1_o)
        q1_o = np.where(sq, (q2 + q1 + q0 + p0 + 2) >> 2, q1_o)
        p2_o = np.where(sp, (2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3, p2)
        q2_o = np.where(sq, (2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3, q2)
    return p2_o, p1_o, p0_o, q0_o, q1_o, q2_o


def filter_chroma_taps(p1, p0, q0, q1, bs, alpha, beta, tc0):
    """Tap-wise chroma edge filter; returns (p0', q0'), or None where no
    sample of the edge is filtered."""
    filt = ((bs > 0) & (np.abs(p0 - q0) < alpha) & (np.abs(p1 - p0) < beta)
            & (np.abs(q1 - q0) < beta))
    if not filt.any():
        return None
    is4 = bs >= 4
    tc = tc0 + 1
    delta = _clip(((q0 - p0) * 4 + (p1 - q1) + 4) >> 3, -tc, tc)
    return (np.where(filt, np.where(is4, (2 * p1 + p0 + q1 + 2) >> 2,
                                    _clip(p0 + delta, 0, 255)), p0),
            np.where(filt, np.where(is4, (2 * q1 + q0 + p1 + 2) >> 2,
                                    _clip(q0 - delta, 0, 255)), q0))


def inter_bs_grids(nnz_blk, mv, R: int, C: int):
    """bS of an all-inter P picture: 2 where either side has coefficients,
    else 1 where the MVs differ by a full sample, else 0. nnz_blk (4R, 4C)
    nonzero counts; mv (R, C, 2) quarter-pel. Returns int32 (bs_v, bs_h),
    the frame border's edges 0."""
    nz = nnz_blk > 0
    mv_blk = np.repeat(np.repeat(mv, 4, axis=0), 4, axis=1)

    def bs_dir(axis):
        coded = nz | np.roll(nz, 1, axis=axis)
        far = (np.abs(mv_blk - np.roll(mv_blk, 1, axis=axis)) >= 4).any(-1)
        bs = np.where(coded, 2, np.where(far, 1, 0)).astype(np.int32)
        if axis == 1:
            bs[:, 0] = 0
        else:
            bs[0, :] = 0
        return bs

    return bs_dir(1), bs_dir(0)


def pframe_bs_grids(mv, luma, R: int, C: int):
    """The bS grids of a P picture from its (R, C, 2) MVs and (R, C, 16, 16)
    luma levels."""
    counts = (luma != 0).sum(axis=3)  # (R, C, 16) raster blocks
    grid = counts.reshape(R, C, 4, 4).transpose(0, 2, 1, 3).reshape(4 * R,
                                                                    4 * C)
    return inter_bs_grids(grid, mv, R, C)


def intra_bs_grids(R: int, C: int):
    """bS of an all-intra picture: 4 on MB edges, 3 inside."""
    bs_v = np.where(np.arange(4 * C) % 4 == 0, 4, 3).astype(np.int32)
    bs_h = np.where(np.arange(4 * R) % 4 == 0, 4, 3).astype(np.int32)
    bs_v = np.broadcast_to(bs_v[None, :], (4 * R, 4 * C)).copy()
    bs_h = np.broadcast_to(bs_h[:, None], (4 * R, 4 * C)).copy()
    bs_v[:, 0] = 0
    bs_h[0, :] = 0
    return bs_v, bs_h


def _tc0_sel(bs, rows):
    """bs: (n, E, B); rows: (n or 1, E or 1, 3) tc0 triplets by bS-1."""
    return np.where(bs == 1, rows[..., 0:1],
                    np.where(bs == 2, rows[..., 1:2],
                             np.where(bs == 3, rows[..., 2:3], 0)))


def build_meta(qp: int, qp_c: int, bs_v, bs_h, R: int, C: int):
    """Per-MB meta (R*C, META_COLS) int32, raster MB order, of a picture at
    one QP, from the (4R, 4C) strengths of the vertical edge left of / the
    horizontal edge above each 4x4 luma block."""
    n = R * C
    tbl = np.stack([ALPHA_TABLE, BETA_TABLE, TC0_TABLE[:, 0],
                    TC0_TABLE[:, 1], TC0_TABLE[:, 2]], axis=1)  # (52, 5)
    bs_v = bs_v.astype(np.int32).copy()
    bs_h = bs_h.astype(np.int32).copy()
    bs_v[:, 0] = 0
    bs_h[0, :] = 0
    # [mb, e, b] = bS at edge e, block b of the MB.
    bsv = bs_v.reshape(R, 4, C, 4).transpose(0, 2, 3, 1).reshape(n, 4, 4)
    bsh = bs_h.reshape(R, 4, C, 4).transpose(0, 2, 1, 3).reshape(n, 4, 4)
    bscv = bsv[:, (0, 2), :]  # chroma edges sit on luma edges 0 and 2
    bsch = bsh[:, (0, 2), :]
    lut = np.broadcast_to(tbl[min(max(qp, 0), 51)], (n, 8, 5))
    lut_c = np.broadcast_to(tbl[min(max(qp_c, 0), 51)], (n, 4, 5))
    return np.concatenate([
        bsv.reshape(n, 16), bsh.reshape(n, 16),
        _tc0_sel(bsv, lut[:, 0:4, 2:5]).reshape(n, 16),
        _tc0_sel(bsh, lut[:, 4:8, 2:5]).reshape(n, 16),
        bscv.reshape(n, 8), bsch.reshape(n, 8),
        _tc0_sel(bscv, lut_c[:, 0:2, 2:5]).reshape(n, 8),
        _tc0_sel(bsch, lut_c[:, 2:4, 2:5]).reshape(n, 8),
        lut[:, :, 0:2].reshape(n, 16), lut_c[:, :, 0:2].reshape(n, 8),
    ], axis=1).astype(np.int32)


def n_waves(R: int, C: int) -> int:
    return 2 * (R - 1) + C


def _luma_edges(p, m):
    """Filter the 4 vertical, then the 4 horizontal luma edges of (n, 20,
    20) int32 patches in place (own MB at [4:20, 4:20])."""
    n = p.shape[0]
    bsv = np.repeat(m[:, 0:16].reshape(n, 4, 4), 4, axis=2)
    bsh = np.repeat(m[:, 16:32].reshape(n, 4, 4), 4, axis=2)
    tcv = np.repeat(m[:, 32:48].reshape(n, 4, 4), 4, axis=2)
    tch = np.repeat(m[:, 48:64].reshape(n, 4, 4), 4, axis=2)
    for e in range(4):
        x = 4 + 4 * e
        out = filter_luma_taps(*(p[:, 4:20, x - 4 + t] for t in range(8)),
                               bsv[:, e], m[:, 96 + 2 * e, None],
                               m[:, 97 + 2 * e, None], tcv[:, e])
        for t, val in enumerate(out or ()):
            p[:, 4:20, x - 3 + t] = val
    for e in range(4):
        y = 4 + 4 * e
        out = filter_luma_taps(*(p[:, y - 4 + t, 4:20] for t in range(8)),
                               bsh[:, e], m[:, 104 + 2 * e, None],
                               m[:, 105 + 2 * e, None], tch[:, e])
        for t, val in enumerate(out or ()):
            p[:, y - 3 + t, 4:20] = val


def _chroma_edges(p, m):
    """Filter the 2 vertical, then the 2 horizontal edges of (2, n, 12, 12)
    int32 U and V patches in place (own block at [4:12, 4:12])."""
    n = p.shape[1]
    bsv = np.repeat(m[:, 64:72].reshape(n, 2, 4), 2, axis=2)
    bsh = np.repeat(m[:, 72:80].reshape(n, 2, 4), 2, axis=2)
    tcv = np.repeat(m[:, 80:88].reshape(n, 2, 4), 2, axis=2)
    tch = np.repeat(m[:, 88:96].reshape(n, 2, 4), 2, axis=2)
    for e in range(2):
        x = 4 + 4 * e
        out = filter_chroma_taps(
            p[:, :, 4:12, x - 2], p[:, :, 4:12, x - 1], p[:, :, 4:12, x],
            p[:, :, 4:12, x + 1], bsv[:, e], m[:, 112 + 2 * e, None],
            m[:, 113 + 2 * e, None], tcv[:, e])
        if out is not None:
            p[:, :, 4:12, x - 1], p[:, :, 4:12, x] = out
    for e in range(2):
        y = 4 + 4 * e
        out = filter_chroma_taps(
            p[:, :, y - 2, 4:12], p[:, :, y - 1, 4:12], p[:, :, y, 4:12],
            p[:, :, y + 1, 4:12], bsh[:, e], m[:, 116 + 2 * e, None],
            m[:, 117 + 2 * e, None], tch[:, e])
        if out is not None:
            p[:, :, y - 1, 4:12], p[:, :, y, 4:12] = out


def _padded(y, u, v):
    """int32 copies of the planes with 4 rows above and 4 columns left
    (never filtered against: their edges have bS 0)."""
    Y = np.zeros((y.shape[0] + 4, y.shape[1] + 4), np.int32)
    Y[4:, 4:] = y
    UV = np.zeros((2, u.shape[0] + 4, u.shape[1] + 4), np.int32)
    UV[0, 4:, 4:] = u
    UV[1, 4:, 4:] = v
    return Y, UV


def deblock_frame(y, u, v, meta, R: int, C: int):
    """uint8 (y, u, v) filtered by the MB wavefront, as new arrays."""
    Y, UV = _padded(y, u, v)
    a20, a12 = np.arange(20), np.arange(12)
    for k in range(n_waves(R, C)):
        r = np.arange(max(0, -(-(k - C + 1) // 2)), min(R - 1, k // 2) + 1)
        c = k - 2 * r
        ry = (16 * r[:, None] + a20)[:, :, None]
        cy = (16 * c[:, None] + a20)[:, None, :]
        rc = (8 * r[:, None] + a12)[:, :, None]
        cc = (8 * c[:, None] + a12)[:, None, :]
        m = meta[r * C + c]
        patch = Y[ry, cy]
        _luma_edges(patch, m)
        Y[ry, cy] = patch
        cpatch = UV[:, rc, cc]
        _chroma_edges(cpatch, m)
        UV[:, rc, cc] = cpatch
    return (Y[4:, 4:].astype(np.uint8), UV[0, 4:, 4:].astype(np.uint8),
            UV[1, 4:, 4:].astype(np.uint8))


def deblock_two_pass(y, u, v, meta, R: int, C: int):
    """The same edge filters in another order: every vertical edge of the
    picture, left to right, then every horizontal edge, top to bottom. That
    is not spec 8.7's MB order: where a vertical and a horizontal edge share
    samples, near MB corners, the result differs. New uint8 arrays."""
    m = meta.reshape(R, C, META_COLS)
    Y, UV = _padded(y, u, v)

    def rep(x, k):
        return np.repeat(x, k, axis=-1).reshape(-1)

    for c in range(C):
        for e in range(4):
            x = 4 + 16 * c + 4 * e
            out = filter_luma_taps(
                *(Y[4:, x - 4 + t] for t in range(8)),
                rep(m[:, c, 4 * e:4 * e + 4], 4),
                rep(m[:, c, 96 + 2 * e, None], 16),
                rep(m[:, c, 97 + 2 * e, None], 16),
                rep(m[:, c, 32 + 4 * e:36 + 4 * e], 4))
            for t, val in enumerate(out or ()):
                Y[4:, x - 3 + t] = val
    for r in range(R):
        for e in range(4):
            y0 = 4 + 16 * r + 4 * e
            out = filter_luma_taps(
                *(Y[y0 - 4 + t, 4:] for t in range(8)),
                rep(m[r, :, 16 + 4 * e:20 + 4 * e], 4),
                rep(m[r, :, 104 + 2 * e, None], 16),
                rep(m[r, :, 105 + 2 * e, None], 16),
                rep(m[r, :, 48 + 4 * e:52 + 4 * e], 4))
            for t, val in enumerate(out or ()):
                Y[y0 - 3 + t, 4:] = val
    for c in range(C):
        for e in range(2):
            x = 4 + 8 * c + 4 * e
            out = filter_chroma_taps(
                UV[:, 4:, x - 2], UV[:, 4:, x - 1], UV[:, 4:, x],
                UV[:, 4:, x + 1], rep(m[:, c, 64 + 4 * e:68 + 4 * e], 2),
                rep(m[:, c, 112 + 2 * e, None], 8),
                rep(m[:, c, 113 + 2 * e, None], 8),
                rep(m[:, c, 80 + 4 * e:84 + 4 * e], 2))
            if out is not None:
                UV[:, 4:, x - 1], UV[:, 4:, x] = out
    for r in range(R):
        for e in range(2):
            y0 = 4 + 8 * r + 4 * e
            out = filter_chroma_taps(
                UV[:, y0 - 2, 4:], UV[:, y0 - 1, 4:], UV[:, y0, 4:],
                UV[:, y0 + 1, 4:], rep(m[r, :, 72 + 4 * e:76 + 4 * e], 2),
                rep(m[r, :, 116 + 2 * e, None], 8),
                rep(m[r, :, 117 + 2 * e, None], 8),
                rep(m[r, :, 88 + 4 * e:92 + 4 * e], 2))
            if out is not None:
                UV[:, y0 - 1, 4:], UV[:, y0, 4:] = out
    return (Y[4:, 4:].astype(np.uint8), UV[0, 4:, 4:].astype(np.uint8),
            UV[1, 4:, 4:].astype(np.uint8))
