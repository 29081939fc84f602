"""Scalar/numpy deblocking filter — the reference decoder's in-loop filter.

Straightforward raster-order per-MB implementation of spec 8.7, independent
of the device wavefront in pipeline/deblock_apply.py; round-trip tests require
the two to agree bit-exactly. The port's copy of media_tpu/ref/deblock.py: its
tables are the port's (ops/deblock.py, ops/transform.py).
"""

from __future__ import annotations

import numpy as np

from ..ops.deblock import ALPHA_TABLE, BETA_TABLE, TC0_TABLE


def _filter_luma_edge(p, q, bs, alpha, beta, tc0):
    """p: (16, 4) [p3..p0], q: (16, 4) [q0..q3], bs/tc0: (16,). Returns new."""
    p = p.astype(np.int64)
    q = q.astype(np.int64)
    p3, p2, p1, p0 = p[:, 0], p[:, 1], p[:, 2], p[:, 3]
    q0, q1, q2, q3 = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    filt = (bs > 0) & (np.abs(p0 - q0) < alpha) & (np.abs(p1 - p0) < beta) & (np.abs(q1 - q0) < beta)
    ap = np.abs(p2 - p0)
    aq = np.abs(q2 - q0)

    tc = tc0 + (ap < beta) + (aq < beta)
    delta = np.clip(((q0 - p0) * 4 + (p1 - q1) + 4) >> 3, -tc, tc)
    p0_n = np.clip(p0 + delta, 0, 255)
    q0_n = np.clip(q0 - delta, 0, 255)
    p1_n = np.where(ap < beta, p1 + np.clip((p2 + ((p0 + q0 + 1) >> 1) - 2 * p1) >> 1, -tc0, tc0), p1)
    q1_n = np.where(aq < beta, q1 + np.clip((q2 + ((p0 + q0 + 1) >> 1) - 2 * q1) >> 1, -tc0, tc0), q1)

    strong = np.abs(p0 - q0) < ((alpha >> 2) + 2)
    sp = strong & (ap < beta)
    sq = strong & (aq < beta)
    p0_s = np.where(sp, (p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3, (2 * p1 + p0 + q1 + 2) >> 2)
    p1_s = np.where(sp, (p2 + p1 + p0 + q0 + 2) >> 2, p1)
    p2_s = np.where(sp, (2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3, p2)
    q0_s = np.where(sq, (q2 + 2 * q1 + 2 * q0 + 2 * p0 + p1 + 4) >> 3, (2 * q1 + q0 + p1 + 2) >> 2)
    q1_s = np.where(sq, (q2 + q1 + q0 + p0 + 2) >> 2, q1)
    q2_s = np.where(sq, (2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3, q2)

    is4 = bs >= 4
    po = p.copy()
    qo = q.copy()
    po[:, 3] = np.where(filt, np.where(is4, p0_s, p0_n), p0)
    po[:, 2] = np.where(filt & ~is4, p1_n, np.where(filt & is4, p1_s, p1))
    po[:, 1] = np.where(filt & is4, p2_s, p2)
    qo[:, 0] = np.where(filt, np.where(is4, q0_s, q0_n), q0)
    qo[:, 1] = np.where(filt & ~is4, q1_n, np.where(filt & is4, q1_s, q1))
    qo[:, 2] = np.where(filt & is4, q2_s, q2)
    return po, qo


def _filter_chroma_edge(p, q, bs, alpha, beta, tc0):
    """p: (8, 2) [p1, p0], q: (8, 2) [q0, q1]."""
    p = p.astype(np.int64)
    q = q.astype(np.int64)
    p1, p0 = p[:, 0], p[:, 1]
    q0, q1 = q[:, 0], q[:, 1]
    filt = (bs > 0) & (np.abs(p0 - q0) < alpha) & (np.abs(p1 - p0) < beta) & (np.abs(q1 - q0) < beta)
    tc = tc0 + 1
    delta = np.clip(((q0 - p0) * 4 + (p1 - q1) + 4) >> 3, -tc, tc)
    is4 = bs >= 4
    p0_o = np.where(filt, np.where(is4, (2 * p1 + p0 + q1 + 2) >> 2, np.clip(p0 + delta, 0, 255)), p0)
    q0_o = np.where(filt, np.where(is4, (2 * q1 + q0 + p1 + 2) >> 2, np.clip(q0 - delta, 0, 255)), q0)
    po = p.copy()
    qo = q.copy()
    po[:, 1] = p0_o
    qo[:, 0] = q0_o
    return po, qo


def deblock_frame_np(y, u, v, qp, qp_c, bs_v, bs_h, qp_map=None):
    """Raster-order per-MB deblock; y: (16R, 16C) etc. Returns new planes.

    qp_map: optional (R, C) per-MB luma QP (per-MB-QP streams). Thresholds
    then follow spec 8.7.2: MB-boundary edges use qPav = (QPp + QPq + 1) >> 1
    of the adjoining MBs (chroma averages the per-MB QPc), internal edges the
    MB's own QP; the scalar qp/qp_c arguments are ignored."""
    from ..ops.transform import CHROMA_QP_TABLE

    y = y.astype(np.int64).copy()
    u = u.astype(np.int64).copy()
    v = v.astype(np.int64).copy()
    H, W = y.shape
    R, C = H // 16, W // 16
    if qp_map is not None:
        qp_map = np.asarray(qp_map, np.int64)
        qpc_map = np.asarray(CHROMA_QP_TABLE)[np.clip(qp_map, 0, 51)]

    def thresholds(qp_e):
        qp_e = int(np.clip(qp_e, 0, 51))
        return (int(ALPHA_TABLE[qp_e]), int(BETA_TABLE[qp_e]),
                TC0_TABLE[qp_e])

    alpha = beta = tc0r = alpha_c = beta_c = tc0r_c = None
    if qp_map is None:
        alpha, beta, tc0r = thresholds(qp)
        alpha_c, beta_c, tc0r_c = thresholds(qp_c)

    def tc0_arr(bs, row):
        return np.where(bs >= 4, 0, row[np.clip(bs - 1, 0, 2)])

    for r in range(R):
        for c in range(C):
            if qp_map is not None:
                qpm = int(qp_map[r, c])
                qpl = int(qp_map[r, c - 1]) if c > 0 else qpm
                qpt = int(qp_map[r - 1, c]) if r > 0 else qpm
                qcm = int(qpc_map[r, c])
                qcl = int(qpc_map[r, c - 1]) if c > 0 else qcm
                qct = int(qpc_map[r - 1, c]) if r > 0 else qcm
                th_own = thresholds(qpm)
                th_left = thresholds((qpl + qpm + 1) >> 1)
                th_top = thresholds((qpt + qpm + 1) >> 1)
                thc_own = thresholds(qcm)
                thc_left = thresholds((qcl + qcm + 1) >> 1)
                thc_top = thresholds((qct + qcm + 1) >> 1)
            else:
                th_own = th_left = th_top = (alpha, beta, tc0r)
                thc_own = thc_left = thc_top = (alpha_c, beta_c, tc0r_c)
            y0, x0 = r * 16, c * 16
            # vertical luma edges
            for e in range(4):
                x = x0 + 4 * e
                if x == 0:
                    continue
                al, be, t0 = th_left if e == 0 else th_own
                bs = np.repeat(bs_v[r * 4 : r * 4 + 4, c * 4 + e], 4)
                p, q = _filter_luma_edge(
                    y[y0 : y0 + 16, x - 4 : x], y[y0 : y0 + 16, x : x + 4],
                    bs, al, be, tc0_arr(bs, t0))
                y[y0 : y0 + 16, x - 4 : x] = p
                y[y0 : y0 + 16, x : x + 4] = q
            # horizontal luma edges
            for e in range(4):
                yy = y0 + 4 * e
                if yy == 0:
                    continue
                al, be, t0 = th_top if e == 0 else th_own
                bs = np.repeat(bs_h[r * 4 + e, c * 4 : c * 4 + 4], 4)
                p, q = _filter_luma_edge(
                    y[yy - 4 : yy, x0 : x0 + 16].T, y[yy : yy + 4, x0 : x0 + 16].T,
                    bs, al, be, tc0_arr(bs, t0))
                y[yy - 4 : yy, x0 : x0 + 16] = p.T
                y[yy : yy + 4, x0 : x0 + 16] = q.T
            # chroma
            for plane in (u, v):
                cy0, cx0 = r * 8, c * 8
                for e in range(2):
                    x = cx0 + 4 * e
                    if x == 0:
                        continue
                    al, be, t0 = thc_left if e == 0 else thc_own
                    bs = bs_v[r * 4 + np.arange(8) // 2, c * 4 + 2 * e]
                    p, q = _filter_chroma_edge(
                        plane[cy0 : cy0 + 8, x - 2 : x], plane[cy0 : cy0 + 8, x : x + 2],
                        bs, al, be, tc0_arr(bs, t0))
                    plane[cy0 : cy0 + 8, x - 2 : x] = p
                    plane[cy0 : cy0 + 8, x : x + 2] = q
                for e in range(2):
                    yy = cy0 + 4 * e
                    if yy == 0:
                        continue
                    al, be, t0 = thc_top if e == 0 else thc_own
                    bs = bs_h[r * 4 + 2 * e, c * 4 + np.arange(8) // 2]
                    p, q = _filter_chroma_edge(
                        plane[yy - 2 : yy, cx0 : cx0 + 8].T, plane[yy : yy + 2, cx0 : cx0 + 8].T,
                        bs, al, be, tc0_arr(bs, t0))
                    plane[yy - 2 : yy, cx0 : cx0 + 8] = p.T
                    plane[yy : yy + 2, cx0 : cx0 + 8] = q.T
    return (np.clip(y, 0, 255).astype(np.uint8),
            np.clip(u, 0, 255).astype(np.uint8),
            np.clip(v, 0, 255).astype(np.uint8))


def inter_bs_grids_np(nnz_blk, mv_qpel, intra_mb=None, mv4=None, ref4=None):
    """Numpy twin of ops.deblock.inter_bs_grids.

    intra_mb: optional (R, C) bool grid of intra-coded MBs inside the P
    picture (spec 8.7.2.1: an edge with an intra neighbor takes bS 4 on MB
    edges, 3 inside the MB — our own encoder never emits intra-in-P, but
    conformant third-party streams do; caught by test_conformance).

    mv4/ref4: optional 4x4-granular (R4, C4, 2) MV and (R4, C4) refIdx
    grids (partitioned / multi-reference streams); when given they replace
    the MB-level mv_qpel, and an edge whose sides use different reference
    pictures takes bS >= 1 (8.7.2.1)."""
    nz = (nnz_blk > 0).astype(np.int32)
    if mv4 is not None:
        mv_blk = np.asarray(mv4)
    else:
        mv_blk = np.repeat(np.repeat(mv_qpel, 4, axis=0), 4, axis=1)
    intra_blk = (None if intra_mb is None or not np.any(intra_mb)
                 else np.repeat(np.repeat(np.asarray(intra_mb, bool), 4, 0),
                                4, 1))

    def bs_dir(axis):
        nz_n = np.roll(nz, 1, axis=axis)
        coded = (nz | nz_n) > 0
        mv_n = np.roll(mv_blk, 1, axis=axis)
        far = np.any(np.abs(mv_blk - mv_n) >= 4, axis=-1)
        if ref4 is not None:
            far = far | (np.asarray(ref4) != np.roll(np.asarray(ref4), 1,
                                                     axis=axis))
        bs = np.where(coded, 2, np.where(far, 1, 0)).astype(np.int32)
        if intra_blk is not None:
            either = intra_blk | np.roll(intra_blk, 1, axis=axis)
            mb_edge = np.zeros_like(bs, bool)
            if axis == 1:
                mb_edge[:, 0::4] = True
            else:
                mb_edge[0::4, :] = True
            bs = np.where(either & mb_edge, 4,
                          np.where(either, 3, bs)).astype(np.int32)
        if axis == 1:
            bs[:, 0] = 0
        else:
            bs[0, :] = 0
        return bs

    return bs_dir(1), bs_dir(0)


def intra_bs_grids_np(R, C):
    bs_v = np.full((R * 4, C * 4), 3, np.int32)
    bs_v[:, 0::4] = 4
    bs_v[:, 0] = 0
    bs_h = np.full((R * 4, C * 4), 3, np.int32)
    bs_h[0::4, :] = 4
    bs_h[0, :] = 0
    return bs_v, bs_h
