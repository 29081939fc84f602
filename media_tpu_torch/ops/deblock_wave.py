"""Whole-frame H.264 deblocking wavefront: the CUDA kernel and its plain twin.

Replaces media_tpu/ops/deblock_wave_pallas.py:deblock_wavemajor_pallas, the
TPU kernel that runs the entire skewed MB wavefront of in-loop deblocking
(spec 8.7) in one launch. Both versions here compute the same function of
raster-order inputs: the planes, filtered in place, given a per-MB meta
tensor (see META_COLS) that the caller builds from the bS grids and the
per-edge thresholds (pipeline/deblock_apply.py:build_meta).

MB (r, c) filters its own 16x16 block plus the 4 columns of its left
neighbour and the 4 rows of its top neighbour, all vertical edges first,
then all horizontal edges (chroma likewise). So (r, c) depends on (r, c-1),
(r-1, c) and (r-1, c+1), and the MBs of one wave k = 2r + c are independent:
their working patches are disjoint. The 2R+C-2 waves (254 at 1080p) must run
in order.

What bounds the kernel on an H100 is the latency of that dependent wave
chain, not bytes or arithmetic: a 1080p frame is 3 MB and the filter math is
a few hundred operations per sample line. The design
(csrc/deblock_wave.cu): one persistent thread block walks the waves in order
and indexes MB (r, c) of wave k directly in the raster planes (no wave-major
shear, which existed for the TPU's DMA); one thread filters one line (row or
column) of one MB for all four edges, so only two __syncthreads() separate
the phases of a wave; the frame stays in L2. Reads at c = 0 / r = 0 are
guarded (bS is 0 there). That uses one SM of 132. Later work should measure
a cooperative grid with a grid-wide barrier per wave, and one launch per
wave captured in a CUDA graph, against it.
"""

from __future__ import annotations

import ctypes

import torch

from .deblock import filter_chroma_taps, filter_luma_taps

# Per-MB meta columns (int32, raster MB order):
#   0:16   bS of vertical luma edges   [edge e, 4x4 block row b]
#   16:32  bS of horizontal luma edges [edge e, 4x4 block column b]
#   32:48  tc0 of vertical luma edges, 48:64 tc0 of horizontal luma edges
#   64:72  bS of chroma vertical edges [edge 0/1 = luma edge 0/2, block b]
#   72:80  bS of chroma horizontal edges, 80:88 / 88:96 their tc0
#   96:112 luma (alpha, beta) per edge: vertical 0-3, then horizontal 0-3
#   112:120 chroma (alpha, beta) per edge: v0, v1, h0, h1
META_COLS = 120


def n_waves(R: int, C: int) -> int:
    return 2 * (R - 1) + C


def wave_mbs(k: int, R: int, C: int, device):
    """(r, c) long tensors of the MBs in wave k = 2r + c, r ascending."""
    lo = max(0, -(-(k - C + 1) // 2))
    hi = min(R - 1, k // 2)
    r = torch.arange(lo, hi + 1, device=device)
    return r, k - 2 * r


def _luma_edges(patch, m):
    """Filter the 4 vertical then 4 horizontal luma edges of (N, 20, 20)
    int32 patches in place (own MB at [4:20, 4:20])."""
    n = patch.shape[0]
    bsv = m[:, 0:16].reshape(n, 4, 4).repeat_interleave(4, dim=2)
    bsh = m[:, 16:32].reshape(n, 4, 4).repeat_interleave(4, dim=2)
    tcv = m[:, 32:48].reshape(n, 4, 4).repeat_interleave(4, dim=2)
    tch = m[:, 48:64].reshape(n, 4, 4).repeat_interleave(4, dim=2)
    for e in range(4):
        x = 4 + 4 * e
        taps = [patch[:, 4:20, x - 4 + t] for t in range(8)]
        out = filter_luma_taps(*taps, bsv[:, e], m[:, 96 + 2 * e, None],
                               m[:, 97 + 2 * e, None], tcv[:, e])
        for t, val in enumerate(out):
            patch[:, 4:20, x - 3 + t] = val
    for e in range(4):
        yy = 4 + 4 * e
        taps = [patch[:, yy - 4 + t, 4:20] for t in range(8)]
        out = filter_luma_taps(*taps, bsh[:, e], m[:, 104 + 2 * e, None],
                               m[:, 105 + 2 * e, None], tch[:, e])
        for t, val in enumerate(out):
            patch[:, yy - 3 + t, 4:20] = val


def _chroma_edges(cp, m):
    """Filter the 2 vertical then 2 horizontal edges of (N, 12, 12) int32
    chroma patches in place (own block at [4:12, 4:12])."""
    n = cp.shape[0]
    bsv = m[:, 64:72].reshape(n, 2, 4).repeat_interleave(2, dim=2)
    bsh = m[:, 72:80].reshape(n, 2, 4).repeat_interleave(2, dim=2)
    tcv = m[:, 80:88].reshape(n, 2, 4).repeat_interleave(2, dim=2)
    tch = m[:, 88:96].reshape(n, 2, 4).repeat_interleave(2, dim=2)
    for e in range(2):
        x = 4 + 4 * e
        p0, q0 = filter_chroma_taps(
            cp[:, 4:12, x - 2], cp[:, 4:12, x - 1], cp[:, 4:12, x],
            cp[:, 4:12, x + 1], bsv[:, e], m[:, 112 + 2 * e, None],
            m[:, 113 + 2 * e, None], tcv[:, e])
        cp[:, 4:12, x - 1] = p0
        cp[:, 4:12, x] = q0
    for e in range(2):
        yy = 4 + 4 * e
        p0, q0 = filter_chroma_taps(
            cp[:, yy - 2, 4:12], cp[:, yy - 1, 4:12], cp[:, yy, 4:12],
            cp[:, yy + 1, 4:12], bsh[:, e], m[:, 116 + 2 * e, None],
            m[:, 117 + 2 * e, None], tch[:, e])
        cp[:, yy - 1, 4:12] = p0
        cp[:, yy, 4:12] = q0


def deblock_wave_plain(y, u, v, meta, R: int, C: int) -> None:
    """Plain PyTorch version: filters the uint8 planes y (16R, 16C) and u/v
    (8R, 8C) in place, one vectorised step per wave. Patches are gathered
    from planes zero-padded by 4 at the top and left; border edges have
    bS 0, so the padding is never filtered against."""
    dev = y.device
    planes = []
    for p in (y, u, v):
        pp = torch.zeros((p.shape[0] + 4, p.shape[1] + 4), dtype=torch.int32,
                         device=dev)
        pp[4:, 4:] = p
        planes.append(pp)
    yp, up, vp = planes
    ar20 = torch.arange(20, device=dev)
    ar12 = torch.arange(12, device=dev)
    for k in range(n_waves(R, C)):
        r, c = wave_mbs(k, R, C, dev)
        m = meta[r * C + c]
        ry = (r[:, None] * 16 + ar20)[:, :, None]
        cy = (c[:, None] * 16 + ar20)[:, None, :]
        patch = yp[ry, cy]
        _luma_edges(patch, m)
        yp[ry, cy] = patch
        rc = (r[:, None] * 8 + ar12)[:, :, None]
        cc = (c[:, None] * 8 + ar12)[:, None, :]
        for cpl in (up, vp):
            cp = cpl[rc, cc]
            _chroma_edges(cp, m)
            cpl[rc, cc] = cp
    y.copy_(yp[4:, 4:])
    u.copy_(up[4:, 4:])
    v.copy_(vp[4:, 4:])


def _check(y, u, v, meta, R: int, C: int) -> None:
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


def deblock_wave(y, u, v, meta, R: int, C: int) -> None:
    """Deblock a whole frame in place. On a CUDA tensor this launches the
    kernel (csrc/deblock_wave.cu) on the current stream and counts the
    launch in `deblock_wave.launches`; on a CPU tensor it runs the plain
    version."""
    _check(y, u, v, meta, R, C)
    if y.device.type == "cpu":
        deblock_wave_plain(y, u, v, meta, R, C)
        return
    from .. import kernels

    lib = kernels.load()
    err = lib.deblock_wave_launch(
        ctypes.c_void_p(y.data_ptr()), ctypes.c_void_p(u.data_ptr()),
        ctypes.c_void_p(v.data_ptr()), ctypes.c_void_p(meta.data_ptr()),
        ctypes.c_int(R), ctypes.c_int(C),
        ctypes.c_void_p(torch.cuda.current_stream(y.device).cuda_stream))
    if err:
        raise RuntimeError(f"deblock_wave kernel launch failed: "
                           f"{kernels.error_string(err)}")
    deblock_wave.launches += 1


deblock_wave.launches = 0
