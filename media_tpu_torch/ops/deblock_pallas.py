"""One deblocking wave step on gathered MB patches: the CUDA kernel and its
plain twin.

Replaces media_tpu/ops/deblock_pallas.py:deblock_wave_pallas, the TPU kernel
that filters the N independent macroblocks of ONE wave of in-loop deblocking
(spec 8.7) in one launch. Each MB comes as a 20x20 luma patch and two 12x12
chroma patches: its own samples at [4:, 4:] with 4 samples of the left and
top neighbours around them. All 4 vertical luma edges are filtered, then all
4 horizontal ones, likewise 2 + 2 per chroma plane (the normative order on
patches whose neighbour strips are final). The per-edge bS, tc0, alpha and
beta come as the MB's row of the meta tensor (ops/deblock.py:META_COLS),
which carries what the TPU kernel takes as eight strength arrays and four
scalars; the meta row also allows per-MB thresholds.

Nothing on an H100 bounds this kernel: a wave is at most 60 MBs at 1080p,
about 1.2 KB in and 0.7 KB out per MB, far under a microsecond of memory
time. Its cost is the launch itself and the gathers and scatters around it,
254 times per 1080p picture. The design (csrc/deblock_wave_step.cu): one
thread block of one warp per MB patch, patches and meta row staged in shared
memory, one thread per sample line (16 luma, 8 U, 8 V), vertical edges,
barrier, horizontal edges, write back.

CUDA C++ and not Triton: the work is data-dependent branching on short lines
of bytes with a barrier between two phases, and it shares its line filters
(csrc/deblock_filters.cuh) with the whole-frame kernel.
"""

from __future__ import annotations

import ctypes

import torch

from .deblock import META_COLS, filter_chroma_taps, filter_luma_taps


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


def deblock_wave_step_plain(yp, up, vp, meta):
    """Plain PyTorch version of one wave step.

    yp: (N, 20, 20), up/vp: (N, 12, 12) patches of 8-bit samples in any
    integer dtype; meta: (N, META_COLS) int32 rows of the patches' MBs.
    Returns new filtered (yp, up, vp) of the input dtype; every filter output
    stays in 0..255."""
    out = [p.to(torch.int32, copy=True) for p in (yp, up, vp)]
    _luma_edges(out[0], meta)
    _chroma_edges(out[1], meta)
    _chroma_edges(out[2], meta)
    return tuple(o.to(p.dtype) for o, p in zip(out, (yp, up, vp)))


def _check(yp, up, vp, meta) -> None:
    n = yp.shape[0] if yp.dim() == 3 else -1
    if n < 1:
        raise ValueError(f"yp: expected (N >= 1, 20, 20), got "
                         f"{tuple(yp.shape)}")
    for name, p, size in (("yp", yp, 20), ("up", up, 12), ("vp", vp, 12)):
        if p.dtype != torch.uint8 or tuple(p.shape) != (n, size, size):
            raise ValueError(f"{name}: expected uint8 (N, {size}, {size}), "
                             f"got {p.dtype} {tuple(p.shape)}")
        if not p.is_contiguous() or p.device != yp.device:
            raise ValueError(f"{name}: must be contiguous on {yp.device}")
    if (meta.dtype != torch.int32 or tuple(meta.shape) != (n, META_COLS)
            or not meta.is_contiguous() or meta.device != yp.device):
        raise ValueError(f"meta: expected contiguous int32 ({n}, "
                         f"{META_COLS}) on {yp.device}")


def deblock_wave_step(yp, up, vp, meta):
    """One deblocking wave step on N MB patches; returns new filtered
    (yp, up, vp).

    yp: (N, 20, 20), up/vp: (N, 12, 12) contiguous uint8 (8-bit samples, so
    uint8 is exact); meta: (N, META_COLS) contiguous int32, all on one
    device. On CUDA tensors this launches the kernel
    (csrc/deblock_wave_step.cu) on the current stream and counts the launch
    in `deblock_wave_step.launches`; on CPU tensors it runs the plain
    version."""
    _check(yp, up, vp, meta)
    if yp.device.type == "cpu":
        return deblock_wave_step_plain(yp, up, vp, meta)
    from .. import kernels

    lib = kernels.load()
    out = tuple(torch.empty_like(p) for p in (yp, up, vp))
    ptr = ctypes.c_void_p
    err = lib.deblock_wave_step_launch(
        ptr(yp.data_ptr()), ptr(up.data_ptr()), ptr(vp.data_ptr()),
        ptr(meta.data_ptr()), *(ptr(o.data_ptr()) for o in out),
        ctypes.c_int(yp.shape[0]),
        ptr(torch.cuda.current_stream(yp.device).cuda_stream))
    if err:
        raise RuntimeError(f"deblock_wave_step kernel launch failed: "
                           f"{kernels.error_string(err)}")
    deblock_wave_step.launches += 1
    return out


deblock_wave_step.launches = 0
