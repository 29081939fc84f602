"""One deblocking wave step: the CUDA kernel (two entries) and its plain twin.

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
time. Its cost is the launch itself, 254 times per 1080p picture, and what
the host does around each launch. So the kernel (csrc/deblock_wave_step.cu)
has a second entry that works in place on the raster planes,
`deblock_wave_step_inplace`: the MBs (r, c) of wave k = 2r + c are read from
the planes and written back by the kernel, row 0 and column 0 guarded
instead of padded, which leaves the host one launch per wave and nothing
else (ops/deblock_wave.py:run_waves replays the launches of a picture as
one CUDA graph). `deblock_wave_step` on gathered patches is the form of the
TPU kernel and of the plain version. Either way: one thread block of one
warp per MB, patches and meta row staged in shared memory, one thread per
sample line (16 luma, 8 U, 8 V), vertical edges, barrier, horizontal edges,
write back.

CUDA C++ and not Triton: the work is data-dependent branching on short lines
of bytes with a barrier between two phases, and it shares its filters
(csrc/deblock_filters.cuh) with the whole-frame kernel.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .deblock import (
    META_COLS, check_aligned, check_planes, filter_chroma_taps,
    filter_luma_taps)


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


def n_waves(R: int, C: int) -> int:
    return 2 * (R - 1) + C


def wave_rows(k: int, R: int, C: int) -> range:
    """The MB rows r of wave k = 2r + c, ascending (a wave of a picture one
    MB wide can be empty)."""
    return range(max(0, -(-(k - C + 1) // 2)), min(R - 1, k // 2) + 1)


def wave_mbs(k: int, R: int, C: int, device):
    """(r, c) long tensors of the MBs in wave k = 2r + c, r ascending."""
    rows = wave_rows(k, R, C)
    r = torch.arange(rows.start, rows.stop, device=device)
    return r, k - 2 * r


@functools.lru_cache(maxsize=8)
def wave_patch_indices(R: int, C: int, device: torch.device):
    """Per wave: the row and column indices of its MBs' 20x20 luma and 12x12
    chroma patches in the raster planes, the MBs' rows of the meta tensor,
    and the slices of the wave's MBs that have a top / a left neighbour (r
    ascends and c descends along a wave, so only the first MB can be in row
    0 and only the last in column 0). Indices above or left of the picture
    are clamped to 0: such samples are gathered but never filtered against
    (their edges have bS 0) and never scattered back. Built once per
    geometry and device."""
    ar20 = torch.arange(20, device=device) - 4
    ar12 = torch.arange(12, device=device) - 4
    out = []
    for k in range(n_waves(R, C)):
        r, c = wave_mbs(k, R, C, device)
        rows = wave_rows(k, R, C)
        n = len(rows)
        out.append(((r[:, None] * 16 + ar20).clamp(min=0)[:, :, None],
                    (c[:, None] * 16 + ar20).clamp(min=0)[:, None, :],
                    (r[:, None] * 8 + ar12).clamp(min=0)[:, :, None],
                    (c[:, None] * 8 + ar12).clamp(min=0)[:, None, :],
                    r * C + c,
                    slice(int(n > 0 and rows[0] == 0), n),
                    slice(0, n - int(n > 0 and k == 2 * rows[-1]))))
    return out


def deblock_wave_step_inplace_plain(y, u, v, meta, R: int, C: int,
                                    k: int) -> None:
    """Plain PyTorch version of the in-place wave step: gather the patches
    of wave k's MBs from the planes, one plain step, scatter back each MB's
    own block, the 4 columns left of it and the 4 rows above it where the MB
    has that neighbour. The patches of one wave are disjoint, so no scatter
    index repeats."""
    ry, cy, rc, cc, rows, top, left = wave_patch_indices(R, C, y.device)[k]
    outs = deblock_wave_step_plain(y[ry, cy], u[rc, cc], v[rc, cc], meta[rows])
    for p, out, ri, ci in zip((y, u, v), outs, (ry, rc, rc), (cy, cc, cc)):
        p[ri[:, 4:], ci[:, :, 4:]] = out[:, 4:, 4:]
        p[ri[left, 4:], ci[left, :, :4]] = out[left, 4:, :4]
        p[ri[top, :4], ci[top, :, 4:]] = out[top, :4, 4:]


def launch_wave_step_inplace(y, u, v, meta, R: int, C: int, k: int) -> int:
    """Launch the in-place entry of the kernel for wave k on the current
    stream: no check, no count (run_waves captures it into a CUDA graph).
    Returns the number of launches: 1, or 0 for a wave without MBs."""
    from .. import kernels

    if not wave_rows(k, R, C):
        return 0

    ptr = ctypes.c_void_p
    err = kernels.load().deblock_wave_step_inplace_launch(
        ptr(y.data_ptr()), ptr(u.data_ptr()), ptr(v.data_ptr()),
        ptr(meta.data_ptr()), ctypes.c_int(R), ctypes.c_int(C),
        ctypes.c_int(k), ptr(torch.cuda.current_stream(y.device).cuda_stream))
    if err:
        raise RuntimeError(f"deblock_wave_step in-place kernel launch "
                           f"failed: {kernels.error_string(err)}")
    return 1


def deblock_wave_step_inplace(y, u, v, meta, R: int, C: int, k: int) -> None:
    """One deblocking wave step in place: filters the MBs (r, c) of wave
    k = 2r + c where they lie in the raster planes.

    y: (16R, 16C), u/v: (8R, 8C) contiguous uint8 planes; meta: (R*C,
    META_COLS) contiguous int32, all on one device; 0 <= k < n_waves(R, C).
    Waves must be run in ascending order. On CUDA tensors this launches the
    kernel's in-place entry (csrc/deblock_wave_step.cu) on the current
    stream and counts the launch in `deblock_wave_step.launches`; on CPU
    tensors it runs the plain version."""
    check_planes(y, u, v, meta, R, C)
    if not 0 <= k < n_waves(R, C):
        raise ValueError(f"wave {k} outside 0..{n_waves(R, C) - 1}")
    if y.device.type == "cpu":
        deblock_wave_step_inplace_plain(y, u, v, meta, R, C, k)
        return
    check_aligned(y, u, v, meta)
    deblock_wave_step.launches += launch_wave_step_inplace(y, u, v, meta, R,
                                                           C, k)
