"""Frame-level deblocking driver.

PyTorch twin of media_tpu/pipeline/deblock_apply.py. `build_meta` turns the
bS grids and the QP (uniform, or per MB) into the per-MB meta tensor that
ops/deblock_wave.py consumes, exactly as the JAX package fills its meta
columns; `deblock_frame` then runs the wavefront by one of two routes:
kernel="frame", the whole frame in one call of ops/deblock_wave.py, or
kernel="wave", one in-place wave step of ops/deblock_pallas.py per wave
(the twin of the JAX package's _deblock_frame_gather under
MEDIA_TPU_DEBLOCK_KERNEL=pallas; the gathers and scatters of that route
happen inside the kernel here). Either way a CUDA tensor goes through the
CUDA kernel and a CPU tensor through its plain version.

The meta of a P picture (from its symbols) or an I picture comes from
`deblock_meta`: on CUDA tensors the hand-written kernel csrc/deblock_meta.cu,
on CPU tensors its plain version, build_meta over pframe_bs_grids or
intra_bs_grids.
"""

from __future__ import annotations

import ctypes
import functools
import threading

import numpy as np
import torch

from ..ops import deblock as db
from ..ops.deblock_wave import deblock_wave, run_waves
from ..ops.transform import CHROMA_QP_TABLE
from .pframe_core import (
    SYMBOLS_PER_MB, _kernel_qp, _ptr, unpack_symbols_device)


@functools.lru_cache(maxsize=None)
def _qp_tables(device: torch.device):
    tbl = np.stack([db.ALPHA_TABLE, db.BETA_TABLE, db.TC0_TABLE[:, 0],
                    db.TC0_TABLE[:, 1], db.TC0_TABLE[:, 2]], axis=1)
    return (torch.as_tensor(tbl, dtype=torch.int32, device=device),  # (52, 5)
            torch.as_tensor(CHROMA_QP_TABLE, dtype=torch.long, device=device))


def _tc0_sel(bs, rows):
    """bs: (n, E, B); rows: (n or 1, E or 1, 3) tc0 triplets by bS-1."""
    return torch.where(bs == 1, rows[..., 0:1],
                       torch.where(bs == 2, rows[..., 1:2],
                                   torch.where(bs == 3, rows[..., 2:3], 0)))


def _qp_index(qp):
    """A QP (Python int, or 0-d tensor computed on the device) clipped to a
    row index of the threshold tables, without a host read."""
    if torch.is_tensor(qp):
        return qp.long().clamp(0, 51)
    return min(max(qp, 0), 51)


def build_meta(qp, qp_c, bs_v, bs_h, R: int, C: int, qp_map=None):
    """Per-MB deblocking meta (R*C, META_COLS) int32, raster MB order.

    qp/qp_c: the picture's luma and chroma QP, Python ints or 0-d tensors.
    bs_v/bs_h: (4R, 4C) strengths (vertical edge left of / horizontal edge
    above each 4x4 luma block). Frame-border edges are forced to bS 0.
    qp_map: optional (R, C) per-MB luma QP; boundary edges then use
    qPav = (QPp + QPq + 1) >> 1 of the two MBs (spec 8.7.2), chroma averages
    the per-MB QPc, internal edges use the MB's own QP; qp/qp_c are ignored.
    """
    dev = bs_v.device
    n = R * C
    tbl, cqp = _qp_tables(dev)
    bs_v = bs_v.to(torch.int32).clone()
    bs_h = bs_h.to(torch.int32).clone()
    bs_v[:, 0] = 0
    bs_h[0, :] = 0
    # [mb, e, b] = bS at edge e, block b of the MB.
    bsv_mb = bs_v.reshape(R, 4, C, 4).permute(0, 2, 3, 1).reshape(n, 4, 4)
    bsh_mb = bs_h.reshape(R, 4, C, 4).permute(0, 2, 1, 3).reshape(n, 4, 4)
    bscv_mb = bsv_mb[:, (0, 2), :]  # chroma edges sit on luma edges 0 and 2
    bsch_mb = bsh_mb[:, (0, 2), :]
    if qp_map is None:
        row = tbl[_qp_index(qp)]
        row_c = tbl[_qp_index(qp_c)]
        lut = row[None, None, :].expand(n, 8, 5)
        lut_c = row_c[None, None, :].expand(n, 4, 5)
    else:
        qpm = torch.as_tensor(qp_map, device=dev).to(torch.long).reshape(R, C)
        qpc_m = cqp[qpm.clamp(0, 51)]

        def edge_qps(m):
            left = torch.cat([m[:, :1], m[:, :-1]], dim=1)
            top = torch.cat([m[:1, :], m[:-1, :]], dim=0)
            return (left + m + 1) >> 1, (top + m + 1) >> 1

        avl, avt = edge_qps(qpm)
        avl_c, avt_c = edge_qps(qpc_m)
        qp_e = torch.stack([avl, qpm, qpm, qpm, avt, qpm, qpm, qpm], dim=-1)
        qp_ce = torch.stack([avl_c, qpc_m, avt_c, qpc_m], dim=-1)
        lut = tbl[qp_e.clamp(0, 51)].reshape(n, 8, 5)
        lut_c = tbl[qp_ce.clamp(0, 51)].reshape(n, 4, 5)
    tcv_mb = _tc0_sel(bsv_mb, lut[:, 0:4, 2:5])
    tch_mb = _tc0_sel(bsh_mb, lut[:, 4:8, 2:5])
    tccv_mb = _tc0_sel(bscv_mb, lut_c[:, 0:2, 2:5])
    tcch_mb = _tc0_sel(bsch_mb, lut_c[:, 2:4, 2:5])
    meta = torch.cat([
        bsv_mb.reshape(n, 16), bsh_mb.reshape(n, 16),
        tcv_mb.reshape(n, 16), tch_mb.reshape(n, 16),
        bscv_mb.reshape(n, 8), bsch_mb.reshape(n, 8),
        tccv_mb.reshape(n, 8), tcch_mb.reshape(n, 8),
        lut[:, :, 0:2].reshape(n, 16), lut_c[:, :, 0:2].reshape(n, 8),
    ], dim=1).to(torch.int32).contiguous()
    return meta


def _check_route(kernel: str, qp_map) -> None:
    if kernel not in ("frame", "wave"):
        raise ValueError(f"deblock kernel {kernel!r} (expected 'frame' or "
                         "'wave')")
    if kernel == "wave" and qp_map is not None:
        raise NotImplementedError("per-MB QP deblocking requires "
                                  "kernel='frame'")


def _filter(y, u, v, meta, R: int, C: int, kernel: str):
    """Filter copies of the planes, as uint8, by the route `kernel`."""
    y, u, v = (p.to(torch.uint8, copy=True).contiguous() for p in (y, u, v))
    if kernel == "wave":
        run_waves(y, u, v, meta, R, C)
    else:
        deblock_wave(y, u, v, meta, R, C)
    return y, u, v


def deblock_frame(y, u, v, qp, qp_c, bs_v, bs_h, R: int, C: int,
                  qp_map=None, kernel: str = "frame"):
    """Deblock one frame; returns filtered uint8 (y, u, v).

    y: (16R, 16C), u/v: (8R, 8C) planes of 8-bit samples (any integer
    dtype); bs_v/bs_h: (4R, 4C) strengths; qp_map: optional (R, C) per-MB
    luma QP (see build_meta). kernel: "frame" runs the whole-frame wavefront
    (ops/deblock_wave.py), "wave" one in-place wave step per wave
    (ops/deblock_pallas.py; uniform QP only, as in the JAX package). On CUDA
    tensors either launches its CUDA kernel; on CPU tensors its plain
    version. Every filter output stays in 0..255, so filtering uint8 planes
    is exact.
    """
    _check_route(kernel, qp_map)
    meta = build_meta(qp, qp_c, bs_v, bs_h, R, C, qp_map=qp_map)
    return _filter(y, u, v, meta, R, C, kernel)


def _zero_slice_boundaries(bs_h, slice_starts):
    """disable_deblocking_filter_idc == 2: no filtering across slice
    boundaries; the horizontal edges at each interior slice-start MB row get
    bS 0 (the frame border row already is)."""
    for r0 in slice_starts:
        if r0 > 0:
            bs_h = bs_h.clone()
            bs_h[4 * r0, :] = 0
    return bs_h


def pframe_bs_grids(symbols, R: int, C: int, slice_starts: tuple = ()):
    """The (4R, 4C) bS grids of a P picture from its packed symbol tensor
    (on the device)."""
    mv, luma, _cdc, _cac = unpack_symbols_device(symbols)
    blk_nnz = (luma != 0).sum(dim=3)  # (R, C, 16) raster blocks
    nnz_grid = blk_nnz.reshape(R, C, 4, 4).transpose(1, 2).reshape(R * 4, C * 4)
    bs_v, bs_h = db.inter_bs_grids(nnz_grid, mv, R, C)
    return bs_v, _zero_slice_boundaries(bs_h, slice_starts)


# ---- the meta as one CUDA kernel -------------------------------------------


@functools.lru_cache(maxsize=None)
def _meta_table(device: torch.device):
    """(52, 6) int32: build_meta's (alpha, beta, tc0 for bS 1, 2, 3) of each
    QP and its chroma QP, the table csrc/deblock_meta.cuh reads."""
    tbl, cqp = _qp_tables(device)
    return torch.cat([tbl, cqp.to(torch.int32)[:, None]], dim=1).contiguous()


@functools.lru_cache(maxsize=None)
def _slice_rows(slice_starts: tuple, R: int, device: torch.device):
    """(R,) uint8, 1 at each interior slice-start MB row; None without one."""
    rows = [r for r in slice_starts if 0 < r < R]
    if not rows:
        return None
    flags = np.zeros(R, dtype=np.uint8)
    flags[rows] = 1
    return torch.as_tensor(flags, device=device)


def _meta_device(symbols, device) -> torch.device:
    return symbols.device if symbols is not None else torch.device(device)


def deblock_meta_plain(symbols, qp, qp_c, R: int, C: int,
                       slice_starts: tuple = (), qp_map=None,
                       intra: bool = False, device=None):
    """The meta of a P picture (from its (R, C, 386) symbol tensor) or, with
    `intra`, an I picture (symbols unused; `device` names its device), in
    plain PyTorch: deblock_meta's CPU path and the kernel's spec."""
    if intra:
        bs_v, bs_h = db.intra_bs_grids(R, C,
                                       device=_meta_device(symbols, device))
        bs_h = _zero_slice_boundaries(bs_h, slice_starts)
    else:
        bs_v, bs_h = pframe_bs_grids(symbols, R, C, slice_starts)
    return build_meta(qp, qp_c, bs_v, bs_h, R, C, qp_map=qp_map)


def launch_deblock_meta(symbols, qp, qp_c, R: int, C: int,
                        slice_starts: tuple = (), qp_map=None,
                        intra: bool = False, device=None):
    """Launch the meta kernel (csrc/deblock_meta.cu) on the current stream of
    the tensors' device, with that device current: no count. Returns the
    (R*C, META_COLS) int32 meta in a fresh tensor; reads nothing back from
    the device (a device QP is read by the kernel)."""
    from .. import kernels

    R, C = int(R), int(C)
    dev = _meta_device(symbols, device)
    if intra:
        symbols = None
    else:
        if (symbols.dtype != torch.int16
                or tuple(symbols.shape) != (R, C, SYMBOLS_PER_MB)):
            raise ValueError(f"symbols: expected int16 "
                             f"{(R, C, SYMBOLS_PER_MB)}, got {symbols.dtype} "
                             f"{tuple(symbols.shape)}")
        symbols = symbols.contiguous()
    # Each QP by value or read by the kernel (_kernel_qp's forms): a uniform
    # one (qp[0]), or the per-MB map in place of both.
    if qp_map is None:
        q, _, q_value = _kernel_qp(qp, 1, dev, "qp")
        qc, _, qc_value = _kernel_qp(qp_c, 1, dev, "qp_c")
        qmap = None
    else:
        q = qc = None
        q_value = qc_value = 0
        qmap = _kernel_qp(torch.as_tensor(qp_map), R * C, dev, "qp_map")[0]
    meta = torch.empty((R * C, db.META_COLS), dtype=torch.int32, device=dev)
    lib = kernels.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.deblock_meta_launch(
            _ptr(symbols), _ptr(q), q_value, _ptr(qc), qc_value, _ptr(qmap),
            _ptr(_slice_rows(tuple(slice_starts), R, dev)),
            _ptr(_meta_table(dev)), _ptr(meta), R, C, int(bool(intra)),
            ctypes.c_void_p(stream))
    if err:
        raise RuntimeError(f"deblock_meta kernel launch failed: "
                           f"{kernels.error_string(err)}")
    return meta


def deblock_meta(symbols, qp, qp_c, R: int, C: int, slice_starts: tuple = (),
                 qp_map=None, intra: bool = False, device=None):
    """The (R*C, META_COLS) int32 deblocking meta of a P picture, from its
    (R, C, 386) int16 symbol tensor, or with `intra` of an I picture
    (symbols may be None; `device` then names the device). qp/qp_c: Python
    ints or 0-d tensors (the rate loop's QP, read on the device); qp_map:
    optional (R, C) per-MB luma QP (see build_meta); slice_starts: MB rows
    whose top edges are not filtered (disable_deblocking_filter_idc 2). On
    CPU tensors it runs deblock_meta_plain; on CUDA tensors it launches the
    kernel on the current stream and counts the call in
    `deblock_meta.launches`."""
    dev = _meta_device(symbols, device)
    if dev.type == "cpu":
        return deblock_meta_plain(symbols, qp, qp_c, R, C, slice_starts,
                                  qp_map, intra, dev)
    meta = launch_deblock_meta(symbols, qp, qp_c, R, C, slice_starts, qp_map,
                               intra, dev)
    with _COUNT_LOCK:  # sessions in several threads call it
        deblock_meta.launches += 1
    return meta


deblock_meta.launches = 0
_COUNT_LOCK = threading.Lock()


def deblock_pframe_from_symbols(recon_y, recon_u, recon_v, symbols, qp,
                                qp_c, R: int, C: int,
                                slice_starts: tuple = (), qp_map=None,
                                kernel: str = "frame"):
    """Inter deblocking given the packed symbol tensor (on the device).
    qp/qp_c: Python ints or 0-d tensors (the rate loop's QP of this frame);
    qp_map: optional (R, C) per-MB QP as the decoder sees it."""
    _check_route(kernel, qp_map)
    meta = deblock_meta(symbols, qp, qp_c, R, C, slice_starts, qp_map)
    return _filter(recon_y, recon_u, recon_v, meta, R, C, kernel)


def deblock_iframe(recon_y, recon_u, recon_v, qp: int, qp_c: int, R: int,
                   C: int, slice_starts: tuple = (), kernel: str = "frame"):
    _check_route(kernel, None)
    meta = deblock_meta(None, qp, qp_c, R, C, slice_starts, intra=True,
                        device=recon_y.device)
    return _filter(recon_y, recon_u, recon_v, meta, R, C, kernel)
