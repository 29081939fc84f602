"""Launchers of the intra wavefront kernels (csrc/intra_wave.cu).

`launch_intra_encode` runs the IDR's wavefront (the I_16x16 and chroma mode
decisions, with `i4x4` the I_4x4 chain and the per-MB decision, transform,
quantisation and reconstruction) and `launch_intra_recon` the decoder's
I-picture reconstruction from given modes and levels: each one C call that
enqueues one kernel a wave on the current stream of the tensors' device,
with no host read between the waves. They count nothing; the counted
wrappers, which take the plain loops on CPU tensors, are
pipeline/encoder.py:intra_encode and pipeline/decoder_tpu.py:intra_recon.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..ops import intra as intra_ops
from ..ops import transform as T
from .pframe_core import _kernel_plane, _ptr


@functools.lru_cache(maxsize=None)
def i4_taps(device: torch.device):
    """The nine 4x4 modes' samples as the kernels read them: (9, 16, 8) int32,
    per sample the three tap indices into [l3 l2 l1 l0 corner t0 .. t7],
    their weights, the rounding and the shift (ops/intra.py _i4_table)."""
    idx, wgt, rnd, sh = intra_ops._i4_table(torch.device("cpu"))
    return torch.cat([idx.reshape(9, 16, 3).to(torch.int32), wgt,
                      rnd[..., None], sh[..., None]], dim=-1).contiguous().to(
                          device)


def kernel_launches(R: int, C: int, i4x4: bool) -> int:
    """The kernels one call enqueues on an (R, C) MB grid: one a wave that
    holds an MB (with the I_4x4 skew and one MB column, only the even
    waves do)."""
    if i4x4 and C == 1:
        return R
    return (2 if i4x4 else 1) * (R - 1) + C


def _check_qp(qp: int) -> int:
    qp = int(qp)
    if not 0 <= qp <= 51:
        raise ValueError(f"QP {qp} outside 0..51")
    return qp


def _flags(x, R: int, dev, what: str):
    """An (R,) bool tensor on `dev` as the kernels read it, one byte a row."""
    if tuple(x.shape) != (R,) or x.dtype != torch.bool or x.device != dev:
        raise ValueError(f"{what}: expected ({R},) bool on {dev}, got "
                         f"{tuple(x.shape)} {x.dtype} on {x.device}")
    return x.contiguous()


def _symbols(x, shape, dev, what: str, dtype=torch.int32):
    """A symbol array as the kernels read it: `dtype`, contiguous, on
    `dev`."""
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{what} of shape {tuple(x.shape)}, expected "
                         f"{tuple(shape)}")
    if x.device != dev:
        raise ValueError(f"{what} on {x.device}, the picture on {dev}")
    return x.to(dtype).contiguous()


def _tables(dev):
    tb = T._tables(dev)
    return _ptr(tb["mf"]), _ptr(tb["v"]), _ptr(tb["zz"]), _ptr(i4_taps(dev))


def _raise(err: int, what: str) -> None:
    from .. import kernels

    if err:
        raise RuntimeError(f"{what} kernel launch failed: "
                           f"{kernels.error_string(err)}")


def launch_intra_encode(y, u, v, qp: int, qp_c: int, row_has_top,
                        i4x4: bool):
    """Launch the IDR's wavefront on the planes y (16R, 16C), u, v (8R, 8C)
    (any integer type; int32 with unit column stride is read in place) of
    one device. row_has_top: (R,) bool, row r's top neighbours usable.
    Returns the symbol dict of encoder.intra_encode_plain in fresh tensors
    (int32; is_i4 bool), the recon planes uint8."""
    from .. import kernels

    H, W = y.shape
    R, C = H // 16, W // 16
    if H % 16 or W % 16 or R == 0 or C == 0:
        raise ValueError(f"luma plane {tuple(y.shape)} is not a grid of MBs")
    dev = y.device
    planes = [_kernel_plane(p, shape, dev, what) for p, shape, what in (
        (y, (H, W), "y"), (u, (H // 2, W // 2), "u"),
        (v, (H // 2, W // 2), "v"))]
    has_top = _flags(row_has_top, R, dev, "row_has_top")
    qp, qp_c = _check_qp(qp), _check_qp(qp_c)

    def empty(*shape, dtype=torch.int32):
        return torch.empty(shape, dtype=dtype, device=dev)

    out = {"mode16": empty(R, C), "chroma_mode": empty(R, C),
           "dc_levels": empty(R, C, 16), "ac_levels": empty(R, C, 16, 15),
           "cdc_levels": empty(R, C, 2, 4),
           "cac_levels": empty(R, C, 2, 4, 15)}
    if i4x4:
        out.update(is_i4=empty(R, C, dtype=torch.bool),
                   modes4=empty(R, C, 16), luma4_levels=empty(R, C, 16, 16))
    recon = (empty(H, W, dtype=torch.uint8),
             empty(H // 2, W // 2, dtype=torch.uint8),
             empty(H // 2, W // 2, dtype=torch.uint8))
    strides = (ctypes.c_int64 * 3)(*(p.stride(0) for p in planes))
    lib = kernels.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.intra_encode_launch(
            *(_ptr(p) for p in planes), ctypes.cast(strides, ctypes.c_void_p),
            _ptr(has_top), qp, qp_c, *_tables(dev),
            *(_ptr(out.get(k)) for k in (
                "mode16", "chroma_mode", "dc_levels", "ac_levels",
                "cdc_levels", "cac_levels", "is_i4", "modes4",
                "luma4_levels")),
            *(_ptr(p) for p in recon), R, C, int(bool(i4x4)),
            ctypes.c_void_p(stream))
    _raise(err, "intra_encode")
    out["recon_y"], out["recon_u"], out["recon_v"] = recon
    return out


def launch_intra_recon(R: int, C: int, mode16, chroma_mode, luma_sym,
                       chroma_sym, qp: int, qp_c: int, row_has_top,
                       i4_sym=None):
    """Launch the decoder's I-picture reconstruction of an (R, C) MB grid
    from its modes and levels (the arguments of
    decoder_tpu.intra_recon_plain, on one device; qp_c the chroma QP;
    row_has_top as for launch_intra_encode). Returns the recon planes,
    uint8, in fresh tensors."""
    from .. import kernels

    R, C = int(R), int(C)
    dev = mode16.device
    dc, ac = luma_sym
    cdc, cac = chroma_sym
    arrays = [_symbols(x, shape, dev, what) for x, shape, what in (
        (mode16, (R, C), "mode16"), (chroma_mode, (R, C), "chroma_mode"),
        (dc, (R, C, 16), "dc_levels"), (ac, (R, C, 16, 15), "ac_levels"),
        (cdc, (R, C, 2, 4), "cdc_levels"),
        (cac, (R, C, 2, 4, 15), "cac_levels"))]
    i4 = [None] * 3
    if i4_sym is not None:
        is_i4, modes4, luma4 = i4_sym
        i4 = [_symbols(is_i4, (R, C), dev, "is_i4", torch.bool),
              _symbols(modes4, (R, C, 16), dev, "modes4"),
              _symbols(luma4, (R, C, 16, 16), dev, "luma4_levels")]
    has_top = _flags(row_has_top, R, dev, "row_has_top")
    qp, qp_c = _check_qp(qp), _check_qp(qp_c)
    recon = tuple(torch.empty((s * R, s * C), dtype=torch.uint8, device=dev)
                  for s in (16, 8, 8))
    lib = kernels.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.intra_recon_launch(
            *(_ptr(x) for x in arrays + i4), _ptr(has_top), qp, qp_c,
            *_tables(dev), *(_ptr(p) for p in recon), R, C,
            ctypes.c_void_p(stream))
    _raise(err, "intra_recon")
    return recon
