"""GPU-backed H.264 decoder: host entropy parse, device reconstruction.

PyTorch twin of media_tpu/pipeline/decoder_tpu.py:TpuDecoder (same module
and class name, so a reader finds the counterpart). The serial stages stay
on the host (NAL scan, slice headers, CAVLC symbol parse), and everything
with pixel-level parallelism runs as batched tensor ops on the device:
inverse quant + IDCT, quarter-pel motion compensation (half-pel planes, one
window gather per plane per MB, a 16-way sub-pel select), wavefront intra
reconstruction and the in-loop deblocking filter (pipeline/deblock_apply.py,
either of its two routes). Reference planes stay on the device between AUs.

The entropy parse runs in the C++ parsers of native/ (CABAC P and I slices;
CAVLC P slices that cover the rest of the picture) and in the Python
parsers where those refuse a slice, for multi-slice CAVLC pictures, for
CAVLC I slices, and throughout with host_parser="python".

Scope: CAVLC and CABAC streams of single- or multi-slice pictures
(row-aligned slices, assembled per picture), P_Skip / P_L0_16x16, I_16x16
and I_4x4 macroblocks, per-MB QP in P slices,
disable_deblocking_filter_idc 0/1/2, |MV| within the supported window.
Anything else (B pictures, POC type 0, I_PCM among it) raises
UnsupportedStream, as in the JAX package. Unlike there, only the parse of a
slice (and the MV window and route checks made before any device work)
turns an error into UnsupportedStream: an error of the device
reconstruction or of a kernel wrapper propagates as it is, so that a caller
that falls back on UnsupportedStream never hides a device fault.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from .. import native
from ..core import nal as nal_mod
from ..core.bitstream import BitReader
from ..core.syntax import PPS, SPS, SliceHeader
from ..device import resolve_device
from ..entropy import cabac_slice, cavlc
from ..entropy.cavlc_tables import CBP_TABLE
from ..ops import interp as interp_ops
from ..ops import intra as intra_ops
from ..ops import transform as T
from ..ops.pad import edge_pad
from . import mv_pred
from .deblock_apply import deblock_iframe, deblock_pframe_from_symbols
from .encoder import ZSCAN_TO_RASTER, i4_chain, wave_lanes
from .intra_wave import kernel_launches, launch_intra_recon
from .pframe_core import (
    _TAPS, INTERP_HALO, SYMBOLS_PER_MB, _blocks8_mb, _blocks_mb, _mb_origins,
    _windows, from_mbs, mc_chroma_ext)
from .slice_coder import UnsupportedStream, parse_islice_mbs

# Supported integer MV reach (full-pel) of the device MC windows; the
# encoder's search range (8) plus sub-pel refinement stays well inside.
MV_RANGE = 10


@dataclass
class DecodedFrame:
    """A decoded picture on the host (MB-padded planes)."""

    y: np.ndarray
    u: np.ndarray
    v: np.ndarray
    frame_num: int
    idr: bool
    poc: int = 0  # PicOrderCnt (display order); 0 under POC type 2


# ------------------------------------------------------------- host parsing


def parse_pslice_symbols(br: BitReader, R: int, C: int, slice_qp: int = 26,
                         partial: bool = False):
    """CAVLC P-slice symbol parse (no reconstruction): the inverse of
    pipeline/slice_coder.write_pslice_mbs. Tracks mb_qp_delta into a per-MB
    QP map (adaptive-quantization streams).

    partial: stop at the RBSP end instead of requiring R*C macroblocks
    (multi-slice pictures: the caller parses each slice into a local array
    with slice-local neighbor rules, then assembles). The returned dict's
    "covered" is the number of MBs parsed."""
    mv = np.zeros((R, C, 2), np.int32)
    luma = np.zeros((R, C, 16, 16), np.int32)
    cdc = np.zeros((R, C, 2, 4), np.int32)
    cac = np.zeros((R, C, 2, 4, 15), np.int32)
    qp_map = np.full((R, C), slice_qp, np.int32)
    cur_qp = int(slice_qp)
    luma_nnz = np.zeros((R * 4, C * 4), np.int32)
    chroma_nnz = np.zeros((2, R * 2, C * 2), np.int32)
    mv_map: dict = {}

    def nc_of(nnz, by, bx):
        a_av = bx > 0
        b_av = by > 0
        na = int(nnz[by, bx - 1]) if a_av else 0
        nb = int(nnz[by - 1, bx]) if b_av else 0
        if a_av and b_av:
            return (na + nb + 1) >> 1
        return na if a_av else (nb if b_av else 0)

    idx = 0
    n = R * C
    while idx < n and (not partial or idx == 0 or br.more_rbsp_data()):
        run = br.ue()
        for _ in range(run):
            if idx >= n:
                raise UnsupportedStream("skip run past slice end")
            r, c = divmod(idx, C)
            smv = mv_pred.skip_mv(mv_map, r, c, C)
            mv[r, c] = smv
            mv_map[(r, c)] = smv
            idx += 1
        if idx >= n:
            break
        r, c = divmod(idx, C)
        mb_type = br.ue()
        if mb_type != 0:
            raise UnsupportedStream(f"P mb_type {mb_type}")
        mvdx = br.se()
        mvdy = br.se()
        px, py = mv_pred.predict_mv(mv_map, r, c, C)
        this = (px + mvdx, py + mvdy)
        mv[r, c] = this
        mv_map[(r, c)] = this
        cbp = int(CBP_TABLE[br.ue()][1])
        cbp_luma, cbp_chroma = cbp & 15, cbp >> 4
        if cbp:
            cur_qp = (cur_qp + br.se() + 52) % 52
        qp_map[r, c] = cur_qp
        for g8 in range(4):
            blks = [int(ZSCAN_TO_RASTER[g8 * 4 + k]) for k in range(4)]
            if not (cbp_luma >> g8) & 1:
                for b in blks:
                    luma_nnz[r * 4 + b // 4, c * 4 + b % 4] = 0
                continue
            for b in blks:
                by, bx = r * 4 + b // 4, c * 4 + b % 4
                coeffs, tc = cavlc.decode_block(br, nc_of(luma_nnz, by, bx), 16)
                luma[r, c, b] = coeffs
                luma_nnz[by, bx] = tc
        if cbp_chroma:
            for comp in range(2):
                coeffs, _ = cavlc.decode_block(br, -1, 4)
                cdc[r, c, comp] = coeffs
        if cbp_chroma == 2:
            for comp in range(2):
                for b in range(4):
                    by, bx = r * 2 + b // 2, c * 2 + b % 2
                    coeffs, tc = cavlc.decode_block(
                        br, nc_of(chroma_nnz[comp], by, bx), 15)
                    cac[r, c, comp, b] = coeffs
                    chroma_nnz[comp, by, bx] = tc
        else:
            chroma_nnz[:, r * 2 : r * 2 + 2, c * 2 : c * 2 + 2] = 0
        idx += 1
    return {"mv": mv, "luma_levels": luma, "cdc_levels": cdc,
            "cac_levels": cac, "qp_map": qp_map, "covered": idx}


# -------------------------------------------------------- device P recon


def _luma_mc_device(ref_y, mv, R: int, C: int):
    """Quarter-pel luma MC for arbitrary per-MB MVs within MV_RANGE.

    ref_y: (H, W) int32; mv: (N, 2) int32 quarter-pel. Builds the three
    half-pel planes once, gathers one 18x18 window per plane per MB at the
    integer base (row 0 of a window sits one sample above and left of it),
    then selects among the 16 sub-pel positions (spec Table 8-12): the
    decode-side twin of the encoder's refine_subpel. `>> 2` and `& 3` floor
    on negative MVs, as the spec's integer and fractional parts do."""
    n = R * C
    pad_off = MV_RANGE + INTERP_HALO
    plane = edge_pad(ref_y, pad_off, pad_off, pad_off, pad_off)
    hp_b, hp_h, hp_j = interp_ops.half_pel_planes(plane)
    r0, c0 = _mb_origins(R, C, 16, mv.device)
    row0 = pad_off + r0 + (mv[:, 1] >> 2) - 1
    col0 = pad_off + c0 + (mv[:, 0] >> 2) - 1

    shifts = {}
    for name, p in (("g", plane), ("b", hp_b), ("h", hp_h), ("j", hp_j)):
        w = _windows(p, row0, col0, 18).to(torch.int32)
        shifts[name] = {(oy, ox): w[:, oy : oy + 16, ox : ox + 16].reshape(n, 256)
                        for oy in (1, 2) for ox in (1, 2)}

    def pred_flat(xf, yf):
        vals = [shifts[p][(1 + py, 1 + px)] for p, px, py in _TAPS[(xf, yf)]]
        if len(vals) == 1:
            return vals[0]
        return (vals[0] + vals[1] + 1) >> 1

    preds = torch.stack([pred_flat(xf, yf) for yf in range(4)
                         for xf in range(4)], dim=1)  # (N, 16, 256)
    sel = ((mv[:, 1] & 3) * 4 + (mv[:, 0] & 3)).long()
    return preds[torch.arange(n, device=mv.device), sel].reshape(n, 16, 16)


def _chroma_recon(pred_c, cdc_c, cac_c, qp_c):
    """Decode-side chroma residual chain (the reconstruction half of
    pframe_core._chroma_code). qp_c: int or per-MB (N,) tensor."""
    n = pred_c.shape[0]
    d2 = T.dequant_dc_2x2(T.hadamard_2x2(cdc_c.reshape(n, 2, 2)), qp_c)
    z_ac = T.inverse_zigzag(torch.cat(
        [torch.zeros((n, 4, 1), dtype=torch.int32, device=cac_c.device),
         cac_c], dim=2))
    d_c = T.dequant_4x4(z_ac, qp_c)
    d_c[:, :, 0, 0] = d2.reshape(n, 4)
    return (pred_c + _blocks8_mb(T.inverse_4x4(d_c))).clamp(0, 255)


def _recon_pframe_device_sparse(R: int, C: int, ref_y, ref_u, ref_v, mv,
                                nz_idx_vals, deblock: bool, qp: int,
                                qp_map=None, slice_starts: tuple = (),
                                kernel: str = "frame"):
    """P recon from a SPARSE level representation: (idx, vals) scattered
    into the flat per-MB level space (256 luma + 8 cdc + 120 cac = 384 per
    MB).

    Residual levels are typically a few percent nonzero; dense int32 symbol
    tensors are about 13 MB per 1080p frame on the host link, (idx int32,
    val int16) of the nonzero entries a small fraction of that. idx holds
    distinct positions, so the scatter is well defined."""
    n = R * C
    idx, vals = nz_idx_vals
    dense = torch.zeros((n * 384,), dtype=torch.int32, device=mv.device)
    dense[idx.long()] = vals.to(torch.int32)
    per_mb = dense.reshape(n, 384)
    luma = per_mb[:, :256].reshape(R, C, 16, 16)
    cdc = per_mb[:, 256:264].reshape(R, C, 2, 4)
    cac = per_mb[:, 264:].reshape(R, C, 2, 4, 15)
    return _recon_pframe_body(R, C, ref_y, ref_u, ref_v, mv, luma,
                              (cdc, cac), deblock, qp, qp_map, slice_starts,
                              kernel)


def _recon_pframe_body(R: int, C: int, ref_y, ref_u, ref_v, mv, luma,
                       symbols_cdc_cac, deblock: bool, qp: int, qp_map=None,
                       slice_starts: tuple = (), kernel: str = "frame"):
    """qp: slice QP; qp_map: optional (R, C) per-MB QP tensor (mb_qp_delta
    streams) for the residual dequant and the per-edge qPav deblocking
    thresholds (spec 8.7.2). All tensors int32 on one device; returns uint8
    planes."""
    cdc, cac = symbols_cdc_cac
    n = R * C
    qp_c = int(T.chroma_qp(qp))
    if qp_map is None:
        qp_res, qp_c_res = qp, qp_c
    else:
        qp_res = qp_map.reshape(n)
        qp_c_res = torch.as_tensor(T.CHROMA_QP_TABLE, device=mv.device)[
            qp_res.long().clamp(0, 51)]
    mvf = mv.reshape(n, 2)
    pred_y = _luma_mc_device(ref_y.to(torch.int32), mvf, R, C)
    # Chroma MC pads rows only; mc_chroma_ext extends the columns itself.
    halo_c = MV_RANGE // 2 + 2
    pred_u = mc_chroma_ext(edge_pad(ref_u.to(torch.int32), halo_c, halo_c, 0, 0),
                           mvf, R, C, halo_c)
    pred_v = mc_chroma_ext(edge_pad(ref_v.to(torch.int32), halo_c, halo_c, 0, 0),
                           mvf, R, C, halo_c)

    z = T.inverse_zigzag(luma.reshape(n, 16, 16))
    res = _blocks_mb(T.inverse_4x4(T.dequant_4x4(z, qp_res)))
    recon = (pred_y + res).clamp(0, 255)
    rec_u = _chroma_recon(pred_u, cdc.reshape(n, 2, 4)[:, 0],
                          cac.reshape(n, 2, 4, 15)[:, 0], qp_c_res)
    rec_v = _chroma_recon(pred_v, cdc.reshape(n, 2, 4)[:, 1],
                          cac.reshape(n, 2, 4, 15)[:, 1], qp_c_res)
    ry, ru, rv = (from_mbs(x, R, C, size).to(torch.uint8)
                  for x, size in ((recon, 16), (rec_u, 8), (rec_v, 8)))
    if deblock:
        # deblock_pframe_from_symbols takes the encoder's packed symbol tensor.
        symbols = torch.cat([
            mvf, luma.reshape(n, 256), cdc.reshape(n, 8),
            cac.reshape(n, 120)], dim=-1).to(torch.int16).reshape(
                R, C, SYMBOLS_PER_MB)
        ry, ru, rv = deblock_pframe_from_symbols(
            ry, ru, rv, symbols, qp, qp_c, R, C, slice_starts=slice_starts,
            qp_map=qp_map, kernel=kernel)
    return ry, ru, rv


# -------------------------------------------------------- device I recon


def _recon_iframe_device(R: int, C: int, mode16, chroma_mode, luma_sym,
                         chroma_sym, qp: int, deblock: bool,
                         slice_starts: tuple = (),
                         deblock_starts: tuple = (), kernel: str = "frame",
                         i4_sym=None):
    """Wavefront intra reconstruction with given modes and levels
    (intra_recon; the JAX package's _recon_iframe_device and
    _recon_iframe_mixed_device in one), then the in-loop filter.

    slice_starts: rows starting a new slice (intra prediction never crosses
    them). deblock_starts: rows the filter must not cross
    (disable_deblocking_filter_idc == 2; empty when idc == 0). i4_sym: None
    for an I_16x16 picture, else (is_i4, modes4, luma4) of a mixed
    I_16x16 / I_4x4 picture (see intra_recon_plain). Returns uint8
    planes."""
    planes = intra_recon(R, C, mode16, chroma_mode, luma_sym, chroma_sym, qp,
                         slice_starts, i4_sym)
    if deblock:
        return deblock_iframe(*planes, qp, int(T.chroma_qp(qp)), R, C,
                              deblock_starts, kernel=kernel)
    return planes


def row_has_top(R: int, slice_starts: tuple, device):
    """(R,) bool: whether MB row r may predict from the row above; false at
    row 0 and at every slice start (intra never crosses a slice boundary).
    Built on the device, with no copy from the host."""
    rows = torch.arange(R, device=device)
    has_top = rows > 0
    for sr in slice_starts:
        has_top &= rows != sr
    return has_top


def intra_recon_plain(R: int, C: int, mode16, chroma_mode, luma_sym,
                      chroma_sym, qp: int, slice_starts: tuple = (),
                      i4_sym=None):
    """The wavefront reconstruction in plain PyTorch (the decode twin of
    encoder.intra_encode_plain's loop over the waves, valid lanes only).
    mode16, chroma_mode (R, C); luma_sym (dc (R, C, 16) zig-zag, ac (R, C,
    16, 15)); chroma_sym (cdc (R, C, 2, 4), cac (R, C, 2, 4, 15)), int32.
    i4_sym: None for an I_16x16 picture (R+C-1 waves), else (is_i4 (R, C)
    bool, modes4 (R, C, 16) z-scan, luma4 (R, C, 16, 16) zig-zag per raster
    block) of a mixed I_16x16 / I_4x4 picture: the skew-2 schedule, and per
    MB the I_16x16 reconstruction or the 16-step I_4x4 chain with the coded
    modes. Returns uint8 planes, before deblocking."""
    dc_levels, ac_levels = luma_sym
    cdc_levels, cac_levels = chroma_sym
    skew = 1 if i4_sym is None else 2
    dev = mode16.device
    i32 = torch.int32
    qp_c = int(T.chroma_qp(qp))
    has_top = row_has_top(R, slice_starts, dev)
    recon_y = torch.zeros((R, C, 16, 16), dtype=i32, device=dev)
    recon_u = torch.zeros((R, C, 8, 8), dtype=i32, device=dev)
    recon_v = torch.zeros((R, C, 8, 8), dtype=i32, device=dev)

    for k in range(skew * (R - 1) + C):
        r, c = wave_lanes(k, R, C, skew, dev)
        lanes = torch.arange(len(r), device=dev)
        avail_top = has_top[r]
        avail_left = c > 0
        rm1 = (r - 1).clamp(min=0)
        cm1 = (c - 1).clamp(min=0)

        top, left = recon_y[rm1, c, 15, :], recon_y[r, cm1, :, 15]
        top_left = recon_y[rm1, cm1, 15, 15]
        preds = intra_ops.pred_16x16_all(top, left, top_left, avail_top,
                                         avail_left)
        pred = preds[lanes, mode16[r, c].long()]
        # Luma residual: DC Hadamard chain + AC blocks.
        f_dc = T.hadamard_4x4(T.inverse_zigzag(dc_levels[r, c]))
        d_dc = T.dequant_dc_4x4(f_dc, qp)
        acz = ac_levels[r, c]  # (N, 16, 15)
        z_ac = T.inverse_zigzag(torch.cat(
            [torch.zeros(acz.shape[:-1] + (1,), dtype=i32, device=dev), acz],
            dim=-1))
        d = T.dequant_4x4(z_ac, qp)
        d[:, :, 0, 0] = d_dc.reshape(-1, 16)
        recon = (pred + _blocks_mb(T.inverse_4x4(d))).clamp(0, 255)
        if i4_sym is not None:
            is_i4, modes4, luma4 = i4_sym
            m4 = modes4[r, c].long()  # (N, 16) z-scan
            lv4 = luma4[r, c]  # (N, 16, 16) zig-zag, raster blocks

            def block_step(z, b, y0, x0, preds4, _ok4):
                zl = T.inverse_zigzag(lv4[:, b])
                return (preds4[lanes, m4[:, z]]
                        + T.inverse_4x4(T.dequant_4x4(zl, qp))).clamp(0, 255)

            cur = i4_chain(
                top, left, top_left,
                recon_y[rm1, (c + 1).clamp(max=C - 1), 15, 0:4], avail_top,
                avail_left, avail_top & (c < C - 1), block_step)
            recon = torch.where(is_i4[r, c][:, None, None], cur, recon)
        recon_y[r, c] = recon

        cmode = chroma_mode[r, c].long()
        for comp, plane in enumerate((recon_u, recon_v)):
            preds_c = intra_ops.pred_chroma_all(
                plane[rm1, c, 7, :], plane[r, cm1, :, 7],
                plane[rm1, cm1, 7, 7], avail_top, avail_left)
            plane[r, c] = _chroma_recon(
                preds_c[lanes, cmode], cdc_levels[r, c, comp],
                cac_levels[r, c, comp], qp_c)

    return tuple(x.transpose(1, 2).reshape(R * s, C * s).to(torch.uint8)
                 for x, s in ((recon_y, 16), (recon_u, 8), (recon_v, 8)))


def intra_recon(R: int, C: int, mode16, chroma_mode, luma_sym, chroma_sym,
                qp: int, slice_starts: tuple = (), i4_sym=None):
    """The I picture's reconstruction, as intra_recon_plain defines it. On
    CPU tensors it runs the plain version; on CUDA tensors it launches the
    kernels (csrc/intra_wave.cu, one a wave) on the current stream, counts
    the call in `intra_recon.launches` and the kernels it enqueued in
    `intra_recon.kernel_launches`."""
    if mode16.device.type == "cpu":
        return intra_recon_plain(R, C, mode16, chroma_mode, luma_sym,
                                 chroma_sym, qp, slice_starts, i4_sym)
    out = launch_intra_recon(R, C, mode16, chroma_mode, luma_sym, chroma_sym,
                             qp, int(T.chroma_qp(qp)),
                             row_has_top(R, slice_starts, mode16.device),
                             i4_sym)
    n = kernel_launches(R, C, i4_sym is not None)
    with _COUNT_LOCK:  # decoders in several threads call it
        intra_recon.launches += 1
        intra_recon.kernel_launches += n
    return out


intra_recon.launches = intra_recon.kernel_launches = 0
_COUNT_LOCK = threading.Lock()


# ------------------------------------------------------------------ session


class LazyDecodedFrame:
    """DecodedFrame twin whose planes stay on the device until accessed.

    The decode pipeline is host entropy parse -> device recon -> plane
    download; materializing planes eagerly would serialize the download of
    frame i against the host parse of frame i+1. Duck-types DecodedFrame
    (.y/.u/.v/.frame_num/.idr)."""

    __slots__ = ("_dev", "_host", "_done", "_np", "frame_num", "idr")

    def __init__(self, dev_planes, frame_num: int, idr: bool):
        self._dev = dev_planes
        self._host = None
        self._done = None
        self._np = None
        self.frame_num = frame_num
        self.idr = idr

    def start_transfer(self) -> None:
        """Start the device->host copies without blocking: on CUDA,
        non-blocking copies into pinned host tensors and an event after
        them; on the CPU there is nothing to copy."""
        if self._dev[0].device.type != "cuda" or self._host is not None:
            return
        self._host = tuple(
            torch.empty(p.shape, dtype=p.dtype, pin_memory=True)
            for p in self._dev)
        for h, p in zip(self._host, self._dev):
            h.copy_(p, non_blocking=True)
        self._done = torch.cuda.Event()
        self._done.record()

    def _materialize(self):
        if self._np is None:
            if self._host is not None:
                self._done.synchronize()
                self._np = tuple(h.numpy() for h in self._host)
            else:
                self._np = tuple(p.cpu().numpy() for p in self._dev)
        return self._np

    @property
    def y(self):
        return self._materialize()[0]

    @property
    def u(self):
        return self._materialize()[1]

    @property
    def v(self):
        return self._materialize()[2]


def _parameter_set(cls, x):
    """An SPS/PPS given as the port's dataclass or as its RBSP bytes."""
    if isinstance(x, (bytes, bytearray, memoryview)):
        return cls.parse(BitReader(bytes(x)))
    return x


@dataclass
class TpuDecoder:
    """Stateful Annex-B decoder on one torch device.

    device: "cuda" unless the caller asks for the CPU; a CUDA device that is
    not there raises. deblock_kernel: the route of the in-loop filter,
    "frame" (the whole-frame kernel) or "wave" (one wave-step kernel launch
    per wave; uniform-QP pictures only). host_parser: "native" (the C++
    slice parsers of native/, the default) or "python" (the Python parsers
    that are their oracle; for tests). profile: synchronize around the
    stages of each picture and append {"idr", "parse_ms", "upload_ms",
    "device_ms"} to `timings` (it serializes the pipeline; for measurement
    only)."""

    device: object = "cuda"
    deblock_kernel: str = "frame"
    host_parser: str = "native"
    sps: SPS | None = None
    pps: PPS | None = None
    ref_planes: tuple | None = None  # (y, u, v) uint8 on the device
    frames: list = field(default_factory=list)
    profile: bool = False
    timings: list = field(default_factory=list)

    def __post_init__(self):
        self.device = resolve_device(self.device)
        if self.deblock_kernel not in ("frame", "wave"):
            raise ValueError(f"deblock_kernel {self.deblock_kernel!r} "
                             "(expected 'frame' or 'wave')")
        if self.host_parser not in ("native", "python"):
            raise ValueError(f"host_parser {self.host_parser!r} (expected "
                             "'native' or 'python')")
        self._asm = None

    def load_state(self, sps, pps, ref_planes) -> None:
        """Continue a stream that another decoder (e.g. the JAX package's)
        began: sps/pps as the port's dataclasses or their RBSP bytes,
        ref_planes as (y, u, v) 8-bit arrays of the last reference picture
        (or None before the first one)."""
        self.sps = _parameter_set(SPS, sps)
        self.pps = _parameter_set(PPS, pps)
        self.ref_planes = None if ref_planes is None else tuple(
            torch.tensor(np.asarray(p, dtype=np.uint8), device=self.device)
            for p in ref_planes)
        self._asm = None

    def decode_annexb(self, data: bytes) -> list[DecodedFrame]:
        out = []
        for nu in nal_mod.iter_nal_units(data):
            if nu.nal_type == 7:
                self.sps = SPS.parse(BitReader(nu.rbsp))
            elif nu.nal_type == 8:
                self.pps = PPS.parse(BitReader(nu.rbsp))
            elif nu.nal_type in (1, 5):
                frame = self._decode_slice(nu.rbsp, nu.nal_type,
                                           nu.nal_ref_idc)
                if frame is not None:
                    frame.start_transfer()
                    out.append(frame)
                    self.frames.append(frame)
        return out

    def _decode_slice(self, rbsp: bytes, nal_type: int, nal_ref_idc: int):
        if self.sps is None or self.pps is None:
            raise ValueError("slice before SPS/PPS")
        sps, pps = self.sps, self.pps
        br = BitReader(rbsp)
        hdr = SliceHeader.parse(br, sps, pps, nal_type=nal_type,
                                nal_ref_idc=nal_ref_idc)
        R, C = sps.pic_height_in_mbs, sps.pic_width_in_mbs
        if hdr.is_b or sps.pic_order_cnt_type == 0:
            # B pictures / reordered streams: outside the device path's
            # envelope; raise on the FIRST slice.
            raise UnsupportedStream("B/reordered stream (POC type 0)")
        if hdr.first_mb_in_slice % C:
            raise UnsupportedStream("non-row-aligned slice")
        if hdr.first_mb_in_slice == 0:
            self._asm = None  # new picture
        try:
            asm = self._assemble_slice(rbsp, br, hdr)
        except UnsupportedStream:
            self._asm = None
            raise
        except (ValueError, NotImplementedError, IndexError, KeyError,
                EOFError) as e:
            # Syntax outside this path's envelope.
            self._asm = None
            raise UnsupportedStream(str(e)) from e
        if asm is None:
            return None  # picture incomplete; wait for the next slice
        # Only the parse above refuses a stream. An error of the device
        # reconstruction or of a kernel wrapper propagates as it is, so the
        # API reports DECODE_FAIL instead of moving the stream to the host.
        return self._finish_picture(asm, hdr, nal_ref_idc, R, C)

    def _parse_pslice(self, rbsp: bytes, br, hdr, n_avail: int, C: int,
                      qp: int):
        """The symbol dict of one P slice that starts n_avail MB rows above
        the picture's end."""
        use_native = self.host_parser == "native"
        if self.pps.entropy_coding_mode:
            pos = br.bit_position
            pos += (8 - pos % 8) % 8  # cabac_alignment_one_bit
            sym = native.cabac_parse_pslice_native(
                rbsp, pos, n_avail, C, qp,
                hdr.cabac_init_idc) if use_native else None
            if sym is not None and sym["covered"] != n_avail * C:
                # The C++ parser stops at a slice that ends above the
                # picture's last row; count it as the CAVLC route counts
                # the refusal of its parser.
                native.fallbacks["cabac_parse_pslice_native"] += 1
                sym = None
            if sym is None:
                sym = cabac_slice.parse_pslice_cabac(
                    rbsp, pos, n_avail, C, qp, hdr.cabac_init_idc)
            if sym.get("qp_map") is None:
                sym["qp_map"] = np.full((n_avail, C), qp, np.int32)
            return sym
        if use_native:
            sym = native.parse_pslice_native(
                rbsp, len(rbsp) * 8, br.bit_position, n_avail, C, qp)
            # C++ fast path: the slice covered the full remaining band
            # (single-slice pictures and last slices).
            if sym is not None and sym["covered"] == n_avail * C:
                return sym
        return parse_pslice_symbols(br, n_avail, C, slice_qp=qp, partial=True)

    def _parse_islice(self, rbsp: bytes, br, n_avail: int, C: int, qp: int):
        """The symbol dict of one I slice, its I_4x4 fields included."""
        if self.pps.entropy_coding_mode:
            pos = br.bit_position
            pos += (8 - pos % 8) % 8  # cabac_alignment_one_bit
            sym = native.cabac_parse_islice_native(
                rbsp, pos, n_avail, C, qp) if (
                    self.host_parser == "native") else None
            if sym is None:
                sym = cabac_slice.parse_islice_cabac(rbsp, pos, n_avail, C,
                                                     qp)
            return sym
        pr = parse_islice_mbs(br, n_avail, C, qp, partial=True)
        return {"mode16": pr.mode16, "chroma_mode": pr.chroma_mode,
                "dc_levels": pr.dc_levels, "ac_levels": pr.ac_levels,
                "cdc_levels": pr.cdc_levels, "cac_levels": pr.cac_levels,
                "is_i4": pr.is_i4, "modes4": pr.modes4,
                "luma4_levels": pr.luma4_levels, "covered": pr.covered}

    def _assemble_slice(self, rbsp: bytes, br, hdr):
        """Parse one slice into slice-local symbol arrays (neighbor rules
        reset at slice boundaries come for free) and accumulate them into
        the picture assembly. Returns the assembly once the picture is
        complete (multi-slice pictures arrive as several NALs), else None."""
        t0 = time.perf_counter()
        sps, pps = self.sps, self.pps
        qp = pps.pic_init_qp + hdr.slice_qp_delta
        R, C = sps.pic_height_in_mbs, sps.pic_width_in_mbs
        r0 = hdr.first_mb_in_slice // C
        n_avail = R - r0

        asm = self._asm
        if asm is None:
            asm = self._asm = {
                "is_p": hdr.is_p, "covered": 0, "slice_starts": [],
                "qp0": qp, "idc": hdr.disable_deblocking_filter_idc,
                "qp_map": np.full((R, C), qp, np.int32), "parse_s": 0.0,
            }
        if asm["is_p"] != hdr.is_p or asm["covered"] != r0 * C:
            raise UnsupportedStream("mixed/out-of-order slices in a picture")
        asm["slice_starts"].append(r0)

        if hdr.is_p:
            if self.ref_planes is None:
                raise ValueError("P slice without reference frame")
            sym = self._parse_pslice(rbsp, br, hdr, n_avail, C, qp)
            keys = ("mv", "luma_levels", "cdc_levels", "cac_levels")
        else:
            if r0 > 0 and qp != asm["qp0"]:
                # The I reconstruction dequantizes the whole picture at
                # qp0; a later slice carrying a different slice_qp_delta
                # would be silently mis-dequantized.
                raise UnsupportedStream(
                    "per-slice QP change in an I picture")
            sym = self._parse_islice(rbsp, br, n_avail, C, qp)
            keys = ("mode16", "chroma_mode", "dc_levels", "ac_levels",
                    "cdc_levels", "cac_levels", "is_i4", "modes4",
                    "luma4_levels")
        covered = int(sym["covered"])
        if covered % C:
            raise UnsupportedStream("slice ends mid-row")
        rows = covered // C
        if asm.setdefault("fields", None) is None:
            asm["fields"] = {
                k: np.zeros((R, C) + sym[k].shape[2:],
                            bool if k == "is_i4" else np.int32) for k in keys}
        for k in keys:
            asm["fields"][k][r0 : r0 + rows] = sym[k][:rows]
        if hdr.is_p:
            asm["qp_map"][r0 : r0 + rows] = sym["qp_map"][:rows]

        asm["covered"] += covered
        asm["parse_s"] += time.perf_counter() - t0
        if asm["covered"] < R * C:
            return None
        self._asm = None
        return asm

    def _sync(self) -> float:
        if self.profile and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    def _finish_picture(self, asm, hdr, nal_ref_idc: int, R: int, C: int):
        qp = int(asm["qp0"])
        deblock = asm["idc"] != 1
        slice_starts = tuple(sr for sr in asm["slice_starts"] if sr > 0)
        deblock_starts = slice_starts if asm["idc"] == 2 else ()
        f = asm["fields"]
        dev = self.device
        kernel = self.deblock_kernel

        def up(a):
            return torch.as_tensor(a).to(dev)

        t0 = self._sync()
        if asm["is_p"]:
            # The MC window covers integer offsets in [-(MV_RANGE+1),
            # MV_RANGE+1] (the row0/col0 bound in _luma_mc_device); mv >> 2
            # floors, so a -35 qpel MV needs integer -9: inside the window
            # for the encoder's own rs=8 envelope (+-35 qpel).
            ix = f["mv"] >> 2
            if ix.min() < -(MV_RANGE + 1) or ix.max() > MV_RANGE + 1:
                raise UnsupportedStream("MV beyond the device MC window")
            qp_varies = bool((asm["qp_map"] != qp).any())
            if qp_varies and deblock and kernel == "wave":
                # Refused before any device work, as the parse refuses.
                raise UnsupportedStream("per-MB QP deblocking requires "
                                        "kernel='frame'")
            qp_map = up(asm["qp_map"]) if qp_varies else None
            n = R * C
            flat = np.concatenate([
                f["luma_levels"].reshape(n, 256),
                f["cdc_levels"].reshape(n, 8),
                f["cac_levels"].reshape(n, 120),
            ], axis=1).reshape(-1)
            nz = np.flatnonzero(flat)
            # ONE cap per geometry, sized at 12.5% density: comfortably
            # above product bitrates (a 1080p frame at 8 Mbps/30 fps
            # carries well under 300k coded coefficients). Denser frames,
            # and levels beyond int16, take the dense path.
            cap = max(65536, (n * 384) // 8)
            i16_ok = (len(nz) == 0
                      or (abs(int(flat[nz].max(initial=0))) < 32768
                          and abs(int(flat[nz].min(initial=0))) < 32768))
            if len(nz) <= cap and cap < n * 384 and i16_ok:
                args = (up(f["mv"]),
                        (up(nz.astype(np.int32)),
                         up(flat[nz].astype(np.int16))))
                recon = _recon_pframe_device_sparse
            else:
                args = (up(f["mv"]), up(f["luma_levels"]),
                        (up(f["cdc_levels"]), up(f["cac_levels"])))
                recon = _recon_pframe_body
            t1 = self._sync()
            planes = recon(R, C, *self.ref_planes, *args, deblock, qp,
                           qp_map, deblock_starts, kernel)
        else:
            args = (up(f["mode16"]), up(f["chroma_mode"]),
                    (up(f["dc_levels"]), up(f["ac_levels"])),
                    (up(f["cdc_levels"]), up(f["cac_levels"])))
            # A picture without I_4x4 MBs takes the shorter I_16x16 schedule.
            i4_sym = (up(f["is_i4"]), up(f["modes4"]),
                      up(f["luma4_levels"])) if f["is_i4"].any() else None
            t1 = self._sync()
            planes = _recon_iframe_device(R, C, *args, qp, deblock,
                                          slice_starts, deblock_starts,
                                          kernel, i4_sym)
        if self.profile:
            t2 = self._sync()
            self.timings.append({
                "idr": bool(hdr.idr), "parse_ms": asm["parse_s"] * 1e3,
                "upload_ms": (t1 - t0) * 1e3, "device_ms": (t2 - t1) * 1e3})

        if nal_ref_idc != 0:
            self.ref_planes = planes
        return LazyDecodedFrame(planes, hdr.frame_num, hdr.idr)
