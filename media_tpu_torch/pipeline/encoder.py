"""Frame encoder core: the intra wavefront (I_16x16, and the per-MB
I_4x4 / I_16x16 decision), batched P frames and bi-predicted B frames.

PyTorch twin of media_tpu/pipeline/encoder.py. Intra prediction depends on
the reconstructed left/top neighbours, so the MBs of one anti-diagonal (wave
k = r + c) are independent: the IDR runs a Python loop over the R+C-1 waves,
vectorising each wave's MBs through batched prediction, transform and
quantisation. With I_4x4 the waves are k = 2r + c, so that the MB above and
to the right is done first, and each wave runs the 16 blocks of its MBs as a
chain in z-scan order. P and B frames have no intra-frame dependency before
deblocking and run as whole-frame tensor ops.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass

import numpy as np
import torch

from ..core.trace import span
from ..device import resolve_device
from ..ops import intra as intra_ops
from ..ops import transform as T
from ..ops.pad import edge_pad
from .deblock_apply import deblock_iframe, deblock_pframe_from_symbols
from .intra_wave import kernel_launches, launch_intra_encode
from .pframe_core import (
    INTERP_HALO, _blocks8_mb, _blocks_mb, _mb_blocks, _mb_blocks8,
    chroma_qp_device, local_bframe_core, pframe_core_whole, unpack_b_symbols,
    unpack_symbols, unpack_symbols_device)

# z-scan order of 4x4 luma blocks within an MB -> raster index (by*4+bx)
ZSCAN_TO_RASTER = np.array(
    [0, 1, 4, 5, 2, 3, 6, 7, 8, 9, 12, 13, 10, 11, 14, 15], dtype=np.int32
)


# Whether the 4x4 block above and to the right of raster block (by, bx),
# by > 0, is decoded before it in z-scan order.
_TR_OK = {(1, 0): True, (1, 1): False, (1, 2): True, (1, 3): False,
          (2, 0): True, (2, 1): True, (2, 2): True, (2, 3): False,
          (3, 0): True, (3, 1): False, (3, 2): True, (3, 3): False}


def wave_lanes(k: int, R: int, C: int, skew: int, device):
    """The (r, c) index tensors of wave k: all MBs with skew*r + c == k, by
    rising row. skew=1 serves left/top dependencies (I_16x16); skew=2 also
    puts the top-right MB in an earlier wave, which I_4x4 needs (block
    (0, 3)'s above-right samples lie in MB (r-1, c+1)). There are
    skew*(R-1) + C waves."""
    lo = max(0, -(-(k - (C - 1)) // skew))
    r = torch.arange(lo, min(R - 1, k // skew) + 1, device=device)
    return r, k - skew * r


def i4_chain(top, left, top_left, tr_row4, avail_top, avail_left, tr_mb_ok,
             block_step):
    """The 16-step chain of the I_4x4 blocks of a wave's MBs, in z-scan
    order, over the canvas `cur` (N, 16, 16) that it returns.

    top, left: (N, 16) bottom row of the MB above and right column of the
    MB to the left; top_left: (N,); tr_row4: (N, 4) the first four bottom
    samples of the MB above and to the right; avail_*, tr_mb_ok: (N,) bool.
    block_step(z, b, y0, x0, preds4, ok4) returns the reconstructed (N, 4, 4)
    block of z-scan index z (raster block b, origin (y0, x0)) given all nine
    predictions and their availability.

    `cur` is written in place: every neighbour of step z is read (and copied
    by pred_4x4_all's concatenation) before the step's write."""
    n = top.shape[0]
    dev = top.device
    cur = torch.zeros((n, 16, 16), dtype=torch.int32, device=dev)
    yes = torch.ones((n,), dtype=torch.bool, device=dev)
    no = torch.zeros((n,), dtype=torch.bool, device=dev)
    for z in range(16):
        b = int(ZSCAN_TO_RASTER[z])
        by, bx = b // 4, b % 4
        x0, y0 = bx * 4, by * 4
        top4 = top[:, x0 : x0 + 4] if by == 0 else cur[:, y0 - 1, x0 : x0 + 4]
        left4 = (left[:, y0 : y0 + 4] if bx == 0
                 else cur[:, y0 : y0 + 4, x0 - 1])
        if by == 0 and bx == 0:
            corner = top_left
        elif by == 0:
            corner = top[:, x0 - 1]
        elif bx == 0:
            corner = left[:, y0 - 1]
        else:
            corner = cur[:, y0 - 1, x0 - 1]
        if by == 0:
            tr4, tr_ok = ((top[:, x0 + 4 : x0 + 8], avail_top) if bx < 3
                          else (tr_row4, tr_mb_ok))
        elif _TR_OK[(by, bx)]:
            tr4, tr_ok = cur[:, y0 - 1, x0 + 4 : x0 + 8], yes
        else:
            tr4, tr_ok = None, no
        # An unavailable top-right repeats p[3, -1] (spec 8.3.1.2).
        rep4 = top4[:, 3:4].expand(n, 4)
        if tr4 is None:
            tr4 = rep4
        elif tr_ok is not yes:
            tr4 = torch.where(tr_ok[:, None], tr4, rep4)
        preds4, ok4 = intra_ops.pred_4x4_all(
            torch.cat([top4, tr4], dim=1), left4, corner,
            yes if by > 0 else avail_top, yes if bx > 0 else avail_left,
            tr_ok)
        cur[:, y0 : y0 + 4, x0 : x0 + 4] = block_step(z, b, y0, x0, preds4,
                                                      ok4)
    return cur


def intra_encode_plain(y, u, v, qp: int, qp_c: int, row_has_top,
                       i4x4: bool = False):
    """The IDR's intra wavefront in plain PyTorch, a Python loop over the
    waves: y (16R, 16C), u, v (8R, 8C) int32 planes; row_has_top (R,) bool,
    false at row 0 and every slice start. Returns {mode16, chroma_mode,
    dc_levels, ac_levels, cdc_levels, cac_levels (int32), with i4x4 also
    is_i4 (bool), modes4, luma4_levels; recon_y, recon_u, recon_v uint8
    planes, before deblocking}."""
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
    if i4x4:
        st["is_i4"] = torch.zeros((R, C), dtype=torch.bool, device=dev)
        st["modes4"] = torch.zeros((R, C, 16), dtype=i32, device=dev)
        st["luma4_levels"] = torch.zeros((R, C, 16, 16), dtype=i32,
                                         device=dev)
        # Mode-bit overhead of I_4x4 (about 16 x 2.5 bits), scaled by the
        # quantizer step so that the trade follows the QP.
        bias = 40 << (qp // 6)
    skew = 2 if i4x4 else 1
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

    for k in range(skew * (R - 1) + C):
        r, c = wave_lanes(k, R, C, skew, dev)
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

        if i4x4:
            # ---- the I_4x4 candidate: per block the SATD-best of the
            # nine modes (first minimum), coded and reconstructed ----
            modes4 = [None] * 16  # z-scan order
            lev4 = [None] * 16  # raster block order
            costs4 = []

            def block_step(z, b, y0, x0, preds4, ok4):
                ob = o[:, y0 : y0 + 4, x0 : x0 + 4]
                c4 = torch.where(ok4, intra_ops.satd_cost(preds4, ob),
                                 unavailable)
                m4 = torch.argmin(c4, dim=-1)
                p4 = preds4[lanes, m4]
                zl = T.quant_4x4(T.forward_4x4(ob - p4), qp, intra=True)
                modes4[z] = m4.to(i32)
                lev4[b] = zl
                costs4.append(torch.gather(c4, 1, m4[:, None])[:, 0])
                return (p4 + T.inverse_4x4(T.dequant_4x4(zl, qp))).clamp(
                    0, 255)

            # The top-right MB's column is clamped: the last column has
            # no MB to its right, and tr_mb_ok says so.
            cur = i4_chain(
                top, left, top_left,
                ry[rm1, (c + 1).clamp(max=C - 1), 15, 0:4], avail_top,
                avail_left, avail_top & (c < C - 1), block_step)
            cost4 = torch.stack(costs4).sum(dim=0, dtype=i32)
            i4_sel = cost4 + bias < cost.min(dim=-1).values
            recon = torch.where(i4_sel[:, None, None], cur, recon)
            # The side that lost carries no levels; mode16 stays.
            z_dc = z_dc.masked_fill(i4_sel[:, None, None], 0)
            z_ac = z_ac.masked_fill(i4_sel[:, None, None, None], 0)
            lev4 = T.zigzag(torch.stack(lev4, dim=1)).masked_fill(
                ~i4_sel[:, None, None], 0)
            modes4 = torch.stack(modes4, dim=1).masked_fill(
                ~i4_sel[:, None], 0)

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
        if i4x4:
            st["is_i4"][r, c] = i4_sel
            st["modes4"][r, c] = modes4
            st["luma4_levels"][r, c] = lev4

    H, W = y.shape
    for k, shape in (("recon_y", (H, W)), ("recon_u", (H // 2, W // 2)),
                     ("recon_v", (H // 2, W // 2))):
        st[k] = st[k].transpose(1, 2).reshape(shape).to(torch.uint8)
    return st


def intra_encode(y, u, v, qp: int, qp_c: int, row_has_top,
                 i4x4: bool = False):
    """The IDR's intra wavefront, as intra_encode_plain defines it. On CPU
    tensors it runs the plain version; on CUDA tensors it launches the
    kernels (csrc/intra_wave.cu, one a wave) on the current stream, counts
    the call in `intra_encode.launches` and the kernels it enqueued in
    `intra_encode.kernel_launches`."""
    if y.device.type == "cpu":
        return intra_encode_plain(y, u, v, qp, qp_c, row_has_top, i4x4)
    out = launch_intra_encode(y, u, v, qp, qp_c, row_has_top, i4x4)
    n = kernel_launches(y.shape[0] // 16, y.shape[1] // 16, i4x4)
    with _COUNT_LOCK:  # sessions, tiles and GOP threads call it at once
        intra_encode.launches += 1
        intra_encode.kernel_launches += n
    return out


intra_encode.launches = intra_encode.kernel_launches = 0
_COUNT_LOCK = threading.Lock()


def stream_prefix_words(max_bits: int, cap: int, bucket: int = 8192) -> int:
    """Words to download from a (K, cap) device stream buffer: the used
    prefix rounded up to a 32 KiB bucket."""
    nw = (max_bits + 31) // 32
    return max(bucket, min(cap, -(-nw // bucket) * bucket))


@dataclass
class IFrameResult:
    """Per-MB symbol arrays (numpy, host) + reconstruction (device)."""

    mode16: np.ndarray  # (R, C) intra16x16 pred mode
    chroma_mode: np.ndarray  # (R, C) chroma pred mode
    dc_levels: np.ndarray  # (R, C, 16) luma DC, zig-zag order
    ac_levels: np.ndarray  # (R, C, 16, 15) luma AC per raster 4x4 blk, zig-zag
    cdc_levels: np.ndarray  # (R, C, 2, 4) chroma DC (u,v), raster scan
    cac_levels: np.ndarray  # (R, C, 2, 4, 15) chroma AC per raster 4x4 blk
    recon_y: torch.Tensor  # (R*16, C*16) uint8
    recon_u: torch.Tensor  # (R*8, C*8) uint8
    recon_v: torch.Tensor  # (R*8, C*8) uint8
    # I_4x4 fields (with the i4x4 mode decision; None otherwise)
    is_i4: np.ndarray | None = None  # (R, C) bool
    modes4: np.ndarray | None = None  # (R, C, 16) 4x4 modes in z-scan order
    luma4_levels: np.ndarray | None = None  # (R, C, 16, 16) zigzag, raster blk


@dataclass
class PFrameResult:
    """Per-MB symbol arrays of an inter frame (P_L0_16x16 everywhere), on
    the host, and its reconstruction on the device."""

    mv: np.ndarray  # (R, C, 2) quarter-pel luma MVs (mvx, mvy)
    luma_levels: np.ndarray  # (R, C, 16, 16) quantized levels per 4x4, zig-zag
    cdc_levels: np.ndarray  # (R, C, 2, 4)
    cac_levels: np.ndarray  # (R, C, 2, 4, 15)
    recon_y: torch.Tensor  # (H, W) uint8
    recon_u: torch.Tensor
    recon_v: torch.Tensor


def _plane_tensor(x, device):
    if torch.is_tensor(x):
        return x.to(device)
    return torch.tensor(np.asarray(x), device=device)


class FrameEncoder:
    """Per-geometry frame encoder on one device."""

    def __init__(self, width: int, height: int, device="cuda",
                 slice_rows: tuple = ()):
        """slice_rows: MB rows starting a new slice (row 0 implicit). Intra
        prediction treats top neighbours across a slice boundary as
        unavailable."""
        if width % 16 or height % 16:
            raise ValueError("FrameEncoder operates on MB-padded planes")
        self.device = resolve_device(device)
        self.width = width
        self.height = height
        self.n_cols = width // 16
        self.n_rows = height // 16
        has_top = np.ones(self.n_rows, dtype=bool)
        has_top[0] = False
        has_top[list(slice_rows)] = False
        self._row_has_top = torch.as_tensor(has_top, device=self.device)
        # Interior slice-start rows; non-empty selects slice-local
        # deblocking (disable_deblocking_filter_idc == 2 semantics).
        self.deblock_slice_starts: tuple = ()

    @property
    def cap_words(self) -> int:
        # ~1.5 bits/pixel budget for packed slice_data (64 KiB minimum): the
        # worst-case stream buffer, as in the JAX package.
        return max(self.width * self.height // 21, 16384)

    # ------------------------------------------------------------------ intra

    def encode_iframe(self, y, u, v, qp: int, deblock: bool = False,
                      i4x4: bool = False) -> IFrameResult:
        """Encode one intra frame. y: (H, W), u/v: (H/2, W/2) 8-bit planes
        (numpy or tensors).

        i4x4: per-MB decision between I_4x4 (nine directional 4x4 modes,
        each block predicted from the reconstruction of the ones before it)
        and I_16x16, on the skew-2 wave schedule."""
        dev = self.device
        with span("enc.idr.launch"):
            out = self._encode_iframe_device(
                _plane_tensor(y, dev).to(torch.int32),
                _plane_tensor(u, dev).to(torch.int32),
                _plane_tensor(v, dev).to(torch.int32),
                qp, int(T.chroma_qp(qp)), deblock, i4x4)
        keys = ("mode16", "chroma_mode", "dc_levels", "ac_levels",
                "cdc_levels", "cac_levels")
        if i4x4:
            keys += ("is_i4", "modes4", "luma4_levels")
        with span("enc.idr.download"):
            host = {k: out[k].cpu().numpy() for k in keys}
        return IFrameResult(**host, recon_y=out["recon_y"],
                            recon_u=out["recon_u"], recon_v=out["recon_v"])

    def _encode_iframe_device(self, y, u, v, qp: int, qp_c: int,
                              deblock: bool = False, i4x4: bool = False):
        st = intra_encode(y, u, v, qp, qp_c, self._row_has_top, i4x4)
        if deblock:
            st["recon_y"], st["recon_u"], st["recon_v"] = deblock_iframe(
                st["recon_y"], st["recon_u"], st["recon_v"], qp, qp_c,
                self.n_rows, self.n_cols, self.deblock_slice_starts)
        return st

    # ------------------------------------------------------------------ inter

    def _pframe_core(self, ref, frame, qp, qp_c, rs: int):
        """The P core of one P frame against the uint8 reference planes
        `ref`, before deblocking: on the card the kernel reads the planes
        as they are, with no halo (pframe_core_whole)."""
        return pframe_core_whole(*frame, *ref, qp, qp_c, rs, self.n_rows,
                                 self.n_cols)

    def _pframe_step(self, ref, frame, qp: int, qp_c: int, rs: int,
                     deblock: bool):
        """One P frame against the uint8 reference planes `ref`. Returns
        (symbols, recon planes)."""
        out = self._pframe_core(ref, frame, qp, qp_c, rs)
        recon = (out["recon_y"], out["recon_u"], out["recon_v"])
        if deblock:
            recon = deblock_pframe_from_symbols(
                *recon, out["symbols"], qp, qp_c, self.n_rows, self.n_cols,
                self.deblock_slice_starts)
        return out["symbols"], recon

    def encode_pframe(self, y, u, v, ref_y, ref_u, ref_v, qp: int,
                      search_range: int = 8,
                      deblock: bool = False) -> PFrameResult:
        """Encode one P frame against a reconstructed reference: the symbol
        arrays on the host, the recon planes on the device."""
        y, u, v, *ref = self._to_device(y, u, v, ref_y, ref_u, ref_v)
        symbols, recon = self._pframe_step(
            ref, (y, u, v), qp, int(T.chroma_qp(qp)), search_range, deblock)
        return PFrameResult(**unpack_symbols(symbols), recon_y=recon[0],
                            recon_u=recon[1], recon_v=recon[2])

    # --------------------------------------------------------------------- B

    def encode_bframe(self, y, u, v, ref0, ref1, qp: int,
                      search_range: int = 8) -> dict:
        """Encode one non-reference B frame against two references
        (B_Bi_16x16 everywhere; pframe_core.local_bframe_core).

        ref0/ref1: (y, u, v) plane triples (device or host). Returns the
        unpacked symbol dict {mv0, mv1, luma_levels, cdc_levels,
        cac_levels} for the host B-slice entropy coder."""
        return unpack_b_symbols(self._encode_bframe_device(
            *self._to_device(y, u, v, *ref0, *ref1), qp,
            int(T.chroma_qp(qp)), search_range))

    def _ref_ext(self, ref, rs: int):
        """A reference's planes, in their own dtype, extended above and
        below by the halos the B core reads."""
        halo_y = rs + INTERP_HALO
        halo_c = rs // 2 + 2
        ry, ru, rv = ref
        return (edge_pad(ry, halo_y, halo_y, 0, 0),
                edge_pad(ru, halo_c, halo_c, 0, 0),
                edge_pad(rv, halo_c, halo_c, 0, 0))

    def _encode_bframe_device(self, y, u, v, r0y, r0u, r0v, r1y, r1u, r1v,
                              qp: int, qp_c: int, search_range: int):
        rs = search_range
        return local_bframe_core(
            y.to(torch.int32), u.to(torch.int32), v.to(torch.int32),
            self._ref_ext((r0y, r0u, r0v), rs),
            self._ref_ext((r1y, r1u, r1v), rs), qp, qp_c, rs, self.n_rows,
            self.n_cols)

    def _encode_pbatch_packed_device(self, ys, us, vs, ref_y, ref_u, ref_v,
                                     qp: int, qp_c: int, search_range: int,
                                     deblock: bool = False, cap=None):
        """K P frames with on-device CAVLC packing. Returns (streams (K, cap)
        int64 words, bits (K,) int64, recon planes after frame K)."""
        # Imported here: device_cavlc takes ZSCAN_TO_RASTER from this module.
        from ..entropy.device_cavlc import pack_pslice_device

        cap = cap or self.cap_words
        recon = (ref_y, ref_u, ref_v)
        streams, bits = [], []
        for j in range(ys.shape[0]):
            symbols, recon = self._pframe_step(
                recon, (ys[j], us[j], vs[j]), qp, qp_c, search_range, deblock)
            stream, nbits = pack_pslice_device(
                *unpack_symbols_device(symbols), cap)
            streams.append(stream)
            bits.append(nbits)
        return torch.stack(streams), torch.stack(bits), recon

    def _encode_pbatch_device(self, ys, us, vs, ref_y, ref_u, ref_v, qp: int,
                              qp_c: int, search_range: int,
                              deblock: bool = False):
        """K P frames; returns (symbols (K, R, C, 386) int16, recon)."""
        recon = (ref_y, ref_u, ref_v)
        symbols = []
        for j in range(ys.shape[0]):
            sym, recon = self._pframe_step(
                recon, (ys[j], us[j], vs[j]), qp, qp_c, search_range, deblock)
            symbols.append(sym)
        return torch.stack(symbols), recon

    def _to_device(self, *planes):
        return [_plane_tensor(p, self.device) for p in planes]

    def encode_pframes_batch(self, ys, us, vs, ref_y, ref_u, ref_v, qp: int,
                             search_range: int = 8, deblock: bool = False):
        """Encode K consecutive P frames. ys/us/vs: (K, H, W) / (K, H/2, W/2).
        Returns (symbols numpy (K, R, C, 386), recon device planes)."""
        symbols, recon = self._encode_pbatch_device(
            *self._to_device(ys, us, vs, ref_y, ref_u, ref_v), qp,
            int(T.chroma_qp(qp)), search_range, deblock)
        return symbols.cpu().numpy(), recon

    def encode_pframes_packed(self, ys, us, vs, ref_y, ref_u, ref_v, qp: int,
                              search_range: int = 8, deblock: bool = False,
                              cap: int | None = None):
        """Encode K P frames with on-device entropy coding. Returns (streams
        numpy (K, cap) uint32, bits numpy (K,), recon device planes);
        bits[j] > cap*32 signals overflow."""
        streams, bits, recon = self._encode_pbatch_packed_device(
            *self._to_device(ys, us, vs, ref_y, ref_u, ref_v), qp,
            int(T.chroma_qp(qp)), search_range, deblock, cap or self.cap_words)
        return (streams.cpu().numpy().astype(np.uint32), bits.cpu().numpy(),
                recon)

    def encode_pframes_packed_dev(self, ys_d, us_d, vs_d, ref, qp: int,
                                  search_range: int = 8,
                                  deblock: bool = False,
                                  cap: int | None = None):
        """Like encode_pframes_packed, but takes device planes and returns
        device tensors (no download), for the session's pipelined path."""
        return self._encode_pbatch_packed_device(
            ys_d, us_d, vs_d, *ref, qp, int(T.chroma_qp(qp)), search_range,
            deblock, cap or self.cap_words)

    # ---------------------------------------------------- inter + CBR control

    def _rc_scalar(self, x):
        """A rate-controller value (Python float or 0-d tensor) as a 0-d
        float32 tensor on the device."""
        if torch.is_tensor(x):
            return x.to(self.device, torch.float32)
        return torch.tensor(float(x), dtype=torch.float32, device=self.device)

    def encode_pframes_cbr(self, ys, us, vs, ref_y, ref_u, ref_v,
                           rc_state: dict, target_bits_per_frame: int,
                           qp_min: int = 12, qp_max: int = 44,
                           search_range: int = 8, deblock: bool = False,
                           adaptive_qp: bool = False,
                           cap: int | None = None):
        """Encode K P frames with on-device CBR rate control.

        The device packer reports each frame's exact bit count, so the
        virtual-buffer feedback loop (bits -> complexity model -> next QP)
        runs on the device with no host read between frames. rc_state
        carries {"qp", "buf", "cplx"} floats across calls. adaptive_qp:
        per-MB QP modulation (mb_qp_delta) realises the fractional part of
        the controller's ideal QP by a deterministic dither.

        Returns (streams numpy uint32 (the used prefix), bits, qps, recon
        device planes, new rc_state)."""
        cap_used = cap or self.cap_words
        streams, bits, qps, recon, new_state = self._encode_pbatch_cbr_device(
            *self._to_device(ys, us, vs, ref_y, ref_u, ref_v),
            *(self._rc_scalar(rc_state[k]) for k in ("qp", "buf", "cplx")),
            float(target_bits_per_frame), qp_min, qp_max, search_range,
            deblock, adaptive_qp, cap_used)
        out_state = dict(zip(("qp", "buf", "cplx"),
                             (float(x) for x in new_state)))
        bits_np = bits.cpu().numpy()
        nw = stream_prefix_words(int(bits_np.max()), cap_used)
        return (streams[:, :nw].cpu().numpy().astype(np.uint32), bits_np,
                qps.cpu().numpy(), recon, out_state)

    def encode_pframes_cbr_dev(self, ys_d, us_d, vs_d, ref, rc_state: dict,
                               target_bits_per_frame: int,
                               bits_scale: float = 1.0, qp_min: int = 12,
                               qp_max: int = 44, search_range: int = 8,
                               deblock: bool = False,
                               adaptive_qp: bool = False,
                               cap: int | None = None):
        """Device-resident CBR batch with a scale on the rate feedback: the
        loop integrates device-CAVLC bits x `bits_scale` (the session's
        running CABAC/CAVLC ratio when the emitted entropy is CABAC through
        the host transcode). rc_state values are floats or 0-d tensors.
        Returns device tensors (streams, bits, qps, recon, (qp, buf, cplx));
        the downloads are the caller's."""
        return self._encode_pbatch_cbr_device(
            ys_d, us_d, vs_d, *ref,
            *(self._rc_scalar(rc_state[k]) for k in ("qp", "buf", "cplx")),
            float(target_bits_per_frame), qp_min, qp_max, search_range,
            deblock, adaptive_qp, cap or self.cap_words,
            bits_scale=float(bits_scale))

    def _encode_pbatch_cbr_device(self, ys, us, vs, ref_y, ref_u, ref_v,
                                  qp0, buf0, cplx0, target: float,
                                  qp_min: int, qp_max: int, search_range: int,
                                  deblock: bool = False,
                                  adaptive_qp: bool = False, cap=None,
                                  bits_scale=None):
        """The CBR loop over a chunk, the carry (recon, qp_f, buf, cplx)
        held as 0-d float32 tensors on the device: no value of it is read
        by the host between frames. Every rate operation is float32 in the
        JAX package's order (Python floats enter as float32 scalars), and
        no input tensor is written to, so a retry with the same inputs
        gives the same QPs and streams."""
        # Imported here: device_cavlc takes ZSCAN_TO_RASTER from this module.
        from ..entropy.device_cavlc import _last_coded, pack_pslice_device

        cap = cap or self.cap_words
        R, C = self.n_rows, self.n_cols
        f32, i32 = torch.float32, torch.int32
        if adaptive_qp:
            # Deterministic stride-97 spread of the dither thresholds.
            thresh = ((torch.arange(R * C, dtype=i32, device=ys.device) * 97)
                      % 128).to(f32) / 128.0
        recon = (ref_y, ref_u, ref_v)
        qp_f, buf, cplx = qp0, buf0, cplx0
        streams, bits_out, qps = [], [], []
        for j in range(ys.shape[0]):
            # Virtual-buffer drain: aim below target when the buffer is full.
            adj_target = torch.clamp(target - 0.35 * buf, min=0.25 * target)
            want_qstep = torch.clamp(cplx / adj_target, 0.625, 1024.0)
            qp_f = torch.clamp(6.0 * torch.log2(want_qstep / 0.625),
                               float(qp_min), float(qp_max))
            if adaptive_qp:
                # Fractional QP by per-MB dither: floor(qp)+1 on a `frac`
                # share of the MBs.
                qp = torch.floor(qp_f).to(i32)
                frac = qp_f - qp.to(f32)
                qp_map = torch.clamp(qp + (thresh < frac).to(i32), qp_min,
                                     qp_max)
                qp_enc, qp_c_enc = qp_map, chroma_qp_device(qp_map)
                qp_c = chroma_qp_device(qp)
            else:
                qp = torch.clamp(torch.round(qp_f), qp_min, qp_max).to(i32)
                qp_c = chroma_qp_device(qp)
                qp_enc, qp_c_enc, qp_map = qp, qp_c, None

            out = self._pframe_core(recon, (ys[j], us[j], vs[j]), qp_enc,
                                    qp_c_enc, search_range)
            mv, luma, cdc, cac = unpack_symbols_device(out["symbols"])
            stream, bits = pack_pslice_device(
                mv, luma, cdc, cac, cap,
                qp_map=None if qp_map is None else qp_map.reshape(R, C),
                slice_qp=qp)
            recon = (out["recon_y"], out["recon_u"], out["recon_v"])
            if deblock:
                eff_map = None
                if adaptive_qp:
                    # The filter must see the decoder's per-MB QP:
                    # mb_qp_delta is coded on cbp != 0 MBs only, so the
                    # other MBs keep the running QP (spec 7.4.4), which
                    # starts at the slice QP.
                    coded = ((luma != 0).any(dim=3).any(dim=2)
                             | (cdc != 0).any(dim=3).any(dim=2)
                             | (cac != 0).any(dim=4).any(dim=3).any(dim=2))
                    eff_map = _last_coded(qp_map, coded.reshape(-1),
                                          qp).reshape(R, C)
                recon = deblock_pframe_from_symbols(
                    *recon, out["symbols"], qp, qp_c, R, C,
                    self.deblock_slice_starts, qp_map=eff_map)
            bits_f = bits.to(f32)
            if bits_scale is not None:
                # Estimated emitted size when the entropy stage differs from
                # the device CAVLC pack (host CABAC transcode).
                bits_f = bits_f * bits_scale
            # Complexity model: bits ~ cplx / qstep  =>  cplx ~ bits * qstep.
            cplx = 0.75 * cplx + 0.25 * bits_f * (
                0.625 * torch.exp2(qp_f / 6.0))
            buf = buf + bits_f - target
            streams.append(stream)
            bits_out.append(bits)
            qps.append(qp)
        return (torch.stack(streams), torch.stack(bits_out), torch.stack(qps),
                recon, (qp_f, buf, cplx))
