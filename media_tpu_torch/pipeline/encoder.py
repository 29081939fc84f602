"""Frame encoder core: the I_16x16 intra wavefront and batched P frames.

PyTorch twin of media_tpu/pipeline/encoder.py (the constant-QP, single-slice
subset). Intra prediction depends on the reconstructed left/top neighbours,
so the MBs of one anti-diagonal (wave k = r + c) are independent: the IDR
runs a Python loop over the R+C-1 waves, vectorising each wave's MBs through
batched prediction, transform and quantisation. P frames have no
intra-frame dependency before deblocking and run as whole-frame tensor ops.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve_device
from ..ops import intra as intra_ops
from ..ops import transform as T
from ..ops.pad import edge_pad
from .deblock_apply import deblock_iframe, deblock_pframe_from_symbols
from .pframe_core import (
    INTERP_HALO, _blocks8_mb, _blocks_mb, _mb_blocks, _mb_blocks8,
    local_pframe_core, unpack_symbols_device)

# z-scan order of 4x4 luma blocks within an MB -> raster index (by*4+bx)
ZSCAN_TO_RASTER = np.array(
    [0, 1, 4, 5, 2, 3, 6, 7, 8, 9, 12, 13, 10, 11, 14, 15], dtype=np.int32
)


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


def _plane_tensor(x, device):
    if torch.is_tensor(x):
        return x.to(device)
    return torch.tensor(np.asarray(x), device=device)


class FrameEncoder:
    """Per-geometry frame encoder on one device."""

    def __init__(self, width: int, height: int, device="cuda"):
        if width % 16 or height % 16:
            raise ValueError("FrameEncoder operates on MB-padded planes")
        self.device = resolve_device(device)
        self.width = width
        self.height = height
        self.n_cols = width // 16
        self.n_rows = height // 16

    @property
    def cap_words(self) -> int:
        # ~1.5 bits/pixel budget for packed slice_data (64 KiB minimum): the
        # worst-case stream buffer, as in the JAX package.
        return max(self.width * self.height // 21, 16384)

    # ------------------------------------------------------------------ intra

    def encode_iframe(self, y, u, v, qp: int,
                      deblock: bool = False) -> IFrameResult:
        """Encode one I_16x16 intra frame. y: (H, W), u/v: (H/2, W/2) 8-bit
        planes (numpy or tensors)."""
        dev = self.device
        out = self._encode_iframe_device(
            _plane_tensor(y, dev).to(torch.int32),
            _plane_tensor(u, dev).to(torch.int32),
            _plane_tensor(v, dev).to(torch.int32),
            qp, int(T.chroma_qp(qp)), deblock)
        host = {k: out[k].cpu().numpy() for k in (
            "mode16", "chroma_mode", "dc_levels", "ac_levels", "cdc_levels",
            "cac_levels")}
        return IFrameResult(**host, recon_y=out["recon_y"],
                            recon_u=out["recon_u"], recon_v=out["recon_v"])

    def _encode_iframe_device(self, y, u, v, qp: int, qp_c: int,
                              deblock: bool = False):
        R, C = self.n_rows, self.n_cols
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

        for k in range(R + C - 1):
            r = torch.arange(max(0, k - C + 1), min(R - 1, k) + 1, device=dev)
            c = k - r
            avail_top = r > 0
            avail_left = c > 0
            rm1 = (r - 1).clamp(min=0)
            cm1 = (c - 1).clamp(min=0)

            # ---- luma: I_16x16 mode decision by SATD, first minimum ----
            ry = st["recon_y"]
            o = orig_y[r, c]  # (N, 16, 16)
            preds = intra_ops.pred_16x16_all(
                ry[rm1, c, 15, :], ry[r, cm1, :, 15], ry[rm1, cm1, 15, 15],
                avail_top, avail_left)
            cost = torch.where(
                intra_ops.mode_available_16x16(avail_top, avail_left),
                intra_ops.satd_cost(preds, o), unavailable)
            mode = torch.argmin(cost, dim=-1)
            pred = preds[torch.arange(len(r), device=dev), mode]

            w = T.forward_4x4(_mb_blocks(o - pred))  # (N, 16, 4, 4)
            z_dc = T.quant_dc_4x4(T.hadamard_4x4(w[:, :, 0, 0].reshape(-1, 4, 4)),
                                  qp)
            d_dc = T.dequant_dc_4x4(T.hadamard_4x4(z_dc), qp)
            z_ac = T.quant_4x4(w, qp, intra=True)
            z_ac[:, :, 0, 0] = 0
            d = T.dequant_4x4(z_ac, qp)
            d[:, :, 0, 0] = d_dc.reshape(-1, 16)
            recon = (pred + _blocks_mb(T.inverse_4x4(d))).clamp(0, 255)

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
            lanes = torch.arange(len(r), device=dev)
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

        ry = st["recon_y"].transpose(1, 2).reshape(self.height, self.width)
        ru = st["recon_u"].transpose(1, 2).reshape(self.height // 2,
                                                   self.width // 2)
        rv = st["recon_v"].transpose(1, 2).reshape(self.height // 2,
                                                   self.width // 2)
        if deblock:
            ry, ru, rv = deblock_iframe(ry, ru, rv, qp, qp_c, R, C)
        else:
            ry, ru, rv = (x.to(torch.uint8) for x in (ry, ru, rv))
        st["recon_y"], st["recon_u"], st["recon_v"] = ry, ru, rv
        return st

    # ------------------------------------------------------------------ inter

    def _pframe_step(self, ref, frame, qp: int, qp_c: int, rs: int,
                     deblock: bool):
        """One P frame against the uint8 reference planes `ref`. Returns
        (symbols, recon planes)."""
        halo_y = rs + INTERP_HALO
        halo_c = rs // 2 + 2
        ry, ru, rv = (p.to(torch.int32) for p in ref)
        y, u, v = (p.to(torch.int32) for p in frame)
        out = local_pframe_core(
            y, u, v, edge_pad(ry, halo_y, halo_y, 0, 0),
            edge_pad(ru, halo_c, halo_c, 0, 0),
            edge_pad(rv, halo_c, halo_c, 0, 0),
            qp, qp_c, rs, self.n_rows, self.n_cols)
        recon = (out["recon_y"], out["recon_u"], out["recon_v"])
        if deblock:
            recon = deblock_pframe_from_symbols(
                *recon, out["symbols"], qp, qp_c, self.n_rows, self.n_cols)
        return out["symbols"], recon

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
