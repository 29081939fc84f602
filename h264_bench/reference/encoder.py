"""The benchmark's plain reference encoder: a GOP's IDR and P pictures of
one configuration, as Annex-B access units and deblocked reconstructions.

It follows the program's documented behaviour at constant QP with CAVLC,
one slice and deblocking on: SPS and PPS before each IDR, an I_16x16 IDR
slice, P_L0_16x16 / P_Skip slices searched +-8 at full pel and refined to
quarter pel, frame_num counted from the IDR, POC type 2. Every stage is
plain PyTorch or NumPy (intra.py, pcore.py, vlc.py, deblock.py and the
bitstream layer), imports nothing of the program, and takes from it nothing
but what it is asked to check.
"""

from __future__ import annotations

import numpy as np
import torch

from . import deblock as db
from .bitstream import BitWriter
from .intra import intra_encode_plain
from .nal import wrap_nal
from .pcore import pframe_core_whole_plain
from .syntax import PPS, SPS, SliceHeader
from .transform import chroma_qp
from .vlc import islice_data, pslice_data

NAL_IDR_SLICE, NAL_SLICE, NAL_SPS, NAL_PPS = 5, 1, 7, 8
SEARCH_RANGE = 8


def pad_to_mb_grid(plane: np.ndarray, mb_size: int) -> np.ndarray:
    """A plane padded to a multiple of mb_size by edge replication."""
    h, w = plane.shape
    ph = -(-h // mb_size) * mb_size
    pw = -(-w // mb_size) * mb_size
    return np.pad(plane, ((0, ph - h), (0, pw - w)), mode="edge")


def append_bits(bw: BitWriter, value: int, nbits: int) -> None:
    """Append nbits bits of value (MSB first) to bw in one step."""
    total = bw._nbits + nbits
    combined = (bw._acc << nbits) | value
    rest = total % 8
    bw._buf += (combined >> rest).to_bytes(total // 8, "big")
    bw._acc = combined & ((1 << rest) - 1)
    bw._nbits = rest


class ReferenceEncoder:
    """One configuration's pictures, from planes the caller made.

    cfg: the configuration file's `encoder` mapping (width, height, qp,
    level_idc, framerate; the rest within ENVELOPE). device: where the plain tensors run. deblock: the function
    that filters a picture given its meta (db.deblock_frame; the control
    passes another)."""

    ENVELOPE = {"profile": "baseline", "rc_mode": "cq", "num_slices": 1,
                "deblock": True, "cabac": False, "i4x4": False, "b_frames": 0}

    def __init__(self, cfg: dict, device="cpu", deblock=db.deblock_frame):
        outside = {k: cfg.get(k) for k, v in self.ENVELOPE.items()
                   if cfg.get(k, v) != v}
        if outside:
            raise ValueError(f"the reference does not code {outside}")
        self.width, self.height = int(cfg["width"]), int(cfg["height"])
        self.qp = int(cfg["qp"])
        self.qp_c = int(chroma_qp(self.qp))
        self.device = torch.device(device)
        self.deblock = deblock
        self.sps = SPS.for_size(self.width, self.height,
                                level_idc=int(cfg["level_idc"]))
        self.sps.vui_timing = (1, 2 * int(cfg["framerate"]))
        self.pps = PPS(pic_init_qp=self.qp,
                       deblocking_filter_control_present=True)
        self.R = self.sps.pic_height_in_mbs
        self.C = self.sps.pic_width_in_mbs

    def planes(self, y, u, v):
        """Caller's uint8 numpy planes as MB-padded int32 tensors."""
        return tuple(torch.as_tensor(pad_to_mb_grid(np.asarray(p), s))
                     .to(self.device, torch.int32)
                     for p, s in ((y, 16), (u, 8), (v, 8)))

    def _prefix(self) -> bytes:
        out = b""
        for nal_type, ps in ((NAL_SPS, self.sps), (NAL_PPS, self.pps)):
            w = BitWriter()
            ps.write(w)
            w.rbsp_trailing_bits()
            out += wrap_nal(nal_type, w.get_bytes())
        return out

    def idr(self, y, u, v):
        """The IDR of the planes: (au_of(idr_pic_id), the deblocked recon
        as uint8 numpy planes)."""
        R, C = self.R, self.C
        has_top = torch.ones(R, dtype=torch.bool, device=self.device)
        has_top[0] = False
        st = intra_encode_plain(*self.planes(y, u, v), self.qp, self.qp_c,
                                has_top)
        payload = islice_data(*(st[k] for k in (
            "mode16", "chroma_mode", "dc_levels", "ac_levels", "cdc_levels",
            "cac_levels")))
        recon = self.deblock(
            *(st[k].cpu().numpy() for k in ("recon_y", "recon_u", "recon_v")),
            db.build_meta(self.qp, self.qp_c, *db.intra_bs_grids(R, C), R, C),
            R, C)
        prefix = self._prefix()

        def au_of(idr_pic_id: int) -> bytes:
            bw = BitWriter()
            SliceHeader(slice_type=7, idr=True, idr_pic_id=idr_pic_id,
                        frame_num=0, first_mb_in_slice=0, slice_qp_delta=0,
                        disable_deblocking_filter_idc=0).write(
                            bw, self.sps, self.pps)
            append_bits(bw, *payload)
            bw.rbsp_trailing_bits()
            return prefix + wrap_nal(NAL_IDR_SLICE, bw.get_bytes(),
                                     nal_ref_idc=3)

        return au_of, recon

    def p(self, y, u, v, ref, frame_num: int):
        """The P picture of the planes against the uint8 reference planes
        `ref`: (au, deblocked recon)."""
        R, C = self.R, self.C
        ref = tuple((r if torch.is_tensor(r) else torch.as_tensor(r))
                    .to(self.device) for r in ref)
        out = pframe_core_whole_plain(*self.planes(y, u, v), *ref, self.qp,
                                      self.qp_c, SEARCH_RANGE, R, C)
        s = out["symbols"].to(torch.int32)
        mv = s[..., 0:2]
        luma = s[..., 2:258].reshape(R, C, 16, 16)
        bw = BitWriter()
        SliceHeader(slice_type=5, idr=False,
                    frame_num=frame_num % (1 << self.sps.log2_max_frame_num),
                    first_mb_in_slice=0, slice_qp_delta=0,
                    disable_deblocking_filter_idc=0).write(
                        bw, self.sps, self.pps)
        append_bits(bw, *pslice_data(mv, luma,
                                     s[..., 258:266].reshape(R, C, 2, 4),
                                     s[..., 266:].reshape(R, C, 2, 4, 15)))
        bw.rbsp_trailing_bits()
        au = wrap_nal(NAL_SLICE, bw.get_bytes(), nal_ref_idc=2)
        bs = db.pframe_bs_grids(mv.cpu().numpy(), luma.cpu().numpy(), R, C)
        recon = self.deblock(
            *(out[k].cpu().numpy() for k in ("recon_y", "recon_u", "recon_v")),
            db.build_meta(self.qp, self.qp_c, *bs, R, C), R, C)
        return au, recon
