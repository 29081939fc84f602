"""The benchmark's plain reference encoder for Main-profile CABAC with I_4x4
IDRs: a GOP's IDR and P pictures of one configuration, as Annex-B access
units and deblocked reconstructions.

It follows the program's documented behaviour at constant QP with CABAC
(cabac_init_idc 0), one slice and deblocking on: SPS (profile_idc 77) and
PPS (entropy_coding_mode_flag 1) before each IDR, an IDR slice whose MBs
choose between I_4x4 and I_16x16 (intra4.py), P_L0_16x16 / P_Skip slices
searched +-8 at full pel and refined to quarter pel (pcore.py, as
encoder.py), each slice header followed by cabac_alignment_one_bits and
the CABAC slice data (cabac.py), frame_num counted from the IDR, POC type
2. Every stage is plain PyTorch, NumPy or Python and imports nothing of the
program.
"""

from __future__ import annotations

import torch

from . import cabac
from . import deblock as db
from .bitstream import BitWriter
from .encoder import NAL_IDR_SLICE, NAL_SLICE, SEARCH_RANGE
from .encoder import ReferenceEncoder as _CavlcReference
from .intra4 import intra_encode_i4
from .nal import wrap_nal
from .pcore import pframe_core_whole_plain
from .syntax import PROFILE_MAIN, SliceHeader

I_KEYS = ("mode16", "chroma_mode", "dc_levels", "ac_levels", "cdc_levels",
          "cac_levels", "is_i4", "modes4", "luma4_levels")


def _align_with_ones(bw: BitWriter) -> None:
    """cabac_alignment_one_bit up to the byte boundary (7.3.4)."""
    n = -bw._nbits % 8
    bw.u(n, (1 << n) - 1)


class ReferenceEncoder(_CavlcReference):
    """One configuration's pictures, from planes the caller made.

    cfg: the configuration file's `encoder` mapping (width, height, qp,
    level_idc, framerate; the rest within ENVELOPE). device: where the
    plain tensors run. deblock: the function that filters a picture given
    its meta (db.deblock_frame; the control passes another)."""

    ENVELOPE = {"profile": "main", "rc_mode": "cq", "num_slices": 1,
                "deblock": True, "cabac": True, "cabac_init_idc": 0,
                "i4x4": True, "adaptive_qp": False, "b_frames": 0,
                "lossless": False, "insert_aud": False, "insert_sei": False,
                "signal_timing": True}

    def __init__(self, cfg: dict, device="cpu", deblock=db.deblock_frame):
        super().__init__(cfg, device=device, deblock=deblock)
        self.sps.profile_idc = PROFILE_MAIN
        self.pps.entropy_coding_mode = 1

    def _slice(self, header: SliceHeader, payload: bytes, nal_type: int,
               nal_ref_idc: int) -> bytes:
        bw = BitWriter()
        header.write(bw, self.sps, self.pps)
        _align_with_ones(bw)
        return wrap_nal(nal_type, bw.get_bytes() + payload,
                        nal_ref_idc=nal_ref_idc)

    def idr(self, y, u, v):
        """The IDR of the planes: (au_of(idr_pic_id), the deblocked recon
        as uint8 numpy planes)."""
        R, C = self.R, self.C
        has_top = torch.ones(R, dtype=torch.bool, device=self.device)
        has_top[0] = False
        st = intra_encode_i4(*self.planes(y, u, v), self.qp, self.qp_c,
                             has_top)
        payload = cabac.islice_data(self.qp,
                                    *(st[k].cpu().numpy() for k in I_KEYS))
        recon = self.deblock(
            *(st[k].cpu().numpy() for k in ("recon_y", "recon_u", "recon_v")),
            db.build_meta(self.qp, self.qp_c, *db.intra_bs_grids(R, C), R, C),
            R, C)
        prefix = self._prefix()

        def au_of(idr_pic_id: int) -> bytes:
            return prefix + self._slice(
                SliceHeader(slice_type=7, idr=True, idr_pic_id=idr_pic_id,
                            frame_num=0, first_mb_in_slice=0,
                            slice_qp_delta=0,
                            disable_deblocking_filter_idc=0),
                payload, NAL_IDR_SLICE, 3)

        return au_of, recon

    def p(self, y, u, v, ref, frame_num: int):
        """The P picture of the planes against the uint8 reference planes
        `ref`: (au, deblocked recon)."""
        R, C = self.R, self.C
        ref = tuple((r if torch.is_tensor(r) else torch.as_tensor(r))
                    .to(self.device) for r in ref)
        out = pframe_core_whole_plain(*self.planes(y, u, v), *ref, self.qp,
                                      self.qp_c, SEARCH_RANGE, R, C)
        s = out["symbols"].to(torch.int32).cpu().numpy()
        mv = s[..., 0:2]
        luma = s[..., 2:258].reshape(R, C, 16, 16)
        payload = cabac.pslice_data(
            self.qp, 0, mv, luma, s[..., 258:266].reshape(R, C, 2, 4),
            s[..., 266:].reshape(R, C, 2, 4, 15))
        frame_num %= 1 << self.sps.log2_max_frame_num
        au = self._slice(
            SliceHeader(slice_type=5, idr=False, frame_num=frame_num,
                        first_mb_in_slice=0, slice_qp_delta=0,
                        disable_deblocking_filter_idc=0, cabac_init_idc=0),
            payload, NAL_SLICE, 2)
        bs = db.pframe_bs_grids(mv, luma, R, C)
        recon = self.deblock(
            *(out[k].cpu().numpy() for k in ("recon_y", "recon_u", "recon_v")),
            db.build_meta(self.qp, self.qp_c, *bs, R, C), R, C)
        return au, recon
