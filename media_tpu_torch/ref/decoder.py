"""Scalar numpy H.264 reference decoder (baseline subset) — the golden oracle.

Deliberately written as straightforward per-MB loops, independent of the
vectorized device encoder/decoder paths, so cross-checks between the two
catch bugs in either (SURVEY.md §7.2 step 2: the CPU golden path every device
kernel is tested against). Decodes the subset the framework emits:
I slices (I_16x16) and P slices (P_L0_16x16 / P_Skip), CAVLC, deblocking off.

The port's copy of media_tpu/ref/decoder.py: numpy throughout, the tables
and the CAVLC, MV-prediction and syntax modules from the port.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..core.bitstream import BitReader
from ..core.nal import H264NalType, iter_nal_units
from ..core.syntax import PPS, SPS, SliceHeader
from ..entropy import cavlc
from ..ops.transform import CHROMA_QP_TABLE, ZIGZAG_4x4
from ..pipeline import mv_pred

# Scalar quant tables (same constants as ops/transform.py, used scalar-wise).
_V = {0: (10, 16, 13), 1: (11, 18, 14), 2: (13, 20, 16),
      3: (14, 23, 18), 4: (16, 25, 20), 5: (18, 29, 23)}

_ZSCAN = [0, 1, 4, 5, 2, 3, 6, 7, 8, 9, 12, 13, 10, 11, 14, 15]


def _pos_class(i, j):
    if i % 2 == 0 and j % 2 == 0:
        return 0
    if i % 2 == 1 and j % 2 == 1:
        return 1
    return 2


def _dequant4(z, qp):
    d = np.zeros((4, 4), np.int64)
    for i in range(4):
        for j in range(4):
            d[i, j] = (int(z[i, j]) * _V[qp % 6][_pos_class(i, j)]) << (qp // 6)
    return d


def _idct4(d):
    e = np.zeros((4, 4), np.int64)
    for i in range(4):
        e0 = d[i, 0] + d[i, 2]
        e1 = d[i, 0] - d[i, 2]
        e2 = (d[i, 1] >> 1) - d[i, 3]
        e3 = d[i, 1] + (d[i, 3] >> 1)
        e[i] = [e0 + e3, e1 + e2, e1 - e2, e0 - e3]
    h = np.zeros((4, 4), np.int64)
    for j in range(4):
        g0 = e[0, j] + e[2, j]
        g1 = e[0, j] - e[2, j]
        g2 = (e[1, j] >> 1) - e[3, j]
        g3 = e[1, j] + (e[3, j] >> 1)
        h[:, j] = [g0 + g3, g1 + g2, g1 - g2, g0 - g3]
    return (h + 32) >> 6


_H4 = np.array([[1, 1, 1, 1], [1, 1, -1, -1], [1, -1, -1, 1], [1, -1, 1, -1]], np.int64)


def _luma_dc_decode(z_dc, qp):
    f = _H4 @ z_dc.astype(np.int64) @ _H4
    ls = 16 * _V[qp % 6][0]
    out = np.zeros((4, 4), np.int64)
    for i in range(4):
        for j in range(4):
            if qp >= 36:
                out[i, j] = (f[i, j] * ls) << (qp // 6 - 6)
            else:
                out[i, j] = (f[i, j] * ls + (1 << (5 - qp // 6))) >> (6 - qp // 6)
    return out


def _chroma_dc_decode(z_dc, qp):
    h2 = np.array([[1, 1], [1, -1]], np.int64)
    f = h2 @ z_dc.astype(np.int64) @ h2
    v0 = _V[qp % 6][0]
    out = np.zeros((2, 2), np.int64)
    for i in range(2):
        for j in range(2):
            out[i, j] = ((f[i, j] * 16 * v0) << (qp // 6)) >> 5
    return out


def _unzigzag(scan16):
    out = np.zeros((4, 4), np.int32)
    for k, (i, j) in enumerate(ZIGZAG_4x4):
        out[i, j] = scan16[k]
    return out


@dataclass
class DecodedFrame:
    y: np.ndarray
    u: np.ndarray
    v: np.ndarray
    frame_num: int
    idr: bool
    poc: int = 0  # PicOrderCnt (display order); 0 under POC type 2


class _PMotion:
    """Slice-local 4x4-granular motion state for general P-MB decoding.

    Carries per-block MV and refIdx grids (spec 8.4.1.3 operates at 4x4
    granularity once partitions exist) plus a decoded mask that realizes
    6.4.11.7 neighbor availability in decoding order — within an MB, a
    sub-partition's above-right neighbor may be a not-yet-decoded block of
    the same MB, which makes it unavailable and triggers the D
    substitution. mv4/ref4 alias the picture-level grids (deblocking bS
    derivation reads them); `done` is slice-local."""

    def __init__(self, mv4, ref4, r0):
        self.mv4 = mv4
        self.ref4 = ref4
        self.C4 = mv4.shape[1]
        self.y_min = 4 * r0
        self.done = np.zeros(mv4.shape[:2], bool)

    def nb(self, gy, gx):
        """(available, refIdx, mv) of the 4x4 block at (gy, gx)."""
        if (gy < self.y_min or gx < 0 or gx >= self.C4
                or not self.done[gy, gx]):
            return False, -1, (0, 0)
        return (True, int(self.ref4[gy, gx]),
                (int(self.mv4[gy, gx, 0]), int(self.mv4[gy, gx, 1])))

    def predict(self, gy0, gx0, w4, ref_idx, shape=None):
        """mvp for the partition whose top-left 4x4 block is (gy0, gx0),
        w4 blocks wide (8.4.1.3.2). shape: None, ('16x8', part) or
        ('8x16', part) for the directional special cases."""
        A = self.nb(gy0, gx0 - 1)
        B = self.nb(gy0 - 1, gx0)
        D = self.nb(gy0 - 1, gx0 - 1)
        Cn = self.nb(gy0 - 1, gx0 + w4)
        if not Cn[0]:
            Cn = D  # D substitutes for C (6.4.11.7)
        if shape == ("16x8", 0) and B[1] == ref_idx:
            return B[2]
        if shape == ("16x8", 1) and A[1] == ref_idx:
            return A[2]
        if shape == ("8x16", 0) and A[1] == ref_idx:
            return A[2]
        if shape == ("8x16", 1) and Cn[1] == ref_idx:
            return Cn[2]
        if A[0] and not B[0] and not Cn[0]:
            return A[2]  # only-A rule (B, C, D unavailable)
        matches = [N[2] for N in (A, B, Cn) if N[1] == ref_idx]
        if len(matches) == 1:
            return matches[0]
        m3 = mv_pred.median3
        return (m3(A[2][0], B[2][0], Cn[2][0]),
                m3(A[2][1], B[2][1], Cn[2][1]))

    def skip_mv(self, r, c):
        """P_Skip inference (8.4.1.1): 16x16 partition with refIdx 0."""
        gy0, gx0 = r * 4, c * 4
        A = self.nb(gy0, gx0 - 1)
        B = self.nb(gy0 - 1, gx0)
        if (not A[0] or not B[0]
                or (A[1] == 0 and A[2] == (0, 0))
                or (B[1] == 0 and B[2] == (0, 0))):
            return (0, 0)
        return self.predict(gy0, gx0, 4, 0)

    def set_region(self, gy0, gx0, h4, w4, mv, ref_idx):
        self.mv4[gy0 : gy0 + h4, gx0 : gx0 + w4] = mv
        self.ref4[gy0 : gy0 + h4, gx0 : gx0 + w4] = ref_idx
        self.done[gy0 : gy0 + h4, gx0 : gx0 + w4] = True

    def set_intra(self, r, c):
        self.set_region(r * 4, c * 4, 4, 4, (0, 0), -1)


@dataclass
class ReferenceDecoder:
    """Stateful Annex-B stream decoder."""

    sps: SPS | None = None
    pps: PPS | None = None
    ref_planes: tuple | None = None  # (y, u, v) of last decoded reference
    frames: list = field(default_factory=list)
    # Decoded picture buffer, most-recent-first (sliding-window marking,
    # spec 8.2.5.3): entries are {"poc", "planes"}; P ref list 0 is this
    # order (descending PicNum), B lists re-sort by POC (8.2.4.2.3).
    dpb: list = field(default_factory=list)
    # POC type 0 MSB/LSB tracking (spec 8.2.1.1).
    _poc_msb: int = 0
    _poc_lsb: int = 0

    def decode_annexb(self, data: bytes) -> list[DecodedFrame]:
        out = []
        for nal in iter_nal_units(data):
            if nal.nal_type == H264NalType.SPS:
                self.sps = SPS.parse(BitReader(nal.rbsp))
            elif nal.nal_type == H264NalType.PPS:
                self.pps = PPS.parse(BitReader(nal.rbsp))
            elif nal.nal_type in (H264NalType.SLICE, H264NalType.IDR_SLICE):
                frame = self._decode_slice(nal.rbsp, nal.nal_type, nal.nal_ref_idc)
                if frame is not None:
                    out.append(frame)
                    self.frames.append(frame)
        return out

    # ------------------------------------------------------------------ slice

    def _qpc(self, qp: int) -> int:
        """Chroma QP: table lookup of qp + pps.chroma_qp_index_offset
        (spec 8.5.8 / Table 8-15). x264 emits a nonzero offset by default;
        ignoring it mis-dequantizes chroma (caught by test_conformance)."""
        off = self.pps.chroma_qp_index_offset if self.pps else 0
        return int(CHROMA_QP_TABLE[np.clip(qp + off, 0, 51)])

    def _decode_slice(self, rbsp: bytes, nal_type: int, nal_ref_idc: int):
        """Decode one slice NAL; returns the finished DecodedFrame when the
        slice completes the picture, else None. Slices are contiguous MB-row
        bands (this framework's SM_FIXEDSLCNUM analog); entropy/prediction
        state is slice-local, pixels accumulate into the picture buffers."""
        if self.sps is None or self.pps is None:
            raise ValueError("slice before SPS/PPS")
        sps, pps = self.sps, self.pps
        br = BitReader(rbsp)
        hdr = SliceHeader.parse(br, sps, pps, nal_type=nal_type, nal_ref_idc=nal_ref_idc)
        qp = pps.pic_init_qp + hdr.slice_qp_delta

        n_rows = sps.pic_height_in_mbs
        n_cols = sps.pic_width_in_mbs
        H, W = n_rows * 16, n_cols * 16
        mb_count = n_rows * n_cols

        if hdr.first_mb_in_slice == 0 or getattr(self, "_asm", None) is None:
            self._asm = {
                "y": np.zeros((H, W), np.int32),
                "u": np.zeros((H // 2, W // 2), np.int32),
                "v": np.zeros((H // 2, W // 2), np.int32),
                "luma_nnz": np.zeros((n_rows * 4, n_cols * 4), np.int32),
                "chroma_nnz": np.zeros((2, n_rows * 2, n_cols * 2), np.int32),
                "mv4": np.zeros((n_rows * 4, n_cols * 4, 2), np.int32),
                "ref4": np.full((n_rows * 4, n_cols * 4), -1, np.int32),
                "intra_mb": np.zeros((n_rows, n_cols), bool),
                "qp_grid": np.full((n_rows, n_cols), qp, np.int32),
                "qp_varies": False,
                "covered": 0,
                "hdr": hdr,
                "qp": qp,
                "slice_starts": [],
            }
        asm = self._asm
        y, u, v = asm["y"], asm["u"], asm["v"]
        luma_nnz, chroma_nnz = asm["luma_nnz"], asm["chroma_nnz"]

        # PicOrderCnt (spec 8.2.1.1, type 0 MSB/LSB arithmetic; type 2
        # pictures never reorder, so 0 is fine there).
        if sps.pic_order_cnt_type == 0:
            max_lsb = 1 << sps.log2_max_pic_order_cnt_lsb
            if hdr.idr:
                self._poc_msb = self._poc_lsb = 0
            lsb = hdr.pic_order_cnt_lsb
            msb = self._poc_msb
            if lsb < self._poc_lsb and self._poc_lsb - lsb >= max_lsb // 2:
                msb += max_lsb
            elif lsb > self._poc_lsb and lsb - self._poc_lsb > max_lsb // 2:
                msb -= max_lsb
            cur_poc = msb + lsb
            if nal_ref_idc != 0:
                self._poc_msb, self._poc_lsb = msb, lsb
        else:
            cur_poc = 0

        if hdr.is_p or hdr.is_b:
            if not self.dpb and self.ref_planes is not None:
                # Session resumed with externally-seeded reference planes
                # (decoder_api fallback handoff).
                self.dpb = [{"poc": -1, "planes": self.ref_planes}]
            if not self.dpb:
                raise ValueError("inter slice without reference frame")
        if hdr.is_p:
            nref = max(1, hdr.num_ref_idx_l0_active)
            ref_list = [e["planes"] for e in self.dpb[:nref]]
            while len(ref_list) < nref:  # degenerate: clamp to what exists
                ref_list.append(ref_list[-1])
        elif hdr.is_b:
            # Default B list init (8.2.4.2.3): L0 = past POCs descending
            # then future ascending; L1 = future ascending then past
            # descending.
            past = sorted((e for e in self.dpb if e["poc"] < cur_poc),
                          key=lambda e: -e["poc"])
            future = sorted((e for e in self.dpb if e["poc"] >= cur_poc),
                            key=lambda e: e["poc"])
            l0 = [e["planes"] for e in past + future]
            l1 = [e["planes"] for e in future + past]
            n0 = max(1, hdr.num_ref_idx_l0_active)
            n1 = max(1, hdr.num_ref_idx_l1_active)
            while len(l0) < n0:
                l0.append(l0[-1] if l0 else self.dpb[0]["planes"])
            while len(l1) < n1:
                l1.append(l1[-1] if l1 else self.dpb[0]["planes"])
            ref_l0, ref_l1 = l0[:n0] or l0, l1[:n1] or l1
            if hdr.disable_deblocking_filter_idc != 1:
                raise NotImplementedError(
                    "deblocking in B slices not supported")

        mb_idx = hdr.first_mb_in_slice
        r0 = mb_idx // n_cols  # row-aligned slices
        asm["slice_starts"].append(r0)
        motion = (_PMotion(asm["mv4"], asm["ref4"], r0) if hdr.is_p else None)
        if hdr.is_b:
            m0 = _PMotion(asm["mv4"], asm["ref4"], r0)
            m1 = _PMotion(np.zeros_like(asm["mv4"]),
                          np.full_like(asm["ref4"], -1), r0)
        qp_state = [qp, False]  # [running per-MB QP, any delta seen]
        start_idx = mb_idx
        while mb_idx < mb_count and (mb_idx == start_idx or br.more_rbsp_data()):
            if hdr.is_b:
                skip_run = br.ue()
                if skip_run:
                    raise NotImplementedError("B_Skip (direct mode)")
                r, c = divmod(mb_idx, n_cols)
                mb_type = br.ue()
                if mb_type >= 23:  # intra MB in B slice (7.4.5: type - 23)
                    asm["intra_mb"][r, c] = True
                    m0.set_intra(r, c)
                    m1.set_intra(r, c)
                    it = mb_type - 23
                    if it == 25:
                        self._decode_ipcm(br, y, u, v, r, c, luma_nnz,
                                          chroma_nnz, asm)
                    elif it == 0:
                        if "i4_modes" not in asm:
                            asm["i4_modes"] = np.full(
                                (n_rows * 4, n_cols * 4), -1, np.int32)
                        self._decode_i4(br, y, u, v, r, c, qp_state[0],
                                        luma_nnz, chroma_nnz, n_cols,
                                        asm["i4_modes"], r0)
                    else:
                        self._decode_i16(br, y, u, v, r, c, it,
                                         qp_state[0], luma_nnz, chroma_nnz,
                                         n_cols, r0)
                elif mb_type == 0:
                    raise NotImplementedError("B_Direct_16x16")
                else:
                    self._decode_b_inter(br, y, u, v, ref_l0, ref_l1, r, c,
                                         mb_type, qp_state, luma_nnz,
                                         chroma_nnz, n_cols, m0, m1, r0)
                asm["qp_grid"][r, c] = qp_state[0]
                asm["qp_varies"] = asm["qp_varies"] or qp_state[1]
                mb_idx += 1
                continue
            if hdr.is_p:
                skip_run = br.ue()  # mb_skip_run precedes each coded MB
                for _ in range(skip_run):
                    r, c = divmod(mb_idx, n_cols)
                    self._decode_p_skip(y, u, v, ref_list[0], r, c, motion)
                    luma_nnz[r * 4 : r * 4 + 4, c * 4 : c * 4 + 4] = 0
                    chroma_nnz[:, r * 2 : r * 2 + 2, c * 2 : c * 2 + 2] = 0
                    asm["qp_grid"][r, c] = qp_state[0]
                    mb_idx += 1
                if mb_idx >= mb_count or not br.more_rbsp_data():
                    break
                r, c = divmod(mb_idx, n_cols)
                mb_type = br.ue()
                if mb_type >= 5:  # intra MB in P slice (7.4.5: type - 5)
                    asm["intra_mb"][r, c] = True
                    motion.set_intra(r, c)
                    if mb_type == 30:  # I_PCM in P slice (5 + 25)
                        self._decode_ipcm(br, y, u, v, r, c, luma_nnz,
                                          chroma_nnz, asm)
                        mb_idx += 1
                        continue
                    if mb_type == 5:  # I_4x4 in P
                        if "i4_modes" not in asm:
                            asm["i4_modes"] = np.full(
                                (n_rows * 4, n_cols * 4), -1, np.int32)
                        self._decode_i4(br, y, u, v, r, c, qp_state[0],
                                        luma_nnz, chroma_nnz, n_cols,
                                        asm["i4_modes"], r0)
                    else:
                        self._decode_i16(br, y, u, v, r, c, mb_type - 5,
                                         qp_state[0], luma_nnz, chroma_nnz,
                                         n_cols, r0)
                else:
                    self._decode_p_inter(br, y, u, v, ref_list, r, c,
                                         mb_type, qp_state, luma_nnz,
                                         chroma_nnz, n_cols, motion,
                                         len(ref_list), r0)
                asm["qp_grid"][r, c] = qp_state[0]
                asm["qp_varies"] = asm["qp_varies"] or qp_state[1]
                mb_idx += 1
            else:
                r, c = divmod(mb_idx, n_cols)
                mb_type = br.ue()
                if mb_type == 0:  # I_4x4
                    if "i4_modes" not in asm:
                        asm["i4_modes"] = np.full(
                            (n_rows * 4, n_cols * 4), -1, np.int32)
                    self._decode_i4(br, y, u, v, r, c, qp, luma_nnz,
                                    chroma_nnz, n_cols, asm["i4_modes"], r0)
                elif mb_type == 25:  # I_PCM
                    self._decode_ipcm(br, y, u, v, r, c, luma_nnz,
                                      chroma_nnz, asm)
                else:
                    self._decode_i16(br, y, u, v, r, c, mb_type, qp,
                                     luma_nnz, chroma_nnz, n_cols, r0)
                mb_idx += 1

        asm["covered"] += mb_idx - start_idx
        if asm["covered"] < mb_count:
            return None

        # Picture complete: deblock and emit.
        self._asm = None
        asm["qp_varies"] = asm["qp_varies"] or qp_state[1]
        if hdr.disable_deblocking_filter_idc != 1:
            from .deblock import (
                deblock_frame_np, inter_bs_grids_np, intra_bs_grids_np)

            qp_c = self._qpc(qp)
            if hdr.is_p:
                bs_v, bs_h = inter_bs_grids_np(luma_nnz, None,
                                               intra_mb=asm["intra_mb"],
                                               mv4=asm["mv4"],
                                               ref4=asm["ref4"])
            else:
                bs_v, bs_h = intra_bs_grids_np(n_rows, n_cols)
            if hdr.disable_deblocking_filter_idc == 2:
                # No filtering across slice boundaries: zero the horizontal
                # edges at each interior slice-start MB row.
                for sr in asm["slice_starts"]:
                    if sr > 0:
                        bs_h[4 * sr, :] = 0
            y, u, v = deblock_frame_np(
                np.clip(y, 0, 255), np.clip(u, 0, 255), np.clip(v, 0, 255),
                qp, qp_c, bs_v, bs_h,
                qp_map=asm["qp_grid"] if asm["qp_varies"] else None)

        frame = DecodedFrame(
            y=np.clip(y, 0, 255).astype(np.uint8),
            u=np.clip(u, 0, 255).astype(np.uint8),
            v=np.clip(v, 0, 255).astype(np.uint8),
            frame_num=hdr.frame_num,
            idr=hdr.idr,
            poc=cur_poc,
        )
        if nal_ref_idc != 0:
            self.ref_planes = (
                frame.y.astype(np.int32),
                frame.u.astype(np.int32),
                frame.v.astype(np.int32),
            )
            if hdr.idr:
                self.dpb = []
            self.dpb.insert(0, {"poc": cur_poc, "planes": self.ref_planes})
            max_ref = max(1, getattr(sps, "max_num_ref_frames", 1) or 1)
            del self.dpb[max_ref:]
        return frame

    # ----------------------------------------------------------------- I_PCM

    def _decode_ipcm(self, br, y, u, v, r, c, luma_nnz, chroma_nnz, asm):
        """I_PCM macroblock (spec 7.3.5): byte-align, then raw 8-bit samples.

        Neighbor bookkeeping per spec: nC sees an I_PCM neighbor as 16
        (9.2.1), and its QP is 0 for deblocking threshold purposes (8.7.2).
        """
        while not br.byte_aligned():
            if br.u(1):
                raise ValueError("nonzero pcm_alignment_zero_bit")
        ymb = np.frombuffer(br.read_bytes(256), np.uint8).reshape(16, 16)
        umb = np.frombuffer(br.read_bytes(64), np.uint8).reshape(8, 8)
        vmb = np.frombuffer(br.read_bytes(64), np.uint8).reshape(8, 8)
        y[r * 16 : r * 16 + 16, c * 16 : c * 16 + 16] = ymb
        u[r * 8 : r * 8 + 8, c * 8 : c * 8 + 8] = umb
        v[r * 8 : r * 8 + 8, c * 8 : c * 8 + 8] = vmb
        luma_nnz[r * 4 : r * 4 + 4, c * 4 : c * 4 + 4] = 16
        chroma_nnz[:, r * 2 : r * 2 + 2, c * 2 : c * 2 + 2] = 16
        asm["qp_grid"][r, c] = 0
        asm["qp_varies"] = True

    # ------------------------------------------------------------- intra 16x16

    def _decode_i16(self, br, y, u, v, r, c, mb_type, qp, luma_nnz, chroma_nnz,
                    n_cols, r0=0):
        if not 1 <= mb_type <= 24:
            raise NotImplementedError(f"mb_type {mb_type} (only I_16x16 supported)")
        mt = mb_type - 1
        pred_mode = mt % 4
        cbp_chroma = (mt // 4) % 3
        cbp_luma = 15 if mt >= 12 else 0
        chroma_mode = br.ue()
        qp_delta = br.se()
        if qp_delta:
            raise NotImplementedError("mb_qp_delta != 0")

        # Residual parse
        n_c = self._nc(luma_nnz, r * 4, c * 4, 4 * r0)
        dc_scan, _ = cavlc.decode_block(br, n_c, 16)
        ac = np.zeros((16, 15), np.int32)
        if cbp_luma:
            for zi in range(16):
                bi = _ZSCAN[zi]
                by, bx = r * 4 + bi // 4, c * 4 + bi % 4
                n_c = self._nc(luma_nnz, by, bx, 4 * r0)
                coeffs, tc = cavlc.decode_block(br, n_c, 15)
                ac[bi] = coeffs
                luma_nnz[by, bx] = tc
        else:
            luma_nnz[r * 4 : r * 4 + 4, c * 4 : c * 4 + 4] = 0
        cdc = np.zeros((2, 4), np.int32)
        cac = np.zeros((2, 4, 15), np.int32)
        if cbp_chroma:
            for comp in range(2):
                coeffs, _ = cavlc.decode_block(br, -1, 4)
                cdc[comp] = coeffs
        if cbp_chroma == 2:
            for comp in range(2):
                for bi in range(4):
                    by, bx = r * 2 + bi // 2, c * 2 + bi % 2
                    n_c = self._nc(chroma_nnz[comp], by, bx, 2 * r0)
                    coeffs, tc = cavlc.decode_block(br, n_c, 15)
                    cac[comp, bi] = coeffs
                    chroma_nnz[comp, by, bx] = tc
        else:
            chroma_nnz[:, r * 2 : r * 2 + 2, c * 2 : c * 2 + 2] = 0

        # Prediction
        pred = self._pred16(y, r, c, pred_mode, r0)
        self._recon_luma_i16(y, r, c, pred, dc_scan, ac, qp)
        for comp, plane in ((0, u), (1, v)):
            cpred = self._pred_chroma(plane, r, c, chroma_mode, r0)
            qpc = self._qpc(qp)
            self._recon_chroma(plane, r, c, cpred, cdc[comp], cac[comp], qpc)

    # ------------------------------------------------------------- intra 4x4

    # In-MB above-right availability for 4x4 blocks (z-scan decode order):
    # (by, bx) -> the block above-right has already been decoded.
    _I4_TR_OK = {(1, 0): True, (1, 1): False, (1, 2): True, (1, 3): False,
                 (2, 0): True, (2, 1): True, (2, 2): True, (2, 3): False,
                 (3, 0): True, (3, 1): False, (3, 2): True, (3, 3): False}

    @staticmethod
    def _pred4x4(mode, t, l, q, have_top, have_left):
        """Independent scalar Intra_4x4 predictors (spec 8.3.1.2).

        t: (8,) p[x,-1] x=0..7 (above-right already substituted);
        l: (4,) p[-1,y]; q: p[-1,-1]. Returns (4, 4) int64."""
        p = np.zeros((4, 4), np.int64)
        t = t.astype(np.int64)
        l = l.astype(np.int64)
        q = int(q)
        if mode == 0:  # Vertical
            p[:, :] = t[0:4][None, :]
        elif mode == 1:  # Horizontal
            p[:, :] = l[:, None]
        elif mode == 2:  # DC
            if have_top and have_left:
                v = (int(t[0:4].sum()) + int(l.sum()) + 4) >> 3
            elif have_top:
                v = (int(t[0:4].sum()) + 2) >> 2
            elif have_left:
                v = (int(l.sum()) + 2) >> 2
            else:
                v = 128
            p[:, :] = v
        elif mode == 3:  # Diagonal-Down-Left
            for yy in range(4):
                for xx in range(4):
                    if xx == 3 and yy == 3:
                        p[yy, xx] = (t[6] + 3 * t[7] + 2) >> 2
                    else:
                        p[yy, xx] = (t[xx + yy] + 2 * t[xx + yy + 1]
                                     + t[xx + yy + 2] + 2) >> 2
        elif mode == 4:  # Diagonal-Down-Right
            for yy in range(4):
                for xx in range(4):
                    if xx > yy:
                        # x-y == 1 reaches p[-1,-1]: index -1 is the corner q,
                        # NOT Python wrap-around into t.
                        a = q if xx - yy - 2 < 0 else t[xx - yy - 2]
                        p[yy, xx] = (a + 2 * t[xx - yy - 1] + t[xx - yy] + 2) >> 2
                    elif xx < yy:
                        a = q if yy - xx - 2 < 0 else l[yy - xx - 2]
                        p[yy, xx] = (a + 2 * l[yy - xx - 1] + l[yy - xx] + 2) >> 2
                    else:
                        p[yy, xx] = (t[0] + 2 * q + l[0] + 2) >> 2
        elif mode in (5, 6):  # Vertical-Right / Horizontal-Down
            # Mirror pair: HD is VR with (x, y) and top/left swapped.
            def px(i):
                return q if i == -1 else int(t[i])

            def py(i):
                return q if i == -1 else int(l[i])

            if mode == 6:
                px, py = py, px
            for yy in range(4):
                for xx in range(4):
                    x_, y_ = (xx, yy) if mode == 5 else (yy, xx)
                    z = 2 * x_ - y_
                    if z >= 0 and z % 2 == 0:
                        p[yy, xx] = (px(x_ - (y_ >> 1) - 1)
                                     + px(x_ - (y_ >> 1)) + 1) >> 1
                    elif z >= 0:
                        p[yy, xx] = (px(x_ - (y_ >> 1) - 2)
                                     + 2 * px(x_ - (y_ >> 1) - 1)
                                     + px(x_ - (y_ >> 1)) + 2) >> 2
                    elif z == -1:
                        p[yy, xx] = (py(0) + 2 * q + px(0) + 2) >> 2
                    else:
                        p[yy, xx] = (py(y_ - 2 * x_ - 1)
                                     + 2 * py(y_ - 2 * x_ - 2)
                                     + py(y_ - 2 * x_ - 3) + 2) >> 2
        elif mode == 7:  # Vertical-Left
            for yy in range(4):
                for xx in range(4):
                    i = xx + (yy >> 1)
                    if yy % 2 == 0:
                        p[yy, xx] = (t[i] + t[i + 1] + 1) >> 1
                    else:
                        p[yy, xx] = (t[i] + 2 * t[i + 1] + t[i + 2] + 2) >> 2
        elif mode == 8:  # Horizontal-Up
            for yy in range(4):
                for xx in range(4):
                    z = xx + 2 * yy
                    i = yy + (xx >> 1)
                    if z > 5:
                        p[yy, xx] = l[3]
                    elif z == 5:
                        p[yy, xx] = (l[2] + 3 * l[3] + 2) >> 2
                    elif z % 2 == 0:
                        p[yy, xx] = (l[i] + l[i + 1] + 1) >> 1
                    else:
                        p[yy, xx] = (l[i] + 2 * l[i + 1] + l[i + 2] + 2) >> 2
        else:
            raise ValueError(f"intra4x4 mode {mode}")
        return p

    def _decode_i4(self, br, y, u, v, r, c, qp, luma_nnz, chroma_nnz, n_cols,
                   i4_modes, r0=0):
        from ..entropy.cavlc_tables import CBP_TABLE

        # 1) prediction modes (MPM chain, z-scan order)
        modes = np.zeros(16, np.int32)
        for zi in range(16):
            bi = _ZSCAN[zi]
            gy, gx = r * 4 + bi // 4, c * 4 + bi % 4
            if gx <= 0 or gy <= 4 * r0:
                # dcPredModePredictedFlag (8.3.1.1): any unavailable
                # neighbor forces the DC prediction outright.
                pred = 2
            else:
                ma = int(i4_modes[gy, gx - 1])
                mb = int(i4_modes[gy - 1, gx])
                pred = min(2 if ma < 0 else ma, 2 if mb < 0 else mb)
            if br.u(1):
                m = pred
            else:
                rem = br.u(3)
                m = rem if rem < pred else rem + 1
            modes[zi] = m
            i4_modes[gy, gx] = m
        chroma_mode = br.ue()
        cbp = int(CBP_TABLE[br.ue()][0])  # intra column
        cbp_luma, cbp_chroma = cbp & 15, cbp >> 4
        if cbp and br.se():
            raise NotImplementedError("mb_qp_delta != 0 in I slices")

        # 2) residuals
        lev = np.zeros((16, 16), np.int32)
        for g8 in range(4):
            blks = [_ZSCAN[g8 * 4 + k] for k in range(4)]
            if not (cbp_luma >> g8) & 1:
                for bi in blks:
                    luma_nnz[r * 4 + bi // 4, c * 4 + bi % 4] = 0
                continue
            for bi in blks:
                by, bx = r * 4 + bi // 4, c * 4 + bi % 4
                n_c = self._nc(luma_nnz, by, bx, 4 * r0)
                coeffs, tc = cavlc.decode_block(br, n_c, 16)
                lev[bi] = coeffs
                luma_nnz[by, bx] = tc
        cdc = np.zeros((2, 4), np.int32)
        cac = np.zeros((2, 4, 15), np.int32)
        if cbp_chroma:
            for comp in range(2):
                coeffs, _ = cavlc.decode_block(br, -1, 4)
                cdc[comp] = coeffs
        if cbp_chroma == 2:
            for comp in range(2):
                for bi in range(4):
                    by, bx = r * 2 + bi // 2, c * 2 + bi % 2
                    n_c = self._nc(chroma_nnz[comp], by, bx, 2 * r0)
                    coeffs, tc = cavlc.decode_block(br, n_c, 15)
                    cac[comp, bi] = coeffs
                    chroma_nnz[comp, by, bx] = tc
        else:
            chroma_nnz[:, r * 2 : r * 2 + 2, c * 2 : c * 2 + 2] = 0

        # 3) reconstruct blocks in z-scan order (neighbors come from the
        # picture plane, already holding earlier blocks' reconstructions)
        y0, x0 = r * 16, c * 16
        for zi in range(16):
            bi = _ZSCAN[zi]
            by, bx = bi // 4, bi % 4
            gy, gx = y0 + by * 4, x0 + bx * 4
            have_top = by > 0 or r > r0
            have_left = bx > 0 or c > 0
            t = np.zeros(8, np.int64)
            l = np.zeros(4, np.int64)
            q = 0
            if have_top:
                t[0:4] = y[gy - 1, gx : gx + 4]
            if have_left:
                l[:] = y[gy : gy + 4, gx - 1]
            if have_top and have_left:
                q = int(y[gy - 1, gx - 1])
            if by == 0:
                tr_ok = have_top and (bx < 3 or c < n_cols - 1)
            else:
                tr_ok = self._I4_TR_OK[(by, bx)]
            if tr_ok:
                t[4:8] = y[gy - 1, gx + 4 : gx + 8]
            elif have_top:
                t[4:8] = t[3]
            pred = self._pred4x4(int(modes[zi]), t, l, q, have_top, have_left)
            res = _idct4(_dequant4(_unzigzag(list(lev[bi])), qp))
            y[gy : gy + 4, gx : gx + 4] = np.clip(pred + res, 0, 255)

        for comp, plane in ((0, u), (1, v)):
            cpred = self._pred_chroma(plane, r, c, chroma_mode, r0)
            qpc = self._qpc(qp)
            self._recon_chroma(plane, r, c, cpred, cdc[comp], cac[comp], qpc)

    @staticmethod
    def _nc(nnz, by, bx, min_by=0):
        a = bx > 0
        b = by > min_by
        if a and b:
            return (int(nnz[by, bx - 1]) + int(nnz[by - 1, bx]) + 1) >> 1
        if a:
            return int(nnz[by, bx - 1])
        if b:
            return int(nnz[by - 1, bx])
        return 0

    @staticmethod
    def _pred16(y, r, c, mode, r0=0):
        y0, x0 = r * 16, c * 16
        has_top = r > r0
        has_left = c > 0
        pred = np.zeros((16, 16), np.int64)
        if mode == 0:  # vertical
            assert has_top
            pred[:] = y[y0 - 1, x0 : x0 + 16][None, :]
        elif mode == 1:  # horizontal
            assert has_left
            pred[:] = y[y0 : y0 + 16, x0 - 1][:, None]
        elif mode == 2:  # DC
            if has_top and has_left:
                s = int(y[y0 - 1, x0 : x0 + 16].sum() + y[y0 : y0 + 16, x0 - 1].sum())
                pred[:] = (s + 16) >> 5
            elif has_top:
                pred[:] = (int(y[y0 - 1, x0 : x0 + 16].sum()) + 8) >> 4
            elif has_left:
                pred[:] = (int(y[y0 : y0 + 16, x0 - 1].sum()) + 8) >> 4
            else:
                pred[:] = 128
        else:  # plane
            assert has_top and has_left
            p = lambda yy, xx: int(y[y0 + yy, x0 + xx])
            h = sum((x + 1) * (p(-1, 8 + x) - p(-1, 6 - x)) for x in range(8))
            vv = sum((yy + 1) * (p(8 + yy, -1) - p(6 - yy, -1)) for yy in range(8))
            a = 16 * (p(-1, 15) + p(15, -1))
            b = (5 * h + 32) >> 6
            cc = (5 * vv + 32) >> 6
            for yy in range(16):
                for xx in range(16):
                    pred[yy, xx] = np.clip((a + b * (xx - 7) + cc * (yy - 7) + 16) >> 5, 0, 255)
        return pred

    @staticmethod
    def _pred_chroma(plane, r, c, mode, r0=0):
        y0, x0 = r * 8, c * 8
        has_top = r > r0
        has_left = c > 0
        pred = np.zeros((8, 8), np.int64)
        if mode == 0:  # DC, per 4x4 quadrant
            for qy in (0, 4):
                for qx in (0, 4):
                    t = plane[y0 - 1, x0 + qx : x0 + qx + 4] if has_top else None
                    l = plane[y0 + qy : y0 + qy + 4, x0 - 1] if has_left else None
                    if qx == qy:  # corners (0,0)/(4,4): average both if avail
                        if has_top and has_left:
                            val = (int(t.sum()) + int(l.sum()) + 4) >> 3
                        elif has_top:
                            val = (int(t.sum()) + 2) >> 2
                        elif has_left:
                            val = (int(l.sum()) + 2) >> 2
                        else:
                            val = 128
                    elif qx == 4:  # top-right block prefers top
                        if has_top:
                            val = (int(t.sum()) + 2) >> 2
                        elif has_left:
                            val = (int(l.sum()) + 2) >> 2
                        else:
                            val = 128
                    else:  # bottom-left block prefers left
                        if has_left:
                            val = (int(l.sum()) + 2) >> 2
                        elif has_top:
                            val = (int(t.sum()) + 2) >> 2
                        else:
                            val = 128
                    pred[qy : qy + 4, qx : qx + 4] = val
        elif mode == 1:  # horizontal
            assert has_left
            pred[:] = plane[y0 : y0 + 8, x0 - 1][:, None]
        elif mode == 2:  # vertical
            assert has_top
            pred[:] = plane[y0 - 1, x0 : x0 + 8][None, :]
        else:  # plane
            assert has_top and has_left
            p = lambda yy, xx: int(plane[y0 + yy, x0 + xx])
            h = sum((x + 1) * (p(-1, 4 + x) - p(-1, 2 - x)) for x in range(4))
            vv = sum((yy + 1) * (p(4 + yy, -1) - p(2 - yy, -1)) for yy in range(4))
            a = 16 * (p(-1, 7) + p(7, -1))
            b = (17 * h + 16) >> 5
            cc = (17 * vv + 16) >> 5
            for yy in range(8):
                for xx in range(8):
                    pred[yy, xx] = np.clip((a + b * (xx - 3) + cc * (yy - 3) + 16) >> 5, 0, 255)
        return pred

    def _recon_luma_i16(self, y, r, c, pred, dc_scan, ac, qp):
        dc_block = _unzigzag(list(dc_scan))  # 4x4 of DC levels
        dc_vals = _luma_dc_decode(dc_block, qp)
        y0, x0 = r * 16, c * 16
        for bi in range(16):
            by, bx = bi // 4, bi % 4
            z = _unzigzag([0] + list(ac[bi]))
            d = _dequant4(z, qp)
            d[0, 0] = dc_vals[by, bx]
            res = _idct4(d)
            py, px = y0 + by * 4, x0 + bx * 4
            y[py : py + 4, px : px + 4] = np.clip(pred[by * 4 : by * 4 + 4, bx * 4 : bx * 4 + 4] + res, 0, 255)

    def _recon_chroma(self, plane, r, c, pred, cdc, cac, qpc):
        dc_vals = _chroma_dc_decode(np.array(cdc, np.int32).reshape(2, 2), qpc)
        y0, x0 = r * 8, c * 8
        for bi in range(4):
            by, bx = bi // 2, bi % 2
            z = _unzigzag([0] + list(cac[bi]))
            d = _dequant4(z, qpc)
            d[0, 0] = dc_vals[by, bx]
            res = _idct4(d)
            py, px = y0 + by * 4, x0 + bx * 4
            plane[py : py + 4, px : px + 4] = np.clip(
                pred[by * 4 : by * 4 + 4, bx * 4 : bx * 4 + 4] + res, 0, 255
            )

    # ----------------------------------------------------------------- inter

    @staticmethod
    def _mv_pred(pred_mv, r, c, n_cols):
        return mv_pred.predict_mv(pred_mv, r, c, n_cols)


    def _mc_luma(self, ref_y, r, c, mvx, mvy):
        return self._mc_luma_blk(ref_y, r * 16, c * 16, 16, 16, mvx, mvy)

    def _mc_luma_blk(self, ref_y, py0, px0, h, w, mvx, mvy):
        """Quarter-pel luma motion compensation (spec 8.4.2.2.1/2) for an
        arbitrary (h, w) block at pixel origin (py0, px0).

        Implemented independently of the device encoder path: a clipped integer
        patch is fetched, 6-tap half-pel values are computed on it, and the
        quarter-pel position is the spec's rounded average of its two
        neighbors.
        """
        H, W = ref_y.shape
        xi, yi = mvx >> 2, mvy >> 2
        xf, yf = mvx & 3, mvy & 3
        y0, x0 = py0 + yi, px0 + xi
        # Patch covering taps (-2..+3) and +1 half/integer neighbors.
        ys = np.clip(np.arange(y0 - 2, y0 + h + 5), 0, H - 1)
        xs = np.clip(np.arange(x0 - 2, x0 + w + 5), 0, W - 1)
        p = ref_y[np.ix_(ys, xs)].astype(np.int64)  # origin at (y0-2, x0-2)

        def tap_h(a):
            ww = a.shape[1]
            return (a[:, 0:ww-5] - 5*a[:, 1:ww-4] + 20*a[:, 2:ww-3]
                    + 20*a[:, 3:ww-2] - 5*a[:, 4:ww-1] + a[:, 5:ww])

        def tap_v(a):
            h_ = a.shape[0]
            return (a[0:h_-5, :] - 5*a[1:h_-4, :] + 20*a[2:h_-3, :]
                    + 20*a[3:h_-2, :] - 5*a[4:h_-1, :] + a[5:h_, :])

        # Integer grid G over (h+1, w+1): G[j, i] = ref(y0 + j, x0 + i)
        G = p[2:h+3, 2:w+3]
        b1 = tap_h(p)            # col i -> half between x0+i and x0+i+1
        B = np.clip((b1[2:h+3, 0:w+1] + 16) >> 5, 0, 255)
        h1 = tap_v(p)            # row j -> half between y0+j and y0+j+1
        Hh = np.clip((h1[0:h+1, 2:w+3] + 16) >> 5, 0, 255)
        j1 = tap_v(b1)
        J = np.clip((j1[0:h+1, 0:w+1] + 512) >> 10, 0, 255)

        def blk(a, px=0, py=0):
            return a[py:py+h, px:px+w]

        def avg(a, b_):
            return (a + b_ + 1) >> 1

        table = {
            (0, 0): lambda: blk(G),
            (1, 0): lambda: avg(blk(G), blk(B)),
            (2, 0): lambda: blk(B),
            (3, 0): lambda: avg(blk(B), blk(G, px=1)),
            (0, 1): lambda: avg(blk(G), blk(Hh)),
            (1, 1): lambda: avg(blk(B), blk(Hh)),
            (2, 1): lambda: avg(blk(B), blk(J)),
            (3, 1): lambda: avg(blk(B), blk(Hh, px=1)),
            (0, 2): lambda: blk(Hh),
            (1, 2): lambda: avg(blk(Hh), blk(J)),
            (2, 2): lambda: blk(J),
            (3, 2): lambda: avg(blk(J), blk(Hh, px=1)),
            (0, 3): lambda: avg(blk(Hh), blk(G, py=1)),
            (1, 3): lambda: avg(blk(Hh), blk(B, py=1)),
            (2, 3): lambda: avg(blk(J), blk(B, py=1)),
            (3, 3): lambda: avg(blk(Hh, px=1), blk(B, py=1)),
        }
        return table[(xf, yf)]()

    def _mc_chroma(self, ref_c, r, c, mvx, mvy):
        return self._mc_chroma_blk(ref_c, r * 8, c * 8, 8, 8, mvx, mvy)

    def _mc_chroma_blk(self, ref_c, py0, px0, h, w, mvx, mvy):
        """Chroma MC at 1/8-pel for an (h, w) block at chroma-pixel origin
        (py0, px0): full-pel luma MVs can still be half-pel in chroma;
        bilinear interpolation per spec 8.4.2.2.2."""
        H, W = ref_c.shape
        # chroma mv in 1/8 units = luma mv (1/4 units) ... mvC = mvL (same
        # numeric value interpreted at 1/8 chroma pel)
        fx, fy = mvx & 7, mvy & 7
        ix, iy = mvx >> 3, mvy >> 3
        y0, x0 = py0 + iy, px0 + ix
        ys = np.clip(np.arange(y0, y0 + h + 1), 0, H - 1)
        xs = np.clip(np.arange(x0, x0 + w + 1), 0, W - 1)
        patch = ref_c[np.ix_(ys, xs)].astype(np.int64)
        a = patch[:h, :w]
        b = patch[:h, 1:w+1]
        cc = patch[1:h+1, :w]
        d = patch[1:h+1, 1:w+1]
        return (
            (8 - fx) * (8 - fy) * a
            + fx * (8 - fy) * b
            + (8 - fx) * fy * cc
            + fx * fy * d
            + 32
        ) >> 6

    def _decode_p_skip(self, y, u, v, ref0, r, c, motion):
        """P_Skip: MV inferred by the grid rule (spec 8.4.1.1), refIdx 0."""
        ref_y, ref_u, ref_v = ref0
        mvx, mvy = motion.skip_mv(r, c)
        motion.set_region(r * 4, c * 4, 4, 4, (mvx, mvy), 0)
        y0, x0 = r * 16, c * 16
        y[y0 : y0 + 16, x0 : x0 + 16] = self._mc_luma(ref_y, r, c, mvx, mvy)
        u[r * 8 : r * 8 + 8, c * 8 : c * 8 + 8] = self._mc_chroma(ref_u, r, c, mvx, mvy)
        v[r * 8 : r * 8 + 8, c * 8 : c * 8 + 8] = self._mc_chroma(ref_v, r, c, mvx, mvy)

    # P macroblock partition geometry: mb_type -> [(by, bx, h4, w4, shape)]
    # in 4x4-block units within the MB (spec Table 7-13).
    _P_PARTS = {
        0: [(0, 0, 4, 4, None)],
        1: [(0, 0, 2, 4, ("16x8", 0)), (2, 0, 2, 4, ("16x8", 1))],
        2: [(0, 0, 4, 2, ("8x16", 0)), (0, 2, 4, 2, ("8x16", 1))],
    }
    # P sub-macroblock partition geometry: sub_mb_type -> [(by, bx, h4, w4)]
    # within the 8x8 (spec Table 7-17).
    _P_SUB_PARTS = {
        0: [(0, 0, 2, 2)],
        1: [(0, 0, 1, 2), (1, 0, 1, 2)],
        2: [(0, 0, 2, 1), (0, 1, 2, 1)],
        3: [(0, 0, 1, 1), (0, 1, 1, 1), (1, 0, 1, 1), (1, 1, 1, 1)],
    }

    def _decode_p_inter(self, br, y, u, v, ref_list, r, c, mb_type,
                        qp_state, luma_nnz, chroma_nnz, n_cols, motion,
                        nref, r0=0):
        """Inter P macroblock: P_L0_16x16 (0), P_L0_L0_16x8 (1),
        P_L0_L0_8x16 (2), P_8x8 (3), P_8x8ref0 (4) with all sub-partition
        shapes and per-partition reference indices (spec 7.3.5.1,
        8.4.1.3). Prediction samples come from ref_list[ref_idx]."""
        qp = qp_state[0]
        if mb_type > 4:
            raise NotImplementedError(f"P mb_type {mb_type}")
        gy0, gx0 = r * 4, c * 4
        pred_y = np.zeros((16, 16), np.int64)
        pred_u = np.zeros((8, 8), np.int64)
        pred_v = np.zeros((8, 8), np.int64)

        def mc_part(by, bx, h4, w4, mvx, mvy, ref_idx):
            ry, ru, rv = ref_list[ref_idx]
            pred_y[by * 4 : (by + h4) * 4, bx * 4 : (bx + w4) * 4] = (
                self._mc_luma_blk(ry, r * 16 + by * 4, c * 16 + bx * 4,
                                  h4 * 4, w4 * 4, mvx, mvy))
            pred_u[by * 2 : (by + h4) * 2, bx * 2 : (bx + w4) * 2] = (
                self._mc_chroma_blk(ru, r * 8 + by * 2, c * 8 + bx * 2,
                                    h4 * 2, w4 * 2, mvx, mvy))
            pred_v[by * 2 : (by + h4) * 2, bx * 2 : (bx + w4) * 2] = (
                self._mc_chroma_blk(rv, r * 8 + by * 2, c * 8 + bx * 2,
                                    h4 * 2, w4 * 2, mvx, mvy))

        if mb_type in (0, 1, 2):
            parts = self._P_PARTS[mb_type]
            refs = [(br.te(nref - 1) if nref > 1 else 0) for _ in parts]
            for (by, bx, h4, w4, shape), ref_idx in zip(parts, refs):
                if ref_idx >= nref:
                    raise ValueError(f"ref_idx {ref_idx} out of range")
                mvdx = br.se()
                mvdy = br.se()
                px, py = motion.predict(gy0 + by, gx0 + bx, w4, ref_idx,
                                        shape)
                mvx, mvy = px + mvdx, py + mvdy
                motion.set_region(gy0 + by, gx0 + bx, h4, w4, (mvx, mvy),
                                  ref_idx)
                mc_part(by, bx, h4, w4, mvx, mvy, ref_idx)
        else:
            sub_types = [br.ue() for _ in range(4)]
            if any(st > 3 for st in sub_types):
                raise NotImplementedError(f"sub_mb_type {sub_types}")
            if mb_type == 4 or nref == 1:  # P_8x8ref0: all refIdx 0
                refs8 = [0, 0, 0, 0]
            else:
                refs8 = [br.te(nref - 1) for _ in range(4)]
            for p8 in range(4):
                sy, sx = (p8 // 2) * 2, (p8 % 2) * 2
                ref_idx = refs8[p8]
                if ref_idx >= nref:
                    raise ValueError(f"ref_idx {ref_idx} out of range")
                for (by, bx, h4, w4) in self._P_SUB_PARTS[sub_types[p8]]:
                    mvdx = br.se()
                    mvdy = br.se()
                    px, py = motion.predict(gy0 + sy + by, gx0 + sx + bx,
                                            w4, ref_idx)
                    mvx, mvy = px + mvdx, py + mvdy
                    motion.set_region(gy0 + sy + by, gx0 + sx + bx, h4, w4,
                                      (mvx, mvy), ref_idx)
                    mc_part(sy + by, sx + bx, h4, w4, mvx, mvy, ref_idx)

        self._inter_residual_recon(br, y, u, v, r, c, qp_state, luma_nnz,
                                   chroma_nnz, pred_y, pred_u, pred_v, r0)

    def _decode_b_inter(self, br, y, u, v, ref_l0, ref_l1, r, c, mb_type,
                        qp_state, luma_nnz, chroma_nnz, n_cols, m0, m1,
                        r0=0):
        """B macroblock, 16x16 types only: B_L0_16x16 (1), B_L1_16x16 (2),
        B_Bi_16x16 (3). m0/m1: per-list _PMotion contexts; bi-prediction
        is the default rounded average (spec 8.4.2.3.2)."""
        if mb_type not in (1, 2, 3):
            raise NotImplementedError(f"B mb_type {mb_type}")
        use0 = mb_type in (1, 3)
        use1 = mb_type in (2, 3)
        gy0, gx0 = r * 4, c * 4
        n0, n1 = len(ref_l0), len(ref_l1)
        ref0 = br.te(n0 - 1) if (use0 and n0 > 1) else 0
        ref1 = br.te(n1 - 1) if (use1 and n1 > 1) else 0
        preds = []
        for use, m, ref_idx, ref_list in ((use0, m0, ref0, ref_l0),
                                          (use1, m1, ref1, ref_l1)):
            if not use:
                m.set_region(gy0, gx0, 4, 4, (0, 0), -1)
                continue
            mvdx = br.se()
            mvdy = br.se()
            px, py = m.predict(gy0, gx0, 4, ref_idx)
            mvx, mvy = px + mvdx, py + mvdy
            m.set_region(gy0, gx0, 4, 4, (mvx, mvy), ref_idx)
            ry, ru, rv = ref_list[ref_idx]
            preds.append((self._mc_luma(ry, r, c, mvx, mvy),
                          self._mc_chroma(ru, r, c, mvx, mvy),
                          self._mc_chroma(rv, r, c, mvx, mvy)))
        if len(preds) == 2:
            pred_y = (preds[0][0] + preds[1][0] + 1) >> 1
            pred_u = (preds[0][1] + preds[1][1] + 1) >> 1
            pred_v = (preds[0][2] + preds[1][2] + 1) >> 1
        else:
            pred_y, pred_u, pred_v = preds[0]
        self._inter_residual_recon(br, y, u, v, r, c, qp_state, luma_nnz,
                                   chroma_nnz, pred_y, pred_u, pred_v, r0)

    def _inter_residual_recon(self, br, y, u, v, r, c, qp_state, luma_nnz,
                              chroma_nnz, pred_y, pred_u, pred_v, r0=0):
        """Shared inter-MB residual parse + reconstruction (P and B)."""
        from ..entropy.cavlc_tables import CBP_TABLE

        qp = qp_state[0]
        cbp_code = br.ue()
        cbp = int(CBP_TABLE[cbp_code][1])  # inter column
        cbp_luma = cbp & 15
        cbp_chroma = cbp >> 4
        ac = np.zeros((16, 16), np.int32)  # full 16-coeff blocks for inter
        if cbp:
            qp_delta = br.se()
            if qp_delta:
                if not -26 <= qp_delta <= 25:
                    raise ValueError(f"mb_qp_delta {qp_delta} out of range")
                qp = (qp + qp_delta + 52) % 52
                qp_state[0] = qp
                qp_state[1] = True
        for g8 in range(4):  # 8x8 groups in z-scan
            if not (cbp_luma >> g8) & 1:
                for k in range(4):
                    bi = _ZSCAN[g8 * 4 + k]
                    luma_nnz[r * 4 + bi // 4, c * 4 + bi % 4] = 0
                continue
            for k in range(4):
                bi = _ZSCAN[g8 * 4 + k]
                by, bx = r * 4 + bi // 4, c * 4 + bi % 4
                n_c = self._nc(luma_nnz, by, bx, 4 * r0)
                coeffs, tc = cavlc.decode_block(br, n_c, 16)
                ac[bi] = coeffs
                luma_nnz[by, bx] = tc
        cdc = np.zeros((2, 4), np.int32)
        cac = np.zeros((2, 4, 15), np.int32)
        if cbp_chroma:
            for comp in range(2):
                coeffs, _ = cavlc.decode_block(br, -1, 4)
                cdc[comp] = coeffs
        if cbp_chroma == 2:
            for comp in range(2):
                for bi in range(4):
                    by, bx = r * 2 + bi // 2, c * 2 + bi % 2
                    n_c = self._nc(chroma_nnz[comp], by, bx, 2 * r0)
                    coeffs, tc = cavlc.decode_block(br, n_c, 15)
                    cac[comp, bi] = coeffs
                    chroma_nnz[comp, by, bx] = tc
        else:
            chroma_nnz[:, r * 2 : r * 2 + 2, c * 2 : c * 2 + 2] = 0

        # Reconstruct luma
        y0, x0 = r * 16, c * 16
        for bi in range(16):
            by, bx = bi // 4, bi % 4
            z = _unzigzag(list(ac[bi]))
            d = _dequant4(z, qp)
            res = _idct4(d)
            pyy, pxx = y0 + by * 4, x0 + bx * 4
            y[pyy : pyy + 4, pxx : pxx + 4] = np.clip(
                pred_y[by * 4 : by * 4 + 4, bx * 4 : bx * 4 + 4] + res, 0, 255
            )
        # Chroma
        qpc = self._qpc(qp)
        for comp, plane, cpred in ((0, u, pred_u), (1, v, pred_v)):
            dc_vals = _chroma_dc_decode(cdc[comp].reshape(2, 2), qpc)
            for bi in range(4):
                by, bx = bi // 2, bi % 2
                z = _unzigzag([0] + list(cac[comp, bi]))
                d = _dequant4(z, qpc)
                d[0, 0] = dc_vals[by, bx]
                res = _idct4(d)
                pyy, pxx = r * 8 + by * 4, c * 8 + bx * 4
                plane[pyy : pyy + 4, pxx : pxx + 4] = np.clip(
                    cpred[by * 4 : by * 4 + 4, bx * 4 : bx * 4 + 4] + res, 0, 255
                )
