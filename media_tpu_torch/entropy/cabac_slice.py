"""CABAC slice-data coding for the symbol tensors this encoder produces.

Mirrors pipeline/slice_coder.py (the CAVLC twin) at the symbol level:
P slices of P_Skip / P_L0_16x16 macroblocks and I slices of I_16x16
macroblocks, with spec 9.3 binarizations (TU, UEG0/UEG3), context index
derivations (neighbor-based ctxIdxInc for skip/mvd/cbp/cbf), the
significance-map + reverse-scan level coding of 9.3.2.7, and per-MB
end_of_slice_flag terminate bins.

Conformance: engine, binarizations, ctxIdxInc derivations and the normative
init tables (cabac_init_tables.py) follow the spec; CABAC streams decode
bit-exactly in third-party decoders (libavcodec harness,
tests/test_conformance.py). Encoder and parser here are exact mirrors, so
in-repo round trips are additionally bit-exact (tests/test_cabac.py).

Reference operating point: OpenH264 path runs CABAC
(video_codec/VideoEncoderOpenH264.cpp:291). A copy of
media_tpu/entropy/cabac_slice.py that takes mv_pred and ZSCAN_TO_RASTER from
this package.
"""

from __future__ import annotations

import numpy as np

from . import cabac_contexts as cc
from .cabac_engine import CabacDecoder, CabacEncoder
from ..pipeline import mv_pred
from ..pipeline.encoder import ZSCAN_TO_RASTER


# --------------------------------------------------------------- primitives


def _enc_tu(enc, ctx, val, cmax, ctx_of):
    """Truncated unary: val in [0, cmax]; ctx_of(binIdx) -> ctxIdx."""
    for k in range(val):
        enc.encode_bin(ctx, ctx_of(k), 1)
    if val < cmax:
        enc.encode_bin(ctx, ctx_of(val), 0)


def _dec_tu(dec, ctx, cmax, ctx_of):
    v = 0
    while v < cmax and dec.decode_bin(ctx, ctx_of(v)):
        v += 1
    return v


def _enc_eg_bypass(enc, val, k):
    """Exp-Golomb order k, bypass bins (suffix of UEGk)."""
    while val >= (1 << k):
        enc.encode_bypass(1)
        val -= 1 << k
        k += 1
    enc.encode_bypass(0)
    for i in range(k - 1, -1, -1):
        enc.encode_bypass((val >> i) & 1)


def _dec_eg_bypass(dec, k):
    val = 0
    while dec.decode_bypass():
        val += 1 << k
        k += 1
    suffix = 0
    for _ in range(k):
        suffix = (suffix << 1) | dec.decode_bypass()
    return val + suffix


def _enc_mvd(enc, ctx, mvd, base, e):
    """UEG3 signed mvd component; e = |mvdA| + |mvdB| (neighbor sum)."""
    a = abs(int(mvd))
    inc0 = 0 if e < 3 else (1 if e <= 32 else 2)

    def ctx_of(k):
        return base + (inc0 if k == 0 else min(k + 2, 6))

    _enc_tu(enc, ctx, min(a, 9), 9, ctx_of)
    if a >= 9:
        _enc_eg_bypass(enc, a - 9, 3)
    if a:
        enc.encode_bypass(1 if mvd < 0 else 0)


def _dec_mvd(dec, ctx, base, e):
    inc0 = 0 if e < 3 else (1 if e <= 32 else 2)

    def ctx_of(k):
        return base + (inc0 if k == 0 else min(k + 2, 6))

    a = _dec_tu(dec, ctx, 9, ctx_of)
    if a == 9:
        a += _dec_eg_bypass(dec, 3)
    if a and dec.decode_bypass():
        return -a
    return a


# --------------------------------------------------- residual blocks (9.3.2.7)


def _enc_block(enc, ctx, cat, levels, cbf_inc):
    """One residual block: coded_block_flag, significance map, levels.

    levels: zig-zag list, length == CAT_MAXCOEFF[cat]. Returns cbf."""
    mc = cc.CAT_MAXCOEFF[cat]
    nz = [i for i, v in enumerate(levels) if v]
    cbf = 1 if nz else 0
    enc.encode_bin(ctx, cc.CBF + 4 * cat + cbf_inc, cbf)
    if not cbf:
        return 0
    last = nz[-1]
    off = cc.CAT_OFFSET_SIG[cat]
    for i in range(mc - 1):
        sig = 1 if levels[i] else 0
        enc.encode_bin(ctx, cc.SIG + off + i, sig)
        if sig:
            enc.encode_bin(ctx, cc.LAST + off + i, 1 if i == last else 0)
            if i == last:
                break
    num_eq1 = num_gt1 = 0
    aoff = cc.ABS_LVL + cc.CAT_OFFSET_ABS[cat]
    cap = 3 if cat == 3 else 4  # chroma DC caps at 3 (9.3.3.1.3)
    for i in reversed(nz):
        a = abs(int(levels[i])) - 1
        inc0 = 0 if num_gt1 else min(4, 1 + num_eq1)
        incN = 5 + min(cap, num_gt1)

        def ctx_of(k, inc0=inc0, incN=incN):
            return aoff + (inc0 if k == 0 else incN)

        _enc_tu(enc, ctx, min(a, 14), 14, ctx_of)
        if a >= 14:
            _enc_eg_bypass(enc, a - 14, 0)
        enc.encode_bypass(1 if levels[i] < 0 else 0)
        if a == 0:
            num_eq1 += 1
        else:
            num_gt1 += 1
    return 1


def _dec_block(dec, ctx, cat, cbf_inc):
    """Returns zig-zag level list (length CAT_MAXCOEFF[cat]) or all zeros."""
    mc = cc.CAT_MAXCOEFF[cat]
    levels = [0] * mc
    if not dec.decode_bin(ctx, cc.CBF + 4 * cat + cbf_inc):
        return levels, 0
    off = cc.CAT_OFFSET_SIG[cat]
    sig_pos = []
    last_found = False
    for i in range(mc - 1):
        if dec.decode_bin(ctx, cc.SIG + off + i):
            sig_pos.append(i)
            if dec.decode_bin(ctx, cc.LAST + off + i):
                last_found = True
                break
    if not last_found:
        sig_pos.append(mc - 1)  # implied: the final coeff is significant
    num_eq1 = num_gt1 = 0
    aoff = cc.ABS_LVL + cc.CAT_OFFSET_ABS[cat]
    cap = 3 if cat == 3 else 4  # chroma DC caps at 3 (9.3.3.1.3)
    for i in reversed(sig_pos):
        inc0 = 0 if num_gt1 else min(4, 1 + num_eq1)
        incN = 5 + min(cap, num_gt1)

        def ctx_of(k, inc0=inc0, incN=incN):
            return aoff + (inc0 if k == 0 else incN)

        a = _dec_tu(dec, ctx, 14, ctx_of)
        if a == 14:
            a += _dec_eg_bypass(dec, 0)
        val = a + 1
        if dec.decode_bypass():
            val = -val
        levels[i] = val
        if a == 0:
            num_eq1 += 1
        else:
            num_gt1 += 1
    return levels, 1


# ------------------------------------------------------------------ P slices


class _CbfState:
    """Neighbor coded_block_flag grids (the CABAC analog of nnz tracking).

    `intra` is the CURRENT MB's prediction class: spec 9.3.3.1.1.9 sets
    condTermFlagN = 1 for an unavailable neighbor when the current MB is
    intra-coded (0 when inter) — getting this wrong shifts every residual
    context at picture/slice edges (caught by the libavcodec harness)."""

    def __init__(self, R, C):
        self.luma = np.zeros((R * 4, C * 4), np.int32)
        self.chroma = np.zeros((2, R * 2, C * 2), np.int32)
        self.luma_dc = np.zeros((R, C), np.int32)
        self.chroma_dc = np.zeros((2, R, C), np.int32)
        self.intra = False

    def _edge(self):
        return 1 if self.intra else 0

    def inc_luma(self, by, bx):
        a = self.luma[by, bx - 1] if bx > 0 else self._edge()
        b = self.luma[by - 1, bx] if by > 0 else self._edge()
        return int(a + 2 * b)

    def inc_chroma(self, comp, by, bx):
        a = self.chroma[comp, by, bx - 1] if bx > 0 else self._edge()
        b = self.chroma[comp, by - 1, bx] if by > 0 else self._edge()
        return int(a + 2 * b)

    def inc_luma_dc(self, r, c):
        a = self.luma_dc[r, c - 1] if c > 0 else self._edge()
        b = self.luma_dc[r - 1, c] if r > 0 else self._edge()
        return int(a + 2 * b)

    def inc_chroma_dc(self, comp, r, c):
        a = self.chroma_dc[comp, r, c - 1] if c > 0 else self._edge()
        b = self.chroma_dc[comp, r - 1, c] if r > 0 else self._edge()
        return int(a + 2 * b)


def _mb_cbp(luma_levels_rc, cdc_rc, cac_rc):
    cbp_luma = 0
    for g8 in range(4):
        blks = [ZSCAN_TO_RASTER[g8 * 4 + k] for k in range(4)]
        if any(np.any(luma_levels_rc[b]) for b in blks):
            cbp_luma |= 1 << g8
    if np.any(cac_rc):
        cbp_chroma = 2
    elif np.any(cdc_rc):
        cbp_chroma = 1
    else:
        cbp_chroma = 0
    return cbp_luma, cbp_chroma


def _enc_cbp(enc, ctx, cbp_luma, cbp_chroma, cbp_l_a, cbp_l_b, cbp_c_a, cbp_c_b):
    """coded_block_pattern: 4 luma bins (z-scan 8x8), 2 chroma bins.

    cbp_l_a/b: left/top MB luma cbp (or None); cbp_c_a/b likewise chroma."""
    for g8 in range(4):
        # neighbor 8x8 for bit g8: left neighbor of g8 0/2 is bits 1/3 of MB A
        if g8 % 2 == 0:
            bit_a = ((cbp_l_a >> (g8 + 1)) & 1) if cbp_l_a is not None else 1
        else:
            bit_a = (cbp_luma >> (g8 - 1)) & 1
        if g8 < 2:
            bit_b = ((cbp_l_b >> (g8 + 2)) & 1) if cbp_l_b is not None else 1
        else:
            bit_b = (cbp_luma >> (g8 - 2)) & 1
        inc = (1 - bit_a) + 2 * (1 - bit_b)
        enc.encode_bin(ctx, cc.CBP_LUMA + inc, (cbp_luma >> g8) & 1)
    a = cbp_c_a if cbp_c_a is not None else 0
    b = cbp_c_b if cbp_c_b is not None else 0
    inc0 = (1 if a else 0) + 2 * (1 if b else 0)
    enc.encode_bin(ctx, cc.CBP_CHROMA + inc0, 1 if cbp_chroma else 0)
    if cbp_chroma:
        inc1 = (1 if a == 2 else 0) + 2 * (1 if b == 2 else 0)
        enc.encode_bin(ctx, cc.CBP_CHROMA + 4 + inc1, 1 if cbp_chroma == 2 else 0)


def _dec_cbp(dec, ctx, cbp_l_a, cbp_l_b, cbp_c_a, cbp_c_b):
    cbp_luma = 0
    for g8 in range(4):
        if g8 % 2 == 0:
            bit_a = ((cbp_l_a >> (g8 + 1)) & 1) if cbp_l_a is not None else 1
        else:
            bit_a = (cbp_luma >> (g8 - 1)) & 1
        if g8 < 2:
            bit_b = ((cbp_l_b >> (g8 + 2)) & 1) if cbp_l_b is not None else 1
        else:
            bit_b = (cbp_luma >> (g8 - 2)) & 1
        inc = (1 - bit_a) + 2 * (1 - bit_b)
        cbp_luma |= dec.decode_bin(ctx, cc.CBP_LUMA + inc) << g8
    a = cbp_c_a if cbp_c_a is not None else 0
    b = cbp_c_b if cbp_c_b is not None else 0
    inc0 = (1 if a else 0) + 2 * (1 if b else 0)
    cbp_chroma = 0
    if dec.decode_bin(ctx, cc.CBP_CHROMA + inc0):
        inc1 = (1 if a == 2 else 0) + 2 * (1 if b == 2 else 0)
        cbp_chroma = 2 if dec.decode_bin(ctx, cc.CBP_CHROMA + 4 + inc1) else 1
    return cbp_luma, cbp_chroma


def _chroma_blocks(enc_or_dec, ctx, st, r, c, cbp_chroma, cdc_rc, cac_rc,
                   write: bool):
    """Shared chroma residual traversal. Mutates cdc_rc/cac_rc on parse."""
    if cbp_chroma == 0:
        st.chroma_dc[:, r, c] = 0
        st.chroma[:, r * 2 : r * 2 + 2, c * 2 : c * 2 + 2] = 0
        return
    for comp in range(2):
        inc = st.inc_chroma_dc(comp, r, c)
        if write:
            cbf = _enc_block(enc_or_dec, ctx, 3, cdc_rc[comp].tolist(), inc)
        else:
            levels, cbf = _dec_block(enc_or_dec, ctx, 3, inc)
            cdc_rc[comp] = levels
        st.chroma_dc[comp, r, c] = cbf
    if cbp_chroma == 2:
        for comp in range(2):
            for blk in range(4):
                by, bx = r * 2 + blk // 2, c * 2 + blk % 2
                inc = st.inc_chroma(comp, by, bx)
                if write:
                    cbf = _enc_block(enc_or_dec, ctx, 4,
                                     cac_rc[comp, blk].tolist(), inc)
                else:
                    levels, cbf = _dec_block(enc_or_dec, ctx, 4, inc)
                    cac_rc[comp, blk] = levels
                st.chroma[comp, by, bx] = cbf
    else:
        st.chroma[:, r * 2 : r * 2 + 2, c * 2 : c * 2 + 2] = 0


def _enc_qp_delta(enc, ctx, delta: int, prev_delta: int) -> None:
    """mb_qp_delta (spec 9.3.2.7): signed map to k, then U binarization;
    ctxIdxInc: bin0 = (prev mb_qp_delta != 0), bin1 -> +2, bins >= 2 -> +3."""
    k = 2 * delta - 1 if delta > 0 else -2 * delta
    ctx0 = cc.MB_QP_DELTA + (1 if prev_delta else 0)
    if k == 0:
        enc.encode_bin(ctx, ctx0, 0)
        return
    enc.encode_bin(ctx, ctx0, 1)
    for i in range(1, k):
        enc.encode_bin(ctx, cc.MB_QP_DELTA + (2 if i == 1 else 3), 1)
    enc.encode_bin(ctx, cc.MB_QP_DELTA + (2 if k == 1 else 3), 0)


def _dec_qp_delta(dec, ctx, prev_delta: int) -> int:
    ctx0 = cc.MB_QP_DELTA + (1 if prev_delta else 0)
    if not dec.decode_bin(ctx, ctx0):
        return 0
    k = 1
    while dec.decode_bin(ctx, cc.MB_QP_DELTA + (2 if k == 1 else 3)):
        k += 1
        if k > 52:
            raise ValueError("corrupt mb_qp_delta")
    return (k + 1) >> 1 if k & 1 else -(k >> 1)


def write_pslice_cabac(mv, luma_levels, cdc_levels, cac_levels,
                       qp: int, cabac_init_idc: int = 0,
                       stats=None, qp_map=None) -> bytes:
    """P-slice slice_data as CABAC RBSP payload (caller handles the slice
    header and the cabac_alignment_one_bit padding before it).

    qp_map: optional (R, C) per-MB luma QP (adaptive quantization); deltas
    vs the running QP (starting at `qp`) are coded as mb_qp_delta on every
    cbp != 0 MB, the CAVLC twin's policy (slice_coder.write_pslice_mbs)."""
    R, C = mv.shape[:2]
    ctx = cc.ContextModels(qp, cabac_init_idc, slice_type="P")
    enc = CabacEncoder()
    enc.stats = stats
    st = _CbfState(R, C)
    mv_map: dict = {}
    mvd_map: dict = {}
    skip_map = np.zeros((R, C), bool)
    cbp_map = np.full((R, C), -1, np.int32)  # -1 = unavailable/skip(0)
    cur_qp = qp
    prev_delta = 0

    for r in range(R):
        for c in range(C):
            this_mv = (int(mv[r, c, 0]), int(mv[r, c, 1]))
            cbp_luma, cbp_chroma = _mb_cbp(
                luma_levels[r, c], cdc_levels[r, c], cac_levels[r, c])
            cbp = cbp_luma | (cbp_chroma << 4)
            can_skip = (cbp == 0
                        and this_mv == mv_pred.skip_mv(mv_map, r, c, C))
            inc = ((1 if c > 0 and not skip_map[r, c - 1] else 0)
                   + (1 if r > 0 and not skip_map[r - 1, c] else 0))
            enc.encode_bin(ctx, cc.MB_SKIP_P + inc, 1 if can_skip else 0)
            mv_map[(r, c)] = this_mv
            skip_map[r, c] = can_skip
            last_mb = r == R - 1 and c == C - 1
            if can_skip:
                mvd_map[(r, c)] = (0, 0)
                st.luma[r * 4 : r * 4 + 4, c * 4 : c * 4 + 4] = 0
                st.chroma[:, r * 2 : r * 2 + 2, c * 2 : c * 2 + 2] = 0
                st.chroma_dc[:, r, c] = 0
                cbp_map[r, c] = 0
                prev_delta = 0  # skip MBs carry an inferred delta of 0
                enc.encode_terminate(1 if last_mb else 0)  # end_of_slice_flag
                continue
            # mb_type P_L0_16x16: bins 0,0,0 (ctx 14, 15, 16)
            enc.encode_bin(ctx, cc.MB_TYPE_P, 0)
            enc.encode_bin(ctx, cc.MB_TYPE_P + 1, 0)
            enc.encode_bin(ctx, cc.MB_TYPE_P + 2, 0)
            px, py = mv_pred.predict_mv(mv_map, r, c, C)
            mvd = (this_mv[0] - px, this_mv[1] - py)
            ea = abs(mvd_map.get((r, c - 1), (0, 0))[0]) + abs(
                mvd_map.get((r - 1, c), (0, 0))[0])
            eb = abs(mvd_map.get((r, c - 1), (0, 0))[1]) + abs(
                mvd_map.get((r - 1, c), (0, 0))[1])
            _enc_mvd(enc, ctx, mvd[0], cc.MVD_X, ea)
            _enc_mvd(enc, ctx, mvd[1], cc.MVD_Y, eb)
            mvd_map[(r, c)] = mvd
            cbp_l_a = int(cbp_map[r, c - 1]) & 15 if c > 0 and cbp_map[r, c - 1] >= 0 else (0 if c > 0 else None)
            cbp_l_b = int(cbp_map[r - 1, c]) & 15 if r > 0 and cbp_map[r - 1, c] >= 0 else (0 if r > 0 else None)
            cbp_c_a = (int(cbp_map[r, c - 1]) >> 4) if c > 0 and cbp_map[r, c - 1] >= 0 else (0 if c > 0 else None)
            cbp_c_b = (int(cbp_map[r - 1, c]) >> 4) if r > 0 and cbp_map[r - 1, c] >= 0 else (0 if r > 0 else None)
            _enc_cbp(enc, ctx, cbp_luma, cbp_chroma, cbp_l_a, cbp_l_b,
                     cbp_c_a, cbp_c_b)
            cbp_map[r, c] = cbp
            if cbp:
                if qp_map is None:
                    _enc_qp_delta(enc, ctx, 0, prev_delta)
                    prev_delta = 0
                else:
                    want = int(qp_map[r, c])
                    delta = want - cur_qp
                    if delta > 25:
                        delta -= 52  # mod-52 wrap (spec 7.4.5)
                    elif delta < -26:
                        delta += 52
                    _enc_qp_delta(enc, ctx, delta, prev_delta)
                    prev_delta = delta
                    cur_qp = want
            else:
                prev_delta = 0
            for g8 in range(4):
                blks = [int(ZSCAN_TO_RASTER[g8 * 4 + k]) for k in range(4)]
                if not (cbp_luma >> g8) & 1:
                    for b in blks:
                        st.luma[r * 4 + b // 4, c * 4 + b % 4] = 0
                    continue
                for b in blks:
                    by, bx = r * 4 + b // 4, c * 4 + b % 4
                    cbf = _enc_block(enc, ctx, 2,
                                     luma_levels[r, c, b].tolist(),
                                     st.inc_luma(by, bx))
                    st.luma[by, bx] = cbf
            _chroma_blocks(enc, ctx, st, r, c, cbp_chroma,
                           cdc_levels[r, c], cac_levels[r, c], write=True)
            enc.encode_terminate(1 if last_mb else 0)
    return enc.get_bytes()


def parse_pslice_cabac(data: bytes, bitpos: int, R: int, C: int, qp: int,
                       cabac_init_idc: int = 0):
    """Inverse of write_pslice_cabac. Returns dict of symbol arrays."""
    ctx = cc.ContextModels(qp, cabac_init_idc, slice_type="P")
    dec = CabacDecoder(data, bitpos)
    st = _CbfState(R, C)
    mv = np.zeros((R, C, 2), np.int32)
    luma = np.zeros((R, C, 16, 16), np.int32)
    cdc = np.zeros((R, C, 2, 4), np.int32)
    cac = np.zeros((R, C, 2, 4, 15), np.int32)
    mv_map: dict = {}
    mvd_map: dict = {}
    skip_map = np.zeros((R, C), bool)
    cbp_map = np.full((R, C), -1, np.int32)
    qp_map = np.full((R, C), qp, np.int32)
    cur_qp = qp
    prev_delta = 0

    for r in range(R):
        for c in range(C):
            inc = ((1 if c > 0 and not skip_map[r, c - 1] else 0)
                   + (1 if r > 0 and not skip_map[r - 1, c] else 0))
            is_skip = dec.decode_bin(ctx, cc.MB_SKIP_P + inc)
            if is_skip:
                smv = mv_pred.skip_mv(mv_map, r, c, C)
                mv[r, c] = smv
                mv_map[(r, c)] = smv
                mvd_map[(r, c)] = (0, 0)
                skip_map[r, c] = True
                cbp_map[r, c] = 0
                qp_map[r, c] = cur_qp
                prev_delta = 0
                if dec.decode_terminate():
                    return _psymbols(mv, luma, cdc, cac, r * C + c + 1,
                                     qp_map)
                continue
            b0 = dec.decode_bin(ctx, cc.MB_TYPE_P)
            if b0:
                raise ValueError("unsupported P mb_type (intra in P)")
            dec.decode_bin(ctx, cc.MB_TYPE_P + 1)
            dec.decode_bin(ctx, cc.MB_TYPE_P + 2)
            ea = abs(mvd_map.get((r, c - 1), (0, 0))[0]) + abs(
                mvd_map.get((r - 1, c), (0, 0))[0])
            eb = abs(mvd_map.get((r, c - 1), (0, 0))[1]) + abs(
                mvd_map.get((r - 1, c), (0, 0))[1])
            mvdx = _dec_mvd(dec, ctx, cc.MVD_X, ea)
            mvdy = _dec_mvd(dec, ctx, cc.MVD_Y, eb)
            px, py = mv_pred.predict_mv(mv_map, r, c, C)
            this_mv = (px + mvdx, py + mvdy)
            mv[r, c] = this_mv
            mv_map[(r, c)] = this_mv
            mvd_map[(r, c)] = (mvdx, mvdy)
            cbp_l_a = int(cbp_map[r, c - 1]) & 15 if c > 0 and cbp_map[r, c - 1] >= 0 else (0 if c > 0 else None)
            cbp_l_b = int(cbp_map[r - 1, c]) & 15 if r > 0 and cbp_map[r - 1, c] >= 0 else (0 if r > 0 else None)
            cbp_c_a = (int(cbp_map[r, c - 1]) >> 4) if c > 0 and cbp_map[r, c - 1] >= 0 else (0 if c > 0 else None)
            cbp_c_b = (int(cbp_map[r - 1, c]) >> 4) if r > 0 and cbp_map[r - 1, c] >= 0 else (0 if r > 0 else None)
            cbp_luma, cbp_chroma = _dec_cbp(dec, ctx, cbp_l_a, cbp_l_b,
                                            cbp_c_a, cbp_c_b)
            cbp_map[r, c] = cbp_luma | (cbp_chroma << 4)
            if cbp_luma or cbp_chroma:
                delta = _dec_qp_delta(dec, ctx, prev_delta)
                prev_delta = delta
                cur_qp += delta
                # spec 7.4.5: QPy wraps mod 52 into [0, 51]
                if cur_qp < 0:
                    cur_qp += 52
                elif cur_qp > 51:
                    cur_qp -= 52
            else:
                prev_delta = 0
            qp_map[r, c] = cur_qp
            for g8 in range(4):
                blks = [int(ZSCAN_TO_RASTER[g8 * 4 + k]) for k in range(4)]
                if not (cbp_luma >> g8) & 1:
                    for b in blks:
                        st.luma[r * 4 + b // 4, c * 4 + b % 4] = 0
                    continue
                for b in blks:
                    by, bx = r * 4 + b // 4, c * 4 + b % 4
                    levels, cbf = _dec_block(dec, ctx, 2, st.inc_luma(by, bx))
                    luma[r, c, b] = levels
                    st.luma[by, bx] = cbf
            _chroma_blocks(dec, ctx, st, r, c, cbp_chroma,
                           cdc[r, c], cac[r, c], write=False)
            if dec.decode_terminate():
                return _psymbols(mv, luma, cdc, cac, r * C + c + 1, qp_map)
    return _psymbols(mv, luma, cdc, cac, R * C, qp_map)


def _psymbols(mv, luma, cdc, cac, covered=None, qp_map=None):
    return {"mv": mv, "luma_levels": luma, "cdc_levels": cdc,
            "cac_levels": cac, "covered": covered, "qp_map": qp_map}


# ------------------------------------------------------------------ I slices


def _i16_mb_type_bins(enc, ctx, cbp_luma, cbp_chroma, mode, avail_inc):
    """I slice mb_type for I_16x16 (Table 9-36 shape): '1' + I_PCM-terminate
    0 + cbp_luma flag + chroma cbp (1-2 bins) + 2 pred-mode bins."""
    enc.encode_bin(ctx, cc.MB_TYPE_I + avail_inc, 1)  # not I_NxN
    enc.encode_terminate(0)  # not I_PCM (ctx 276: terminate bin)
    enc.encode_bin(ctx, cc.MB_TYPE_I + 3, 1 if cbp_luma else 0)
    enc.encode_bin(ctx, cc.MB_TYPE_I + 4, 1 if cbp_chroma else 0)
    if cbp_chroma:
        enc.encode_bin(ctx, cc.MB_TYPE_I + 5, 1 if cbp_chroma == 2 else 0)
    enc.encode_bin(ctx, cc.MB_TYPE_I + 6, (mode >> 1) & 1)
    enc.encode_bin(ctx, cc.MB_TYPE_I + 7, mode & 1)


def _i16_mb_type_parse(dec, ctx, avail_inc):
    if dec.decode_terminate():
        raise ValueError("I_PCM unsupported")
    cbp_luma = 15 if dec.decode_bin(ctx, cc.MB_TYPE_I + 3) else 0
    cbp_chroma = 0
    if dec.decode_bin(ctx, cc.MB_TYPE_I + 4):
        cbp_chroma = 2 if dec.decode_bin(ctx, cc.MB_TYPE_I + 5) else 1
    mode = dec.decode_bin(ctx, cc.MB_TYPE_I + 6) << 1
    mode |= dec.decode_bin(ctx, cc.MB_TYPE_I + 7)
    return cbp_luma, cbp_chroma, mode


def _i4_pred_mode(mode_grid, gy, gx):
    """predIntra4x4PredMode (spec 8.3.1.1) — shared rule with the CAVLC
    coder (pipeline/slice_coder._i4_pred_mode): an unavailable neighbor
    forces DC outright (dcPredModePredictedFlag); a non-I4x4 neighbor is
    DC-substituted inside the min."""
    if gx <= 0 or gy <= 0:
        return 2
    a = int(mode_grid[gy, gx - 1])
    b = int(mode_grid[gy - 1, gx])
    a = 2 if a < 0 else a
    b = 2 if b < 0 else b
    return min(a, b)


def write_islice_cabac(mode16, chroma_mode, dc_levels, ac_levels,
                       cdc_levels, cac_levels, qp: int,
                       stats=None, is_i4=None, modes4=None,
                       luma4_levels=None) -> bytes:
    """I-slice slice_data (I_16x16 + optional I_4x4 MBs) as CABAC RBSP
    payload. modes4: (R, C, 16) z-scan 4x4 modes; luma4_levels:
    (R, C, 16, 16) zig-zag per raster block (the CAVLC twin's layout)."""
    R, C = mode16.shape
    ctx = cc.ContextModels(qp, slice_type="I")
    enc = CabacEncoder()
    enc.stats = stats
    st = _CbfState(R, C)
    st.intra = True  # I slice: edge condTermFlag = 1 (9.3.3.1.1.9)
    cm_map = np.zeros((R, C), np.int32)
    i4_map = np.zeros((R, C), bool)
    cbp_map = np.zeros((R, C), np.int32)
    mode_grid = np.full((R * 4, C * 4), -1, np.int32)

    for r in range(R):
        for c in range(C):
            # mb_type bin 0 ctxIdxInc: condTermFlagN = avail && !I_NxN
            avail_inc = ((1 if c > 0 and not i4_map[r, c - 1] else 0)
                         + (1 if r > 0 and not i4_map[r - 1, c] else 0))
            mb_i4 = is_i4 is not None and bool(is_i4[r, c])
            if mb_i4:
                i4_map[r, c] = True
                enc.encode_bin(ctx, cc.MB_TYPE_I + avail_inc, 0)  # I_NxN
                for zi in range(16):
                    bi = int(ZSCAN_TO_RASTER[zi])
                    gy, gx = r * 4 + bi // 4, c * 4 + bi % 4
                    pred = _i4_pred_mode(mode_grid, gy, gx)
                    m = int(modes4[r, c, zi])
                    if m == pred:
                        enc.encode_bin(ctx, cc.I4_PRED_FLAG, 1)
                    else:
                        enc.encode_bin(ctx, cc.I4_PRED_FLAG, 0)
                        rem = m - 1 if m > pred else m
                        for k in range(3):  # rem: 3 FL bins, ctx 69
                            enc.encode_bin(ctx, cc.I4_PRED_REM,
                                           (rem >> k) & 1)
                    mode_grid[gy, gx] = m
                cm = int(chroma_mode[r, c])
                inc = ((1 if c > 0 and cm_map[r, c - 1] else 0)
                       + (1 if r > 0 and cm_map[r - 1, c] else 0))
                _enc_tu(enc, ctx, cm, 3,
                        lambda k, inc=inc: cc.CHROMA_PRED
                        + (inc if k == 0 else 3))
                cm_map[r, c] = cm
                lv4 = luma4_levels[r, c]
                cbp_luma = 0
                for g8 in range(4):
                    blks = [int(ZSCAN_TO_RASTER[g8 * 4 + k]) for k in range(4)]
                    if any(np.any(lv4[b]) for b in blks):
                        cbp_luma |= 1 << g8
                if np.any(cac_levels[r, c]):
                    cbp_chroma = 2
                elif np.any(cdc_levels[r, c]):
                    cbp_chroma = 1
                else:
                    cbp_chroma = 0
                cbp_l_a = int(cbp_map[r, c - 1]) & 15 if c > 0 else None
                cbp_l_b = int(cbp_map[r - 1, c]) & 15 if r > 0 else None
                cbp_c_a = int(cbp_map[r, c - 1]) >> 4 if c > 0 else None
                cbp_c_b = int(cbp_map[r - 1, c]) >> 4 if r > 0 else None
                _enc_cbp(enc, ctx, cbp_luma, cbp_chroma, cbp_l_a, cbp_l_b,
                         cbp_c_a, cbp_c_b)
                cbp_map[r, c] = cbp_luma | (cbp_chroma << 4)
                if cbp_luma or cbp_chroma:
                    enc.encode_bin(ctx, cc.MB_QP_DELTA, 0)
                st.luma_dc[r, c] = 0
                for g8 in range(4):
                    blks = [int(ZSCAN_TO_RASTER[g8 * 4 + k]) for k in range(4)]
                    if not (cbp_luma >> g8) & 1:
                        for b in blks:
                            st.luma[r * 4 + b // 4, c * 4 + b % 4] = 0
                        continue
                    for b in blks:
                        by, bx = r * 4 + b // 4, c * 4 + b % 4
                        cbf = _enc_block(enc, ctx, 2, lv4[b].tolist(),
                                         st.inc_luma(by, bx))
                        st.luma[by, bx] = cbf
                _chroma_blocks(enc, ctx, st, r, c, cbp_chroma,
                               cdc_levels[r, c], cac_levels[r, c], write=True)
                enc.encode_terminate(
                    1 if (r == R - 1 and c == C - 1) else 0)
                continue
            cbp_luma = 15 if np.any(ac_levels[r, c]) else 0
            if np.any(cac_levels[r, c]):
                cbp_chroma = 2
            elif np.any(cdc_levels[r, c]):
                cbp_chroma = 1
            else:
                cbp_chroma = 0
            _i16_mb_type_bins(enc, ctx, cbp_luma, cbp_chroma,
                              int(mode16[r, c]), avail_inc)
            cbp_map[r, c] = cbp_luma | (cbp_chroma << 4)
            cm = int(chroma_mode[r, c])
            inc = ((1 if c > 0 and cm_map[r, c - 1] else 0)
                   + (1 if r > 0 and cm_map[r - 1, c] else 0))
            _enc_tu(enc, ctx, cm, 3,
                    lambda k, inc=inc: cc.CHROMA_PRED + (inc if k == 0 else 3))
            cm_map[r, c] = cm
            # mb_qp_delta: always present for I_16x16; we emit 0.
            enc.encode_bin(ctx, cc.MB_QP_DELTA, 0)
            # Luma DC (cat 0)
            cbf = _enc_block(enc, ctx, 0, dc_levels[r, c].tolist(),
                             st.inc_luma_dc(r, c))
            st.luma_dc[r, c] = cbf
            # Luma AC (cat 1) if cbp_luma
            for b in (int(z) for z in ZSCAN_TO_RASTER):
                by, bx = r * 4 + b // 4, c * 4 + b % 4
                if cbp_luma:
                    cbf = _enc_block(enc, ctx, 1, ac_levels[r, c, b].tolist(),
                                     st.inc_luma(by, bx))
                    st.luma[by, bx] = cbf
                else:
                    st.luma[by, bx] = 0
            _chroma_blocks(enc, ctx, st, r, c, cbp_chroma,
                           cdc_levels[r, c], cac_levels[r, c], write=True)
            enc.encode_terminate(1 if (r == R - 1 and c == C - 1) else 0)
    return enc.get_bytes()


def parse_islice_cabac(data: bytes, bitpos: int, R: int, C: int, qp: int):
    ctx = cc.ContextModels(qp, slice_type="I")
    dec = CabacDecoder(data, bitpos)
    st = _CbfState(R, C)
    st.intra = True  # I slice: edge condTermFlag = 1 (9.3.3.1.1.9)
    mode16 = np.zeros((R, C), np.int32)
    chroma_mode = np.zeros((R, C), np.int32)
    dc = np.zeros((R, C, 16), np.int32)
    ac = np.zeros((R, C, 16, 15), np.int32)
    cdc = np.zeros((R, C, 2, 4), np.int32)
    cac = np.zeros((R, C, 2, 4, 15), np.int32)
    cm_map = np.zeros((R, C), np.int32)
    is_i4 = np.zeros((R, C), bool)
    modes4 = np.zeros((R, C, 16), np.int32)
    luma4 = np.zeros((R, C, 16, 16), np.int32)
    cbp_map = np.zeros((R, C), np.int32)
    mode_grid = np.full((R * 4, C * 4), -1, np.int32)

    for r in range(R):
        for c in range(C):
            avail_inc = ((1 if c > 0 and not is_i4[r, c - 1] else 0)
                         + (1 if r > 0 and not is_i4[r - 1, c] else 0))
            if not dec.decode_bin(ctx, cc.MB_TYPE_I + avail_inc):
                # I_NxN (I_4x4: no 8x8 transform flag in this profile set)
                is_i4[r, c] = True
                for zi in range(16):
                    bi = int(ZSCAN_TO_RASTER[zi])
                    gy, gx = r * 4 + bi // 4, c * 4 + bi % 4
                    pred = _i4_pred_mode(mode_grid, gy, gx)
                    if dec.decode_bin(ctx, cc.I4_PRED_FLAG):
                        m = pred
                    else:
                        rem = 0
                        for k in range(3):
                            rem |= dec.decode_bin(ctx, cc.I4_PRED_REM) << k
                        m = rem if rem < pred else rem + 1
                    modes4[r, c, zi] = m
                    mode_grid[gy, gx] = m
                inc = ((1 if c > 0 and cm_map[r, c - 1] else 0)
                       + (1 if r > 0 and cm_map[r - 1, c] else 0))
                cm = _dec_tu(dec, ctx, 3,
                             lambda k, inc=inc: cc.CHROMA_PRED
                             + (inc if k == 0 else 3))
                chroma_mode[r, c] = cm
                cm_map[r, c] = cm
                cbp_l_a = int(cbp_map[r, c - 1]) & 15 if c > 0 else None
                cbp_l_b = int(cbp_map[r - 1, c]) & 15 if r > 0 else None
                cbp_c_a = int(cbp_map[r, c - 1]) >> 4 if c > 0 else None
                cbp_c_b = int(cbp_map[r - 1, c]) >> 4 if r > 0 else None
                cbp_luma, cbp_chroma = _dec_cbp(dec, ctx, cbp_l_a, cbp_l_b,
                                                cbp_c_a, cbp_c_b)
                cbp_map[r, c] = cbp_luma | (cbp_chroma << 4)
                if (cbp_luma or cbp_chroma) and dec.decode_bin(
                        ctx, cc.MB_QP_DELTA):
                    raise ValueError("mb_qp_delta != 0 unsupported")
                st.luma_dc[r, c] = 0
                for g8 in range(4):
                    blks = [int(ZSCAN_TO_RASTER[g8 * 4 + k])
                            for k in range(4)]
                    if not (cbp_luma >> g8) & 1:
                        for b in blks:
                            st.luma[r * 4 + b // 4, c * 4 + b % 4] = 0
                        continue
                    for b in blks:
                        by, bx = r * 4 + b // 4, c * 4 + b % 4
                        levels, cbf = _dec_block(dec, ctx, 2,
                                                 st.inc_luma(by, bx))
                        luma4[r, c, b] = levels
                        st.luma[by, bx] = cbf
                _chroma_blocks(dec, ctx, st, r, c, cbp_chroma,
                               cdc[r, c], cac[r, c], write=False)
                if dec.decode_terminate():
                    covered = r * C + c + 1
                    break
                continue
            cbp_luma, cbp_chroma, mode = _i16_mb_type_parse(dec, ctx, avail_inc)
            cbp_map[r, c] = cbp_luma | (cbp_chroma << 4)
            mode16[r, c] = mode
            inc = ((1 if c > 0 and cm_map[r, c - 1] else 0)
                   + (1 if r > 0 and cm_map[r - 1, c] else 0))
            cm = _dec_tu(dec, ctx, 3,
                         lambda k, inc=inc: cc.CHROMA_PRED + (inc if k == 0 else 3))
            chroma_mode[r, c] = cm
            cm_map[r, c] = cm
            if dec.decode_bin(ctx, cc.MB_QP_DELTA):
                raise ValueError("mb_qp_delta != 0 unsupported")
            levels, cbf = _dec_block(dec, ctx, 0, st.inc_luma_dc(r, c))
            dc[r, c] = levels
            st.luma_dc[r, c] = cbf
            for b in (int(z) for z in ZSCAN_TO_RASTER):
                by, bx = r * 4 + b // 4, c * 4 + b % 4
                if cbp_luma:
                    levels, cbf = _dec_block(dec, ctx, 1, st.inc_luma(by, bx))
                    ac[r, c, b] = levels
                    st.luma[by, bx] = cbf
                else:
                    st.luma[by, bx] = 0
            _chroma_blocks(dec, ctx, st, r, c, cbp_chroma,
                           cdc[r, c], cac[r, c], write=False)
            if dec.decode_terminate():
                covered = r * C + c + 1
                break
        else:
            continue
        break
    else:
        covered = R * C
    return {"mode16": mode16, "chroma_mode": chroma_mode, "dc_levels": dc,
            "ac_levels": ac, "cdc_levels": cdc, "cac_levels": cac,
            "is_i4": is_i4, "modes4": modes4, "luma4_levels": luma4,
            "covered": covered}
