"""Host CAVLC slice layer: per-MB symbol arrays <-> slice RBSP bits.

Copies of the I-slice (I_16x16 and I_4x4), P-slice and B-slice writers of
media_tpu/pipeline/slice_coder.py and of its I-slice parser. The I-slice
writer serves the IDR (an IDR with I_4x4 macroblocks always, the C++ writer
codes I_16x16 only); the P-slice writer serves the overflow fallback of the
on-device packer; the B-slice writer serves the B-GOP; the parser serves the
decoder (pipeline/decoder_tpu.py). Tests hold all of them to the originals.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..core.bitstream import BitReader, BitWriter
from ..entropy import cavlc
from ..entropy import cavlc_tables as tables
from . import mv_pred
from .encoder import ZSCAN_TO_RASTER


def _nc(nnz: np.ndarray, by: int, bx: int) -> int:
    """nC for the 4x4 block at block coords (by, bx) (spec 9.2.1)."""
    avail_a = bx > 0
    avail_b = by > 0
    if avail_a and avail_b:
        return (int(nnz[by, bx - 1]) + int(nnz[by - 1, bx]) + 1) >> 1
    if avail_a:
        return int(nnz[by, bx - 1])
    if avail_b:
        return int(nnz[by - 1, bx])
    return 0


class UnsupportedStream(Exception):
    """Feature outside the decode path's envelope."""


class _MbGridCoder:
    """nC bookkeeping for an encode or decode walk."""

    def __init__(self, n_rows: int, n_cols: int):
        self.luma_nnz = np.zeros((n_rows * 4, n_cols * 4), dtype=np.int32)
        self.chroma_nnz = np.zeros((2, n_rows * 2, n_cols * 2), dtype=np.int32)


def _cbp_chroma(cdc, cac) -> int:
    if np.any(cac):
        return 2
    if np.any(cdc):
        return 1
    return 0


def _i4_pred_mode(mode_grid, gy, gx):
    """predIntra4x4PredMode (spec 8.3.1.1).

    dcPredModePredictedFlag: if either neighbour block is unavailable
    (outside the picture or slice) the prediction is DC outright; only an
    available neighbour coded outside I_4x4 is substituted with DC inside
    the min."""
    if gx <= 0 or gy <= 0:
        return 2
    a = int(mode_grid[gy, gx - 1])
    b = int(mode_grid[gy - 1, gx])
    a = 2 if a < 0 else a
    b = 2 if b < 0 else b
    return min(a, b)


def _cbp_luma(luma_rc) -> int:
    """Luma coded_block_pattern of one MB's (16, 16) levels in raster block
    order: one bit per 8x8 group, in z-scan order."""
    cbp = 0
    for g8 in range(4):
        blks = [int(ZSCAN_TO_RASTER[g8 * 4 + k]) for k in range(4)]
        if any(np.any(luma_rc[b]) for b in blks):
            cbp |= 1 << g8
    return cbp


def _write_luma_4x4(bw, st, r, c, luma_rc, cbp_luma) -> None:
    """The 16-coefficient luma blocks of the coded 8x8 groups of one MB, in
    z-scan order."""
    for g8 in range(4):
        blks = [int(ZSCAN_TO_RASTER[g8 * 4 + k]) for k in range(4)]
        if not (cbp_luma >> g8) & 1:
            for b in blks:
                st.luma_nnz[r * 4 + b // 4, c * 4 + b % 4] = 0
            continue
        for b in blks:
            by, bx = r * 4 + b // 4, c * 4 + b % 4
            st.luma_nnz[by, bx] = cavlc.encode_block(
                bw, luma_rc[b].tolist(), _nc(st.luma_nnz, by, bx))


def write_islice_mbs(bw: BitWriter, *, mode16: np.ndarray,
                     chroma_mode: np.ndarray, dc_levels: np.ndarray,
                     ac_levels: np.ndarray, cdc_levels: np.ndarray,
                     cac_levels: np.ndarray,
                     is_i4: np.ndarray | None = None,
                     modes4: np.ndarray | None = None,
                     luma4_levels: np.ndarray | None = None) -> None:
    """Write all macroblocks of an I slice (I_16x16, and I_4x4 where the
    per-MB decision arrays say so: modes4 (R, C, 16) in z-scan order,
    luma4_levels (R, C, 16, 16) zig-zag per raster 4x4 block)."""
    n_rows, n_cols = mode16.shape
    st = _MbGridCoder(n_rows, n_cols)
    # 4x4 prediction-mode grid; -1 marks an MB that is not I_4x4 (taken as
    # DC by the most-probable-mode rule).
    mode_grid = np.full((n_rows * 4, n_cols * 4), -1, np.int32)
    for r in range(n_rows):
        for c in range(n_cols):
            cbp_chroma = _cbp_chroma(cdc_levels[r, c], cac_levels[r, c])
            if is_i4 is not None and is_i4[r, c]:
                bw.ue(0)  # mb_type = I_4x4
                for zi in range(16):
                    bi = int(ZSCAN_TO_RASTER[zi])
                    gy, gx = r * 4 + bi // 4, c * 4 + bi % 4
                    pred = _i4_pred_mode(mode_grid, gy, gx)
                    m = int(modes4[r, c, zi])
                    if m == pred:
                        bw.u(1, 1)  # prev_intra4x4_pred_mode_flag
                    else:
                        bw.u(1, 0)
                        bw.u(3, m - 1 if m > pred else m)
                    mode_grid[gy, gx] = m
                bw.ue(int(chroma_mode[r, c]))
                cbp_luma = _cbp_luma(luma4_levels[r, c])
                cbp = cbp_luma | (cbp_chroma << 4)
                bw.ue(int(tables.CBP_TO_CODE_INTRA[cbp]))
                if cbp:
                    bw.se(0)  # mb_qp_delta
                _write_luma_4x4(bw, st, r, c, luma4_levels[r, c], cbp_luma)
                _write_chroma_residual(bw, st, r, c, cdc_levels[r, c],
                                       cac_levels[r, c], cbp_chroma)
                continue
            cbp_luma = 15 if np.any(ac_levels[r, c]) else 0
            bw.ue(1 + int(mode16[r, c]) + 4 * cbp_chroma
                  + 12 * (1 if cbp_luma else 0))  # mb_type
            bw.ue(int(chroma_mode[r, c]))
            bw.se(0)  # mb_qp_delta (fixed-QP slice)
            _write_mb_residual_i16(bw, st, r, c, dc_levels[r, c],
                                   ac_levels[r, c], cbp_luma, cdc_levels[r, c],
                                   cac_levels[r, c], cbp_chroma)


def _write_mb_residual_i16(bw, st, r, c, dc, ac, cbp_luma, cdc, cac,
                           cbp_chroma):
    # Luma DC: nC as for 4x4 block 0.
    cavlc.encode_block(bw, dc.tolist(), _nc(st.luma_nnz, r * 4, c * 4))
    if cbp_luma:
        for zi in range(16):
            bi = int(ZSCAN_TO_RASTER[zi])
            by, bx = r * 4 + bi // 4, c * 4 + bi % 4
            # Record immediately: later blocks in this MB see earlier ones.
            st.luma_nnz[by, bx] = cavlc.encode_block(
                bw, ac[bi].tolist(), _nc(st.luma_nnz, by, bx))
    else:
        st.luma_nnz[r * 4 : r * 4 + 4, c * 4 : c * 4 + 4] = 0
    _write_chroma_residual(bw, st, r, c, cdc, cac, cbp_chroma)


def _write_chroma_residual(bw, st, r, c, cdc, cac, cbp_chroma):
    if cbp_chroma:
        for comp in range(2):
            cavlc.encode_block(bw, cdc[comp].tolist(), -1)
    if cbp_chroma == 2:
        for comp in range(2):
            for bi in range(4):
                by, bx = r * 2 + bi // 2, c * 2 + bi % 2
                st.chroma_nnz[comp, by, bx] = cavlc.encode_block(
                    bw, cac[comp, bi].tolist(),
                    _nc(st.chroma_nnz[comp], by, bx))
    else:
        st.chroma_nnz[:, r * 2 : r * 2 + 2, c * 2 : c * 2 + 2] = 0


@dataclass
class ParsedISlice:
    mode16: np.ndarray
    chroma_mode: np.ndarray
    dc_levels: np.ndarray
    ac_levels: np.ndarray
    cdc_levels: np.ndarray
    cac_levels: np.ndarray
    qp: int
    is_i4: np.ndarray | None = None
    modes4: np.ndarray | None = None
    luma4_levels: np.ndarray | None = None
    covered: int = 0  # macroblocks parsed (== n_rows*n_cols unless partial)


def parse_islice_mbs(br: BitReader, n_rows: int, n_cols: int, qp: int,
                     partial: bool = False) -> ParsedISlice:
    """Parse the MBs of an I slice written by write_islice_mbs. With
    partial, stop at the RBSP end (one slice of a multi-slice picture parsed
    into a slice-local array); `covered` reports the parsed MB count."""
    st = _MbGridCoder(n_rows, n_cols)
    mode16 = np.zeros((n_rows, n_cols), np.int32)
    chroma_mode = np.zeros((n_rows, n_cols), np.int32)
    dc_levels = np.zeros((n_rows, n_cols, 16), np.int32)
    ac_levels = np.zeros((n_rows, n_cols, 16, 15), np.int32)
    cdc_levels = np.zeros((n_rows, n_cols, 2, 4), np.int32)
    cac_levels = np.zeros((n_rows, n_cols, 2, 4, 15), np.int32)
    is_i4 = np.zeros((n_rows, n_cols), bool)
    modes4 = np.zeros((n_rows, n_cols, 16), np.int32)
    luma4_levels = np.zeros((n_rows, n_cols, 16, 16), np.int32)
    mode_grid = np.full((n_rows * 4, n_cols * 4), -1, np.int32)

    def parse_chroma(r, c, cbp_chroma):
        if cbp_chroma:
            for comp in range(2):
                coeffs, _ = cavlc.decode_block(br, -1, 4)
                cdc_levels[r, c, comp] = coeffs
        if cbp_chroma == 2:
            for comp in range(2):
                for bi in range(4):
                    by, bx = r * 2 + bi // 2, c * 2 + bi % 2
                    coeffs, tc = cavlc.decode_block(
                        br, _nc(st.chroma_nnz[comp], by, bx), 15)
                    cac_levels[r, c, comp, bi] = coeffs
                    st.chroma_nnz[comp, by, bx] = tc

    covered = 0
    done = False
    for r in range(n_rows):
        if done:
            break
        for c in range(n_cols):
            if partial and covered > 0 and not br.more_rbsp_data():
                done = True
                break
            covered += 1
            mb_type = br.ue()
            if mb_type == 0:  # I_4x4
                is_i4[r, c] = True
                for zi in range(16):
                    bi = int(ZSCAN_TO_RASTER[zi])
                    gy, gx = r * 4 + bi // 4, c * 4 + bi % 4
                    pred = _i4_pred_mode(mode_grid, gy, gx)
                    if br.u(1):
                        m = pred
                    else:
                        rem = br.u(3)
                        m = rem if rem < pred else rem + 1
                    modes4[r, c, zi] = m
                    mode_grid[gy, gx] = m
                chroma_mode[r, c] = br.ue()
                cbp = int(tables.CBP_TABLE[br.ue()][0])  # intra column
                cbp_luma, cbp_chroma = cbp & 15, cbp >> 4
                if cbp and br.se():
                    raise NotImplementedError("per-MB QP in I slices")
                for g8 in range(4):
                    blks = [int(ZSCAN_TO_RASTER[g8 * 4 + k]) for k in range(4)]
                    if not (cbp_luma >> g8) & 1:
                        for b in blks:
                            st.luma_nnz[r * 4 + b // 4, c * 4 + b % 4] = 0
                        continue
                    for b in blks:
                        by, bx = r * 4 + b // 4, c * 4 + b % 4
                        coeffs, tc = cavlc.decode_block(
                            br, _nc(st.luma_nnz, by, bx), 16)
                        luma4_levels[r, c, b] = coeffs
                        st.luma_nnz[by, bx] = tc
                parse_chroma(r, c, cbp_chroma)
                if cbp_chroma != 2:
                    st.chroma_nnz[:, r * 2 : r * 2 + 2, c * 2 : c * 2 + 2] = 0
                continue
            if not 1 <= mb_type <= 24:
                raise NotImplementedError(f"I-slice mb_type {mb_type} unsupported")
            mt = mb_type - 1
            mode16[r, c] = mt % 4
            cbp_chroma = (mt // 4) % 3
            cbp_luma = 15 if mt >= 12 else 0
            chroma_mode[r, c] = br.ue()
            if br.se():
                raise NotImplementedError("per-MB QP changes not yet supported")
            # Luma DC
            coeffs, _tc = cavlc.decode_block(
                br, _nc(st.luma_nnz, r * 4, c * 4), 16)
            dc_levels[r, c] = coeffs
            # Luma AC
            if cbp_luma:
                for zi in range(16):
                    bi = int(ZSCAN_TO_RASTER[zi])
                    by, bx = r * 4 + bi // 4, c * 4 + bi % 4
                    coeffs, tc = cavlc.decode_block(
                        br, _nc(st.luma_nnz, by, bx), 15)
                    ac_levels[r, c, bi] = coeffs
                    st.luma_nnz[by, bx] = tc
            parse_chroma(r, c, cbp_chroma)

    return ParsedISlice(mode16=mode16, chroma_mode=chroma_mode,
                        dc_levels=dc_levels, ac_levels=ac_levels,
                        cdc_levels=cdc_levels, cac_levels=cac_levels, qp=qp,
                        is_i4=is_i4, modes4=modes4,
                        luma4_levels=luma4_levels, covered=covered)


def write_pslice_mbs(bw: BitWriter, *, mv: np.ndarray,
                     luma_levels: np.ndarray, cdc_levels: np.ndarray,
                     cac_levels: np.ndarray,
                     qp_map: np.ndarray | None = None,
                     slice_qp: int | None = None) -> dict:
    """Write all macroblocks of a P slice (P_L0_16x16 / P_Skip). mv:
    (R, C, 2) quarter-pel luma MVs; luma_levels: (R, C, 16, 16) zig-zag.
    qp_map: optional (R, C) per-MB luma QP; deltas against the running QP
    (starting at slice_qp) are coded as mb_qp_delta on every MB with
    cbp != 0, and MBs without a coded delta keep the running QP. Returns
    {"n_skip": ...}."""
    cur_qp = slice_qp
    n_rows, n_cols = mv.shape[:2]
    st = _MbGridCoder(n_rows, n_cols)
    mv_map: dict = {}
    skip_run = 0
    n_skip = 0
    for r in range(n_rows):
        for c in range(n_cols):
            this_mv = (int(mv[r, c, 0]), int(mv[r, c, 1]))  # quarter-pel
            cbp_luma = _cbp_luma(luma_levels[r, c])
            cbp_chroma = _cbp_chroma(cdc_levels[r, c], cac_levels[r, c])
            cbp = cbp_luma | (cbp_chroma << 4)

            if cbp == 0 and this_mv == mv_pred.skip_mv(mv_map, r, c, n_cols):
                skip_run += 1
                n_skip += 1
                mv_map[(r, c)] = this_mv
                st.luma_nnz[r * 4 : r * 4 + 4, c * 4 : c * 4 + 4] = 0
                st.chroma_nnz[:, r * 2 : r * 2 + 2, c * 2 : c * 2 + 2] = 0
                continue

            bw.ue(skip_run)
            skip_run = 0
            bw.ue(0)  # mb_type = P_L0_16x16
            px, py = mv_pred.predict_mv(mv_map, r, c, n_cols)
            bw.se(this_mv[0] - px)
            bw.se(this_mv[1] - py)
            mv_map[(r, c)] = this_mv
            bw.ue(int(tables.CBP_TO_CODE_INTER[cbp]))
            if cbp and qp_map is None:
                bw.se(0)  # mb_qp_delta (fixed-QP slice)
            elif cbp:
                want = int(qp_map[r, c])
                delta = want - cur_qp
                # mb_qp_delta lies in [-26, +25], with a mod-52 wrap
                if delta > 25:
                    delta -= 52
                elif delta < -26:
                    delta += 52
                bw.se(delta)
                cur_qp = want
            _write_luma_4x4(bw, st, r, c, luma_levels[r, c], cbp_luma)
            _write_chroma_residual(bw, st, r, c, cdc_levels[r, c],
                                   cac_levels[r, c], cbp_chroma)
    if skip_run:
        bw.ue(skip_run)
    return {"n_skip": n_skip}


def write_bslice_mbs(bw: BitWriter, *, mv0: np.ndarray, mv1: np.ndarray,
                     luma_levels: np.ndarray, cdc_levels: np.ndarray,
                     cac_levels: np.ndarray) -> None:
    """Write all macroblocks of a B slice as B_Bi_16x16 (Table 7-14 type 3)
    with refIdx 0 in both lists (num_ref_idx_active 1/1: no ref_idx coded).

    mv0/mv1: (R, C, 2) quarter-pel MVs of list 0 / list 1. MV prediction
    runs per list with the same 8.4.1.3 rules as P (all MBs carry both
    lists with matching refIdx, so the grid reduces to the median path)."""
    n_rows, n_cols = mv0.shape[:2]
    st = _MbGridCoder(n_rows, n_cols)
    map0: dict = {}
    map1: dict = {}
    for r in range(n_rows):
        for c in range(n_cols):
            cbp_luma = _cbp_luma(luma_levels[r, c])
            cbp_chroma = _cbp_chroma(cdc_levels[r, c], cac_levels[r, c])
            cbp = cbp_luma | (cbp_chroma << 4)
            bw.ue(0)  # mb_skip_run (this encoder codes no B_Skip)
            bw.ue(3)  # mb_type = B_Bi_16x16
            for mv, mp in ((mv0, map0), (mv1, map1)):
                this = (int(mv[r, c, 0]), int(mv[r, c, 1]))
                px, py = mv_pred.predict_mv(mp, r, c, n_cols)
                bw.se(this[0] - px)
                bw.se(this[1] - py)
                mp[(r, c)] = this
            bw.ue(int(tables.CBP_TO_CODE_INTER[cbp]))
            if cbp:
                bw.se(0)  # mb_qp_delta (fixed-QP slice)
            _write_luma_4x4(bw, st, r, c, luma_levels[r, c], cbp_luma)
            _write_chroma_residual(bw, st, r, c, cdc_levels[r, c],
                                   cac_levels[r, c], cbp_chroma)
