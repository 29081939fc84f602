"""Host CAVLC slice layer: per-MB symbol arrays <-> slice RBSP bits.

Copies of the I_16x16 I-slice and the P-slice writers of
media_tpu/pipeline/slice_coder.py and of its I-slice parser. The I-slice
writer serves the IDR; the P-slice writer serves the overflow fallback of
the on-device packer; the parser serves the decoder
(pipeline/decoder_tpu.py). Tests hold all three to the originals.
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


def write_islice_mbs(bw: BitWriter, *, mode16: np.ndarray,
                     chroma_mode: np.ndarray, dc_levels: np.ndarray,
                     ac_levels: np.ndarray, cdc_levels: np.ndarray,
                     cac_levels: np.ndarray) -> None:
    """Write all I_16x16 macroblocks of an I slice."""
    n_rows, n_cols = mode16.shape
    st = _MbGridCoder(n_rows, n_cols)
    for r in range(n_rows):
        for c in range(n_cols):
            cbp_luma = 15 if np.any(ac_levels[r, c]) else 0
            cbp_chroma = _cbp_chroma(cdc_levels[r, c], cac_levels[r, c])
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
    covered: int = 0  # macroblocks parsed (== n_rows*n_cols unless partial)


def parse_islice_mbs(br: BitReader, n_rows: int, n_cols: int, qp: int,
                     partial: bool = False) -> ParsedISlice:
    """Parse the I_16x16 MBs of an I slice written by write_islice_mbs. With
    partial, stop at the RBSP end (one slice of a multi-slice picture parsed
    into a slice-local array); `covered` reports the parsed MB count. An
    I_4x4 macroblock raises UnsupportedStream."""
    st = _MbGridCoder(n_rows, n_cols)
    mode16 = np.zeros((n_rows, n_cols), np.int32)
    chroma_mode = np.zeros((n_rows, n_cols), np.int32)
    dc_levels = np.zeros((n_rows, n_cols, 16), np.int32)
    ac_levels = np.zeros((n_rows, n_cols, 16, 15), np.int32)
    cdc_levels = np.zeros((n_rows, n_cols, 2, 4), np.int32)
    cac_levels = np.zeros((n_rows, n_cols, 2, 4, 15), np.int32)

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
            if mb_type == 0:
                raise UnsupportedStream(
                    "I_4x4 macroblock: media_tpu_torch does not port I_4x4 "
                    "reconstruction yet (ROADMAP queue 1, item 10)")
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
            # Chroma
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

    return ParsedISlice(mode16=mode16, chroma_mode=chroma_mode,
                        dc_levels=dc_levels, ac_levels=ac_levels,
                        cdc_levels=cdc_levels, cac_levels=cac_levels, qp=qp,
                        covered=covered)


def write_pslice_mbs(bw: BitWriter, *, mv: np.ndarray,
                     luma_levels: np.ndarray, cdc_levels: np.ndarray,
                     cac_levels: np.ndarray) -> dict:
    """Write all macroblocks of a P slice (P_L0_16x16 / P_Skip) at the slice
    QP. mv: (R, C, 2) quarter-pel luma MVs; luma_levels: (R, C, 16, 16)
    zig-zag. Returns {"n_skip": ...}."""
    n_rows, n_cols = mv.shape[:2]
    st = _MbGridCoder(n_rows, n_cols)
    mv_map: dict = {}
    skip_run = 0
    n_skip = 0
    for r in range(n_rows):
        for c in range(n_cols):
            this_mv = (int(mv[r, c, 0]), int(mv[r, c, 1]))  # quarter-pel
            # CBP from quantized levels: luma bit per 8x8 group (z-scan).
            cbp_luma = 0
            for g8 in range(4):
                blks = [ZSCAN_TO_RASTER[g8 * 4 + k] for k in range(4)]
                if any(np.any(luma_levels[r, c, b]) for b in blks):
                    cbp_luma |= 1 << g8
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
            if cbp:
                bw.se(0)  # mb_qp_delta (fixed-QP slice)
            for g8 in range(4):
                blks = [int(ZSCAN_TO_RASTER[g8 * 4 + k]) for k in range(4)]
                if not (cbp_luma >> g8) & 1:
                    for b in blks:
                        st.luma_nnz[r * 4 + b // 4, c * 4 + b % 4] = 0
                    continue
                for b in blks:
                    by, bx = r * 4 + b // 4, c * 4 + b % 4
                    st.luma_nnz[by, bx] = cavlc.encode_block(
                        bw, luma_levels[r, c, b].tolist(),
                        _nc(st.luma_nnz, by, bx))
            _write_chroma_residual(bw, st, r, c, cdc_levels[r, c],
                                   cac_levels[r, c], cbp_chroma)
    if skip_run:
        bw.ue(skip_run)
    return {"n_skip": n_skip}
