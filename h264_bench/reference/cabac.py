"""CABAC slice data (spec 7.3.4, 7.3.5, 9.3) of an I slice of I_16x16 and
I_4x4 macroblocks and of a P slice of P_L0_16x16 and P_Skip macroblocks,
from per-MB symbol arrays, in plain Python and NumPy.

A slice is first written out as its bins in decoding order, one int each:
a context-coded bin as ctxIdx << 1 | bin, a bypass bin as -1 - bin, a
terminate bin as -3 - bin. The arithmetic coder (9.3.4) then runs over that
list, its contexts initialised for the slice QP (9.3.1.1) from
cabac_tables.py. Every ctxIdxInc is derived from the left and top
neighbours as 9.3.3.1.1 sets out. A neighbour's coded_block_flag is the
nonzero-ness of its block, which is final before any block is written: a
block left out because its coded_block_pattern bit is 0 holds no level, and
a skipped MB none. Every MB is coded at the slice QP (mb_qp_delta 0, so
each mb_qp_delta's first bin takes ctxIdxInc 0).

Written for the benchmark from the spec; nothing of the program is
imported.
"""

from __future__ import annotations

import numpy as np
import torch

from . import cabac_tables as tables
from .vlc import ZSCAN, _mv_prediction

# ctxIdx offsets of the elements these slices carry (Table 9-34).
MB_TYPE_I, MB_SKIP_P, MB_TYPE_P = 3, 11, 14
MVD_X, MVD_Y, MB_QP_DELTA, CHROMA_PRED = 40, 47, 60, 64
I4_FLAG, I4_REM, CBP_LUMA, CBP_CHROMA = 68, 69, 73, 77
CBF, SIG, LAST, ABS = 85, 105, 166, 227
# Residual block categories (Table 9-42): 0 Intra16x16DCLevel, 1
# Intra16x16ACLevel, 2 LumaLevel4x4, 3 ChromaDCLevel, 4 ChromaACLevel.
MAX_COEFF = (16, 15, 16, 4, 15)
SIG_OFFSET = (0, 15, 29, 44, 47)  # ctxBlockCatOffset, frame coding
ABS_OFFSET = (0, 10, 20, 30, 39)

# Per category: the context codes (ctxIdx << 1) of significant_coeff_flag
# and last_significant_coeff_flag by scan position, of coeff_abs_level_
# minus1 by ctxIdxInc, and the cap on numDecodAbsLevelGt1 (9.3.3.1.3).
_CAT = [([(SIG + SIG_OFFSET[c] + i) << 1 for i in range(MAX_COEFF[c])],
         [(LAST + SIG_OFFSET[c] + i) << 1 for i in range(MAX_COEFF[c])],
         [(ABS + ABS_OFFSET[c] + i) << 1 for i in range(10)],
         3 if c == 3 else 4) for c in range(5)]

# The coder's tables by context state s = pStateIdx << 1 | valMPS.
_LPS = [tables.RANGE_TAB_LPS[s >> 1][q] for s in range(128) for q in range(4)]
_NEXT_MPS = [min((s >> 1) + 1, 62) << 1 | (s & 1) for s in range(128)]
_NEXT_LPS = [tables.TRANS_IDX_LPS[s >> 1] << 1
             | ((s & 1) ^ (1 if s >> 1 == 0 else 0)) for s in range(128)]
# The shifts that renormalise a range below 256 (9.3.4.3).
_RENORM = [0] + [max(0, 8 - r.bit_length() + 1) for r in range(1, 512)]

BYPASS_0, BYPASS_1, TERMINATE_0, TERMINATE_1 = -1, -2, -3, -4


def init_contexts(mn, qp: int) -> list:
    """Every context's state for the slice QP from its (m, n) (9.3.1.1)."""
    qp = min(max(qp, 0), 51)
    out = []
    for m, n in mn:
        pre = min(max(((m * qp) >> 4) + n, 1), 126)
        out.append((pre - 64) << 1 | 1 if pre > 63 else (63 - pre) << 1)
    return out


def encode_bins(bins, ctx: list) -> bytes:
    """The arithmetic coder (9.3.4) over a slice's bins, the last of which
    is the terminate bin 1 of its last end_of_slice_flag: the slice data's
    bytes, that is the coder's bits, the rbsp_stop_one_bit that its flush
    writes (9.3.4.5) and zero bits to the byte boundary. ctx: the context
    states, updated in place.

    The bits are those of the lower end of the coding interval, all
    renormalisations applied, from the one below the first (which is always
    0, 9.3.4.1's firstBitFlag) down to bit 8 of the register after the
    flush. The register `low` is held with the q bits not yet written
    above its 9 (so renormalising is a shift), a byte is written once q
    reaches 8, and 0xFF bytes are held back until a carry out of `low`
    (turning them into 0x00 and adding one to the byte before them) can no
    longer reach them: 9.3.4.2's outstanding bits, by the byte."""
    low, rng, q = 0, 510, 0
    held = 0
    out = bytearray()
    for b in bins:
        if b >= 0:
            c = b >> 1
            s = ctx[c]
            lps = _LPS[(s << 2) | ((rng >> 6) & 3)]
            rng -= lps
            if (b & 1) != (s & 1):
                low += rng
                rng = lps
                ctx[c] = _NEXT_LPS[s]
                n = _RENORM[rng]
            else:
                ctx[c] = _NEXT_MPS[s]
                if rng >= 256:
                    continue
                n = 1
            low <<= n
            rng <<= n
            q += n
        elif b == BYPASS_0:
            low <<= 1
            q += 1
        elif b == BYPASS_1:
            low = (low << 1) + rng
            q += 1
        else:
            rng -= 2
            if b == TERMINATE_1:
                low = (low + rng) << 7
                q += 7
            elif rng >= 256:
                continue
            else:
                low <<= 1
                rng <<= 1
                q += 1
        if q >= 8:
            o = low >> (q + 1)
            low &= (1 << (q + 1)) - 1
            q -= 8
            if o > 0xFF:
                out[-1] += 1
                out += bytes(held)
                held = 0
                o &= 0xFF
            if o == 0xFF:
                held += 1
            else:
                out += b"\xff" * held
                held = 0
                out.append(o)
    tail = low >> 8  # q + 1 bits, and a carry above them
    if tail >> (q + 1):
        out[-1] += 1
        out += bytes(held)
        tail &= (1 << (q + 1)) - 1
    else:
        out += b"\xff" * held
    nbits = q + 2
    pad = -nbits % 8
    out += (((tail << 1) | 1) << pad).to_bytes((nbits + pad) // 8, "big")
    return bytes(out)


# ------------------------------------------------------------ binarizations


def _exp_golomb(out: list, v: int, k: int) -> None:
    """The k-th order Exp-Golomb suffix of UEGk, bypass bins (9.3.2.3)."""
    while v >= 1 << k:
        out.append(BYPASS_1)
        v -= 1 << k
        k += 1
    out.append(BYPASS_0)
    for i in range(k - 1, -1, -1):
        out.append(BYPASS_1 if (v >> i) & 1 else BYPASS_0)


def _mvd(out: list, v: int, base: int, e: int) -> None:
    """mvd_l0 of one component: UEG3, signed, uCoff 9; e is absMvdComp of
    the left and top MBs summed (9.3.3.1.1.7)."""
    a = abs(v)
    inc = 0 if e < 3 else (1 if e <= 32 else 2)
    if a == 0:
        out.append((base + inc) << 1)
        return
    out.append(((base + inc) << 1) | 1)
    p = min(a, 9)
    out += [((base + min(k + 2, 6)) << 1) | 1 for k in range(1, p)]
    if p < 9:
        out.append((base + min(p + 2, 6)) << 1)
    else:
        _exp_golomb(out, a - 9, 3)
    out.append(BYPASS_1 if v < 0 else BYPASS_0)


def _block(out: list, levels: list, cat: int) -> None:
    """significant_coeff_flag, last_significant_coeff_flag and the levels
    (coeff_abs_level_minus1 as TU of cMax 14 + UEG0, and the sign) of a
    block with at least one nonzero coefficient, `levels` in scan order
    (7.3.5.3.3, 9.3.3.1.3)."""
    sig, last, absc, cap = _CAT[cat]
    nz = [i for i, v in enumerate(levels) if v]
    end = nz[-1]
    for i in range(min(end + 1, len(levels) - 1)):
        if levels[i]:
            out.append(sig[i] | 1)
            out.append(last[i] | (i == end))
        else:
            out.append(sig[i])
    eq1 = gt1 = 0
    for i in reversed(nz):
        v = levels[i]
        a = abs(v) - 1
        first = absc[0 if gt1 else min(4, 1 + eq1)]
        if a == 0:
            out.append(first)
            eq1 += 1
        else:
            rest = absc[5 + min(cap, gt1)]
            out.append(first | 1)
            out += [rest | 1] * (min(a, 14) - 1)
            if a < 14:
                out.append(rest)
            else:
                _exp_golomb(out, a - 14, 0)
            gt1 += 1
        out.append(BYPASS_1 if v < 0 else BYPASS_0)


def _coded(out: list, levels: list, cat: int, inc: int) -> None:
    """coded_block_flag, then the block where it is 1."""
    flag = any(levels)
    out.append(((CBF + 4 * cat + inc) << 1) | flag)
    if flag:
        _block(out, levels, cat)


def _cbp(out: list, cbp: int, left: int, top: int) -> None:
    """coded_block_pattern: four luma bins, one per 8x8 block, then the
    chroma TU of cMax 2 (9.3.2.6, 9.3.3.1.1.4). left, top: the neighbour
    MB's pattern (0 for a skipped one), -1 where unavailable."""
    for b8 in range(4):
        # The left and top 8x8 blocks: in this MB, or in the neighbour MB.
        if b8 & 1:
            a = 1 - ((cbp >> (b8 - 1)) & 1)
        else:
            a = 0 if left < 0 else 1 - ((left >> (b8 + 1)) & 1)
        if b8 & 2:
            t = 1 - ((cbp >> (b8 - 2)) & 1)
        else:
            t = 0 if top < 0 else 1 - ((top >> (b8 + 2)) & 1)
        out.append(((CBP_LUMA + a + 2 * t) << 1) | ((cbp >> b8) & 1))
    chroma, ca, cb = cbp >> 4, max(left, 0) >> 4, max(top, 0) >> 4
    out.append(((CBP_CHROMA + (ca > 0) + 2 * (cb > 0)) << 1) | (chroma > 0))
    if chroma:
        out.append(((CBP_CHROMA + 4 + (ca == 2) + 2 * (cb == 2)) << 1)
                   | (chroma == 2))


# ------------------------------------------------------- per-slice grids


def _neighbour_inc(grid: np.ndarray, edge: int) -> np.ndarray:
    """condTermFlagA + 2 * condTermFlagB over a grid of flags, `edge` where
    the left or top neighbour lies outside the picture."""
    g = grid.astype(np.int64)
    left = np.pad(g, ((0, 0), (1, 0)), constant_values=edge)[:, :-1]
    top = np.pad(g, ((1, 0), (0, 0)), constant_values=edge)[:-1, :]
    return left + 2 * top


def _block_grid(nz: np.ndarray, n: int) -> np.ndarray:
    """(R, C, n*n) per-MB raster flags as the (n R, n C) picture grid."""
    R, C = nz.shape[:2]
    return nz.reshape(R, C, n, n).transpose(0, 2, 1, 3).reshape(R * n, C * n)


def _mb_rows(grid: np.ndarray, n: int) -> list:
    """The (n R, n C) grid back as one list of n*n raster values per MB."""
    R, C = grid.shape[0] // n, grid.shape[1] // n
    return grid.reshape(R, n, C, n).transpose(0, 2, 1, 3).reshape(
        R * C, n * n).tolist()


def _cbp_of(luma_nz: np.ndarray, cdc, cac) -> np.ndarray:
    """Per MB: CodedBlockPatternLuma (a bit per 8x8 block with any nonzero
    4x4 block, luma_nz its (R, C, 16) raster flags) | chroma << 4."""
    R, C = luma_nz.shape[:2]
    g = luma_nz.reshape(R, C, 2, 2, 2, 2).any(axis=(3, 5)).reshape(R, C, 4)
    luma = (g * np.array([1, 2, 4, 8])).sum(axis=2)
    chroma = np.where(cac.reshape(R, C, -1).any(axis=2), 2,
                      np.where(cdc.reshape(R, C, -1).any(axis=2), 1, 0))
    return luma | (chroma << 4)


def _chroma_incs(cdc, cac, edge: int):
    """ctxIdxInc of each MB's two chroma DC blocks (R C, 2) and of its
    eight chroma AC blocks (R C, 2, 4), component by component."""
    R, C = cdc.shape[:2]
    dc = np.stack([_neighbour_inc(cdc[:, :, k].any(axis=2), edge)
                   for k in range(2)], axis=2).reshape(R * C, 2)
    ac = np.stack([_mb_rows(_neighbour_inc(_block_grid(
        cac[:, :, k].any(axis=3), 2), edge), 2) for k in range(2)], axis=1)
    return dc.tolist(), ac.tolist()


def _chroma(out, m, cbp, cdc, cac, dc_inc, ac_inc) -> None:
    """The chroma DC blocks of MB m, then its AC blocks, as its pattern
    says."""
    chroma = cbp >> 4
    if chroma:
        for k in range(2):
            _coded(out, cdc[m][k], 3, dc_inc[m][k])
    if chroma == 2:
        for k in range(2):
            for b in range(4):
                _coded(out, cac[m][k][b], 4, ac_inc[m][k][b])


def _luma4(out, m, cbp, blocks, incs, cat: int) -> None:
    """The 4x4 luma blocks of MB m in z-scan order, those of 8x8 blocks
    whose pattern bit is set."""
    for z in range(16):
        if (cbp >> (z >> 2)) & 1:
            b = ZSCAN[z]
            _coded(out, blocks[m * 16 + b], cat, incs[m][b])


def _left_top(values: np.ndarray):
    """Each MB's left and top value of an (R, C) int grid, -1 outside."""
    v = values.astype(np.int64)
    left = np.pad(v, ((0, 0), (1, 0)), constant_values=-1)[:, :-1]
    top = np.pad(v, ((1, 0), (0, 0)), constant_values=-1)[:-1, :]
    return left.reshape(-1).tolist(), top.reshape(-1).tolist()


# ---------------------------------------------------------------- slices


def islice_data(qp: int, mode16, chroma_mode, dc, ac, cdc, cac, is_i4,
                modes4, luma4) -> bytes:
    """The CABAC slice_data of an I slice covering the picture: numpy
    arrays mode16, chroma_mode (R, C); dc (R, C, 16) and ac (R, C, 16, 15)
    the I_16x16 levels, zig-zag, raster blocks; cdc (R, C, 2, 4), cac
    (R, C, 2, 4, 15) the chroma levels; is_i4 (R, C) the I_4x4 MBs, modes4
    (R, C, 16) their 4x4 modes in z-scan order and luma4 (R, C, 16, 16)
    their levels, zig-zag, raster blocks."""
    R, C = mode16.shape
    n = R * C
    is_i4 = np.asarray(is_i4, bool)
    i4_list = is_i4.reshape(-1).tolist()
    luma_nz = np.where(is_i4[..., None], (luma4 != 0).any(axis=3),
                       (ac != 0).any(axis=3))
    cbp = _cbp_of(luma_nz, cdc, cac)
    # An I_16x16 MB's luma pattern is 0 or 15 (its AC blocks all or none).
    cbp = np.where(~is_i4 & ((cbp & 15) > 0), cbp | 15, cbp)
    cbp_left, cbp_top = _left_top(cbp)
    # mb_type bin 0: ctxIdxInc counts the neighbours that are not I_NxN.
    not_i4 = np.pad(~is_i4, 1, constant_values=False)
    type_inc = (not_i4[1:-1, :-2].astype(int)
                + not_i4[:-2, 1:-1]).reshape(-1).tolist()
    cm = np.pad(chroma_mode != 0, 1, constant_values=False)
    cm_inc = (cm[1:-1, :-2].astype(int) + cm[:-2, 1:-1]).reshape(-1).tolist()
    # predIntra4x4PredMode (8.3.1.1): DC (2) for an MB that is not I_4x4,
    # and where the left or the top block is outside the picture.
    grid = _block_grid(np.where(is_i4[..., None],
                                np.asarray(modes4)[..., np.argsort(ZSCAN)],
                                2), 4)
    pred = np.minimum(np.pad(grid, ((0, 0), (1, 0)))[:, :-1],
                      np.pad(grid, ((1, 0), (0, 0)))[:-1, :])
    pred[0, :] = 2
    pred[:, 0] = 2
    modes_r = _mb_rows(grid, 4)
    pred_r = _mb_rows(pred, 4)
    luma_inc = _mb_rows(_neighbour_inc(_block_grid(luma_nz, 4), 1), 4)
    dc_inc = _neighbour_inc(~is_i4 & (dc != 0).any(axis=2), 1).reshape(
        -1).tolist()
    cdc_inc, cac_inc = _chroma_incs(cdc, cac, 1)
    blocks4 = luma4.reshape(n * 16, 16).tolist()
    blocks_ac = ac.reshape(n * 16, 15).tolist()
    dcs = dc.reshape(n, 16).tolist()
    cdcs = cdc.reshape(n, 2, 4).tolist()
    cacs = cac.reshape(n, 2, 4, 15).tolist()
    cbps = cbp.reshape(-1).tolist()
    m16 = mode16.reshape(-1).tolist()
    cms = chroma_mode.reshape(-1).tolist()

    out: list = []
    for m in range(n):
        c = cbps[m]
        if i4_list[m]:
            out.append((MB_TYPE_I + type_inc[m]) << 1)  # I_NxN
            for z in range(16):
                b = ZSCAN[z]
                mode, p = modes_r[m][b], pred_r[m][b]
                if mode == p:
                    out.append((I4_FLAG << 1) | 1)
                else:
                    rem = mode if mode < p else mode - 1
                    out += [I4_FLAG << 1] + [(I4_REM << 1) | ((rem >> k) & 1)
                                             for k in range(3)]
        else:
            # I_16x16: 1, terminate 0 (not I_PCM), the luma and chroma
            # pattern and the prediction mode (Table 9-36).
            chroma = c >> 4
            out += [((MB_TYPE_I + type_inc[m]) << 1) | 1, TERMINATE_0,
                    ((MB_TYPE_I + 3) << 1) | (c & 1),
                    ((MB_TYPE_I + 4) << 1) | (chroma > 0)]
            if chroma:
                out.append(((MB_TYPE_I + 5) << 1) | (chroma == 2))
            out += [((MB_TYPE_I + 6) << 1) | (m16[m] >> 1),
                    ((MB_TYPE_I + 7) << 1) | (m16[m] & 1)]
        mode_c = cms[m]
        out.append(((CHROMA_PRED + cm_inc[m]) << 1) | (mode_c > 0))
        if mode_c:
            out += [((CHROMA_PRED + 3) << 1) | 1] * (mode_c - 1)
            if mode_c < 3:
                out.append((CHROMA_PRED + 3) << 1)
        if i4_list[m]:
            _cbp(out, c, cbp_left[m], cbp_top[m])
            if c:
                out.append(MB_QP_DELTA << 1)
            _luma4(out, m, c, blocks4, luma_inc, 2)
        else:
            out.append(MB_QP_DELTA << 1)
            _coded(out, dcs[m], 0, dc_inc[m])
            _luma4(out, m, c, blocks_ac, luma_inc, 1)
        _chroma(out, m, c, cdcs, cacs, cdc_inc, cac_inc)
        out.append(TERMINATE_1 if m == n - 1 else TERMINATE_0)
    return encode_bins(out, init_contexts(tables.INIT_MN_I, qp))


def pslice_data(qp: int, cabac_init_idc: int, mv, luma, cdc, cac) -> bytes:
    """The CABAC slice_data of a P slice covering the picture, every MB
    P_L0_16x16 or P_Skip: numpy mv (R, C, 2) quarter-pel; luma
    (R, C, 16, 16) zig-zag levels, raster blocks; cdc (R, C, 2, 4), cac
    (R, C, 2, 4, 15). An MB is skipped where it has no level and its MV is
    the P_Skip MV (8.4.1.1)."""
    R, C = mv.shape[:2]
    n = R * C
    luma_nz = (luma != 0).any(axis=3)
    cbp = _cbp_of(luma_nz, cdc, cac)
    mv_t = torch.as_tensor(np.asarray(mv, np.int64))
    pred, skip_mv = (p.numpy() for p in _mv_prediction(mv_t, R, C))
    skip = (cbp == 0) & (mv == skip_mv).all(axis=2)
    mvd = np.where(skip[..., None], 0, mv - pred).astype(np.int64)
    # absMvdComp of the left and top MBs, summed (0 outside the picture).
    a = np.abs(mvd)
    e = (np.pad(a, ((0, 0), (1, 0), (0, 0)))[:, :-1]
         + np.pad(a, ((1, 0), (0, 0), (0, 0)))[:-1]).reshape(n, 2).tolist()
    coded = np.pad(~skip, 1, constant_values=False)
    skip_inc = (coded[1:-1, :-2].astype(int) + coded[:-2, 1:-1]).reshape(
        -1).tolist()
    cbp_left, cbp_top = _left_top(np.where(skip, 0, cbp))
    luma_inc = _mb_rows(_neighbour_inc(_block_grid(luma_nz, 4), 0), 4)
    cdc_inc, cac_inc = _chroma_incs(cdc, cac, 0)
    blocks = luma.reshape(n * 16, 16).tolist()
    cdcs = cdc.reshape(n, 2, 4).tolist()
    cacs = cac.reshape(n, 2, 4, 15).tolist()
    cbps = cbp.reshape(-1).tolist()
    skips = skip.reshape(-1).tolist()
    mvds = mvd.reshape(n, 2).tolist()

    out: list = []
    for m in range(n):
        out.append(((MB_SKIP_P + skip_inc[m]) << 1) | skips[m])
        if not skips[m]:
            c = cbps[m]
            # mb_type P_L0_16x16: bins 0, 0, 0 (Table 9-37, 9-39).
            out += [MB_TYPE_P << 1, (MB_TYPE_P + 1) << 1,
                    (MB_TYPE_P + 2) << 1]
            _mvd(out, mvds[m][0], MVD_X, e[m][0])
            _mvd(out, mvds[m][1], MVD_Y, e[m][1])
            _cbp(out, c, cbp_left[m], cbp_top[m])
            if c:
                out.append(MB_QP_DELTA << 1)
            _luma4(out, m, c, blocks, luma_inc, 2)
            _chroma(out, m, c, cdcs, cacs, cdc_inc, cac_inc)
        out.append(TERMINATE_1 if m == n - 1 else TERMINATE_0)
    return encode_bins(out, init_contexts(tables.INIT_MN_P[cabac_init_idc],
                                          qp))
