"""CAVLC code tables (Rec. ITU-T H.264 Tables 9-4, 9-5, 9-7..9-10).

Each VLC table entry is (length_in_bits, code_value). Structural validators at
the bottom assert the codebooks are prefix-free (and complete where the spec
makes them complete), which is run by the test suite to guard transcription.
"""

from __future__ import annotations

import numpy as np

# --- Table 9-5: coeff_token -------------------------------------------------
# Indexed [context][trailing_ones][total_coeff] -> (len, code); context 0 is
# 0 <= nC < 2, context 1 is 2 <= nC < 4, context 2 is 4 <= nC < 8.
# nC >= 8 uses a 6-bit FLC handled in code; nC == -1 uses COEFF_TOKEN_CHROMA_DC.

_LEN_CT = [
    [  # 0 <= nC < 2
        [1, 6, 8, 9, 10, 11, 13, 13, 13, 14, 14, 15, 15, 16, 16, 16, 16],
        [0, 2, 6, 8, 9, 10, 11, 13, 13, 14, 14, 15, 15, 15, 16, 16, 16],
        [0, 0, 3, 7, 8, 9, 10, 11, 13, 13, 14, 14, 15, 15, 16, 16, 16],
        [0, 0, 0, 5, 6, 7, 8, 9, 10, 11, 13, 14, 14, 15, 15, 16, 16],
    ],
    [  # 2 <= nC < 4
        [2, 6, 6, 7, 8, 8, 9, 11, 11, 12, 12, 12, 13, 13, 13, 14, 14],
        [0, 2, 5, 6, 6, 7, 8, 9, 11, 11, 12, 12, 13, 13, 14, 14, 14],
        [0, 0, 3, 6, 6, 7, 8, 9, 11, 11, 12, 12, 13, 13, 13, 14, 14],
        [0, 0, 0, 4, 4, 5, 6, 6, 7, 9, 11, 11, 12, 13, 13, 13, 14],
    ],
    [  # 4 <= nC < 8
        [4, 6, 6, 6, 7, 7, 7, 7, 8, 8, 9, 9, 9, 10, 10, 10, 10],
        [0, 4, 5, 5, 5, 5, 6, 6, 7, 8, 8, 9, 9, 9, 10, 10, 10],
        [0, 0, 4, 5, 5, 5, 6, 6, 7, 7, 8, 8, 9, 9, 10, 10, 10],
        [0, 0, 0, 4, 4, 4, 4, 4, 5, 6, 7, 8, 8, 9, 10, 10, 10],
    ],
]

_COD_CT = [
    [
        [1, 5, 7, 7, 7, 7, 15, 11, 8, 15, 11, 15, 11, 15, 11, 7, 4],
        [0, 1, 4, 6, 6, 6, 6, 14, 10, 14, 10, 14, 10, 1, 14, 10, 6],
        [0, 0, 1, 5, 5, 5, 5, 5, 13, 9, 13, 9, 13, 9, 13, 9, 5],
        [0, 0, 0, 3, 3, 4, 4, 4, 4, 4, 12, 12, 8, 12, 8, 12, 8],
    ],
    [
        [3, 11, 7, 7, 7, 4, 7, 15, 11, 15, 11, 8, 15, 11, 7, 9, 7],
        [0, 2, 7, 10, 6, 6, 6, 6, 14, 10, 14, 10, 14, 10, 11, 8, 6],
        [0, 0, 3, 9, 5, 5, 5, 5, 13, 9, 13, 9, 13, 9, 6, 10, 5],
        [0, 0, 0, 5, 4, 6, 8, 4, 4, 4, 12, 8, 12, 12, 8, 1, 4],
    ],
    [
        [15, 15, 11, 8, 15, 11, 9, 8, 15, 11, 15, 11, 8, 13, 9, 5, 1],
        [0, 14, 15, 12, 10, 8, 14, 10, 14, 14, 10, 14, 10, 7, 12, 8, 4],
        [0, 0, 13, 14, 11, 9, 13, 9, 13, 10, 13, 9, 13, 9, 11, 7, 3],
        [0, 0, 0, 12, 11, 10, 9, 8, 13, 12, 12, 12, 8, 12, 10, 6, 2],
    ],
]

# COEFF_TOKEN[ctx][(trailing_ones, total_coeff)] = (len, code)
COEFF_TOKEN = [
    {
        (t1, tc): (_LEN_CT[ctx][t1][tc], _COD_CT[ctx][t1][tc])
        for t1 in range(4)
        for tc in range(17)
        if _LEN_CT[ctx][t1][tc] > 0 and t1 <= tc and (t1 < 4)
    }
    for ctx in range(3)
]
# (0,0) has length 1+ in every context and must be present:
for ctx in range(3):
    COEFF_TOKEN[ctx][(0, 0)] = (_LEN_CT[ctx][0][0], _COD_CT[ctx][0][0])

# Chroma DC (nC == -1), 2x2 blocks, TotalCoeff <= 4.
COEFF_TOKEN_CHROMA_DC = {
    (0, 0): (2, 1),
    (0, 1): (6, 7),
    (1, 1): (1, 1),
    (0, 2): (6, 4),
    (1, 2): (6, 6),
    (2, 2): (3, 1),
    (0, 3): (6, 3),
    (1, 3): (7, 3),
    (2, 3): (7, 2),
    (3, 3): (6, 5),
    (0, 4): (6, 2),
    (1, 4): (8, 3),
    (2, 4): (8, 2),
    (3, 4): (7, 0),
}


def coeff_token_code(n_c: int, trailing_ones: int, total_coeff: int) -> tuple[int, int]:
    """(length, code) for coeff_token given the nC context."""
    if n_c == -1:
        return COEFF_TOKEN_CHROMA_DC[(trailing_ones, total_coeff)]
    if n_c >= 8:
        if total_coeff == 0:
            return 6, 3
        return 6, ((total_coeff - 1) << 2) | trailing_ones
    ctx = 0 if n_c < 2 else (1 if n_c < 4 else 2)
    return COEFF_TOKEN[ctx][(trailing_ones, total_coeff)]


# --- Tables 9-7/9-8: total_zeros for 4x4 (maxNumCoeff 15/16) ----------------
# TOTAL_ZEROS[total_coeff - 1][total_zeros] = (len, code)

_LEN_TZ = [
    [1, 3, 3, 4, 4, 5, 5, 6, 6, 7, 7, 8, 8, 9, 9, 9],
    [3, 3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 6, 6, 6, 6],
    [4, 3, 3, 3, 4, 4, 3, 3, 4, 5, 5, 6, 5, 6],
    [5, 3, 4, 4, 3, 3, 3, 4, 3, 4, 5, 5, 5],
    [4, 4, 4, 3, 3, 3, 3, 3, 4, 5, 4, 5],
    [6, 5, 3, 3, 3, 3, 3, 3, 4, 3, 6],
    [6, 5, 3, 3, 3, 2, 3, 4, 3, 6],
    [6, 4, 5, 3, 2, 2, 3, 3, 6],
    [6, 6, 4, 2, 2, 3, 2, 5],
    [5, 5, 3, 2, 2, 2, 4],
    [4, 4, 3, 3, 1, 3],
    [4, 4, 2, 1, 3],
    [3, 3, 1, 2],
    [2, 2, 1],
    [1, 1],
]

_COD_TZ = [
    [1, 3, 2, 3, 2, 3, 2, 3, 2, 3, 2, 3, 2, 3, 2, 1],
    [7, 6, 5, 4, 3, 5, 4, 3, 2, 3, 2, 3, 2, 1, 0],
    [5, 7, 6, 5, 4, 3, 4, 3, 2, 3, 2, 1, 1, 0],
    [3, 7, 5, 4, 6, 5, 4, 3, 3, 2, 2, 1, 0],
    [5, 4, 3, 7, 6, 5, 4, 3, 2, 1, 1, 0],
    [1, 1, 7, 6, 5, 4, 3, 2, 1, 1, 0],
    [1, 1, 5, 4, 3, 3, 2, 1, 1, 0],
    [1, 1, 1, 3, 3, 2, 2, 1, 0],
    [1, 0, 1, 3, 2, 1, 1, 1],
    [1, 0, 1, 3, 2, 1, 1],
    [0, 1, 1, 2, 1, 3],
    [0, 1, 1, 1, 1],
    [0, 1, 1, 1],
    [0, 1, 1],
    [0, 1],
]

TOTAL_ZEROS = [
    [(_LEN_TZ[tc][tz], _COD_TZ[tc][tz]) for tz in range(len(_LEN_TZ[tc]))]
    for tc in range(15)
]

# Table 9-9(a): total_zeros for chroma DC (2x2, maxNumCoeff 4)
TOTAL_ZEROS_CHROMA_DC = [
    [(1, 1), (2, 1), (3, 1), (3, 0)],  # total_coeff = 1
    [(1, 1), (2, 1), (2, 0)],  # total_coeff = 2
    [(1, 1), (1, 0)],  # total_coeff = 3
]

# --- Table 9-10: run_before --------------------------------------------------
# RUN_BEFORE[min(zeros_left, 7) - 1][run] = (len, code)

_LEN_RB = [
    [1, 1],
    [1, 2, 2],
    [2, 2, 2, 2],
    [2, 2, 2, 3, 3],
    [2, 2, 3, 3, 3, 3],
    [2, 3, 3, 3, 3, 3, 3],
    [3, 3, 3, 3, 3, 3, 3, 4, 5, 6, 7, 8, 9, 10, 11],
]

_COD_RB = [
    [1, 0],
    [1, 1, 0],
    [3, 2, 1, 0],
    [3, 2, 1, 1, 0],
    [3, 2, 3, 2, 1, 0],
    [3, 0, 1, 3, 2, 5, 4],
    [7, 6, 5, 4, 3, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1],
]

RUN_BEFORE = [
    [(_LEN_RB[zl][r], _COD_RB[zl][r]) for r in range(len(_LEN_RB[zl]))]
    for zl in range(7)
]

# --- Table 9-4: coded_block_pattern me(v) mapping ----------------------------
# codeNum -> cbp, columns (Intra_4x4 / Intra_8x8, Inter).

CBP_TABLE = np.array(
    [
        # (intra, inter)
        (47, 0), (31, 16), (15, 1), (0, 2), (23, 4), (27, 8), (29, 32), (30, 3),
        (7, 5), (11, 10), (13, 12), (14, 15), (39, 47), (43, 7), (45, 11), (46, 13),
        (16, 14), (3, 6), (5, 9), (10, 31), (12, 35), (19, 37), (21, 42), (26, 44),
        (28, 33), (35, 34), (37, 36), (42, 40), (44, 39), (1, 43), (2, 45), (4, 46),
        (8, 17), (17, 18), (18, 20), (20, 24), (24, 19), (6, 21), (9, 26), (22, 28),
        (25, 23), (32, 27), (33, 29), (34, 30), (36, 22), (40, 25), (38, 38), (41, 41),
    ],
    dtype=np.int32,
)

# Inverse maps: cbp -> codeNum
CBP_TO_CODE_INTRA = np.zeros(48, dtype=np.int32)
CBP_TO_CODE_INTER = np.zeros(48, dtype=np.int32)
for _code, (_intra_cbp, _inter_cbp) in enumerate(CBP_TABLE):
    CBP_TO_CODE_INTRA[_intra_cbp] = _code
    CBP_TO_CODE_INTER[_inter_cbp] = _code


# --- Structural validation ---------------------------------------------------


def _check_prefix_free(codes: list[tuple[int, int]], *, complete: bool) -> None:
    seen = []
    for length, code in codes:
        assert 0 < length <= 16, (length, code)
        assert code < (1 << length), (length, code)
        for l2, c2 in seen:
            # Neither code may be a prefix of the other.
            if length >= l2:
                assert (code >> (length - l2)) != c2, ((length, code), (l2, c2))
            else:
                assert (c2 >> (l2 - length)) != code, ((length, code), (l2, c2))
        seen.append((length, code))
    kraft = sum(2.0 ** -l for l, _ in codes)
    assert kraft <= 1.0 + 1e-12, kraft
    if complete:
        assert abs(kraft - 1.0) < 1e-12, kraft


def validate_tables() -> None:
    """Assert all VLC tables are prefix-free; complete where the spec is."""
    for ctx in range(3):
        _check_prefix_free(list(COEFF_TOKEN[ctx].values()), complete=False)
        assert len(COEFF_TOKEN[ctx]) == 62
    _check_prefix_free(list(COEFF_TOKEN_CHROMA_DC.values()), complete=False)
    for tc in range(15):
        row = TOTAL_ZEROS[tc]
        assert len(row) == 16 - tc
        # Not all rows are Kraft-complete in the spec (e.g. TC=1 leaves the
        # all-zeros 9-bit word unused), so require prefix-freeness only.
        _check_prefix_free(row, complete=False)
    for row in TOTAL_ZEROS_CHROMA_DC:
        _check_prefix_free(row, complete=True)
    for zl, row in enumerate(RUN_BEFORE):
        expect = 15 if zl == 6 else zl + 2
        assert len(row) == expect, (zl, len(row))
        _check_prefix_free(row, complete=False)
    intra_col = sorted(int(x) for x in CBP_TABLE[:, 0])
    inter_col = sorted(int(x) for x in CBP_TABLE[:, 1])
    assert intra_col == list(range(48))
    assert inter_col == list(range(48))
