"""CABAC context models and initialization (spec 9.3.1.1).

Context layout follows the spec's ctxIdx space for the syntax this encoder
emits (ctxIdx 0..459 would be the full space; we allocate the standard
indices so ctx numbers in cabac_slice.py match the spec tables):

  11..13   mb_skip_flag (P)          14..20  mb_type (P prefix + sub)
  3..10    mb_type (I / I-in-P suffix)       21..23  (unused sub_mb)
  40..46   mvd_l0 x                  47..53  mvd_l0 y
  60..63   mb_qp_delta               64..67  intra_chroma_pred_mode
  68..72   prev_intra4x4_pred_mode / rem (unused: I16 only)
  73..76   coded_block_pattern luma  77..84  coded_block_pattern chroma
  85..104  coded_block_flag (5 cats x 4)
  105..165 significant_coeff_flag (frame, cats 0..4)
  166..226 last_significant_coeff_flag
  227..275 coeff_abs_level_minus1
  276      end_of_slice (terminate; no state)

Initialization (spec 9.3.1.1 machinery, per-slice-type and per-idc tables):
    preCtxState = Clip3(1, 126, ((m * Clip3(0, 51, qp)) >> 4) + n)
I slices use INIT_MN_I; P slices select INIT_MN_P[cabac_init_idc] via the
slice header. Tables are the normative Table 9-12..9-33 constants
(cabac_init_tables.py documents provenance + third-party validation).
"""

from __future__ import annotations

import numpy as np

from .cabac_init_tables import INIT_MN_I, INIT_MN_P, NUM_CTX

# Backward-compat alias (uniform-era name); I-slice table.
INIT_MN = INIT_MN_I


class ContextModels:
    """Per-slice adaptive contexts: pStateIdx and valMPS arrays."""

    def __init__(self, qp: int, cabac_init_idc: int = 0,
                 slice_type: str = "I", table=None):
        """table: explicit (NUM_CTX, 2) (m, n) override — used by codecs
        that reuse this engine with their own init data (e.g. the HEVC
        skeleton passes a uniform table so its streams do not silently
        depend on the H.264 constants)."""
        tbl = (table if table is not None
               else INIT_MN_I if slice_type == "I"
               else INIT_MN_P[int(np.clip(cabac_init_idc, 0, 2))])
        m = tbl[:, 0]
        n = tbl[:, 1]
        pre = np.clip(((m * int(np.clip(qp, 0, 51))) >> 4) + n, 1, 126)
        self.mps = (pre > 63).astype(np.int32)
        self.state = np.where(pre > 63, pre - 64, 63 - pre).astype(np.int32)

    def clone(self) -> "ContextModels":
        c = object.__new__(ContextModels)
        c.mps = self.mps.copy()
        c.state = self.state.copy()
        return c


# ctxIdx bases (spec 9.3.3.1.1 / Table 9-11 assignments used here)
MB_SKIP_P = 11
MB_TYPE_P = 14
MB_TYPE_I = 3
MVD_X = 40
MVD_Y = 47
MB_QP_DELTA = 60
CHROMA_PRED = 64
I4_PRED_FLAG = 68  # prev_intra4x4_pred_mode_flag
I4_PRED_REM = 69   # rem_intra4x4_pred_mode (all 3 FL bins, LSB first)
CBP_LUMA = 73
CBP_CHROMA = 77
CBF = 85          # + 4 * ctxBlockCat + ctxIdxInc
SIG = 105         # + sig_offset[cat] + scan pos
LAST = 166        # + sig_offset[cat] + scan pos
ABS_LVL = 227     # + abs_offset[cat] + ctxIdxInc

# per-category offsets within the CBF/SIG/LAST/ABS ranges (frame coding)
CAT_OFFSET_SIG = {0: 0, 1: 15, 2: 29, 3: 44, 4: 47}
CAT_OFFSET_ABS = {0: 0, 1: 10, 2: 20, 3: 30, 4: 39}
# max number of coefficients per category
CAT_MAXCOEFF = {0: 16, 1: 15, 2: 16, 3: 4, 4: 15}
