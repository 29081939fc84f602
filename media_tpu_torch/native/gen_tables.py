#!/usr/bin/env python
"""Generate cavlc_tables.inc for the port's C++ entropy coders and parsers
(media_tpu_torch/csrc/*.cpp) from the validated Python tables of this
package: entropy/cavlc_tables.py, the encoder's ZSCAN_TO_RASTER and the CABAC
engine's range / transition tables. The twin of the JAX package's
csrc/gen_tables.py; the arrays it writes are the same, name for name.

    python -m media_tpu_torch.native.gen_tables [out_path]
"""

from __future__ import annotations

import os
import sys

from ..entropy import cabac_engine as ce
from ..entropy import cavlc_tables as t
from ..pipeline.encoder import ZSCAN_TO_RASTER

HEADER = "// GENERATED by media_tpu_torch/native/gen_tables.py; do not edit.\n"


def _arr(name, dims, values, dtype="unsigned char"):
    dim_s = "".join(f"[{d}]" for d in dims)
    flat = ", ".join(str(int(v)) for v in values)
    return f"static const {dtype} {name}{dim_s} = {{{flat}}};\n"


def _len_code(entries):
    return [e[0] for e in entries], [e[1] for e in entries]


def _rows(table, n_rows, width):
    return [table[r][i] if i < len(table[r]) else (0, 0)
            for r in range(n_rows) for i in range(width)]


def render() -> str:
    """The text of cavlc_tables.inc."""
    t.validate_tables()
    lines = [HEADER]

    def pair(len_name, cod_name, dims, entries):
        lens, codes = _len_code(entries)
        lines.append(_arr(len_name, dims, lens))
        lines.append(_arr(cod_name, dims, codes))

    pair("kLenCT", "kCodCT", (3, 4, 17),
         [t.COEFF_TOKEN[ctx].get((t1, tc), (0, 0))
          for ctx in range(3) for t1 in range(4) for tc in range(17)])
    pair("kLenCTCdc", "kCodCTCdc", (4, 5),
         [t.COEFF_TOKEN_CHROMA_DC.get((t1, tc), (0, 0))
          for t1 in range(4) for tc in range(5)])
    pair("kLenTZ", "kCodTZ", (15, 16), _rows(t.TOTAL_ZEROS, 15, 16))
    pair("kLenTZCdc", "kCodTZCdc", (3, 4),
         _rows(t.TOTAL_ZEROS_CHROMA_DC, 3, 4))
    pair("kLenRB", "kCodRB", (7, 15), _rows(t.RUN_BEFORE, 7, 15))

    lines.append(_arr("kCbpCodeIntra", (48,), t.CBP_TO_CODE_INTRA))
    lines.append(_arr("kCbpCodeInter", (48,), t.CBP_TO_CODE_INTER))
    # Decode direction: ue(code) -> (intra_cbp, inter_cbp)  (Table 9-4).
    lines.append(_arr("kCbpFromCode", (48, 2),
                      [v for code in range(48) for v in t.CBP_TABLE[code]]))
    lines.append(_arr("kZscanToRaster", (16,), ZSCAN_TO_RASTER))
    # CABAC engine tables (spec Tables 9-44/9-45).
    lines.append(_arr("kRangeTabLPS", (64, 4), ce.RANGE_TAB_LPS.reshape(-1)))
    lines.append(_arr("kTransIdxLPS", (64,), ce.TRANS_IDX_LPS))
    return "".join(lines)


def main(out_path: str) -> None:
    with open(out_path, "w") as f:
        f.write(render())
    print(f"wrote {out_path}")


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "..", "csrc", "build",
        "cavlc_tables.inc"))
