"""Motion-vector prediction shared by encoder entropy stage and decoders.

Median MV prediction for 16x16 partitions (spec 8.4.1.3) and the P_Skip
motion inference rule (spec 8.4.1.1). Both sides of the codec must apply
identical rules, so they live in one place.

`mv_map` maps (mb_row, mb_col) -> (mvx, mvy) for macroblocks that are
inter-coded with the current reference index; intra MBs are absent (their
refIdx is -1: they contribute a zero MV to the median, never match the
reference index, and never trigger the skip zero-rule).

Full 8.4.1.3.2 rule order (validated against libavcodec on x264 streams,
tests/test_conformance.py):
  1. If the B and C neighbor MBs are unavailable and A is available,
     the predictor is mvA (zero if A is intra).
  2. Else if exactly ONE of A/B/C has refIdx equal to the current partition's
     (here: is present in mv_map), the predictor is that neighbor's MV alone.
  3. Else the component-wise median with absent/unavailable entries as zero.
Rule 2 only differs from the median when some neighbor is intra or coded
against another reference — our own encoder never emits those in P slices
today, so the device/C++ packers (device_cavlc.py, csrc/*.cpp) implement the
median-only reduction; this host rule is the decode-side general case.
"""

from __future__ import annotations


def median3(a, b, c):
    return max(min(a, b), min(max(a, b), c))


def predict_mv(mv_map, r: int, c: int, n_cols: int):
    """Median MV predictor for the 16x16 partition at MB (r, c)."""
    a_avail = c > 0
    b_avail = r > 0
    c_pos = (r - 1, c + 1) if (r > 0 and c + 1 < n_cols) else None
    if c_pos is None and r > 0 and c > 0:
        c_pos = (r - 1, c - 1)  # D substitutes for C (6.4.11.7)
    a = mv_map.get((r, c - 1)) if a_avail else None
    b = mv_map.get((r - 1, c)) if b_avail else None
    cc = mv_map.get(c_pos) if c_pos is not None else None
    if a_avail and not b_avail and c_pos is None:
        return a if a is not None else (0, 0)
    matches = [m for m in (a, b, cc) if m is not None]
    if len(matches) == 1:
        return matches[0]
    va = a if a is not None else (0, 0)
    vb = b if b is not None else (0, 0)
    vc = cc if cc is not None else (0, 0)
    return (
        median3(va[0], vb[0], vc[0]),
        median3(va[1], vb[1], vc[1]),
    )


def skip_mv(mv_map, r: int, c: int, n_cols: int):
    """MV inferred for a P_Skip macroblock (spec 8.4.1.1)."""
    if r == 0 or c == 0:
        return (0, 0)
    a = mv_map.get((r, c - 1))
    b = mv_map.get((r - 1, c))
    if (a is not None and a == (0, 0)) or (b is not None and b == (0, 0)):
        return (0, 0)
    return predict_mv(mv_map, r, c, n_cols)
