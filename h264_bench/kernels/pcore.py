"""The P-frame core (csrc/pframe_core.cu, pipeline/pframe_core.py): one
activity a P frame.

Its work is the exhaustive search that defines its output: every
candidate's 256 luma samples once, for the (2*8+1)^2 = 289 full-pel and
the 49 quarter-pel candidates of each MB, at one operation a sample, on
the card's packed-byte rate (4 samples an instruction, 64 integer lanes an
SM a clock, every SM, the highest SM clock); against its bytes: the current
and reference pictures read once, the int16 symbols (386 an MB) and the
reconstruction written once. The bound is the larger.
"""

from __future__ import annotations

PATTERN = r"\bpframe_core_kernel\b"
CANDIDATES = (2 * 8 + 1) ** 2 + 49


def samples_per_frame(R: int, C: int) -> int:
    return R * C * CANDIDATES * 256


def bound_per_frame_s(run):
    """None where the card's highest SM clock could not be read."""
    p = run.peaks
    if "max_sm_mhz" not in p:
        return None
    rate = (p["samples_per_packed_instruction"] * p["int_lanes_per_sm"]
            * p["sm_count"] * p["max_sm_mhz"] * 1e6)
    n_bytes = 3 * run.picture_bytes + run.R * run.C * 386 * 2
    return max(samples_per_frame(run.R, run.C) / rate, run.hbm_s(n_bytes))


def bound_s(run):
    """The least time of the window's P frames."""
    per_frame = bound_per_frame_s(run)
    return None if per_frame is None else run.p_frames * per_frame
