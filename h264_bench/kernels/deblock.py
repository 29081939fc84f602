"""Kernel 1, the whole-picture deblocking wavefront (csrc/deblock_wave.cu,
ops/deblock_wave.py): one activity a deblocked picture, IDR or P.

Its work is bytes: the picture read and written once, plus the per-MB meta
(120 int32 an MB) read once, at the memory rate."""

from __future__ import annotations

PATTERN = r"\bdeblock_wave_kernel\b"


def bound_s(run) -> float:
    per_frame = 2 * run.picture_bytes + run.R * run.C * 120 * 4
    return run.frames * run.hbm_s(per_frame)
