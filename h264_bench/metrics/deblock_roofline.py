"""The deblock stage's least time (kernels/deblock.py) over the device time of
its activities in the traced window, in %."""

from __future__ import annotations


def read(run):
    stage = run.stages["deblock"]
    seconds, count = run.trace.stage(stage.PATTERN)
    if not count or seconds <= 0:
        return None
    bound = stage.bound_s(run)
    return None if bound is None else 100.0 * bound / seconds
