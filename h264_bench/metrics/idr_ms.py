"""Median over the window's IDRs of the host clock around encode_frame,
ending in a synchronise, in ms."""

import statistics


def read(run):
    return statistics.median(run.idr_ms) if run.idr_ms else None
