"""The per-layer metrics that read the program's spans (enc.*): present in
a traced run of the tiny cell, and read from the window's thread alone on a
synthetic trace, and nothing where the program has no spans."""

from __future__ import annotations

import pytest
import torch

from h264_bench import harness
from h264_bench.trace import WINDOW, Summary

SPAN_METRICS = {"p_dispatch_ms.natural": "enc.p.dispatch",
                "p_wait_ms.natural": "enc.p.download",
                "au_assembly_ms.natural": "enc.p.assemble",
                "idr_write_ms.natural": "enc.idr.write"}


def test_traced_line_reads_the_spans(tiny):
    spec, bench = tiny
    out = harness.run_cell(spec, "tiny.natural", 2**31 + 77, 0.0, True,
                           device="cpu", bench=bench)
    assert out["correct"] is True
    for name in SPAN_METRICS:
        value = out["metrics"][name]["value"]
        assert isinstance(value, float) and value > 0
        assert out["metrics"][name]["unit"] == "ms"


class _Event:
    """The parts of a kineto event that Summary reads."""

    def __init__(self, name, start, end, thread=1):
        self._v = (name, start, end, thread)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def end_ns(self):
        return self._v[2]

    def start_thread_id(self):
        return self._v[3]

    def is_user_annotation(self):
        return True

    def device_type(self):
        return torch.autograd.DeviceType.CPU


def _run(events, p_frames=4, idr_frames=2):
    return harness.Run(trace=Summary([_Event(WINDOW, 0, 10_000_000)]
                                     + events),
                       frames=p_frames + idr_frames, idr_frames=idr_frames,
                       p_frames=p_frames, R=3, C=4)


@pytest.mark.parametrize("metric", sorted(SPAN_METRICS))
def test_span_reader_on_a_synthetic_trace(metric):
    """Two spans of 1 ms and 3 ms on the window's thread, one on another
    thread and one after the window: 4 ms over the frames it divides."""
    span = SPAN_METRICS[metric]
    run = _run([_Event(span, 1_000_000, 2_000_000),
                _Event(span, 5_000_000, 8_000_000),
                _Event(span, 2_000_000, 9_000_000, thread=2),
                _Event(span, 11_000_000, 12_000_000),
                _Event("bench.staged", 0, 9_000_000)])
    frames = run.idr_frames if span.startswith("enc.idr") else run.p_frames
    got = harness.load_module("metrics", metric).read(run)
    assert got == pytest.approx(4.0 / frames)


@pytest.mark.parametrize("metric", sorted(SPAN_METRICS))
def test_span_reader_without_spans(metric):
    """A program without the spans: the reader finds nothing."""
    run = _run([_Event("bench.staged", 0, 9_000_000)])
    assert harness.load_module("metrics", metric).read(run) is None
