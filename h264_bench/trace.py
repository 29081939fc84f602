"""The traced window: torch.profiler over the window, reduced to what the
per-layer metrics and the breakdown read.

Device activities (kernels, copies, sets; not the device-side copies of
the harness's spans) give the busy time, as the union
of their intervals inside the window, and each kernel stage's time, by the
stage's profiler-name pattern. Each idle gap between them is charged to the
innermost host event of the window's thread that spans the gap's middle: an
operator or a runtime call, else the harness's span around it (`bench.*`),
which then stands for the program's Python between its operators.
"""

from __future__ import annotations

import bisect
import re
from collections import defaultdict

import torch
from torch.profiler import ProfilerActivity, profile, record_function

WINDOW = "bench.window"


class Tracer:
    def __init__(self, device):
        acts = [ProfilerActivity.CPU]
        if torch.device(device).type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.window = None

    def start(self) -> None:
        self.prof.__enter__()
        self.window = record_function(WINDOW)
        self.window.__enter__()

    def span(self, name: str):
        return record_function(name)

    def stop(self) -> "Summary":
        self.window.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)
        return Summary(self.prof.profiler.kineto_results.events())


class Summary:
    """Device intervals and host events of the window, in seconds."""

    def __init__(self, events):
        host, dev = [], []
        win = None
        for e in events:
            name = e.name()
            if e.is_user_annotation() and e.device_type() != \
                    torch.autograd.DeviceType.CPU:
                continue  # a span's copy on the device's timeline
            if e.device_type() == torch.autograd.DeviceType.CPU:
                if name == WINDOW:
                    win = (e.start_ns(), e.end_ns(), e.start_thread_id())
                host.append((e.start_ns(), e.end_ns(), name,
                             e.start_thread_id()))
            else:
                dev.append((e.start_ns(), e.end_ns(), name))
        if win is None:
            raise RuntimeError("the trace holds no window span")
        w0, w1, tid = win
        self.window_s = (w1 - w0) / 1e9
        self.dev = sorted((max(a, w0), min(b, w1), n) for a, b, n in dev
                          if b > w0 and a < w1)
        self.host = sorted((a, b, n) for a, b, n, t in host
                           if t == tid and b > w0 and a < w1 and n != WINDOW)
        self._starts = [h[0] for h in self.host]
        self.spans = [h for h in self.host if h[2].startswith("bench.")]
        busy, gaps, cur = 0, [], w0
        start = end = None
        for a, b, _ in self.dev:
            if end is None or a > end:
                if end is not None:
                    busy += end - start
                gaps.append((cur if end is None else end, a))
                start, end = a, b
            else:
                end = max(end, b)
        if end is not None:
            busy += end - start
            gaps.append((end, w1))
        else:
            gaps.append((w0, w1))
        self.busy_s = busy / 1e9
        self.gaps = [(a, b) for a, b in gaps if b > a]

    def stage(self, pattern: str) -> tuple[float, int]:
        """(seconds, activities) of the device activities whose name
        matches `pattern` (re.search)."""
        rx = re.compile(pattern)
        hits = [b - a for a, b, n in self.dev if rx.search(n)]
        return sum(hits) / 1e9, len(hits)

    def _host_at(self, t: int) -> str:
        """The innermost host event around t; where only a harness span is,
        the span's name: Python of the program between its operators."""
        i = bisect.bisect_right(self._starts, t) - 1
        for j in range(i, max(i - 400, -1), -1):
            a, b, name = self.host[j]
            if a <= t < b:
                return name
        for a, b, name in self.spans:
            if a <= t < b:
                return f"{name} (Python between operators)"
        return "(outside the harness's spans)"

    def breakdown(self, top: int = 10) -> dict:
        ops = defaultdict(int)
        for a, b, n in self.dev:
            ops[n] += b - a
        idle = defaultdict(int)
        for a, b in self.gaps:
            idle[self._host_at((a + b) // 2)] += b - a
        return {
            "device_ops": [[n, v / 1e9] for n, v in sorted(
                ops.items(), key=lambda kv: -kv[1])[:top]],
            "idle_gaps": [[n, v / 1e9] for n, v in sorted(
                idle.items(), key=lambda kv: -kv[1])[:top]],
        }
