"""The program's spans against the device trace, on one traced run of a cell.

    python3 h264_bench/clock_check.py --workload <cell> --seed <n> \\
        --seconds <s> [--out <file>]

Runs the cell as run.py --trace 1 does (harness.run_cell on cuda:0), keeps
the trace's events, and prints one JSON line (also written to --out):

- `pcore_launches`: the P core's kernels in the window, by where the host
  call that launched them (tied by correlation id) lies: inside an
  enc.p.dispatch span, outside one, or not found.
- `downloads`: enc.p.download spans, and how many end after the last device
  activity that their chunk's enc.p.dispatch launched (the n-th download of
  the thread belongs to its n-th dispatch: the pipeline is first in, first
  out), and how many after the last activity of the chunk dispatched next.
- `span_s`: each enc.* and bench.* span's seconds in the window, and
  `p_spans_over_staged`: enc.p.dispatch + download + assemble over
  bench.staged + bench.staged_tail.
- `idle_by_span`: the device's idle seconds by the innermost enc.* span
  open at each gap's middle (else the bench.* span, else none).
- `metrics`: the run's result line's metrics; `correct`.
- `host_pslice_writer_calls`: the program's count of C++ CAVLC P-slice
  writer calls (native.write_pslice_native.calls) before the window (the
  set-up) and inside it; None where the program has no such counter. In
  the window, each call is a P frame that the device packer did not take.

The benchmark's runs never run it.
"""

from __future__ import annotations

import argparse
import bisect
import json
import os
import sys
import time

T_PROCESS = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
os.environ["OMP_NUM_THREADS"] = "1"

# Innermost first: a download or assembly lies inside its finish.
ENC_SPANS = ("enc.p.download", "enc.p.assemble", "enc.p.dispatch",
             "enc.idr.launch", "enc.idr.download", "enc.idr.write",
             "enc.p.finish")
BENCH_SPANS = ("bench.idr", "bench.staged", "bench.staged_tail")


class Intervals:
    """Disjoint (start, end) intervals of one span name, sorted."""

    def __init__(self, spans):
        self.spans = sorted(spans)
        self.starts = [a for a, _ in self.spans]

    def index(self, t: int):
        i = bisect.bisect_right(self.starts, t) - 1
        return i if i >= 0 and t < self.spans[i][1] else None


def check(summary, events, pcore_pattern: str) -> dict:
    import re

    import torch

    cpu = torch.autograd.DeviceType.CPU
    w0, w1 = summary.window_ns
    by_name = {n: Intervals([(a, b) for a, b, m in summary.host if m == n])
               for n in ENC_SPANS + BENCH_SPANS}
    launch, device = {}, []
    for e in events:
        if e.device_type() == cpu:
            name = e.name()
            if name.startswith("cu") and ("Launch" in name
                                          or "Memcpy" in name
                                          or "Memset" in name):
                launch[e.correlation_id()] = e.start_ns()
        elif not e.is_user_annotation() and e.end_ns() > w0 \
                and e.start_ns() < w1:
            device.append((e.correlation_id(), e.start_ns(), e.end_ns(),
                           e.name()))

    dispatch = by_name["enc.p.dispatch"]
    rx = re.compile(pcore_pattern)
    pcore = {"inside_dispatch": 0, "outside": 0, "launch_not_found": 0}
    last_end = [0] * len(dispatch.spans)  # a dispatch's last activity
    for corr, _a, b, name in device:
        t = launch.get(corr)
        k = None if t is None else dispatch.index(t)
        if k is not None:
            last_end[k] = max(last_end[k], b)
        if rx.search(name):
            pcore["launch_not_found" if t is None else
                  "outside" if k is None else "inside_dispatch"] += 1

    downloads = by_name["enc.p.download"].spans
    n = min(len(downloads), len(dispatch.spans))
    after_own = sum(downloads[k][1] >= last_end[k] for k in range(n))
    nxt = [k for k in range(n - 1)
           if dispatch.spans[k + 1][1] <= downloads[k][0]]
    after_next = sum(downloads[k][1] >= last_end[k + 1] for k in nxt)

    span_s = {name: sum(b - a for a, b in iv.spans) / 1e9
              for name, iv in by_name.items()}
    staged = span_s["bench.staged"] + span_s["bench.staged_tail"]
    p_spans = sum(span_s[f"enc.p.{s}"] for s in ("dispatch", "download",
                                                  "assemble"))
    idle = {}
    for a, b in summary.gaps:
        mid = (a + b) // 2
        key = next((name for name in ENC_SPANS + BENCH_SPANS
                    if by_name[name].index(mid) is not None), "none")
        idle[key] = idle.get(key, 0.0) + (b - a) / 1e9
    return {
        "pcore_launches": pcore,
        "downloads": {"spans": len(downloads), "dispatches":
                      len(dispatch.spans), "finishes":
                      len(by_name["enc.p.finish"].spans),
                      "end_after_own_chunk": after_own,
                      "with_next_chunk_dispatched": len(nxt),
                      "end_after_next_chunk": after_next},
        "span_s": span_s,
        "p_spans_over_staged": p_spans / staged if staged else None,
        "idle_by_span": dict(sorted(idle.items(), key=lambda kv: -kv[1])),
        "window_s": summary.window_s, "busy_s": summary.busy_s,
    }


def traced_run(spec: dict, cell: str, seed: int, seconds: float,
               device="cuda:0", bench: str | None = None,
               t_start: float | None = None) -> dict:
    """harness.run_cell with the trace; the check's line."""
    from h264_bench import harness
    from h264_bench import trace as tr
    from media_tpu_torch import native

    def calls():
        return getattr(native.write_pslice_native, "calls", None)

    kept = {}
    start, stop = tr.Tracer.start, tr.Tracer.stop

    def begin(self):
        kept["calls"] = calls()
        start(self)

    def keep(self):
        summary = stop(self)
        n = calls()
        kept["calls"] = None if n is None else {
            "set_up": kept["calls"], "window": n - kept["calls"]}
        kept["summary"] = summary
        kept["events"] = self.prof.profiler.kineto_results.events()
        # The window's bounds on the trace's clock.
        win = next(e for e in kept["events"] if e.name() == tr.WINDOW)
        summary.window_ns = (win.start_ns(), win.end_ns())
        return summary

    tr.Tracer.start, tr.Tracer.stop = begin, keep
    try:
        result = harness.run_cell(spec, cell, seed, seconds, True,
                                  device=device, t_start=t_start,
                                  bench=bench or harness.HERE)
    finally:
        tr.Tracer.start, tr.Tracer.stop = start, stop
    out = check(kept["summary"], kept["events"],
                harness.kernel_stages()["pcore"].PATTERN)
    out.update(workload=cell, seed=seed, correct=result["correct"],
               host_pslice_writer_calls=kept["calls"],
               metrics={k: v["value"] for k, v in result["metrics"].items()},
               device=result["device"])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out")
    args = ap.parse_args(argv)

    import torch

    from h264_bench import harness

    torch.set_num_threads(1)
    line = json.dumps(traced_run(harness.load_spec(), args.workload,
                                 args.seed, args.seconds,
                                 t_start=T_PROCESS))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
