"""One run of one benchmark cell: set-up, the measured window, the
comparison with the plain reference, the per-layer metrics.

Everything a cell needs is found by name: BENCHMARK.json's cell names a
configuration (configs/<config>.json: the program's EncoderConfig fields,
the chunk size and the reference module in reference/) and a traffic mix
(traffic/<traffic>.json, read by gen.py); each per-layer metric is
metrics/<metric>.py with a `read(run)`; each kernel stage is
kernels/<stage>.py with a profiler-name `PATTERN` and its `bound_s`.

The window is a closed loop of whole GOPs on one EncoderSession: the IDR
through encode_frame (host I420 bytes), then the GOP's P frames through
encode_frames_staged over chunks that set-up staged once: one call for the
ring's chunks of PIPELINE_CHUNK frames up to the GOP's last chunk, one call
for that last, shorter chunk. The GOP that crosses the end of --seconds is
finished and counted. Every GOP encodes the same pictures.
"""

from __future__ import annotations

import contextlib
import importlib
import importlib.util
import json
import os
import sys
import time

import numpy as np
import torch

from . import gen

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "media_tpu")


def load_spec() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def load_config(name: str, bench: str = HERE) -> dict:
    with open(os.path.join(bench, "configs", f"{name}.json")) as f:
        return json.load(f)


def load_module(kind: str, name: str, bench: str = HERE):
    """<kind>/<name>.py as a module. A name with a dot, the quantity split
    by the end-to-end metric it moves (device_idle.screen), is read by
    <kind>/<the part before the dot>.py where it has no file of its own."""
    path = os.path.join(bench, kind, f"{name}.py")
    if not os.path.exists(path):
        path = os.path.join(bench, kind, f"{name.split('.')[0]}.py")
    spec = importlib.util.spec_from_file_location(
        f"h264_bench_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def kernel_stages(bench: str = HERE) -> dict:
    """Every kernels/<stage>.py, by stage name."""
    return {f[:-3]: load_module("kernels", f[:-3], bench)
            for f in sorted(os.listdir(os.path.join(bench, "kernels")))
            if f.endswith(".py")}


def cell_metrics(spec: dict, cell: str, section: str) -> list:
    """The metrics of `section` that this cell reports."""
    return [m for m in spec[section]
            if cell in m.get("workloads", [cell])]


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


class GopPlan:
    """The frames of one GOP: the IDR's picture and the ring positions of
    its P frames, split into the staged calls: call A, whole chunks of
    `chunk` P frames; call B, the GOP's last, shorter chunk."""

    def __init__(self, gop: int, ring: int, chunk: int):
        self.ring, self.chunk, self.gop = ring, chunk, gop
        self.n_full = (gop - 1) // chunk  # chunks of `chunk` in call A
        # call B's P frames, numbered from 1 after the IDR
        self.tail = list(range(self.n_full * chunk + 1, gop))
        if not self.n_full or not self.tail:
            raise ValueError("the GOP must hold a whole chunk and end on a "
                             "shorter one")
        # Call A's chunks as ring frames; equal chunks are staged once.
        self.chunks = [tuple(self.ring_index(p) for p in
                             range(k * chunk + 1, (k + 1) * chunk + 1))
                       for k in range(self.n_full)]
        self.tail_ring = [self.ring_index(p) for p in self.tail]
        # The P frames that the reference encodes from the pictures alone:
        # the first chunk and the first frame of the next, so that one
        # hand-over between chunks is compared.
        self.head = list(range(1, min(chunk + 1, self.n_full * chunk) + 1))

    def ring_index(self, p: int) -> int:
        """Ring frame of the GOP's P frame p (1-based)."""
        return (p - 1) % self.ring


class Run:
    """What a per-layer metric and a kernel stage's bound read: counts of
    the window, the trace's summary, the geometry and the card's peaks."""

    def __init__(self, **kw):
        self.__dict__.update(kw)
        self.picture_bytes = self.R * self.C * 384  # 8-bit 4:2:0, MB-padded

    def hbm_s(self, n_bytes: float) -> float:
        """Seconds to move n_bytes at the card's memory rate."""
        return n_bytes / self.peaks["hbm_bytes_s"]


class Cell:
    """One cell's program side: its configuration, its traffic and, once
    staged, a session with the frames of one seed on the device."""

    def __init__(self, spec: dict, cell_name: str, device="cuda",
                 bench: str = HERE):
        w = next(w for w in spec["workloads"] if w["name"] == cell_name)
        self.cfg = load_config(w["config"], bench)
        self.traffic = gen.load(w["traffic"], bench)
        self.enc = self.cfg["encoder"]
        self.dev = torch.device(device)
        self.W, self.H = int(self.enc["width"]), int(self.enc["height"])
        self.plan = GopPlan(int(self.enc["gop_size"]),
                            int(self.traffic["ring_frames"]),
                            int(self.cfg["pipeline_chunk"]))

    def stage(self, seed: int) -> None:
        """Frames from the seed, a session, its staged chunks; then one
        IDR, one chunk and the GOP's last chunk to warm its shapes."""
        from media_tpu_torch.pipeline.codec import (EncoderConfig,
                                                    EncoderSession)

        plan = self.plan
        self.host = gen.to_host(gen.make_frames(self.traffic, self.W, self.H,
                                                seed, self.dev))
        self.idr_bytes = gen.i420(self.host[0])
        self.ring = self.host[1:]
        sess = EncoderSession(EncoderConfig(**self.enc), device=self.dev)
        sess.PIPELINE_CHUNK = plan.chunk
        staged = {}
        for key in plan.chunks:
            if key not in staged:
                (staged[key],) = sess.upload_frames(
                    [gen.i420(self.ring[i]) for i in key])
        self.chunks = list(staged.values())
        self.call_a = [staged[key] for key in plan.chunks]
        (self.tail,) = sess.upload_frames(
            [gen.i420(self.ring[i]) for i in plan.tail_ring])
        sess.encode_frame(self.idr_bytes)
        sess.encode_frames_staged(self.chunks[:1])
        sess.encode_frames_staged([self.tail])
        sess.reset_gop_state()
        self.sess = sess
        _sync(self.dev)

    def window(self, seconds: float, prof=None) -> tuple:
        """Whole GOPs until `seconds` have passed. Returns (gops, idr_ms,
        window seconds). Of the first GOP it keeps every access unit; of
        each later one its IDR and the count of its P access units that
        differ from the first GOP's (every GOP encodes the same pictures).
        Of each GOP it keeps its IDR's picture id and its count and bytes
        of access units; and of the first and of the latest GOP the
        session's reference planes after the IDR and after each call (kept
        for every GOP they would grow the device's memory through the
        window)."""
        sess, dev = self.sess, self.dev
        gops, idr_ms = [], []
        t0 = time.perf_counter()
        deadline = t0 + seconds
        while True:
            ti = time.perf_counter()
            g = {"idr_pic_id": sess.idr_pic_id}
            with _span(prof, "bench.idr"):
                aus = [sess.encode_frame(self.idr_bytes)]
                _sync(dev)
            idr_ms.append((time.perf_counter() - ti) * 1e3)
            recon = {"idr_recon": sess.recon}
            with _span(prof, "bench.staged"):
                aus += sess.encode_frames_staged(self.call_a)
            recon["mid_recon"] = sess.recon
            with _span(prof, "bench.staged_tail"):
                aus += sess.encode_frames_staged([self.tail])
            recon["end_recon"] = sess.recon
            g.update(ms=(time.perf_counter() - ti) * 1e3, n=len(aus),
                     idr_bytes=len(aus[0]),
                     p_bytes=sum(len(a) for a in aus[1:]), idr=aus[0],
                     **recon)
            if not gops:
                g["aus"] = aus
            else:
                first = gops[0]["aus"]
                g["p_differ"] = (sum(a != b for a, b in zip(aus[1:],
                                                             first[1:]))
                                 + abs(len(aus) - len(first)))
            if len(gops) > 1:  # the planes of the GOP before go
                for k in recon:
                    gops[-1].pop(k, None)
            gops.append(g)
            if time.perf_counter() >= deadline:
                break
        _sync(dev)
        return gops, idr_ms, time.perf_counter() - t0

    def staged_writes(self) -> int:
        """Samples of the staged chunks that differ from their host
        copies: the session must never write its inputs."""
        return sum(int((ch[j].cpu().numpy() != ch[j + 3]).sum())
                   for ch in self.chunks + [self.tail] for j in range(3))

    def release(self) -> None:
        """Free the session and the staged chunks."""
        del self.sess, self.chunks, self.tail, self.call_a
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, **kw):
        mod = importlib.import_module(
            f"h264_bench.reference.{self.cfg['reference']}")
        dev = self.dev if self.dev.type == "cuda" else torch.device("cpu")
        return mod.ReferenceEncoder(self.enc, device=dev, **kw)


def run_cell(spec: dict, cell_name: str, seed: int, seconds: float,
             trace: bool, device="cuda", t_start: float | None = None,
             bench: str = HERE) -> dict:
    """One run of a cell. Returns the result mapping (correct, attempted,
    failed, metrics, device, compared, and with trace the breakdown).
    t_start: the process's start on the perf_counter clock (set-up is
    counted from it); bench: the folder whose files the cell's names
    find."""
    if t_start is None:
        t_start = time.perf_counter()
    from media_tpu_torch.entropy import device_cavlc

    cell = Cell(spec, cell_name, device, bench)
    dev, plan = cell.dev, cell.plan
    cell.stage(seed)
    setup_s = time.perf_counter() - t_start
    log(f"set-up {setup_s:.3f} s")

    launches0 = device_cavlc.pack_pslice_device.launches
    prof = None
    if trace:
        from . import trace as tr
        prof = tr.Tracer(dev)
        prof.start()
    gops, idr_ms, window_s = cell.window(seconds, prof)
    gt = sorted(g["ms"] for g in gops)
    log(f"window {window_s:.3f} s, {len(gops)} GOPs, ms a GOP min "
        f"{gt[0]:.1f} median {gt[len(gt) // 2]:.1f} max {gt[-1]:.1f}; "
        f"bytes an IDR {gops[0]['idr_bytes']}, a P frame "
        f"{gops[0]['p_bytes'] / max(gops[0]['n'] - 1, 1):.0f}")
    summary = None
    if prof:
        t1 = time.perf_counter()
        summary = prof.stop()
        log(f"trace read {time.perf_counter() - t1:.3f} s")
    launches = device_cavlc.pack_pslice_device.launches - launches0
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)

    attempted = len(gops) * plan.gop
    returned = sum(g["n"] for g in gops)
    n_bytes = {"idr": sum(g["idr_bytes"] for g in gops),
               "p": sum(g["p_bytes"] for g in gops)}
    staged_writes = cell.staged_writes()
    cell.release()

    t2 = time.perf_counter()
    compared = compare_with(cell.reference(), plan, gops, idr=cell.host[0],
                            ring=cell.ring, seed=seed)
    log(f"reference and comparison {time.perf_counter() - t2:.3f} s")
    compared["missing_aus"] = {"value": attempted - returned, "limit": 0}
    compared["staged_input_writes"] = {"value": staged_writes, "limit": 0}
    correct = all(c["value"] <= c["limit"] for c in compared.values())

    metrics = {}
    if not trace:
        e2e = {"encode_fps": returned / window_s, "setup_s": setup_s}
        for m in cell_metrics(spec, cell_name, "end_to_end"):
            metrics[m["name"]] = {"value": e2e[m["name"].split(".")[0]],
                                  "unit": m["unit"]}
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else "cpu"),
                   "count": 1, "memory_peak_bytes": int(peak)}
    out = {"correct": correct, "attempted": attempted,
           "failed": attempted - returned}
    if trace:
        n_gops = len(gops)
        run = Run(trace=summary, frames=returned, idr_frames=n_gops,
                  p_frames=returned - n_gops, idr_ms=idr_ms,
                  counters={"pack_pslice_device.launches": launches},
                  width=cell.W, height=cell.H, R=-(-cell.H // 16),
                  C=-(-cell.W // 16), au_bytes=n_bytes,
                  stages=kernel_stages(bench), peaks=device_peaks(dev))
        for m in cell_metrics(spec, cell_name, "per_layer"):
            value = load_module("metrics", m["name"], bench).read(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device_info["busy_s"] = summary.busy_s
        device_info["window_s"] = summary.window_s
        out["breakdown"] = summary.breakdown()
    out["metrics"] = metrics
    out["device"] = device_info
    out["compared"] = compared
    return out


def _np(plane) -> np.ndarray:
    return plane.cpu().numpy() if torch.is_tensor(plane) else np.asarray(plane)


def log(msg: str) -> None:
    print(f"[h264_bench] {msg}", file=sys.stderr, flush=True)


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _span(prof, name: str):
    """A named span in the trace (nothing without one)."""
    return prof.span(name) if prof else contextlib.nullcontext()


def device_peaks(dev) -> dict:
    """The card's peaks (peaks.json by device name) with its SM count and
    its highest SM clock as nvidia-smi reads it."""
    import subprocess

    with open(os.path.join(HERE, "peaks.json")) as f:
        table = json.load(f)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    peaks = dict(table.get(name, {}))
    if dev.type == "cuda":
        peaks["sm_count"] = torch.cuda.get_device_properties(
            dev).multi_processor_count
        try:
            peaks["max_sm_mhz"] = float(subprocess.run(
                ["nvidia-smi", "-i", str(dev.index or 0),
                 "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                check=True, capture_output=True, text=True,
                timeout=30).stdout.split()[0])
        except (OSError, subprocess.SubprocessError, ValueError, IndexError):
            pass  # the P core's bound then has no rate, and reads nothing
    return peaks


def compare_with(ref, plan: GopPlan, gops: list, *, idr, ring,
                 seed: int) -> dict:
    """The numbers that decide `correct`, each with its limit.

    The reference encodes the IDR's picture and the head of the GOP's P
    frames (plan.head: the first chunk and the first frame of the next)
    from the pictures alone, and, from the program's reference planes after
    call A of a GOP drawn from the seed among those whose planes were kept,
    call B's P frames. Against that: every GOP's IDR, and the first GOP's
    head and call B access units, byte for byte; the reference planes after
    the IDR and after call B of every GOP whose planes were kept, sample
    for sample; and every later GOP's P access units against the first
    GOP's, byte for byte."""
    first = gops[0] if gops else {}
    whole = [g for g in gops if g["n"] == plan.gop]
    planes = [g for g in whole if "mid_recon" in g]
    au_bad = recon_bad = 0
    compared = bool(planes) and first.get("n") == plan.gop
    if compared:
        au_of, rec0 = ref.idr(*idr)
        want, rec = {}, rec0
        for p in plan.head:
            want[p], rec = ref.p(*ring[plan.ring_index(p)], rec, p)
        pick = planes[np.random.default_rng(seed).integers(len(planes))]
        rec = pick["mid_recon"]
        for p in plan.tail:
            want[p], rec = ref.p(*ring[plan.ring_index(p)], rec, p)
        au_bad = sum(g["idr"] != au_of(g["idr_pic_id"]) for g in gops)
        au_bad += sum(first["aus"][p] != a for p, a in want.items())
        for g in planes:
            for got, ref_planes in ((g["idr_recon"], rec0),
                                    (g["end_recon"], rec)):
                recon_bad += sum(int((_np(a) != b).sum())
                                 for a, b in zip(got, ref_planes))
    return {"au_mismatch": {"value": au_bad, "limit": 0},
            "recon_mismatch": {"value": recon_bad, "limit": 0},
            "gop_mismatch": {"value": sum(g.get("p_differ", 0)
                                          for g in gops), "limit": 0},
            "gops_not_compared": {"value": int(not compared), "limit": 0}}
