#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (media_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py              # needs one CUDA device
    python3 chip_smoke.py --kernels    # phases 1-3 only, prints no result

Phases, one line each; nothing is caught, any failure exits non-zero:
  1. environment: nvidia-smi name/power limit, torch/CUDA versions;
  2. build: nvcc compiles media_tpu_torch/csrc/*.cu for sm_90a (one process
     per source);
  3. kernels == plain versions, exact equality, timed with one CUDA event
     pair per launch on a fresh copy of the unfiltered input (median): the
     whole-frame deblocking kernel at the 1080p geometry (R=68, C=120),
     uniform QP 22/30/36 and one per-MB QP map, at 4K (R=135, C=240), at
     (1,1), (1,5), (5,1), with its rows shared out among 5 persistent
     blocks, 20 launches on one input with one digest, and compiled without
     its filters (the floor of its dependent chain); the wave-step
     deblocking kernel on the patches and meta rows of the widest 1080p
     wave (N=60) and of N=1, QP 22/30/36, and in place on the planes
     against gather -> plain step -> scatter; the routes of deblock_frame
     against each other (whole frame, per wave as a CUDA graph, per wave
     launch by launch); and torch.argmin's first-minimum rule on CUDA;
  4. native: g++ builds the host library (media_tpu_torch/csrc/*.cpp, tables
     generated from the package); on the symbols of one 1080p I and one P
     frame of the clip, each C++ writer, parser and the transcoder against
     the Python coder (bytes or arrays equal), with both times;
  5. encode path at constant QP: EncoderSession(1920x1080, QP 30, CAVLC,
     deblock, entropy on the device) on its default device: an IDR via
     encode_frame, 4 P frames via encode_frames, 4 more via upload_frames +
     encode_frames_staged; the deblock launch count, the AU digests against
     the ones recorded from the JAX package
     (media_tpu_torch/golden_1080p.json, written by
     tools/record_torch_golden.py), P-frame fps, a per-stage split and the
     last recon's PSNR; plus a small clip encoded on CUDA and on the CPU
     (which the tests hold to the JAX package) must give the same bytes;
  6. decode path: TpuDecoder() (default device, whole-frame deblock route)
     decodes phase 5's IDR + 4 P access units: picture 0 must equal the
     encoder's recon after the IDR and picture 4 its recon after
     encode_frames, every picture's digest the one recorded from the JAX
     TpuDecoder, with one whole-frame kernel launch per picture; decode fps
     and the split host parse / upload / device per picture, the P parse
     also through the Python parser; then TpuDecoder(deblock_kernel="wave")
     decodes the IDR + 1 P to the same planes through 254 wave-step
     launches per picture; plus a small stream decoded on CUDA and on the
     CPU must give the same planes;
  7. the reference operating point at full width: CBR at 8 Mbit/s with
     CABAC (cabac_init_idc 1, deblock, PIPELINE_CHUNK 8): IDR + 8 P through
     encode_frames and 8 P staged; per AU the digest, per P frame the device
     loop's bits and QP (exact), the rate controller's floats (1e-5), all
     against the golden, so that a divergence names its first frame; the
     achieved bitrate, P fps, a per-stage split with the whole-frame kernel
     in per-MB-QP mode; then IDR + 4 P with adaptive_qp and IDR + 4 P CBR
     with CAVLC against their goldens; no refusal of a C++ routine; one
     whole-frame kernel launch per picture;
  8. CABAC decode: TpuDecoder() on phase 7's IDR + 8 P: planes equal to the
     encoder's recon and to the JAX TpuDecoder's digests, fps and the split;
  9. the operating point as the JAX package's bench defines it, with the
     I_4x4 / I_16x16 decision in the IDR: phase 7's first run with
     i4x4=True, held to its golden in the same way; the IDR's time, size, QP
     and count of I_4x4 macroblocks (> 0, the golden's); then TpuDecoder()
     on its IDR + 8 P, as in phase 8;
 10. four slices a picture: (a) CAVLC at constant QP with
     deblock_across_slices=False (idc 2: the whole-frame kernel with
     slice-local strengths), IDR + 4 P through the host C++ writers, the P
     pictures decoded by both deblock routes (one of them through the 254
     wave-step launches) to the encoder's recon; (b) CABAC under CBR (the
     host rate loop, a QP per frame), IDR + 4 P, QPs the golden's, decoded
     by TpuDecoder();
 11. the IBPBP B-GOP (b_frames=1): 5 frames through encode_frames come out
     as IDR, P, B, P, B; three whole-frame kernel launches (no B picture is
     deblocked); ms per anchor and per B picture; TpuDecoder refuses the
     stream as the JAX one does;
 12. lossless (all I_PCM): one frame, assembled on the host; the samples
     read back out of the AU equal the input.
Phases 9 to 12 hold every AU and decoded picture to the golden as well.
The second-to-last line is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import time

import numpy as np

WIDTH, HEIGHT, QP = 1920, 1080, 30
N_P = 8          # P frames per phase of the rate-controlled main path
N_CQ_P = 4       # P frames per phase of the constant-QP path (and decoded)
N_WAVE_P = 1     # P pictures decoded through the per-wave deblock route
CHUNK = 8        # session PIPELINE_CHUNK, as the JAX package's bench uses
SEED = 0
R_MB, C_MB = -(-HEIGHT // 16), -(-WIDTH // 16)  # 68 x 120 macroblocks
ROOT = os.path.dirname(os.path.abspath(__file__))

# Published peaks of one H100 SXM (NVIDIA data sheet): HBM bytes/s, and the
# float32 rate outside the tensor cores, taken as the ceiling of the
# kernels' int32 arithmetic (the data sheet gives no integer rate).
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = 67e12
# Integer operations of one line filter on its longest path, counted from
# csrc/deblock_filters.cuh (loads, compares, adds, shifts, clips, stores).
OPS_LUMA_LINE = 64
OPS_CHROMA_LINE = 28


def synthetic_video(w, h, n, seed=0):
    """Natural-statistics scene: smooth texture, sub-pixel global pan, a
    moving object, and mild sensor noise (a copy of the JAX package's bench
    clip, so the golden digests recorded from it apply here)."""
    rng = np.random.default_rng(seed)
    big = rng.integers(0, 256, (h + 160, w + 160)).astype(np.float64)
    for _ in range(3):  # low-pass into natural-image-like statistics
        big = (big + np.roll(big, 1, 0) + np.roll(big, 1, 1)
               + np.roll(big, 3, 0) + np.roll(big, 3, 1)) / 5
    big = (big - big.min()) / (big.max() - big.min()) * 220 + 16
    frames = []
    for t in range(n):
        dx, dy = 2.5 * t % 96, 1.25 * t % 96
        ix, iy = int(dx), int(dy)
        fx, fy = dx - ix, dy - iy
        a = big[iy : iy + h, ix : ix + w]
        b = big[iy : iy + h, ix + 1 : ix + w + 1]
        c = big[iy + 1 : iy + h + 1, ix : ix + w]
        d = big[iy + 1 : iy + h + 1, ix + 1 : ix + w + 1]
        y = ((1 - fx) * (1 - fy) * a + fx * (1 - fy) * b
             + (1 - fx) * fy * c + fx * fy * d)
        bx = (40 + 11 * t) % max(w - 80, 1)
        by = (30 + 7 * t) % max(h - 80, 1)
        y[by : by + 64, bx : bx + 64] = 255 - y[by : by + 64, bx : bx + 64]
        y = y + rng.normal(0, 1.5, y.shape)  # mild sensor noise
        y = y.round().clip(0, 255).astype(np.uint8)
        u = (y[::2, ::2] // 2 + 40).astype(np.uint8)
        v = (y[::2, ::2] // 3 + 70).astype(np.uint8)
        frames.append((y, u, v))
    return frames


def clip_i420(w=WIDTH, h=HEIGHT, n=1 + 2 * N_P, seed=SEED):
    """The smoke clip as packed I420 buffers, and their sha256."""
    bufs = [y.tobytes() + u.tobytes() + v.tobytes()
            for y, u, v in synthetic_video(w, h, n, seed)]
    return bufs, hashlib.sha256(b"".join(bufs)).hexdigest()


def _sha(aus) -> str:
    return hashlib.sha256(b"".join(aus)).hexdigest()


# The reference operating point (CABAC with a bitrate target) and its two
# neighbours, each as (EncoderConfig fields beside width/height/qp/gop_size,
# P frames through encode_frames, P frames staged after them).
CBR = dict(rc_mode="cbr", bitrate=8_000_000, framerate=30, deblock=True)
RATE_RUNS = {
    "cbr_cabac": (dict(cabac=True, cabac_init_idc=1, **CBR), N_P, N_P),
    "cbr_cabac_aq": (dict(cabac=True, cabac_init_idc=1, adaptive_qp=True,
                          **CBR), 4, 0),
    "cbr_cavlc": (dict(CBR), 4, 0),
    # The operating point as the JAX package's bench defines it: with the
    # I_4x4 / I_16x16 decision in the IDR.
    "cbr_cabac_i4x4": (dict(cabac=True, cabac_init_idc=1, i4x4=True, **CBR),
                       N_P, N_P),
}
# The runs of phase 7; phase 9 drives the last entry.
RATE_RUNS_PHASE7 = ("cbr_cabac", "cbr_cabac_aq", "cbr_cavlc")
I4_RUN = "cbr_cabac_i4x4"

# The other tools of EncoderConfig, each as (fields beside
# width/height/qp/gop_size, frames of the clip; the first is the IDR).
N_TOOL = 5
TOOL_RUNS = {
    "slices4_cavlc": (dict(num_slices=4, deblock_across_slices=False),
                      N_TOOL),
    "slices4_cabac_cbr": (dict(num_slices=4, cabac=True, cabac_init_idc=1,
                               **CBR), N_TOOL),
    "bgop": (dict(b_frames=1), N_TOOL),
    "lossless": (dict(lossless=True), 1),
}
# The runs whose stream the device decoder takes (B and I_PCM streams are
# outside it in both packages).
TOOL_RUNS_DECODED = ("slices4_cavlc", "slices4_cabac_cbr")


def _host(x):
    """A device array of either package as numpy."""
    return np.asarray(x.cpu() if hasattr(x, "cpu") else x)


def tap_rate_loop(sess) -> list:
    """Record what the session's device rate loop returns, chunk by chunk:
    wraps the frame encoder's two CBR entries and returns the list they
    append (bits, qps, (qp, buf, cplx)) to, still as device arrays, so that
    the tap reads nothing back while the session runs. Works on the JAX
    package's session as on the port's: same names, same tuple."""
    enc = sess._frame_encoder
    log: list = []

    def wrap(fn):
        def tapped(*a, **kw):
            out = fn(*a, **kw)
            log.append((out[1], out[2], out[4]))
            return out
        return tapped

    enc.encode_pframes_cbr_dev = wrap(enc.encode_pframes_cbr_dev)
    enc.encode_pframes_cbr = wrap(enc.encode_pframes_cbr)
    return log


def rate_record(sess, aus, log) -> dict:
    """What a rate-controlled run is held to: a digest and a size per AU,
    the device loop's CAVLC bits and QP per P frame and its (qp, buf, cplx)
    carry after each chunk, and the session's final controller state."""
    rc = [r if isinstance(r, dict) else dict(zip(("qp", "buf", "cplx"), r))
          for _b, _q, r in log]
    return {
        "au_sha256": [hashlib.sha256(a).hexdigest() for a in aus],
        "au_bytes": [len(a) for a in aus],
        "bits": [int(b) for bits, _q, _r in log for b in _host(bits)],
        "qps": [int(q) for _b, qps, _r in log for q in _host(qps)],
        "rc_chunks": [[float(_host(r[k])) for k in ("qp", "buf", "cplx")]
                      for r in rc],
        "rc_final": {**{k: float(v) for k, v in sess.rc_state.items()},
                     "cabac_scale": float(sess._cabac_scale),
                     "rc_corr": float(sess._rc_corr)},
    }


def tap_i4_mbs(sess) -> list:
    """Record the number of I_4x4 macroblocks of every intra frame the
    session encodes (0 without the I_4x4 decision). Works on the JAX
    package's session as on the port's."""
    enc = sess._frame_encoder
    inner = enc.encode_iframe
    log: list = []

    def tapped(*a, **kw):
        res = inner(*a, **kw)
        log.append(0 if res.is_i4 is None else int(np.asarray(res.is_i4).sum()))
        return res

    enc.encode_iframe = tapped
    return log


def tap_slice_qps(sess) -> list:
    """Record the QP of every P picture the session assembles from host
    symbols (the multi-slice paths; under CBR the host rate loop's QP).
    Works on the JAX package's session as on the port's."""
    inner = sess._pslice_au
    log: list = []

    def tapped(fields, qp=None, **kw):
        log.append(int(sess.cfg.qp if qp is None else qp))
        return inner(fields, qp=qp, **kw)

    sess._pslice_au = tapped
    return log


def drive_tool_run(sess, bufs, n: int, sync=lambda: None) -> dict:
    """n frames of the clip through one session: the IDR through
    encode_frame, the rest through one call of encode_frames (a B-GOP
    session takes all n through encode_frames, so that the call reorders
    them itself). Works on the JAX package's session as on the port's.
    Returns "aus", "qps" (tap_slice_qps'), "i4_mbs", "recon_idr" (the
    reference planes after the first frame; None for a B-GOP), "t_idr" and
    "t_rest" in seconds."""
    out = {"qps": tap_slice_qps(sess), "i4_mbs": tap_i4_mbs(sess),
           "recon_idr": None, "t_idr": 0.0}

    def timed(fn):
        sync()
        t0 = time.perf_counter()
        res = fn()
        sync()
        return res, time.perf_counter() - t0

    if sess.cfg.b_frames:
        out["aus"], out["t_rest"] = timed(lambda: sess.encode_frames(bufs[:n]))
        return out
    idr, out["t_idr"] = timed(lambda: sess.encode_frame(bufs[0]))
    out["recon_idr"] = tuple(sess.recon)
    rest, out["t_rest"] = timed(lambda: sess.encode_frames(bufs[1:n]))
    out["aus"] = [idr] + rest
    return out


def tool_record(sess, run) -> dict:
    """What a run of TOOL_RUNS is held to: a digest and a size per AU, the
    QP of every P picture assembled on the host, and under CBR the final
    state of the host rate loop."""
    rec = {"au_sha256": [hashlib.sha256(a).hexdigest() for a in run["aus"]],
           "au_bytes": [len(a) for a in run["aus"]],
           "qps": list(run["qps"])}
    if sess.cfg.rc_mode == "cbr":
        rec["rc_final"] = {k: float(v) for k, v in sess.rc_state.items()}
    return rec


def drive_rate_run(sess, bufs, n_p: int, n_staged: int, sync=lambda: None):
    """IDR through encode_frame, n_p P frames through encode_frames, then
    n_staged through upload_frames + encode_frames_staged, each phase timed
    on the host clock between calls of `sync` (the device's synchronise,
    where there is one). Works on the JAX package's session as on the
    port's. Returns a dict: "aus" (the IDR and the first run), "staged",
    "log" (tap_rate_loop's), "i4_mbs" (tap_i4_mbs'), "recon_idr" and "recon_run" (the reference
    planes after the IDR and after the first run), "t_idr", "t_run",
    "t_staged" in seconds."""
    out = {"log": tap_rate_loop(sess), "i4_mbs": tap_i4_mbs(sess),
           "staged": [], "t_staged": 0.0}

    def timed(fn):
        sync()
        t0 = time.perf_counter()
        res = fn()
        sync()
        return res, time.perf_counter() - t0

    idr, out["t_idr"] = timed(lambda: sess.encode_frame(bufs[0]))
    out["recon_idr"] = tuple(sess.recon)
    run, out["t_run"] = timed(lambda: sess.encode_frames(bufs[1 : 1 + n_p]))
    out["recon_run"] = tuple(sess.recon)
    out["aus"] = [idr] + run
    if n_staged:
        chunks = sess.upload_frames(bufs[1 + n_p : 1 + n_p + n_staged])
        out["staged"], out["t_staged"] = timed(
            lambda: sess.encode_frames_staged(chunks))
    return out


def planes_sha(frame) -> str:
    """sha256 over the Y, U, V planes of a decoded picture."""
    return hashlib.sha256(b"".join(
        np.ascontiguousarray(p).tobytes()
        for p in (frame.y, frame.u, frame.v))).hexdigest()


def _psnr(a, b) -> float:
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return float("inf") if mse == 0 else 10.0 * np.log10(255.0 ** 2 / mse)


def _cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of fn() on the current stream, by CUDA events."""
    import torch

    fn()  # warm-up
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _cuda_median_ms(fn, fresh, reps: int) -> float:
    """Median milliseconds of fn(*fresh()) on the current stream: one CUDA
    event pair around each call alone, every call on a fresh copy of its
    input (made outside the pair), so that each call does its caller's
    work."""
    import torch

    fn(*fresh())  # warm-up
    pairs = []
    for _ in range(reps):
        args = fresh()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args)
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(b) for a, b in pairs]))


def _bound(n_bytes: int, meta) -> dict:
    """The least time the card could take: bytes moved once over the memory
    rate against the line filters this meta asks for over the ALU rate."""
    luma_lines = int((meta[:, 0:32] > 0).sum()) * 4
    chroma_lines = int((meta[:, 64:80] > 0).sum()) * 2 * 2  # U and V
    ops = luma_lines * OPS_LUMA_LINE + chroma_lines * OPS_CHROMA_LINE
    t_bytes, t_ops = n_bytes / PEAK_BYTES_S, ops / PEAK_OPS_S
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None}  # no PyTorch call computes this function


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _smooth_planes(R, C, g, dev):
    """Random planes smoothed so that many edges pass the alpha/beta tests."""
    import torch

    return [(torch.randint(0, 256, (R * s, C * s), generator=g,
                           dtype=torch.int32) // 8 + 100).to(torch.uint8).to(dev)
            for s in (16, 8, 8)]


def _random_bs(R, C, g):
    import torch

    bs_v = torch.randint(0, 5, (R * 4, C * 4), generator=g, dtype=torch.int32)
    bs_h = torch.randint(0, 5, (R * 4, C * 4), generator=g, dtype=torch.int32)
    bs_v[:, 0] = 0
    bs_h[0, :] = 0
    return bs_v, bs_h


def phase_environment():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script needs an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    print(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} device "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    return smi


def phase_build():
    from media_tpu_torch import kernels

    lib, secs = kernels.build(verbose=True)
    kernels.load()
    print(f"[build] {os.path.relpath(lib, ROOT)} nvcc {secs:.2f} s")
    from media_tpu_torch import native

    lib, secs = native.build()
    handle = native.load()
    found = [sym for sym in native.SYMBOLS if hasattr(handle, sym)]
    print(f"[native] {os.path.relpath(lib, ROOT)} g++ {secs:.2f} s, symbols "
          f"{len(found)}/{len(native.SYMBOLS)}: {' '.join(found)}")


def _digest(planes) -> str:
    return hashlib.sha256(b"".join(
        p.cpu().numpy().tobytes() for p in planes)).hexdigest()


def _equal_planes(got, want, what: str) -> int:
    """Raise unless the plane triples are equal; returns max |difference|."""
    import torch

    worst = 0
    for a, b, name in zip(got, want, "yuv"):
        err = int((a.int() - b.int()).abs().max())
        worst = max(worst, err)
        if not torch.equal(a, b):
            raise AssertionError(f"{what}: plane {name} differs, max |err| "
                                 f"{err}")
    return worst


def phase_kernel(smi: str) -> dict:
    import torch

    from media_tpu_torch.ops.deblock_wave import (
        deblock_wave, deblock_wave_plain, launch_deblock_wave)
    from media_tpu_torch.ops.transform import chroma_qp
    from media_tpu_torch.pipeline.deblock_apply import build_meta

    dev = torch.device("cuda")
    R, C = R_MB, C_MB
    g = torch.Generator(device="cpu").manual_seed(7)
    planes = _smooth_planes(R, C, g, dev)
    bs_v, bs_h = _random_bs(R, C, g)
    qp_map = (30 + torch.randint(0, 9, (R, C), generator=g,
                                 dtype=torch.int32) - 4).to(dev)
    cases = [(qp, None) for qp in (22, 30, 36)] + [(30, qp_map)]
    max_err = 0
    rec = {}

    def fresh():
        return [p.clone() for p in planes]

    for qp, qmap in cases:
        meta = build_meta(qp, int(chroma_qp(qp)), bs_v.to(dev), bs_h.to(dev),
                          R, C, qp_map=qmap)
        got = fresh()
        deblock_wave(*got, meta, R, C)
        want = fresh()
        timed = qmap is None and qp == 30
        if timed:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        deblock_wave_plain(*want, meta, R, C)
        torch.cuda.synchronize()
        if timed:
            rec["plain_ms"] = (time.perf_counter() - t0) * 1e3
        what = f"deblock kernel vs plain, qp {qp}, qp_map {qmap is not None}"
        max_err = max(max_err, _equal_planes(got, want, what))
        changed = sum(int((a != p).sum()) for a, p in zip(got, planes))
        if changed == 0:
            raise AssertionError("deblock test case filtered nothing")
        # The rows shared out among 5 persistent blocks: the route a grid
        # takes that the device cannot hold at once.
        few = fresh()
        launch_deblock_wave(*few, meta, R, C, max_blocks=5)
        _equal_planes(few, want, what + ", 5 persistent blocks")
        print(f"[kernel] deblock_wave qp={qp} qp_map={qmap is not None} "
              f"equal=True (also on 5 persistent blocks) "
              f"samples_changed={changed}")
        if not timed:
            continue
        # 20 launches on fresh copies of one input: one digest (a race
        # between rows would show as a digest that differs).
        digests = set()
        for _ in range(20):
            work = fresh()
            deblock_wave(*work, meta, R, C)
            digests.add(_digest(work))
        if digests != {_digest(want)}:
            raise AssertionError(f"deblock kernel: {len(digests)} digests "
                                 "over 20 launches on one input")
        print(f"[kernel] deblock_wave 20 launches on one 1080p input: one "
              f"digest {_digest(want)[:16]} == plain")

        def run(filt, blocks=0):
            return lambda *w: launch_deblock_wave(*w, meta, R, C,
                                                  with_filter=filt,
                                                  max_blocks=blocks)

        rec["ms"] = _cuda_median_ms(run(True), fresh, 30)
        rec["chain_floor_ms"] = _cuda_median_ms(run(False), fresh, 30)
        few_ms = _cuda_median_ms(run(True, 5), fresh, 10)
        # Planes read once and written once, meta read once.
        rec.update(_bound(2 * _nbytes(*planes) + _nbytes(meta), meta))
        print(f"[kernel] deblock_wave 1080p (R={R}, C={C}) kernel "
              f"{rec['ms']:.4f} ms (median of 30, each on fresh planes) "
              f"chain floor {rec['chain_floor_ms']:.4f} ms (same kernel "
              f"without its filters) on 5 persistent blocks {few_ms:.4f} ms "
              f"plain {rec['plain_ms']:.4f} ms bound {rec['bound_ms']:.6f} "
              f"ms by {rec['bound_by']} | {smi}")

    # Other geometries: 4K (more MB rows than the card has SMs), and the
    # three degenerate ones.
    for R2, C2 in ((135, 240), (1, 1), (1, 5), (5, 1)):
        g2 = torch.Generator(device="cpu").manual_seed(R2 * C2)
        src = _smooth_planes(R2, C2, g2, dev)
        bv, bh = (b.to(dev) for b in _random_bs(R2, C2, g2))
        meta = build_meta(30, int(chroma_qp(30)), bv, bh, R2, C2)
        got = [p.clone() for p in src]
        deblock_wave(*got, meta, R2, C2)
        want = [p.clone() for p in src]
        deblock_wave_plain(*want, meta, R2, C2)
        torch.cuda.synchronize()
        max_err = max(max_err, _equal_planes(
            got, want, f"deblock kernel vs plain, R={R2} C={C2}"))
        line = f"[kernel] deblock_wave R={R2} C={C2} equal=True"
        if R2 * C2 > 1000:
            ms = _cuda_median_ms(
                lambda *w: launch_deblock_wave(*w, meta, R2, C2),
                lambda: [p.clone() for p in src], 10)
            line += f" kernel {ms:.4f} ms | {smi}"
        print(line)

    # First-minimum rule of argmin on CUDA for tied int32 costs (MVs and
    # modes depend on it).
    rng = np.random.default_rng(1)
    costs = rng.integers(0, 4, (8160, 289)).astype(np.int32)
    got = torch.argmin(torch.as_tensor(costs, device=dev), dim=1).cpu().numpy()
    if not np.array_equal(got, np.argmin(costs, axis=1)):
        raise AssertionError("torch.argmin on CUDA does not keep the first "
                             "minimum")
    print("[kernel] argmin keeps the first minimum on CUDA ties: True")
    return {"max_abs_err": max_err, **rec}


def phase_kernel_step(smi: str) -> dict:
    """The wave-step kernel against its plain version, on gathered patches
    and in place on the planes, at the waves the per-wave route runs at
    1080p; and that route, as a CUDA graph and launch by launch, against
    the whole-frame one."""
    import torch

    from media_tpu_torch.ops.deblock_pallas import (
        deblock_wave_step, deblock_wave_step_inplace,
        deblock_wave_step_inplace_plain, deblock_wave_step_plain,
        wave_patch_indices)
    from media_tpu_torch.ops.deblock_wave import n_waves, run_waves
    from media_tpu_torch.ops.transform import chroma_qp
    from media_tpu_torch.pipeline.deblock_apply import (
        build_meta, deblock_frame)

    dev = torch.device("cuda")
    R, C = R_MB, C_MB
    g = torch.Generator(device="cpu").manual_seed(11)
    planes = _smooth_planes(R, C, g, dev)
    bs_v, bs_h = (b.to(dev) for b in _random_bs(R, C, g))
    waves = wave_patch_indices(R, C, dev)
    widths = [len(w[4]) for w in waves]
    widest = widths.index(max(widths))
    if max(widths) != min(R, (C + 1) // 2) or widths[0] != 1:
        raise AssertionError(f"waves: widest {max(widths)}, first "
                             f"{widths[0]}")

    def fresh():
        return [p.clone() for p in planes]

    max_err = 0
    rec = {}
    for qp in (22, 30, 36):
        meta = build_meta(qp, int(chroma_qp(qp)), bs_v, bs_h, R, C)
        for k in (widest, 0):
            # Patches in, patches out.
            ry, cy, rc, cc, rows = waves[k][:5]
            patches = [planes[0][ry, cy], planes[1][rc, cc],
                       planes[2][rc, cc]]
            m = meta[rows]
            got = deblock_wave_step(*patches, m)
            want = deblock_wave_step_plain(*patches, m)
            torch.cuda.synchronize()
            what = f"deblock_wave_step vs plain, qp {qp}, N {len(rows)}"
            max_err = max(max_err, _equal_planes(got, want, what))
            # In place on the planes against gather -> plain -> scatter.
            here, there = fresh(), fresh()
            deblock_wave_step_inplace(*here, meta, R, C, k)
            deblock_wave_step_inplace_plain(*there, meta, R, C, k)
            torch.cuda.synchronize()
            max_err = max(max_err, _equal_planes(here, there,
                                                 what + ", in place"))
            changed = sum(int((a != p).sum()) for a, p in zip(here, planes))
            # One MB at QP 22 may pass no alpha/beta test; a wave of 60 does.
            if changed == 0 and (k == widest or qp == 36):
                raise AssertionError("wave-step test case filtered nothing")
            if qp == 30 and k == widest:
                rec["ms"] = _cuda_median_ms(
                    lambda *w: deblock_wave_step_inplace(*w, meta, R, C, k),
                    fresh, 50)
                rec["plain_ms"] = _cuda_median_ms(
                    lambda *w: deblock_wave_step_inplace_plain(
                        *w, meta, R, C, k), fresh, 3)
                rec["patch_form_ms"] = _cuda_median_ms(
                    lambda: deblock_wave_step(*patches, m), lambda: (), 50)
                # Patches read once and written once, meta rows read once.
                rec.update(_bound(2 * _nbytes(*patches) + _nbytes(m), m))
            print(f"[kernel] deblock_wave_step qp={qp} N={len(rows)} "
                  f"patches equal=True in place equal=True "
                  f"samples_changed={changed}")
    print(f"[kernel] deblock_wave_step N={max(widths)} (widest wave of "
          f"R={R}, C={C}) in place {rec['ms']:.4f} ms a launch (median of "
          f"50, each on fresh planes) on gathered patches "
          f"{rec['patch_form_ms']:.4f} ms plain {rec['plain_ms']:.4f} ms "
          f"bound {rec['bound_ms']:.6f} ms by {rec['bound_by']} | {smi}")

    # The routes over one 1080p frame: the same planes three ways.
    qp = 30
    meta = build_meta(qp, int(chroma_qp(qp)), bs_v, bs_h, R, C)
    args = (*planes, qp, int(chroma_qp(qp)), bs_v, bs_h, R, C)
    a = deblock_frame(*args, kernel="frame")
    before = deblock_wave_step.launches
    b = deblock_frame(*args, kernel="wave")
    if deblock_wave_step.launches - before != n_waves(R, C):
        raise AssertionError("route wave: "
                             f"{deblock_wave_step.launches - before} launches")
    def launch_by_launch(*w):
        for k in range(n_waves(R, C)):
            deblock_wave_step_inplace(*w, meta, R, C, k)

    eager = fresh()
    launch_by_launch(*eager)
    _equal_planes(b, a, "deblock_frame route wave (graph) vs route frame")
    _equal_planes(eager, a, "wave steps launch by launch vs route frame")
    t_frame = _cuda_ms(lambda: deblock_frame(*args, kernel="frame"), 10)
    t_wave = _cuda_ms(lambda: deblock_frame(*args, kernel="wave"), 10)
    t_graph = _cuda_median_ms(lambda *w: run_waves(*w, meta, R, C), fresh, 10)
    t_eager = _cuda_median_ms(launch_by_launch, fresh, 10)
    print(f"[kernel] deblock_frame R={R} C={C}, meta build included: route "
          f"frame {t_frame:.3f} ms (1 launch), route wave {t_wave:.3f} ms "
          f"({n_waves(R, C)} launches as one CUDA graph) | {smi}")
    print(f"[kernel] run_waves R={R} C={C}, the {n_waves(R, C)} in-place "
          f"launches alone: as one CUDA graph (copies in and out included) "
          f"{t_graph:.3f} ms, launch by launch {t_eager:.3f} ms, all three "
          f"routes equal | {smi}")
    rec.update(route_wave_graph_ms=t_graph, route_wave_eager_ms=t_eager)
    return {"max_abs_err": max_err, **rec}


def _timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, (time.perf_counter() - t0) * 1e3


def phase_native(smi: str, bufs) -> None:
    """Each C++ coder, parser and the transcoder against the Python coder
    it mirrors, on the symbols of one 1080p I frame and one P frame of the
    clip (encoded on the card at QP 36, near the operating point's QPs)."""
    from media_tpu_torch import native
    from media_tpu_torch.core.bitstream import BitReader, BitWriter
    from media_tpu_torch.entropy import cabac_slice
    from media_tpu_torch.pipeline import slice_coder
    from media_tpu_torch.pipeline.codec import EncoderConfig, EncoderSession
    from media_tpu_torch.pipeline.decoder_tpu import parse_pslice_symbols
    from media_tpu_torch.pipeline.pframe_core import unpack_symbols

    qp = 36
    sess = EncoderSession(EncoderConfig(width=WIDTH, height=HEIGHT, qp=qp,
                                        gop_size=300))
    enc = sess._frame_encoder
    res = enc.encode_iframe(*sess._planes(bufs[0]), qp, deblock=True)
    y, u, v = sess._planes(bufs[1])
    symbols, _ = enc.encode_pframes_batch(
        y[None], u[None], v[None], res.recon_y, res.recon_u, res.recon_v, qp,
        deblock=True)
    p_sym = unpack_symbols(symbols[0])
    i_keys = ("mode16", "chroma_mode", "dc_levels", "ac_levels", "cdc_levels",
              "cac_levels")
    p_keys = ("mv", "luma_levels", "cdc_levels", "cac_levels")
    i_args = [getattr(res, k) for k in i_keys]
    p_args = [p_sym[k] for k in p_keys]
    R, C = R_MB, C_MB

    def report(what, got, t_cpp, want, t_py, size):
        if isinstance(got, dict):
            same = all(np.array_equal(np.asarray(got[k]), np.asarray(want[k]))
                       for k in want if k in got)
        else:
            same = got == want
        if got is None or not same:
            raise AssertionError(f"native {what}: C++ result differs from "
                                 "the Python coder's")
        print(f"[native] {what}: C++ {t_cpp:.2f} ms, Python {t_py:.1f} ms, "
              f"equal ({size}) | {smi}")

    def cavlc(native_fn, python_fn, args, kw):
        def run_native():
            bw = BitWriter()
            bw.u(5, 0x15)
            native_fn(bw, *args)
            return bw.get_bytes()

        def run_python():
            bw = BitWriter()
            bw.u(5, 0x15)
            python_fn(bw, **kw)
            nbits = bw.bit_position
            bw.rbsp_trailing_bits()
            return bw.get_bytes(), nbits

        got, t_cpp = _timed(run_native)
        (want, nbits), t_py = _timed(run_python)
        return got, t_cpp, want, t_py, nbits

    got, t_cpp, want, t_py, _ = cavlc(
        native.write_islice_native, slice_coder.write_islice_mbs, i_args,
        dict(zip(i_keys, i_args)))
    report("CAVLC I-slice writer", got, t_cpp, want, t_py, f"{len(got)} B")
    p_cavlc, t_cpp, want, t_py, p_nbits = cavlc(
        native.write_pslice_native, slice_coder.write_pslice_mbs, p_args,
        dict(zip(p_keys, p_args)))
    report("CAVLC P-slice writer", p_cavlc, t_cpp, want, t_py,
           f"{len(p_cavlc)} B")

    i_cabac, t_cpp = _timed(
        lambda: native.cabac_write_islice_native(*i_args, qp))
    want, t_py = _timed(lambda: cabac_slice.write_islice_cabac(*i_args, qp))
    report("CABAC I-slice writer", i_cabac, t_cpp, want, t_py,
           f"{len(want)} B")
    p_cabac, t_cpp = _timed(
        lambda: native.cabac_write_pslice_native(*p_args, qp, 1))
    want, t_py = _timed(
        lambda: cabac_slice.write_pslice_cabac(*p_args, qp, cabac_init_idc=1))
    report("CABAC P-slice writer", p_cabac, t_cpp, want, t_py,
           f"{len(want)} B")

    def python_cavlc_parse():
        br = BitReader(p_cavlc)
        br.u(5)
        return parse_pslice_symbols(br, R, C, slice_qp=qp)

    got, t_cpp = _timed(lambda: native.parse_pslice_native(
        p_cavlc, len(p_cavlc) * 8, 5, R, C, qp))
    parsed, t_py = _timed(python_cavlc_parse)
    report("CAVLC P-slice parser", got, t_cpp, parsed, t_py,
           f"{R * C} MBs, 5 arrays")
    if not all(np.array_equal(got[k], p_sym[k]) for k in p_keys):
        raise AssertionError("native CAVLC parse != the encoder's symbols")
    got, t_cpp = _timed(lambda: native.cabac_parse_pslice_native(
        p_cabac, 0, R, C, qp, 1))
    want, t_py = _timed(lambda: cabac_slice.parse_pslice_cabac(
        p_cabac, 0, R, C, qp, 1))
    report("CABAC P-slice parser", got, t_cpp, want, t_py,
           f"{R * C} MBs, 5 arrays")
    got, t_cpp = _timed(lambda: native.cabac_parse_islice_native(
        i_cabac, 0, R, C, qp))
    want, t_py = _timed(lambda: cabac_slice.parse_islice_cabac(
        i_cabac, 0, R, C, qp))
    report("CABAC I-slice parser", got, t_cpp, want, t_py,
           f"{R * C} MBs, 6 arrays")
    if not all(np.array_equal(got[k], a) for k, a in zip(i_keys, i_args)):
        raise AssertionError("native CABAC I parse != the encoder's symbols")

    def python_transcode():
        sym = python_cavlc_parse()
        return cabac_slice.write_pslice_cabac(
            *(sym[k] for k in p_keys), qp, cabac_init_idc=1,
            qp_map=sym["qp_map"])

    got, t_cpp = _timed(lambda: native.transcode_pslice_native(
        p_cavlc, p_nbits, 5, R, C, qp, cabac_init_idc=1))
    want, t_py = _timed(python_transcode)
    report("CAVLC->CABAC transcoder", got, t_cpp, want, t_py,
           f"{len(p_cavlc)} B -> {len(want)} B")
    if got != p_cabac:
        raise AssertionError("transcode != the CABAC writer on the symbols")
    if sum(native.fallbacks.values()):
        raise AssertionError(f"native fallbacks {dict(native.fallbacks)}")


def _first_difference(what: str, aus, want_sha, want_bytes) -> None:
    """Raise, naming the first AU whose digest is not the recorded one."""
    for i, au in enumerate(aus):
        if hashlib.sha256(au).hexdigest() != want_sha[i]:
            raise AssertionError(
                f"{what}: AU {i} differs from the JAX package's ({len(au)} "
                f"bytes against {want_bytes[i]}); sizes "
                f"{[len(a) for a in aus]} against {want_bytes[:len(aus)]}")


def _stage_split(sess, frame_buf, smi: str):
    """ms per stage of one 1080p P frame, each stage run and synchronised
    on its own (outside the pipelined session loop)."""
    import torch

    from media_tpu_torch.entropy.device_cavlc import pack_pslice_device
    from media_tpu_torch.ops.pad import edge_pad
    from media_tpu_torch.ops.transform import chroma_qp
    from media_tpu_torch.ops.deblock_wave import launch_deblock_wave
    from media_tpu_torch.pipeline.deblock_apply import (
        build_meta, deblock_pframe_from_symbols, pframe_bs_grids)
    from media_tpu_torch.pipeline.pframe_core import (
        INTERP_HALO, local_pframe_core, unpack_symbols_device)

    enc = sess._frame_encoder
    R, C = enc.n_rows, enc.n_cols
    qp, qp_c, rs = QP, int(chroma_qp(QP)), 8
    y, u, v = (torch.tensor(p, device="cuda") for p in sess._planes(frame_buf))
    ref = [p.to(torch.int32) for p in sess.recon]
    ext = (edge_pad(ref[0], rs + INTERP_HALO, rs + INTERP_HALO, 0, 0),
           edge_pad(ref[1], rs // 2 + 2, rs // 2 + 2, 0, 0),
           edge_pad(ref[2], rs // 2 + 2, rs // 2 + 2, 0, 0))
    cur = [p.to(torch.int32) for p in (y, u, v)]
    box = {}

    def core():
        box["out"] = local_pframe_core(*cur, *ext, qp, qp_c, rs, R, C)

    t_core = _cuda_ms(core, 3)
    out = box["out"]
    cap = sess._device_cap()

    def pack():
        box["pack"] = pack_pslice_device(
            *unpack_symbols_device(out["symbols"]), cap)

    t_pack = _cuda_ms(pack, 3)
    t_deblock = _cuda_ms(lambda: deblock_pframe_from_symbols(
        out["recon_y"], out["recon_u"], out["recon_v"], out["symbols"], qp,
        qp_c, R, C), 3)
    # The whole-frame kernel alone on this frame's own planes and strengths.
    meta = build_meta(qp, qp_c, *pframe_bs_grids(out["symbols"], R, C), R, C)
    t_kernel = _cuda_median_ms(
        lambda *w: launch_deblock_wave(*w, meta, R, C),
        lambda: [out[k].to(torch.uint8, copy=True).contiguous() for k in
                 ("recon_y", "recon_u", "recon_v")], 20)
    stream, bits = box["pack"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    nbits = int(bits)
    words = stream[: (nbits + 31) // 32 + 1].cpu().numpy().astype(np.uint32)
    sess._pslice_au_packed(words, nbits)
    t_host = (time.perf_counter() - t0) * 1e3
    print(f"[stages] {WIDTH}x{HEIGHT} P frame ms: p_core {t_core:.3f} cavlc_pack "
          f"{t_pack:.3f} deblock {t_deblock:.3f} (of which the kernel, median "
          f"of 20 on this frame's planes, {t_kernel:.4f}) host_au "
          f"{t_host:.3f} | {smi}")


def phase_main_path(smi: str, golden: dict, bufs):
    """The constant-QP encode path. Returns (deblock launches, the IDR + P AUs of the
    first run, the recon after the IDR, the recon after that run)."""
    import torch

    from media_tpu_torch.ops.deblock_wave import deblock_wave
    from media_tpu_torch.pipeline.codec import EncoderConfig, EncoderSession

    sess = EncoderSession(EncoderConfig(width=WIDTH, height=HEIGHT, qp=QP,
                                        gop_size=300))  # default device
    if sess.device.type != "cuda":
        raise AssertionError(f"EncoderSession defaulted to {sess.device}")
    sess.PIPELINE_CHUNK = CHUNK
    staged_in = bufs[1 + N_CQ_P : 1 + 2 * N_CQ_P]

    deblock_wave.launches = 0
    t0 = time.perf_counter()
    aus = [sess.encode_frame(bufs[0])]
    t_idr = time.perf_counter() - t0
    recon_idr = [p.clone() for p in sess.recon]
    aus += sess.encode_frames(bufs[1 : 1 + N_CQ_P])
    recon_run = [p.clone() for p in sess.recon]
    chunks = sess.upload_frames(staged_in)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    staged = sess.encode_frames_staged(chunks)
    torch.cuda.synchronize()
    t_staged = time.perf_counter() - t0
    launches = deblock_wave.launches

    n_frames = len(aus) + len(staged)
    if launches != n_frames:
        raise AssertionError(f"deblock kernel launched {launches} times for "
                             f"{n_frames} frames")
    # At constant QP the staged entry emits what encode_frames would: the
    # golden's AUs 0..8, whichever entry the golden took them through.
    _first_difference("constant-QP AUs", aus + staged, golden["au_sha256"],
                      golden["au_bytes"])
    recon = [p.cpu().numpy() for p in sess.recon]
    ph, pw = sess._pad_h, sess._pad_w
    if any(p.shape != s for p, s in zip(
            recon, [(ph, pw), (ph // 2, pw // 2), (ph // 2, pw // 2)])):
        raise AssertionError(f"recon shapes {[p.shape for p in recon]}")
    last = np.frombuffer(staged_in[-1][: WIDTH * HEIGHT], np.uint8).reshape(
        HEIGHT, WIDTH)
    psnr = _psnr(recon[0][:HEIGHT, :WIDTH], last)
    if not psnr > 28.0:
        raise AssertionError(f"last recon PSNR {psnr:.2f} dB")
    print(f"[main] {WIDTH}x{HEIGHT} QP{QP} IDR + {2 * N_CQ_P} P on cuda: AUs "
          f"== JAX golden (sha256 {_sha(aus)[:16]}, staged "
          f"{_sha(staged)[:16]}), deblock launches {launches}/{n_frames}, "
          f"IDR {t_idr * 1e3:.1f} ms (C++ I-slice writer)")
    print(f"[main] P-frame fps {N_CQ_P / t_staged:.3f} (staged, {N_CQ_P} "
          f"frames, {sum(len(a) for a in staged) * 8 / N_CQ_P / 1e3:.1f} "
          f"kbit/frame), PSNR(last Y) {psnr:.3f} dB | {smi}")
    # The IDR once more through the Python I-slice writer, for its time.
    slow = EncoderSession(EncoderConfig(width=WIDTH, height=HEIGHT, qp=QP,
                                        gop_size=300), host_coder="python")
    t0 = time.perf_counter()
    idr_py = slow.encode_frame(bufs[0])
    t_idr_py = time.perf_counter() - t0
    if idr_py != aus[0]:
        raise AssertionError("IDR through the Python writer differs")
    print(f"[main] IDR through the Python I-slice writer {t_idr_py * 1e3:.1f} "
          f"ms against {t_idr * 1e3:.1f} ms, same bytes | {smi}")

    _stage_split(sess, bufs[2 * N_CQ_P + 1], smi)

    # The CPU path is the one the tests hold to the JAX package at small
    # sizes; CUDA must give the same bytes.
    small, _ = clip_i420(64, 48, 5, seed=3)
    out = []
    for device in ("cuda", "cpu"):
        s = EncoderSession(EncoderConfig(width=64, height=48, qp=QP,
                                         gop_size=30, entropy_mode="device"),
                           device=device)
        out.append([s.encode_frame(small[0])] + s.encode_frames(small[1:]))
    if out[0] != out[1]:
        raise AssertionError("64x48 AUs differ between cuda and cpu")
    print("[main] 64x48 IDR + 4 P: cuda AUs == cpu AUs")
    return launches, aus, recon_idr, recon_run


def _split(timings, idr: bool) -> str:
    rows = [t for t in timings if t["idr"] == idr]
    mean = {k: sum(t[k] for t in rows) / len(rows)
            for k in ("parse_ms", "upload_ms", "device_ms")}
    return (f"{'I' if idr else 'P'} x{len(rows)}: host parse "
            f"{mean['parse_ms']:.1f} upload {mean['upload_ms']:.3f} device "
            f"recon+deblock {mean['device_ms']:.3f}")


def phase_decode_path(smi: str, golden: dict, aus, recon_idr, recon_run):
    """The decode path through both deblock routes. Returns the launches of
    (the whole-frame kernel, the wave-step kernel)."""
    import torch

    from media_tpu_torch.ops.deblock_pallas import deblock_wave_step
    from media_tpu_torch.ops.deblock_wave import deblock_wave, n_waves
    from media_tpu_torch.pipeline.codec import EncoderConfig, EncoderSession
    from media_tpu_torch.pipeline.decoder_tpu import TpuDecoder

    def equal_planes(frame, planes, what):
        for got, want, name in zip((frame.y, frame.u, frame.v), planes, "yuv"):
            want = want.cpu().numpy() if torch.is_tensor(want) else want
            if got.shape != want.shape or not np.array_equal(got, want):
                raise AssertionError(f"{what}: plane {name} differs")

    # ---- whole-frame route (the default), IDR + N_CQ_P P pictures
    stream = aus[: 1 + N_CQ_P]
    deblock_wave.launches = deblock_wave_step.launches = 0
    dec = TpuDecoder(profile=True)  # default device, default route
    if dec.device.type != "cuda" or dec.deblock_kernel != "frame":
        raise AssertionError(f"TpuDecoder defaulted to {dec.device}, "
                             f"{dec.deblock_kernel}")
    t0 = time.perf_counter()
    frames = [f for au in stream for f in dec.decode_annexb(au)]
    for f in frames:
        f.y  # wait for the downloads
    t_all = time.perf_counter() - t0
    frame_launches = deblock_wave.launches
    if len(frames) != len(stream):
        raise AssertionError(f"decoded {len(frames)} of {len(stream)} AUs")
    if frame_launches != len(frames) or deblock_wave_step.launches != 0:
        raise AssertionError(
            f"whole-frame route: {frame_launches} whole-frame and "
            f"{deblock_wave_step.launches} wave-step launches for "
            f"{len(frames)} pictures")
    equal_planes(frames[0], recon_idr, "decoded IDR vs encoder recon")
    equal_planes(frames[-1], recon_run, "last decoded P vs encoder recon")
    digests = [planes_sha(f) for f in frames]
    if digests != golden["decoded_sha256"][: len(frames)]:
        bad = [i for i, (a, b) in enumerate(
            zip(digests, golden["decoded_sha256"])) if a != b]
        raise AssertionError(f"decoded pictures {bad} differ from the JAX "
                             "TpuDecoder's recorded digests")
    ph, pw = frames[0].y.shape
    if ((ph, pw) != (R_MB * 16, C_MB * 16)
            or frames[0].u.shape != (ph // 2, pw // 2)):
        raise AssertionError(f"decoded shapes {frames[0].y.shape}")
    print(f"[decode] {WIDTH}x{HEIGHT} IDR + {N_CQ_P} P on cuda, route frame: "
          "pictures == encoder recon == JAX TpuDecoder golden (sha256 "
          f"{digests[-1][:16]}), deblock launches {frame_launches}/"
          f"{len(frames)}")
    p_s = sum(t["parse_ms"] + t["upload_ms"] + t["device_ms"]
              for t in dec.timings if not t["idr"]) / 1e3
    print(f"[decode] fps {len(frames) / t_all:.3f} over all {len(frames)} "
          f"pictures, P pictures alone {N_CQ_P / p_s:.3f} (each stage "
          f"synchronised; C++ CAVLC P parser, Python CAVLC I parser) | {smi}")
    print(f"[decode] ms per picture, route frame: {_split(dec.timings, True)}"
          f"; {_split(dec.timings, False)} | {smi}")
    # One P picture through the Python parser, for its time.
    slow = TpuDecoder(host_parser="python", profile=True)
    slow.load_state(dec.sps, dec.pps, (frames[0].y, frames[0].u, frames[0].v))
    (again,) = slow.decode_annexb(stream[1])
    equal_planes(again, (frames[1].y, frames[1].u, frames[1].v),
                 "P picture through the Python parser")
    print(f"[decode] P picture host parse through the Python parser "
          f"{slow.timings[0]['parse_ms']:.1f} ms, same planes | {smi}")

    # ---- per-wave route, IDR + N_WAVE_P P pictures
    deblock_wave.launches = deblock_wave_step.launches = 0
    wave = TpuDecoder(deblock_kernel="wave", profile=True)
    wframes = [f for au in aus[: 1 + N_WAVE_P] for f in wave.decode_annexb(au)]
    step_launches = deblock_wave_step.launches
    want = (1 + N_WAVE_P) * n_waves(R_MB, C_MB)
    if step_launches != want or deblock_wave.launches != 0:
        raise AssertionError(
            f"per-wave route: {step_launches} wave-step launches (expected "
            f"{want}) and {deblock_wave.launches} whole-frame launches")
    for i, (a, b) in enumerate(zip(wframes, frames)):
        equal_planes(a, (b.y, b.u, b.v), f"route wave vs route frame, "
                                         f"picture {i}")
    print(f"[decode] route wave: IDR + {N_WAVE_P} P == route frame, "
          f"wave-step launches {step_launches} = {1 + N_WAVE_P} x "
          f"{n_waves(R_MB, C_MB)}")
    print(f"[decode] ms per picture, route wave: {_split(wave.timings, True)}"
          f"; {_split(wave.timings, False)} | {smi}")

    # ---- a small stream on CUDA and on the CPU (which the tests hold to
    # the JAX package): same planes through both routes.
    small, _ = clip_i420(64, 48, 5, seed=3)
    s = EncoderSession(EncoderConfig(width=64, height=48, qp=QP, gop_size=30))
    small_aus = [s.encode_frame(small[0])] + s.encode_frames(small[1:])
    for kernel in ("frame", "wave"):
        out = []
        for device in ("cuda", "cpu"):
            d = TpuDecoder(device=device, deblock_kernel=kernel)
            out.append([f for au in small_aus for f in d.decode_annexb(au)])
        for i, (a, b) in enumerate(zip(*out)):
            equal_planes(a, (b.y, b.u, b.v),
                         f"64x48 cuda vs cpu, route {kernel}, picture {i}")
        equal_planes(out[0][-1], s.recon, "64x48 decode vs encoder recon")
    print("[decode] 64x48 IDR + 4 P: cuda planes == cpu planes == encoder "
          "recon, both routes")
    return frame_launches, step_launches


# The golden's rate floats come from XLA on a CPU, the run's from CUDA: log2
# and exp2 differ in their last places and 6 * log2 amplifies that, so the
# carry agrees to about 2e-6 relative while every QP, bit count and byte is
# equal (measured on an H100: 2.04e-06). The floats are a diagnostic that
# says how near a run came to a rounding boundary; what the run is held to,
# exactly, is the AUs, the QPs and the bits.
RATE_FLOAT_TOL = 1e-5


def _check_rate_record(name: str, got: dict, want: dict, target: float):
    """AUs, bits and QPs exact, the controller's floats within
    RATE_FLOAT_TOL (buf relative to the per-frame target). Names the first
    frame that differs, with both sides' QPs and bits. Returns the worst
    relative difference of a float."""
    both = (f"; qps {got['qps']} against {want['qps']}; bits {got['bits']} "
            f"against {want['bits']}; rc after each chunk {got['rc_chunks']} "
            f"against {want['rc_chunks']}")
    for i, (a, b) in enumerate(zip(got["au_sha256"], want["au_sha256"])):
        if a != b:
            raise AssertionError(
                f"{name}: AU {i} differs from the JAX package's "
                f"({got['au_bytes'][i]} bytes against {want['au_bytes'][i]})"
                + both)
    if (len(got["au_sha256"]) != len(want["au_sha256"])
            or got["qps"] != want["qps"] or got["bits"] != want["bits"]):
        raise AssertionError(f"{name}: per-frame QPs or bits differ" + both)
    worst = 0.0
    pairs = [(g, w) for g, w in zip(got["rc_chunks"], want["rc_chunks"])]
    pairs.append(([got["rc_final"][k] for k in ("qp", "buf", "cplx")],
                  [want["rc_final"][k] for k in ("qp", "buf", "cplx")]))
    for g, w in pairs:
        for key, a, b in zip(("qp", "buf", "cplx"), g, w):
            scale = max(abs(a), abs(b), target if key == "buf" else 0.0)
            rel = abs(a - b) / scale if scale else 0.0
            worst = max(worst, rel)
            if rel > RATE_FLOAT_TOL:
                raise AssertionError(
                    f"{name}: rate controller's {key} {a!r} against {b!r} "
                    f"(relative {rel:.3g})" + both)
    return worst


def _rate_stage_split(sess, frame_buf, qp_f: float, smi: str):
    """ms per stage of one 1080p P frame of the rate-controlled path with
    per-MB QP, each stage run and synchronised on its own: the P core and
    the packer with a QP map, the deblock stage and the whole-frame kernel
    alone in per-MB-QP mode, and the host's transcode of the slice."""
    import torch

    from media_tpu_torch.entropy.device_cavlc import (
        _last_coded, pack_pslice_device)
    from media_tpu_torch.ops.deblock_wave import launch_deblock_wave
    from media_tpu_torch.pipeline.deblock_apply import (
        build_meta, deblock_pframe_from_symbols, pframe_bs_grids)
    from media_tpu_torch.pipeline.pframe_core import (
        chroma_qp_device, unpack_symbols_device)

    enc = sess._frame_encoder
    R, C = enc.n_rows, enc.n_cols
    dev = sess.device
    qp = torch.tensor(int(qp_f), dtype=torch.int32, device=dev)
    thresh = ((torch.arange(R * C, dtype=torch.int32, device=dev) * 97)
              % 128).to(torch.float32) / 128.0
    qp_map = qp + (thresh < (qp_f - int(qp_f))).to(torch.int32)
    frame = [torch.tensor(p, device=dev) for p in sess._planes(frame_buf)]
    box = {}

    def core():
        box["out"] = enc._pframe_core(sess.recon, frame, qp_map,
                                      chroma_qp_device(qp_map), 8)

    t_core = _cuda_ms(core, 3)
    out = box["out"]
    mv, luma, cdc, cac = unpack_symbols_device(out["symbols"])
    cap = sess._device_cap()

    def pack():
        box["pack"] = pack_pslice_device(mv, luma, cdc, cac, cap,
                                         qp_map=qp_map.reshape(R, C),
                                         slice_qp=qp)

    t_pack = _cuda_ms(pack, 3)
    coded = ((luma != 0).any(dim=3).any(dim=2)
             | (cdc != 0).any(dim=3).any(dim=2)
             | (cac != 0).any(dim=4).any(dim=3).any(dim=2))
    eff = _last_coded(qp_map, coded.reshape(-1), qp).reshape(R, C)
    recon = (out["recon_y"], out["recon_u"], out["recon_v"])
    qp_c = chroma_qp_device(qp)
    t_deblock = _cuda_ms(lambda: deblock_pframe_from_symbols(
        *recon, out["symbols"], qp, qp_c, R, C, qp_map=eff), 3)
    meta = build_meta(qp, qp_c, *pframe_bs_grids(out["symbols"], R, C), R, C,
                      qp_map=eff)
    t_kernel = _cuda_median_ms(
        lambda *w: launch_deblock_wave(*w, meta, R, C),
        lambda: [p.to(torch.uint8, copy=True).contiguous() for p in recon],
        20)
    stream, bits = box["pack"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    nbits = int(bits)
    words = stream[: (nbits + 31) // 32 + 1].cpu().numpy().astype(np.uint32)
    au = sess._cabac_au_from_cavlc_stream(words, nbits, int(qp_f), 1)
    t_host = (time.perf_counter() - t0) * 1e3
    print(f"[stages] {WIDTH}x{HEIGHT} P frame of the CBR + CABAC path with "
          f"per-MB QP {int(qp_f)}/{int(qp_f) + 1} ms: p_core {t_core:.3f} "
          f"cavlc_pack {t_pack:.3f} deblock {t_deblock:.3f} (of which the "
          f"kernel in per-MB-QP mode, median of 20 on this frame's planes, "
          f"{t_kernel:.4f}) host download + C++ transcode + AU {t_host:.3f} "
          f"({nbits} CAVLC bits -> {len(au)} B) | {smi}")
    return t_kernel


def phase_rate_path(smi: str, golden: dict, bufs, names):
    """The rate-controlled runs `names` of RATE_RUNS at full width, each
    held to its golden. Returns (whole-frame kernel launches, {name:
    (session, drive_rate_run's dict, rate_record's dict)})."""
    import torch

    from media_tpu_torch import native
    from media_tpu_torch.ops.deblock_wave import deblock_wave
    from media_tpu_torch.pipeline import encoder as enc_mod
    from media_tpu_torch.pipeline.codec import EncoderConfig, EncoderSession

    # Count the pictures deblocked with a per-MB QP map.
    per_mb = {"n": 0}
    inner = enc_mod.deblock_pframe_from_symbols

    def counting(*a, qp_map=None, **kw):
        per_mb["n"] += qp_map is not None
        return inner(*a, qp_map=qp_map, **kw)

    enc_mod.deblock_pframe_from_symbols = counting
    total_launches = 0
    keep = {}
    for name in names:
        fields, n_p, n_staged = RATE_RUNS[name]
        want = golden[name]
        sess = EncoderSession(EncoderConfig(
            width=WIDTH, height=HEIGHT, qp=QP, gop_size=300, **fields))
        sess.PIPELINE_CHUNK = CHUNK
        deblock_wave.launches = 0
        per_mb["n"] = 0
        run = drive_rate_run(sess, bufs, n_p, n_staged,
                             sync=torch.cuda.synchronize)
        aus, staged, log = run["aus"], run["staged"], run["log"]
        t_idr, t_run, t_staged = run["t_idr"], run["t_run"], run["t_staged"]
        launches = deblock_wave.launches
        total_launches += launches
        n_frames = len(aus) + len(staged)
        if launches != n_frames:
            raise AssertionError(f"{name}: deblock kernel launched {launches} "
                                 f"times for {n_frames} frames")
        want_per_mb = (n_frames - 1) if fields.get("adaptive_qp") else 0
        if per_mb["n"] != want_per_mb:
            raise AssertionError(f"{name}: {per_mb['n']} pictures deblocked "
                                 f"with a per-MB QP map, expected "
                                 f"{want_per_mb}")
        got = rate_record(sess, aus + staged, log)
        worst = _check_rate_record(name, got, want, sess._rc_target)
        if sum(native.fallbacks.values()):
            raise AssertionError(f"{name}: native fallbacks "
                                 f"{dict(native.fallbacks)}")
        p_bytes = sum(len(a) for a in (aus + staged)[1:])
        n_pf = n_frames - 1
        fps = sess.cfg.framerate
        print(f"[ops] {name} {WIDTH}x{HEIGHT} IDR + {n_p} P"
              f"{f' + {n_staged} staged' if n_staged else ''} on cuda, "
              f"PIPELINE_CHUNK {CHUNK}: AUs, QPs and bits == JAX golden "
              f"(qps {got['qps']}, IDR {want['au_bytes'][0]} B), rate "
              f"floats within {worst:.2g} "
              f"relative, deblock launches {launches}/{n_frames} "
              f"({per_mb['n']} with a per-MB QP map), native fallbacks 0")
        line = (f"[ops] {name} IDR {t_idr * 1e3:.1f} ms, encode_frames P fps "
                f"{n_p / t_run:.3f}")
        if n_staged:
            line += f", staged P fps {n_staged / t_staged:.3f}"
        print(line + f"; P frames {p_bytes * 8 * fps / n_pf / 1e6:.3f} Mbit/s "
              f"and with the IDR {sum(got['au_bytes']) * 8 * fps / n_frames / 1e6:.3f} "
              f"Mbit/s over {n_frames} frames against a target of "
              f"{sess.cfg.bitrate / 1e6:.3f} Mbit/s (buffer "
              f"{got['rc_final']['buf'] / 1e6:.3f} Mbit over) | {smi}")
        if fields.get("i4x4"):
            # The IDR really holds I_4x4 macroblocks, as many as the
            # golden's; its QP is the header's (the controller's start - 2).
            if run["i4_mbs"] != want["i4_mbs"] or not run["i4_mbs"][0] > 0:
                raise AssertionError(f"{name}: I_4x4 macroblocks "
                                     f"{run['i4_mbs']} against the golden's "
                                     f"{want['i4_mbs']}")
            print(f"[ops] {name} IDR with the I_4x4 decision: "
                  f"{t_idr * 1e3:.1f} ms, {len(aus[0])} B, QP "
                  f"{sess.pps.pic_init_qp - 2}, {run['i4_mbs'][0]} of "
                  f"{R_MB * C_MB} macroblocks I_4x4 (== golden) | {smi}")
        keep[name] = (sess, run, got)
    enc_mod.deblock_pframe_from_symbols = inner
    return total_launches, keep


def phase_cabac_decode(smi: str, want, aus, recon_idr, recon_run,
                       what: str = "CABAC"):
    """TpuDecoder on a CBR + CABAC stream, against the recorded digests
    `want`. Returns the whole-frame kernel's launches."""
    import torch

    from media_tpu_torch import native
    from media_tpu_torch.ops.deblock_wave import deblock_wave
    from media_tpu_torch.pipeline.decoder_tpu import TpuDecoder

    deblock_wave.launches = 0
    dec = TpuDecoder(profile=True)
    t0 = time.perf_counter()
    frames = [f for au in aus for f in dec.decode_annexb(au)]
    for f in frames:
        f.y  # wait for the downloads
    t_all = time.perf_counter() - t0
    launches = deblock_wave.launches
    if len(frames) != len(aus) or launches != len(frames):
        raise AssertionError(f"CABAC decode: {len(frames)} pictures and "
                             f"{launches} launches for {len(aus)} AUs")
    _frame_equals(frames[0], recon_idr, f"{what} decode: IDR vs the "
                                        "encoder's recon")
    _frame_equals(frames[-1], recon_run, f"{what} decode: last P vs the "
                                         "encoder's recon")
    digests = [planes_sha(f) for f in frames]
    if digests != want:
        bad = [i for i, (a, b) in enumerate(zip(digests, want)) if a != b]
        raise AssertionError(f"{what} decode: pictures {bad} differ from the "
                             "JAX TpuDecoder's recorded digests")
    if sum(native.fallbacks.values()):
        raise AssertionError(f"CABAC decode: native fallbacks "
                             f"{dict(native.fallbacks)}")
    n_p = len(frames) - 1
    p_s = sum(t["parse_ms"] + t["upload_ms"] + t["device_ms"]
              for t in dec.timings if not t["idr"]) / 1e3
    print(f"[decode] {what} {WIDTH}x{HEIGHT} IDR + {n_p} P of the CBR stream "
          f"on cuda: pictures == encoder recon == JAX TpuDecoder golden "
          f"(sha256 {digests[-1][:16]}), deblock launches {launches}/"
          f"{len(frames)}, native fallbacks 0")
    print(f"[decode] {what} fps {len(frames) / t_all:.3f} over all "
          f"{len(frames)} pictures, P pictures alone {n_p / p_s:.3f} (each "
          f"stage synchronised; C++ CABAC parsers) | {smi}")
    print(f"[decode] {what} ms per picture: {_split(dec.timings, True)}; "
          f"{_split(dec.timings, False)} | {smi}")
    return launches


def _i4_idr_split(smi: str, bufs) -> None:
    """Where the host's time goes in one I_4x4 IDR (QP 28, the operating
    point's): the stages enqueue small kernels without waiting for them and
    the device is idle between them, so the host clock inside a stage is
    the cost of its launches. Beside it the same frame as I_16x16."""
    import torch

    from media_tpu_torch.ops import intra as intra_ops
    from media_tpu_torch.pipeline import encoder as enc_mod
    from media_tpu_torch.pipeline.encoder import FrameEncoder
    from media_tpu_torch.utils import yuv

    enc = FrameEncoder(C_MB * 16, R_MB * 16)
    planes = [yuv.pad_to_mb_grid(p, size) for p, size in zip(
        yuv.split_i420(bufs[0], WIDTH, HEIGHT), (16, 8, 8))]
    spent = {"chain": 0.0, "pred": 0.0, "satd": 0.0}
    patched = ((enc_mod, "i4_chain", "chain", lambda *a: True),
               (intra_ops, "pred_4x4_all", "pred", lambda *a: True),
               (intra_ops, "satd_cost", "satd", lambda p, _o: p.shape[1] == 9))
    inner = {}
    for mod, attr, key, when in patched:
        def timed(*a, _fn=getattr(mod, attr), _key=key, _when=when):
            if not _when(*a):
                return _fn(*a)
            t0 = time.perf_counter()
            out = _fn(*a)
            spent[_key] += time.perf_counter() - t0
            return out
        inner[(mod, attr)] = getattr(mod, attr)
        setattr(mod, attr, timed)
    total = {}
    for i4x4 in (True, False):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        enc.encode_iframe(*planes, 28, deblock=True, i4x4=i4x4)
        torch.cuda.synchronize()
        total[i4x4] = (time.perf_counter() - t0) * 1e3
    for (mod, attr), fn in inner.items():
        setattr(mod, attr, fn)
    chain, pred, satd = (spent[k] * 1e3 for k in ("chain", "pred", "satd"))
    print(f"[i4x4] encode_iframe {WIDTH}x{HEIGHT} QP28 with the I_4x4 "
          f"decision {total[True]:.1f} ms over {2 * (R_MB - 1) + C_MB} waves, "
          f"host clock: the 16-step chain {chain:.1f} (pred_4x4_all "
          f"{pred:.1f}, nine-mode SATD {satd:.1f}, argmin + transform + "
          f"quant + recon + canvas {chain - pred - satd:.1f}), the I_16x16 "
          f"candidate, chroma, select, scatters and deblock "
          f"{total[True] - chain:.1f}; the same frame without the decision "
          f"{total[False]:.1f} ms over {R_MB + C_MB - 1} waves | {smi}")


def _np_planes(planes):
    return tuple(p.cpu().numpy() if hasattr(p, "cpu") else np.asarray(p)
                 for p in planes)


def _frame_equals(frame, planes, what: str) -> None:
    for got, want, name in zip((frame.y, frame.u, frame.v),
                               _np_planes(planes), "yuv"):
        if got.shape != want.shape or not np.array_equal(got, want):
            raise AssertionError(f"{what}: plane {name} differs")


def _tool_session(name: str):
    from media_tpu_torch.pipeline.codec import EncoderConfig, EncoderSession

    fields, n = TOOL_RUNS[name]
    sess = EncoderSession(EncoderConfig(
        width=WIDTH, height=HEIGHT, qp=QP, gop_size=300, **fields))
    sess.PIPELINE_CHUNK = CHUNK
    return sess, n


def _check_tool_record(name: str, sess, run, want: dict) -> dict:
    """AUs and QPs exact; under CBR the host rate loop's final floats within
    RATE_FLOAT_TOL. Names the first AU that differs."""
    got = tool_record(sess, run)
    _first_difference(name, run["aus"], want["au_sha256"], want["au_bytes"])
    if len(run["aus"]) != len(want["au_sha256"]) or got["qps"] != want["qps"]:
        raise AssertionError(f"{name}: {len(run['aus'])} AUs, QPs "
                             f"{got['qps']} against the golden's "
                             f"{len(want['au_sha256'])}, {want['qps']}")
    for k, b in want.get("rc_final", {}).items():
        a = got["rc_final"][k]
        scale = max(abs(a), abs(b), sess._rc_target if k == "buf" else 0.0)
        if scale and abs(a - b) / scale > RATE_FLOAT_TOL:
            raise AssertionError(f"{name}: host rate loop's {k} {a!r} "
                                 f"against {b!r}")
    return got


def phase_multislice(smi: str, golden: dict, bufs):
    """Four slices a picture, both entropy coders, both deblocking idc
    values, both deblock routes of the decoder. Returns the launches of
    (the whole-frame kernel, the wave-step kernel)."""
    import torch

    from media_tpu_torch import native
    from media_tpu_torch.ops.deblock_pallas import deblock_wave_step
    from media_tpu_torch.ops.deblock_wave import deblock_wave, n_waves
    from media_tpu_torch.pipeline.decoder_tpu import TpuDecoder

    deblock_wave.launches = deblock_wave_step.launches = 0
    sync = torch.cuda.synchronize

    # ---- (a) CAVLC, constant QP, the filter kept inside each slice
    name = "slices4_cavlc"
    want = golden[name]
    sess, n = _tool_session(name)
    if (len(sess.slice_rows) != 4 or sess._deblock_idc != 2
            or len(sess._frame_encoder.deblock_slice_starts) != 3):
        raise AssertionError(f"{name}: slices {sess.slice_rows}, idc "
                             f"{sess._deblock_idc}")
    run = drive_tool_run(sess, bufs, n, sync)
    _check_tool_record(name, sess, run, want)
    if deblock_wave.launches != n:
        raise AssertionError(f"{name}: {deblock_wave.launches} whole-frame "
                             f"launches for {n} frames")
    print(f"[slices] {name} {WIDTH}x{HEIGHT} QP{QP} IDR + {n - 1} P, slices "
          f"at MB rows {[r0 for r0, _ in sess.slice_rows]}, idc 2: AUs == JAX "
          f"golden, deblock launches {deblock_wave.launches}/{n}; IDR "
          f"{run['t_idr'] * 1e3:.1f} ms, P frames (device core, symbols to "
          f"the host, C++ CAVLC writer per slice) "
          f"{(n - 1) / run['t_rest']:.3f} fps | {smi}")
    # The P pictures from the encoder's recon after the IDR (a CAVLC I
    # picture parses in Python for seconds): route frame all four, route
    # wave the first.
    frames = {}
    for kernel, n_dec in (("frame", n - 1), ("wave", 1)):
        dec = TpuDecoder(deblock_kernel=kernel, profile=True)
        dec.load_state(sess.sps, sess.pps, _np_planes(run["recon_idr"]))
        frames[kernel] = [f for au in run["aus"][1 : 1 + n_dec]
                          for f in dec.decode_annexb(au)]
        digests = [planes_sha(f) for f in frames[kernel]]
        if digests != want["decoded_sha256"][1 : 1 + n_dec]:
            raise AssertionError(f"{name}: route {kernel} decoded pictures "
                                 "differ from the JAX TpuDecoder's digests")
        print(f"[slices] {name} decode, route {kernel}, ms per picture: "
              f"{_split(dec.timings, False)} (C++ CAVLC parser on the last "
              f"slice of a picture, Python parser on the three above) | "
              f"{smi}")
    _frame_equals(frames["frame"][-1], sess.recon,
                  f"{name}: last decoded P vs encoder recon")
    f0 = frames["frame"][0]
    _frame_equals(frames["wave"][0], (f0.y, f0.u, f0.v),
                  f"{name}: route wave vs route frame")
    step_launches = deblock_wave_step.launches
    if (step_launches != n_waves(R_MB, C_MB)
            or deblock_wave.launches != n + n - 1):
        raise AssertionError(
            f"{name}: {step_launches} wave-step launches (expected "
            f"{n_waves(R_MB, C_MB)}), {deblock_wave.launches} whole-frame "
            f"launches (expected {2 * n - 1})")
    # The C++ CAVLC P parser refuses a slice that ends above the picture's
    # last row (the Python parser then takes it), and nothing else here.
    refused = dict(native.fallbacks)
    if refused != {"parse_pslice_native": 3 * n}:
        raise AssertionError(f"{name}: native fallbacks {refused}, expected "
                             f"3 slices of each of {n} decoded pictures")
    native.fallbacks.clear()
    print(f"[slices] {name}: {n - 1} P pictures by route frame == JAX "
          f"TpuDecoder golden == encoder recon; picture 1 by route wave "
          f"({step_launches} wave-step launches, slice-local strengths) == "
          f"route frame; {3 * n} slices through the Python parser")
    frame_launches = deblock_wave.launches

    # ---- (b) CABAC under CBR: the host rate loop, the filter across slices
    name = "slices4_cabac_cbr"
    want = golden[name]
    sess, n = _tool_session(name)
    if len(sess.slice_rows) != 4 or sess._deblock_idc != 0:
        raise AssertionError(f"{name}: slices {sess.slice_rows}, idc "
                             f"{sess._deblock_idc}")
    deblock_wave.launches = 0
    run = drive_tool_run(sess, bufs, n, sync)
    got = _check_tool_record(name, sess, run, want)
    if deblock_wave.launches != n or sum(native.fallbacks.values()):
        raise AssertionError(f"{name}: {deblock_wave.launches} whole-frame "
                             f"launches for {n} frames, native fallbacks "
                             f"{dict(native.fallbacks)}")
    print(f"[slices] {name} {WIDTH}x{HEIGHT} IDR + {n - 1} P, idc 0: AUs and "
          f"QPs == JAX golden (qps {got['qps']}, IDR {len(run['aus'][0])} "
          f"B), deblock launches {deblock_wave.launches}/{n}, native "
          f"fallbacks 0; IDR {run['t_idr'] * 1e3:.1f} ms, P frames (a host "
          f"read of the AU's size per frame, C++ CABAC writer per slice) "
          f"{(n - 1) / run['t_rest']:.3f} fps | {smi}")
    dec = TpuDecoder(profile=True)
    decoded = [f for au in run["aus"] for f in dec.decode_annexb(au)]
    if [planes_sha(f) for f in decoded] != want["decoded_sha256"]:
        raise AssertionError(f"{name}: decoded pictures differ from the JAX "
                             "TpuDecoder's digests")
    _frame_equals(decoded[0], run["recon_idr"], f"{name}: decoded IDR")
    _frame_equals(decoded[-1], sess.recon, f"{name}: last decoded P")
    if deblock_wave.launches != 2 * n or sum(native.fallbacks.values()):
        raise AssertionError(f"{name}: {deblock_wave.launches} whole-frame "
                             f"launches after the decode, native fallbacks "
                             f"{dict(native.fallbacks)}")
    print(f"[slices] {name} decode: {n} pictures == JAX TpuDecoder golden == "
          f"encoder recon; ms per picture: {_split(dec.timings, True)}; "
          f"{_split(dec.timings, False)} (C++ CABAC parsers; the Python "
          f"CABAC parser on the P slices that end above the picture's last "
          f"row) | {smi}")
    return frame_launches + deblock_wave.launches, step_launches


def phase_bgop(smi: str, golden: dict, bufs) -> int:
    """The IBPBP B-GOP. Returns the whole-frame kernel's launches."""
    import torch

    from media_tpu_torch.ops.deblock_wave import deblock_wave
    from media_tpu_torch.pipeline.decoder_tpu import TpuDecoder
    from media_tpu_torch.pipeline.slice_coder import UnsupportedStream

    name = "bgop"
    sess, n = _tool_session(name)
    times = {"_encode_p_anchor": [], "_encode_b": []}
    for attr, log in times.items():
        def timed(*a, _inner=getattr(sess, attr), _log=log, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = _inner(*a, **kw)
            torch.cuda.synchronize()
            _log.append((time.perf_counter() - t0) * 1e3)
            return out
        setattr(sess, attr, timed)
    deblock_wave.launches = 0
    run = drive_tool_run(sess, bufs, n, torch.cuda.synchronize)
    _check_tool_record(name, sess, run, golden[name])
    launches = deblock_wave.launches
    n_anchor, n_b = len(times["_encode_p_anchor"]), len(times["_encode_b"])
    if (launches, n_anchor, n_b) != (3, 2, 2):
        raise AssertionError(f"{name}: {launches} whole-frame launches, "
                             f"{n_anchor} anchors, {n_b} B pictures")
    if sess.sps.pic_order_cnt_type != 0 or sess.sps.max_num_ref_frames != 2:
        raise AssertionError(f"{name}: SPS {sess.sps}")
    try:
        TpuDecoder().decode_annexb(run["aus"][0])
    except UnsupportedStream:
        pass
    else:
        raise AssertionError(f"{name}: TpuDecoder took a POC type 0 stream")
    print(f"[bgop] {WIDTH}x{HEIGHT} QP{QP} (B pictures QP{QP + 2}) {n} frames "
          f"through encode_frames -> IDR, P, B, P, B: AUs == JAX golden "
          f"(sizes {[len(a) for a in run['aus']]}), deblock launches "
          f"{launches} (IDR and two anchors, none for B); ms per anchor "
          f"{np.mean(times['_encode_p_anchor']):.1f}, per B picture (two "
          f"searches, Python B-slice writer) {np.mean(times['_encode_b']):.1f}"
          f"; TpuDecoder refuses the stream | {smi}")
    return launches


def phase_lossless(smi: str, golden: dict, bufs) -> None:
    """Lossless: one all-I_PCM picture, assembled on the host."""
    from media_tpu_torch.core import nal as nal_mod
    from media_tpu_torch.core.bitstream import BitReader
    from media_tpu_torch.core.syntax import SliceHeader
    from media_tpu_torch.ops.deblock_wave import deblock_wave
    from media_tpu_torch.pipeline.decoder_tpu import TpuDecoder
    from media_tpu_torch.pipeline.slice_coder import UnsupportedStream

    name = "lossless"
    sess, n = _tool_session(name)
    deblock_wave.launches = 0
    t0 = time.perf_counter()
    run = drive_tool_run(sess, bufs, n)
    t_ms = (time.perf_counter() - t0) * 1e3
    _check_tool_record(name, sess, run, golden[name])
    if deblock_wave.launches or not all(
            isinstance(p, np.ndarray) for p in sess.recon):
        raise AssertionError(f"{name}: the lossless path touched the device")
    # Read the samples back out of the AU: after the slice header, mb_type
    # ue(25) and the alignment zeros, every MB is 384 bytes of samples, and
    # every MB but the first has the same two bytes of type and alignment
    # before them.
    mbs = []
    for nu in nal_mod.iter_nal_units(run["aus"][0]):
        if nu.nal_type != 5:
            continue
        br = BitReader(nu.rbsp)
        SliceHeader.parse(br, sess.sps, sess.pps, nal_type=5,
                          nal_ref_idc=nu.nal_ref_idc)
        if br.ue() != 25:
            raise AssertionError(f"{name}: first mb_type is not I_PCM")
        start = -(-br.bit_position // 8)
        body = np.frombuffer(nu.rbsp, np.uint8)[start - 2 : -1]
        mbs.append(body.reshape(-1, 386)[:, 2:])
    mbs = np.concatenate(mbs).reshape(R_MB, C_MB, 384)
    y = mbs[..., :256].reshape(R_MB, C_MB, 16, 16).transpose(
        0, 2, 1, 3).reshape(R_MB * 16, C_MB * 16)
    u, v = (mbs[..., a : a + 64].reshape(R_MB, C_MB, 8, 8).transpose(
        0, 2, 1, 3).reshape(R_MB * 8, C_MB * 8) for a in (256, 320))
    src = np.frombuffer(bufs[0], np.uint8)
    n_y = WIDTH * HEIGHT
    for got, want, w, h, what in (
            (y, src[:n_y], WIDTH, HEIGHT, "y"),
            (u, src[n_y : n_y + n_y // 4], WIDTH // 2, HEIGHT // 2, "u"),
            (v, src[n_y + n_y // 4 :], WIDTH // 2, HEIGHT // 2, "v")):
        if not np.array_equal(got[:h, :w], want.reshape(h, w)):
            raise AssertionError(f"{name}: plane {what} read back out of the "
                                 "AU differs from the input")
    try:
        TpuDecoder().decode_annexb(run["aus"][0])
    except UnsupportedStream:
        pass
    else:
        raise AssertionError(f"{name}: TpuDecoder took an I_PCM stream")
    print(f"[lossless] {WIDTH}x{HEIGHT} one frame, all I_PCM: AU == JAX "
          f"golden ({len(run['aus'][0])} B), the {WIDTH}x{HEIGHT} samples in "
          f"the AU equal the input, no device touched, host {t_ms:.1f} ms; "
          f"TpuDecoder refuses the stream | {smi}")


def main() -> None:
    smi = phase_environment()
    import torch

    sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with open(os.path.join(ROOT, "media_tpu_torch", "golden_1080p.json")) as f:
        golden = json.load(f)
    phase_build()
    krec = phase_kernel(smi)
    krec_step = phase_kernel_step(smi)
    if "--kernels" in sys.argv[1:]:
        return
    bufs, clip_sha = clip_i420()
    if clip_sha != golden["clip_sha256"]:
        raise AssertionError(f"input clip digest {clip_sha} != recorded "
                             f"{golden['clip_sha256']} (numpy clip differs)")
    phase_native(smi, bufs)
    enc_launches, aus, recon_idr, recon_run = phase_main_path(smi, golden,
                                                              bufs)
    dec_launches, step_launches = phase_decode_path(smi, golden, aus,
                                                    recon_idr, recon_run)
    rate_launches, keep = phase_rate_path(smi, golden, bufs,
                                          RATE_RUNS_PHASE7)
    sess, _run, got = keep["cbr_cabac_aq"]
    t_per_mb = _rate_stage_split(sess, bufs[5], got["rc_final"]["qp"], smi)
    run = keep["cbr_cabac"][1]
    cabac_launches = phase_cabac_decode(
        smi, golden["cbr_cabac"]["decoded_sha256"], run["aus"],
        run["recon_idr"], run["recon_run"])
    del keep, sess, run
    i4_launches, keep = phase_rate_path(smi, golden, bufs, (I4_RUN,))
    run = keep[I4_RUN][1]
    i4_launches += phase_cabac_decode(
        smi, golden[I4_RUN]["decoded_sha256"], run["aus"], run["recon_idr"],
        run["recon_run"], what="CABAC + I_4x4")
    del keep, run
    _i4_idr_split(smi, bufs)
    slice_launches, slice_step_launches = phase_multislice(smi, golden, bufs)
    bgop_launches = phase_bgop(smi, golden, bufs)
    phase_lossless(smi, golden, bufs)
    print(json.dumps({"kernels": [
        {"name": "deblock_wave", "route": "cuda",
         "source": "media_tpu_torch/csrc/deblock_wave.cu",
         "replaces": "media_tpu/ops/deblock_wave_pallas.py:230",
         "launches": (enc_launches + dec_launches + rate_launches
                      + cabac_launches + i4_launches + slice_launches
                      + bgop_launches),
         "launches_encode_path": enc_launches,
         "launches_decode_path": dec_launches,
         "launches_rate_path": rate_launches,
         "launches_cabac_decode_path": cabac_launches,
         "launches_i4x4_operating_point": i4_launches,
         "launches_multislice": slice_launches,
         "launches_bgop": bgop_launches,
         "per_mb_qp_ms_on_clip_frame": t_per_mb, **krec},
        {"name": "deblock_wave_step", "route": "cuda",
         "source": "media_tpu_torch/csrc/deblock_wave_step.cu",
         "replaces": "media_tpu/ops/deblock_pallas.py:96",
         "launches": step_launches + slice_step_launches,
         "launches_decode_path": step_launches,
         "launches_multislice": slice_step_launches, **krec_step}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
