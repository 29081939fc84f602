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
  4. encode path: EncoderSession(1920x1080, QP 30, CAVLC, deblock, entropy on
     the device) on its default device: an IDR via encode_frame, 8 P frames
     via encode_frames, 8 more via upload_frames + encode_frames_staged; the
     deblock launch count, the AU digests against the ones recorded from
     the JAX package (media_tpu_torch/golden_1080p.json, written by
     tools/record_torch_golden.py), P-frame fps, a per-stage split and the
     last recon's PSNR; plus a small clip encoded on CUDA and on the CPU
     (which the tests hold to the JAX package) must give the same bytes;
  5. decode path: TpuDecoder() (default device, whole-frame deblock route)
     decodes phase 4's IDR + 8 P access units: picture 0 must equal the
     encoder's recon after the IDR and picture 8 its recon after
     encode_frames, every picture's digest the one recorded from the JAX
     TpuDecoder, with one whole-frame kernel launch per picture; decode fps
     and the split host parse / upload / device per picture; then
     TpuDecoder(deblock_kernel="wave") decodes the IDR + 2 P to the same
     planes through 254 wave-step launches per picture; plus a small stream
     decoded on CUDA and on the CPU must give the same planes.
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
N_P = 8          # P frames per phase (encode_frames, then staged)
N_DEC_P = 8      # P pictures decoded through the whole-frame deblock route
N_WAVE_P = 2     # P pictures decoded through the per-wave deblock route
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


def phase_main_path(smi: str, golden: dict):
    """The encode path. Returns (deblock launches, the IDR + P AUs of the
    first run, the recon after the IDR, the recon after that run)."""
    import torch

    from media_tpu_torch.ops.deblock_wave import deblock_wave
    from media_tpu_torch.pipeline.codec import EncoderConfig, EncoderSession

    bufs, clip_sha = clip_i420()
    if clip_sha != golden["clip_sha256"]:
        raise AssertionError(f"input clip digest {clip_sha} != recorded "
                             f"{golden['clip_sha256']} (numpy clip differs)")
    sess = EncoderSession(EncoderConfig(width=WIDTH, height=HEIGHT, qp=QP,
                                        gop_size=300))  # default device
    if sess.device.type != "cuda":
        raise AssertionError(f"EncoderSession defaulted to {sess.device}")
    sess.PIPELINE_CHUNK = CHUNK
    staged_in = bufs[1 + N_P : 1 + 2 * N_P]

    deblock_wave.launches = 0
    t0 = time.perf_counter()
    aus = [sess.encode_frame(bufs[0])]
    t_idr = time.perf_counter() - t0
    recon_idr = [p.clone() for p in sess.recon]
    aus += sess.encode_frames(bufs[1 : 1 + N_P])
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
    if _sha(aus) != golden["aus_sha256"]:
        raise AssertionError("IDR + P AUs differ from the JAX package's: "
                             f"{[len(a) for a in aus]} vs "
                             f"{golden['au_bytes'][:1 + N_P]}")
    if _sha(staged) != golden["staged_sha256"]:
        raise AssertionError("staged P AUs differ from the JAX package's: "
                             f"{[len(a) for a in staged]} vs "
                             f"{golden['au_bytes'][1 + N_P:]}")
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
    print(f"[main] {WIDTH}x{HEIGHT} QP{QP} IDR + {2 * N_P} P on cuda: AUs == "
          "JAX golden "
          f"(sha256 {_sha(aus)[:16]}, staged {_sha(staged)[:16]}), deblock "
          f"launches {launches}/{n_frames}, IDR {t_idr * 1e3:.1f} ms")
    print(f"[main] P-frame fps {N_P / t_staged:.3f} (staged, {N_P} frames, "
          f"{sum(len(a) for a in staged) * 8 / N_P / 1e3:.1f} kbit/frame), "
          f"PSNR(last Y) {psnr:.3f} dB | {smi}")

    _stage_split(sess, bufs[2 * N_P], smi)

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

    # ---- whole-frame route (the default), IDR + N_DEC_P P pictures
    stream = aus[: 1 + N_DEC_P]
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
    if N_DEC_P == N_P:
        equal_planes(frames[-1], recon_run,
                     "last decoded P vs encoder recon")
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
    print(f"[decode] {WIDTH}x{HEIGHT} IDR + {N_DEC_P} P on cuda, route frame: "
          "pictures == encoder recon == JAX TpuDecoder golden (sha256 "
          f"{digests[-1][:16]}), deblock launches {frame_launches}/"
          f"{len(frames)}")
    p_s = sum(t["parse_ms"] + t["upload_ms"] + t["device_ms"]
              for t in dec.timings if not t["idr"]) / 1e3
    print(f"[decode] fps {len(frames) / t_all:.3f} over all {len(frames)} "
          f"pictures, P pictures alone {N_DEC_P / p_s:.3f} (each stage "
          f"synchronised) | {smi}")
    print(f"[decode] ms per picture, route frame: {_split(dec.timings, True)}"
          f"; {_split(dec.timings, False)} | {smi}")

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
    enc_launches, aus, recon_idr, recon_run = phase_main_path(smi, golden)
    dec_launches, step_launches = phase_decode_path(smi, golden, aus,
                                                    recon_idr, recon_run)
    print(json.dumps({"kernels": [
        {"name": "deblock_wave", "route": "cuda",
         "source": "media_tpu_torch/csrc/deblock_wave.cu",
         "replaces": "media_tpu/ops/deblock_wave_pallas.py:230",
         "launches": enc_launches + dec_launches,
         "launches_encode_path": enc_launches,
         "launches_decode_path": dec_launches, **krec},
        {"name": "deblock_wave_step", "route": "cuda",
         "source": "media_tpu_torch/csrc/deblock_wave_step.cu",
         "replaces": "media_tpu/ops/deblock_pallas.py:96",
         "launches": step_launches, **krec_step}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
