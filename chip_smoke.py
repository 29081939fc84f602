#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (media_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py              # needs one CUDA device

Phases, one line each; nothing is caught, any failure exits non-zero:
  1. environment: nvidia-smi name/power limit, torch/CUDA versions;
  2. build: nvcc compiles media_tpu_torch/csrc/*.cu for sm_90a;
  3. kernel == plain: the whole-frame deblocking kernel against its plain
     PyTorch version at the 1080p geometry (R=68, C=120), uniform QP
     22/30/36 and one per-MB QP map, exact equality, both timed with CUDA
     events; and torch.argmin's first-minimum rule on CUDA;
  4. main path: EncoderSession(1920x1080, QP 30, CAVLC, deblock, entropy on
     the device) on "cuda": an IDR via encode_frame, 8 P frames via
     encode_frames, 8 more via upload_frames + encode_frames_staged; the
     deblock launch count, the AU digests against the ones recorded from
     the JAX package (media_tpu_torch/golden_1080p.json, written by
     tools/record_torch_golden.py), P-frame fps, a per-stage split and the
     last recon's PSNR; plus a small clip encoded on CUDA and on the CPU
     (which the tests hold to the JAX package) must give the same bytes.
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
CHUNK = 8        # session PIPELINE_CHUNK, as the JAX package's bench uses
SEED = 0
ROOT = os.path.dirname(os.path.abspath(__file__))


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


def phase_kernel(smi: str) -> dict:
    import torch

    from media_tpu_torch.ops.deblock_wave import (
        deblock_wave, deblock_wave_plain)
    from media_tpu_torch.ops.transform import chroma_qp
    from media_tpu_torch.pipeline.deblock_apply import build_meta

    dev = torch.device("cuda")
    R, C = 68, 120
    g = torch.Generator(device="cpu").manual_seed(7)

    def rand(shape, hi):
        return torch.randint(0, hi, shape, generator=g, dtype=torch.int32)

    planes = [rand((R * 16, C * 16), 256), rand((R * 8, C * 8), 256),
              rand((R * 8, C * 8), 256)]
    # Smooth the planes so that many edges pass the alpha/beta tests.
    planes = [(p // 8 + 100).to(torch.uint8).to(dev) for p in planes]
    bs_v = rand((R * 4, C * 4), 5)
    bs_h = rand((R * 4, C * 4), 5)
    bs_v[:, 0] = 0
    bs_h[0, :] = 0
    qp_map = (30 + rand((R, C), 9) - 4).to(dev)
    cases = [(qp, None) for qp in (22, 30, 36)] + [(30, qp_map)]
    max_err = 0
    kernel_ms = plain_ms = 0.0
    for qp, qmap in cases:
        meta = build_meta(qp, int(chroma_qp(qp)), bs_v.to(dev), bs_h.to(dev),
                          R, C, qp_map=qmap)
        got = [p.clone() for p in planes]
        deblock_wave(*got, meta, R, C)
        want = [p.clone() for p in planes]
        deblock_wave_plain(*want, meta, R, C)
        torch.cuda.synchronize()
        for a, b, name in zip(got, want, "yuv"):
            err = int((a.int() - b.int()).abs().max())
            max_err = max(max_err, err)
            if not torch.equal(a, b):
                raise AssertionError(f"deblock kernel != plain on {name}, "
                                     f"qp {qp}, qp_map {qmap is not None}: "
                                     f"max |err| {err}")
        changed = sum(int((a != p).sum()) for a, p in zip(got, planes))
        if changed == 0:
            raise AssertionError("deblock test case filtered nothing")
        if qmap is None and qp == 30:
            work = [p.clone() for p in planes]
            kernel_ms = _cuda_ms(lambda: deblock_wave(*work, meta, R, C), 50)
            plain_ms = _cuda_ms(
                lambda: deblock_wave_plain(*work, meta, R, C), 2)
        print(f"[kernel] deblock_wave qp={qp} qp_map={qmap is not None} "
              f"equal=True samples_changed={changed}")
    print(f"[kernel] deblock_wave 1080p (R={R}, C={C}) kernel {kernel_ms:.4f} "
          f"ms plain {plain_ms:.4f} ms | {smi}")

    # First-minimum rule of argmin on CUDA for tied int32 costs (MVs and
    # modes depend on it).
    rng = np.random.default_rng(1)
    costs = rng.integers(0, 4, (8160, 289)).astype(np.int32)
    got = torch.argmin(torch.as_tensor(costs, device=dev), dim=1).cpu().numpy()
    if not np.array_equal(got, np.argmin(costs, axis=1)):
        raise AssertionError("torch.argmin on CUDA does not keep the first "
                             "minimum")
    print("[kernel] argmin keeps the first minimum on CUDA ties: True")
    return {"max_abs_err": max_err, "ms": kernel_ms, "plain_ms": plain_ms}


def _stage_split(sess, frame_buf, smi: str):
    """ms per stage of one 1080p P frame, each stage run and synchronised
    on its own (outside the pipelined session loop)."""
    import torch

    from media_tpu_torch.entropy.device_cavlc import pack_pslice_device
    from media_tpu_torch.ops.pad import edge_pad
    from media_tpu_torch.ops.transform import chroma_qp
    from media_tpu_torch.pipeline.deblock_apply import (
        deblock_pframe_from_symbols)
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
    stream, bits = box["pack"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    nbits = int(bits)
    words = stream[: (nbits + 31) // 32 + 1].cpu().numpy().astype(np.uint32)
    sess._pslice_au_packed(words, nbits)
    t_host = (time.perf_counter() - t0) * 1e3
    print(f"[stages] {WIDTH}x{HEIGHT} P frame ms: p_core {t_core:.3f} cavlc_pack "
          f"{t_pack:.3f} deblock {t_deblock:.3f} host_au {t_host:.3f} | {smi}")


def phase_main_path(smi: str) -> int:
    import torch

    from media_tpu_torch.ops.deblock_wave import deblock_wave
    from media_tpu_torch.pipeline.codec import EncoderConfig, EncoderSession

    with open(os.path.join(ROOT, "media_tpu_torch", "golden_1080p.json")) as f:
        golden = json.load(f)
    bufs, clip_sha = clip_i420()
    if clip_sha != golden["clip_sha256"]:
        raise AssertionError(f"input clip digest {clip_sha} != recorded "
                             f"{golden['clip_sha256']} (numpy clip differs)")
    sess = EncoderSession(EncoderConfig(width=WIDTH, height=HEIGHT, qp=QP,
                                        gop_size=300), device="cuda")
    sess.PIPELINE_CHUNK = CHUNK
    staged_in = bufs[1 + N_P : 1 + 2 * N_P]

    deblock_wave.launches = 0
    t0 = time.perf_counter()
    aus = [sess.encode_frame(bufs[0])]
    t_idr = time.perf_counter() - t0
    aus += sess.encode_frames(bufs[1 : 1 + N_P])
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
    return launches


def main() -> None:
    smi = phase_environment()
    import torch

    sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_build()
    krec = phase_kernel(smi)
    launches = phase_main_path(smi)
    print(json.dumps({"kernels": [{
        "name": "deblock_wave", "route": "cuda",
        "source": "media_tpu_torch/csrc/deblock_wave.cu",
        "replaces": "media_tpu/ops/deblock_wave_pallas.py:230",
        "launches": launches, **krec}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
