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
     launch by launch); torch.argmin's first-minimum rule on CUDA; and the
     CAVLC P-slice packer kernel (csrc/device_cavlc.cu) against
     pack_pslice_plain at (1,1), (1,5), (5,1), (4,6), (17,120), 1080p and
     4K on sparse symbols, dense 28-bit escapes at ratio 1.0, a stream cap
     that overflows, groups of the bitcat tree over their level's cap, an
     all-skip slice and a QP map with the slice QP on the device: every
     stream word and bit count equal; at 1080p both timed on fresh inputs,
     the kernel also on an all-skip slice (its device-busy time the floor of
     the kernel's dependent launches), the device activities and busy time
     of one call of each by torch.profiler; and the P-frame core kernel
     (csrc/pframe_core.cu) against local_pframe_core_plain, its search alone
     against search_refine_luma_plain, at (1,1), (1,5), (5,1), (6,9), 1080p
     and 4K on the pictures of PCORE_KINDS (a pan, two-level planes full of
     ties, constant planes, stripes that tie at the minimum, MVs past the
     far and near edges, noise at QP 0) at search ranges 8 and 4 with the
     QP as an int, a 0-d tensor and a per-MB map, and on two 17-row tiles
     whose halo rows are their neighbours' rows, through its int32 entry
     and its uint8 one (a whole-picture reference whose rows the kernel
     clamps; the tiles' real halo rows as given): every output equal; at
     1080p both entries timed on fresh inputs, the search alone too, the
     device activities and busy time of one call of each; and the intra
     wavefront
     kernels (csrc/intra_wave.cu) against encoder.intra_encode_plain and
     decoder_tpu.intra_recon_plain at (1,1), (1,5), (5,1), (6,9) and 1080p
     on flat planes (ties everywhere), a structured picture with a slice
     start (and below 1080p noise at QP 0 and QP 51), with and without the
     I_4x4 decision, and at 4K without it: every symbol array and recon
     sample equal, the recon kernel on the plain encode's symbols; at
     1080p both timed on fresh inputs beside one run of each plain loop,
     the device activities and busy time of one call of each, the bounds
     and the time a wave; and (after the clip is made) the deblocking meta
     kernel (csrc/deblock_meta.cu) against deblock_meta_plain (build_meta
     over pframe_bs_grids or intra_bs_grids) at META_SHAPES and 4K on
     meta_runs' cases (P and I pictures, the QP an int, a 0-d device
     tensor and a per-MB map, QP 0 and 51, slice starts, MVs 3 and 4
     quarter-pels apart), at 1080p on the clip's P symbols, and on their
     four 17-row tiles with a device QP each: every column equal; at 1080p
     timed by one event pair a launch beside the plain build, its device
     activities, busy time and byte bound;
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
     tools/record_torch_golden.py), P-frame fps, a per-stage split (the
     P-core kernel through the encoder's uint8 entry, the kernel alone and
     the int32 entry, and the packer kernel, beside their plain versions on
     the frame's own planes and symbols; the deblock stage split into the
     meta kernel, the three plane copies and kernel 1), a [profile] of one
     whole staged P frame (torch.profiler: device activities by name,
     device-busy ms, wall ms, idle share) and
     the last recon's PSNR; the same frames once more with
     entropy_mode="host" (the C++ writer): the same AUs, no packer launch,
     its P fps beside the device route's; plus a small clip encoded on CUDA
     and on the CPU (which the tests hold to the JAX package) must give the
     same bytes;
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
     achieved bitrate, P fps, a per-stage split with the P-core kernel
     beside its plain version and the deblock stage's parts in per-MB-QP
     mode, a [profile] of one whole staged P frame of the CBR + CABAC run;
     then IDR + 4 P with adaptive_qp and IDR + 4 P CBR
     with CAVLC against their goldens; no refusal of a C++ routine; one
     whole-frame kernel launch per picture;
  8. CABAC decode: TpuDecoder() on phase 7's IDR + 8 P: planes equal to the
     encoder's recon and to the JAX TpuDecoder's digests, fps and the split;
  9. the operating point as the JAX package's bench defines it, with the
     I_4x4 / I_16x16 decision in the IDR: phase 7's first run with
     i4x4=True, held to its golden in the same way; the IDR's time, size, QP
     and count of I_4x4 macroblocks (> 0, the golden's); then TpuDecoder()
     on its IDR + 8 P, as in phase 8; then the clip's IDR with and without
     the decision through encode_iframe (host clock), the wavefront kernel
     alone (events, device activities) and one run of the plain loop;
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
     read back out of the AU equal the input;
 13. the public API at full width: create_video_encoder(device="cuda")
     at the shipped property defaults (720x1280 baseline: CAVLC, CBR
     5 Mbit/s, I_4x4; a forced IDR at frame 5) and at 1080p on main (CABAC,
     CBR 8 Mbit/s; a parameter adjust to 6 Mbit/s, so a reset, at frame 6),
     8 frames each through encode_one_frame; every code SUCCESS, AUs and
     the encoder's QP after each frame against the golden; the stream back
     through create_video_decoder(device="cuda") in 65536-byte pieces and
     the end-of-stream marker, drained until EOS: every payload the
     golden's, no fallback to the oracle, no warning or error in the media
     log; ms of both IDRs, P fps, API decode fps, encoder statistics;
 14. the port's scalar oracle (ref/decoder.py) on five 176x144 streams
     encoded on the card (IDR + 4 P, the same with I_4x4, four slices with
     idc 2, the B-GOP, lossless): AUs and pictures the golden's, pictures
     the encoder's recon; the B-GOP and lossless streams through
     VideoDecoder(device="cuda"): one hand-over to the oracle each, every
     payload the oracle's picture; and one hand-over in mid-stream, with the
     device decoder's reference planes;
 15. the format-2 (HEVC) slot through both factories at 320x240 under CBR:
     AUs and payloads the golden's;
 16. row tiles (parallel/sharding.py), several on the one card at 1080p:
     (a) ShardedEncoderSession over ["cuda:0"] * 4 (tiles of 17 MB rows)
     on the slices4_cavlc configuration, AUs the slices4_cavlc golden's;
     (b) one tile on phase 5's first 5 frames, AUs phase 5's golden; (c)
     CBR 8 Mbit/s with CAVLC and adaptive_qp over 4 tiles, IDR + 4 P, AUs,
     QPs and the tiles' bits exact and the rate state within 1e-5 against
     the sharded4_cbr_aq golden (the JAX ShardedEncoderSession on 4 virtual
     CPU devices); one whole-frame launch per tile per picture; IDR ms and
     P fps; (d) the API with media.tpu.multichip=1 at 64x64: a
     ShardedEncoderSession from the pool, no warning, 3 frames encoded and
     decoded, the pool's load back to 0 after destroy_encoder;
 17. GOP dispatch at 1080p, constant QP 30, CAVLC, 6 GOPs of 16 frames: one
     sequential session applying reset_gop_state per GOP, GopDispatcher with
     2 threads, dispatch_multiprocess with 1, 2 and 4 spawned processes (a
     gloo process group at 4), MPS off; every AU list equal to the
     sequential one; fps of the warm window, scaling_efficiency,
     dispatch_overhead, prewarm_s;
 18. the C ABI (media_tpu_torch/csrc/api, libVideoCodec, built with g++
     against this interpreter's libpython; runs right after phase 13): (a)
     phase 13's two runs through the C functions, the library loaded into
     this process with ctypes.CDLL: CreateVideoEncoder() (void, so cuda),
     every property through MtpuEncoderSetParam under its key string,
     EncodeOneFrame per frame; the stream back through CreateVideoDecoder()
     / SendStreamData in 65536-byte pieces / RetrieveFrameData into a
     w*h*3/2 buffer (made anew for the geometry BAD_PIC_SIZE reports), a C
     event callback; AUs, codes, decoder codes and payloads the golden's,
     events phase 13's, two whole-frame launches a picture; P fps through
     EncodeOneFrame beside phase 13's, both IDRs' ms, decode fps; (b)
     api_main_1080p through capi_drive (csrc/api/capi_drive.c, a C program
     linked to the library) in a child process with --device cuda and this
     process's sys.path as PYTHONPATH: AUs and codes the golden's, its wall
     time and start-up apart from the encoding; (c) the C hop alone: one
     encoder through encode_one_frame and one through EncodeOneFrame at
     api_main_1080p's properties without its reset take the IDR and 16 P
     frames of the clip in turns (Python, C, C, Python, ...): AUs equal,
     the first six the golden's, the median ms of a P frame each way and
     of their difference per frame;
 19. libavcodec on the card's host (media_tpu_torch/testing/avref.py, the
     shim built with gcc against the system libavcodec; runs after phase
     18): phase 5's nine AUs (the route-frame decoder of phase 6 decodes
     pictures 5-8 on) and phase 9's seventeen through ffmpeg's H.264
     decoder: every AU a picture of 1920x1080, the first nine of each equal
     to the port's decoded pictures cropped to 1920x1080, whose digests are
     the golden's, the last equal to the encoder's last recon; ffmpeg's ms
     a picture. Where the shim does not build because libavcodec's header
     or library is missing, the phase prints "[avref] unavailable" with the
     compiler's message and the run goes on; any other failure fails it.
Phases 9 to 16 hold every AU and decoded picture to the golden as well.
Phase 3 also runs route wave in two threads, 20 pictures each.
The packer's, the P core's, the meta kernel's and the intra kernels'
launches are counted phase by phase (the counts set to 0 just before a
phase and read just after; the spawned GOP workers report theirs); every
phase that deblocks pictures on the card (5-11, 13, 14, 16-18, and 19 where
libavcodec is there) must have launched the meta kernel; the encode, rate,
I_4x4,
tile and GOP-dispatch phases must have launched the packer, every phase
that encodes P frames on the card (5, 7, 9, 10, 11, 13, 14, 16, 17, 18) the
P core, the B-GOP's B pictures its search alone, every phase that encodes
an IDR on the card (5, 6, 7, 9, 10, 11, 13, 14, 16, 17, 18) the intra
encoder kernel and every phase that decodes an I picture there (6, 8, 9,
10, 13, 18) the intra recon kernel. A [time] line gives each phase's seconds. The
second-to-last line is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import subprocess
import sys
import sysconfig
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
# Integer lanes an SM, each one 32-bit instruction a clock (NVIDIA H100
# Tensor Core GPU Architecture whitepaper: 16 INT32 units in each of an SM's
# four partitions). The card's integer rate is these over its SMs at its
# highest SM clock (peak_int_ops_s); a packed-byte instruction, such as one
# VABSDIFF4 over four samples, counts once.
INT_LANES_PER_SM = 64
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

# Phase 16: row tiles, one slice each. The run with a golden of its own:
# the operating point's rate loop with CAVLC and per-MB QP over four tiles
# (four devices in the recorder, four tiles on the one card here), IDR + 4 P.
SHARDED_RUN = "sharded4_cbr_aq"
SHARDED_TILES = 4
SHARDED_FIELDS = dict(adaptive_qp=True, **CBR)
N_SHARDED = 5

# Phase 17: GOP dispatch at constant QP with CAVLC, GOP 16, GOPS_DISPATCH
# GOPs of the clip; the worker counts of the thread and process dispatchers.
GOP_DISPATCH = 16
GOPS_DISPATCH = 6
DISPATCH_THREADS = 2
DISPATCH_PROCS = (1, 2, 4)

# The public API (phases 13 and 15), each run as (properties set on a fresh
# ParamStore, by the name of their key in core/params.py; frames; for a
# frame index the properties set just before that frame; the clip's
# geometry). Keys and values are those of both packages' params modules.
API_FRAMES = 8
API_FEED = 65536  # bytes per send_stream_data call
API_RUNS = {
    # The reference's shipped property defaults (core/params.py:47-58):
    # 720x1280 portrait, 30 fps, 5 Mbit/s, GOP 30, baseline, so CAVLC under
    # CBR with I_4x4; frame 5 a forced IDR.
    "api_default": ({}, API_FRAMES, {5: {"KEY_FORCE_KEYFRAME": "1"}},
                    (720, 1280)),
    # The policy at api/encoder_api.py:142-154 on main: CABAC; before frame
    # 6 a new bitrate through the parameter-adjust poll (a reset: new IDR).
    "api_main_1080p": ({"KEY_HW_WIDTH": "1920", "KEY_HW_HEIGHT": "1080",
                        "KEY_BITRATE": "8000000", "KEY_PROFILE": "main"},
                       API_FRAMES, {6: {"KEY_BITRATE": "6000000",
                                        "KEY_PARAM_ADJUSTING": "1"}},
                       (1920, 1080)),
    # The format-2 slot: intra-only HEVC under CBR at the lowest bitrate the
    # API's envelope accepts (core/params.py MIN_BITRATE).
    "hevc_api": ({"KEY_ENCODE_FORMAT": "2", "KEY_HW_WIDTH": "320",
                  "KEY_HW_HEIGHT": "240", "KEY_BITRATE": "1000000"}, 3, {},
                 (320, 240)),
}


# The H.264 runs of API_RUNS that phases 13 and 18 drive at full width, each
# with the frame of its second IDR and what makes it one.
API_IDRS = (("api_default", 5, "forced IDR"),
            ("api_main_1080p", 6, "IDR of the reset to 6 Mbit/s"))


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


def tap_sharded(sess) -> list:
    """Record what a sharded session's P runs assemble: per run the tiles'
    bit counts (K, n) and the frames' QPs (None at constant QP), as host
    arrays. Wraps _pslice_aus_from_streams, which both packages'
    ShardedEncoderSession call with host arrays once a run is accepted
    (after any retry at a doubled cap)."""
    inner = sess._pslice_aus_from_streams
    log: list = []

    def tapped(streams_h, bits_h, k, qps=None):
        log.append((np.asarray(bits_h),
                    None if qps is None else np.asarray(qps)))
        return inner(streams_h, bits_h, k, qps=qps)

    sess._pslice_aus_from_streams = tapped
    return log


def drive_sharded_run(sess, bufs, n: int, sync=lambda: None) -> dict:
    """n frames of the clip through a sharded session: the IDR through one
    encode_frames call, the P frames through a second. Works on the JAX
    package's ShardedEncoderSession as on the port's. Returns "aus", "log"
    (tap_sharded's), "t_idr" and "t_p" in seconds."""
    out = {"log": tap_sharded(sess)}

    def timed(fn):
        sync()
        t0 = time.perf_counter()
        res = fn()
        sync()
        return res, time.perf_counter() - t0

    idr, out["t_idr"] = timed(lambda: sess.encode_frames(bufs[:1]))
    rest, out["t_p"] = timed(lambda: sess.encode_frames(bufs[1:n]))
    out["aus"] = idr + rest
    return out


def sharded_record(sess, aus, log) -> dict:
    """What a sharded run is held to: a digest and a size per AU, per P
    frame the tiles' bit counts and the QP, and the final rate state."""
    return {
        "au_sha256": [hashlib.sha256(a).hexdigest() for a in aus],
        "au_bytes": [len(a) for a in aus],
        "bits": [[int(b) for b in row] for bits, _q in log for row in bits],
        "qps": [int(q) for _b, qps in log if qps is not None for q in qps],
        "rc_final": {k: float(v) for k, v in sess.base.rc_state.items()},
    }


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


# Phase 14: the streams the scalar oracle decodes, each as (EncoderConfig
# fields beside width/height/qp/gop_size, frames of the clip), at 176x144
# (QCIF) and constant QP 30 with CAVLC (the oracle parses CAVLC only). The
# last two are the streams the device decoder refuses, so the API's
# decoder hands them to the oracle.
ORACLE_W, ORACLE_H = 176, 144
ORACLE_RUNS = {
    "oracle_cq": (dict(), 5),
    "oracle_i4x4": (dict(i4x4=True), 5),
    "oracle_slices4": (dict(num_slices=4, deblock_across_slices=False), 5),
    "oracle_bgop": (dict(b_frames=1), 5),
    "oracle_lossless": (dict(lossless=True), 1),
}
ORACLE_FALLBACK = ("oracle_bgop", "oracle_lossless")


def drive_oracle_run(session_cls, config_cls, name: str, bufs, **kw):
    """One run of ORACLE_RUNS through a session of either package: a B-GOP
    through one encode_frames call, any other frame by frame through
    encode_frame. Returns (session, AUs, per AU the recon planes after it
    as numpy, None for a B-GOP's)."""
    fields, n = ORACLE_RUNS[name]
    sess = session_cls(config_cls(width=ORACLE_W, height=ORACLE_H, qp=QP,
                                  gop_size=30, **fields), **kw)
    if sess.cfg.b_frames:
        return sess, sess.encode_frames(bufs[:n]), [None] * n
    aus, recon = [], []
    for buf in bufs[:n]:
        aus.append(sess.encode_frame(buf))
        recon.append(tuple(_host(p) for p in sess.recon))
    return sess, aus, recon


def api_clip(name: str):
    """The I420 frames of an API run: the smoke clip at the run's
    geometry."""
    _props, n, _events, (w, h) = API_RUNS[name]
    return clip_i420(w, h, n)[0]


def api_codec_format(name: str) -> int:
    """The decoder's CodecFormat for an API run's stream: H265 (1) for the
    format-2 slot, else H264 (0)."""
    return int(API_RUNS[name][0].get("KEY_ENCODE_FORMAT") == "2")


def drive_api_encode(api, params, name: str, bufs, sync=lambda: None,
                     **factory_kw) -> dict:
    """One run of API_RUNS through create_video_encoder -> init -> start ->
    encode_one_frame per frame -> stop -> destroy, the properties of the
    run set on the store before the frames that name them. Works on the
    JAX package's api/params modules as on the port's (factory_kw: the
    port's device). Returns "codes" (every call's), "aus", "qps" (the
    encoder's QP after each frame), "ms" per frame on the host clock
    between calls of `sync`, and "stats" (get_encoder_statistics after the
    last frame)."""
    props, n, events, _geometry = API_RUNS[name]
    store = params.ParamStore({getattr(params, k): v
                               for k, v in props.items()})
    enc = api.create_video_encoder(store, **factory_kw)
    out = {"codes": [enc.init_encoder(), enc.start_encoder()], "aus": [],
           "qps": [], "ms": []}
    for i in range(n):
        for k, v in events.get(i, {}).items():
            store.set(getattr(params, k), v)
        sync()
        t0 = time.perf_counter()
        code, au = enc.encode_one_frame(bufs[i])
        sync()
        out["ms"].append((time.perf_counter() - t0) * 1e3)
        out["codes"].append(code)
        out["aus"].append(bytes(au))
        out["qps"].append(enc._current_qp())
    out["stats"] = enc.get_encoder_statistics()
    out["codes"] += [enc.stop_encoder(), enc.destroy_encoder()]
    out["codes"] = [int(c) for c in out["codes"]]
    return out


# Codes of the decoder half that the drain loop acts on (DecoderRetCode,
# the reference's values, in both packages and in the C ABI).
DEC_SUCCESS, DEC_WRITE_OVERFLOW, DEC_READ_UNDERFLOW = 0, 11, 12
DEC_BAD_PIC_SIZE, DEC_EOS = 13, 14


def feed_and_drain(aus, send, retrieve, sync=lambda: None):
    """The stream in API_FEED-byte pieces through send(piece) -> code, then
    the end-of-stream marker b"", draining with retrieve() -> (code,
    payload) after every piece (draining and feeding again on
    WRITE_OVERFLOW, retrying on BAD_PIC_SIZE) until EOS. Returns (every
    send's code, the payloads, seconds on the host clock between calls of
    `sync`)."""
    codes, payloads = [], []

    def drain(until_eos: bool) -> None:
        while True:
            code, payload = retrieve()
            if code == DEC_SUCCESS:
                payloads.append(payload)
            elif code == DEC_EOS and until_eos:
                return
            elif code == DEC_READ_UNDERFLOW and not until_eos:
                return
            elif code != DEC_BAD_PIC_SIZE:
                raise AssertionError(f"retrieve_frame_data: {code!r}")

    def feed(piece: bytes) -> None:
        while True:
            code = send(piece)
            codes.append(code)
            if code != DEC_WRITE_OVERFLOW:
                return
            drain(False)

    stream = b"".join(aus)
    sync()
    t0 = time.perf_counter()
    for i in range(0, len(stream), API_FEED):
        feed(stream[i : i + API_FEED])
        drain(False)
    feed(b"")
    drain(True)
    sync()
    return codes, payloads, time.perf_counter() - t0


def drive_api_decode(api, aus, codec_format: int = 0, sync=lambda: None,
                     **factory_kw) -> dict:
    """A stream through create_video_decoder -> create_decoder ->
    init -> start, fed in API_FEED-byte pieces and then the end-of-stream
    marker, drained with retrieve_frame_data after every piece (draining
    and feeding again on WRITE_OVERFLOW, taking the new geometry on
    BAD_PIC_SIZE) until EOS. Works on both packages' api modules. Returns
    "codes" (every send's and the lifecycle calls'), "payloads", "events",
    "fallbacks" (the chunks the decoder handed to the scalar oracle) and
    "s" on the host clock between calls of `sync`."""
    dec = api.create_video_decoder(**factory_kw)
    out = {"codes": [dec.create_decoder(codec_format), dec.init_decoder()],
           "payloads": [], "events": [], "fallbacks": 0}
    dec.set_callbacks(lambda ev, info: out["events"].append(int(ev)))
    out["codes"].append(dec.start_decoder())
    inner = dec._fallback_to_reference

    def fallback(chunk):
        out["fallbacks"] += 1
        return inner(chunk)

    dec._fallback_to_reference = fallback
    codes, out["payloads"], out["s"] = feed_and_drain(
        aus, dec.send_stream_data, lambda: dec.retrieve_frame_data()[:2],
        sync)
    out["codes"] += codes + [dec.stop_decoder(), dec.destroy_decoder()]
    out["codes"] = [int(c) for c in out["codes"] if c != DEC_WRITE_OVERFLOW]
    return out


def api_record(enc_run, dec_run) -> dict:
    """What an API run is held to: every code, a digest and a size per AU,
    the encoder's QP after each frame, a digest per decoded payload, and
    the decoder's fallbacks to the scalar oracle."""
    return {"codes": enc_run["codes"],
            "au_sha256": [hashlib.sha256(a).hexdigest()
                          for a in enc_run["aus"]],
            "au_bytes": [len(a) for a in enc_run["aus"]],
            "qps": [float(q) for q in enc_run["qps"]],
            "decode_codes": dec_run["codes"],
            "decoded_sha256": [hashlib.sha256(p).hexdigest()
                               for p in dec_run["payloads"]],
            "fallbacks": dec_run["fallbacks"]}


def api_speeds(enc_run, dec_run, idr2: int) -> dict:
    """An API run's host-clock speeds: "p_fps" (the frames that are not
    IDRs, one a call), "idr_ms" (frame 0 and frame idr2), "decode_fps"."""
    ms = enc_run["ms"]
    p_ms = [t for i, t in enumerate(ms) if i not in (0, idr2)]
    return {"p_fps": len(p_ms) / (sum(p_ms) / 1e3),
            "idr_ms": (ms[0], ms[idr2]),
            "decode_fps": len(dec_run["payloads"]) / dec_run["s"]}


def drive_capi_encode(lib, enc, params, run, bufs, sync=lambda: None) -> dict:
    """An API_RUNS entry through the C ABI on the encoder handle `enc` of
    `lib` (a library bound by media_tpu_torch.native.bind_capi): each
    property through MtpuEncoderSetParam under its string key in `params`,
    before InitEncoder or before the frame that names it; InitEncoder ->
    StartEncoder -> EncodeOneFrame per frame -> StopEncoder ->
    DestroyVideoEncoder. Returns "codes" (every call's after the factory),
    "aus" and "ms" per frame on the host clock between calls of `sync`."""
    import ctypes

    props, n, events, _geometry = run
    if not enc:
        raise AssertionError("the C encoder factory returned NULL")

    def set_props(items) -> None:
        for k, v in items:
            code = lib.MtpuEncoderSetParam(enc, getattr(params, k).encode(),
                                           str(v).encode())
            if code:
                raise AssertionError(f"MtpuEncoderSetParam({k}): {code:#x}")

    set_props(props.items())
    out = {"codes": [lib.InitEncoder(enc), lib.StartEncoder(enc)], "aus": [],
           "ms": []}
    ptr = ctypes.POINTER(ctypes.c_uint8)()
    n_out = ctypes.c_uint32()
    for i in range(n):
        set_props(events.get(i, {}).items())
        sync()
        t0 = time.perf_counter()
        code = lib.EncodeOneFrame(enc, bufs[i], len(bufs[i]),
                                  ctypes.byref(ptr), ctypes.byref(n_out))
        sync()
        out["ms"].append((time.perf_counter() - t0) * 1e3)
        out["codes"].append(code)
        out["aus"].append(ctypes.string_at(ptr, n_out.value) if code == 0
                          else b"")
    out["codes"] += [lib.StopEncoder(enc), lib.DestroyVideoEncoder(enc)]
    return out


def drive_capi_decode(lib, dec, aus, geometry, sync=lambda: None) -> dict:
    """A stream through the C ABI's decoder half on the handle `dec` of
    `lib`: MtpuCreateDecoder(H.264) -> InitDecoder -> SetDecoderCallbacks ->
    StartDecoder, fed in API_FEED-byte pieces with SendStreamData and then
    the zero-length end of stream, drained with RetrieveFrameData into a
    buffer of w*h*3/2 bytes by feed_and_drain, as drive_api_decode drains
    (on BAD_PIC_SIZE the buffer is made anew for the geometry the call
    reports).
    Returns "codes" (as drive_api_decode's), "payloads", "events" (event,
    width, height as the C callback received them) and "s"."""
    import ctypes

    from media_tpu_torch.native import EVENT_CB

    if not dec:
        raise AssertionError("the C decoder factory returned NULL")
    events = []

    @EVENT_CB
    def on_event(ev, info, _user):
        events.append((int(ev), info.contents.width, info.contents.height))

    out = {"codes": [lib.MtpuCreateDecoder(dec, 0), lib.InitDecoder(dec)],
           "events": events}
    if lib.SetDecoderCallbacks(dec, on_event, None):
        raise AssertionError("SetDecoderCallbacks failed")
    out["codes"].append(lib.StartDecoder(dec))
    w, h = geometry
    buf = [ctypes.create_string_buffer(w * h * 3 // 2)]
    filled, ow, oh = ctypes.c_uint32(), ctypes.c_uint32(), ctypes.c_uint32()

    def retrieve():
        code = lib.RetrieveFrameData(dec, buf[0], len(buf[0]),
                                     ctypes.byref(filled), ctypes.byref(ow),
                                     ctypes.byref(oh))
        if code == DEC_BAD_PIC_SIZE:
            buf[0] = ctypes.create_string_buffer(ow.value * oh.value * 3 // 2)
        return code, buf[0].raw[: filled.value]

    codes, out["payloads"], out["s"] = feed_and_drain(
        aus, lambda piece: lib.SendStreamData(dec, piece, len(piece)),
        retrieve, sync)
    out["codes"] += codes + [lib.StopDecoder(dec),
                             lib.DestroyVideoDecoder(dec)]
    out["codes"] = [c for c in out["codes"] if c != DEC_WRITE_OVERFLOW]
    return out


def read_capi_drive_output(path: str) -> tuple[list, list]:
    """The records capi_drive writes: (every code, the AUs of the
    EncodeOneFrame calls)."""
    import struct

    with open(path, "rb") as f:
        data = f.read()
    codes, payloads, i = [], [], 0
    while i < len(data):
        code, n = struct.unpack_from("<II", data, i)
        codes.append(code)
        payloads.append(data[i + 8 : i + 8 + n])
        i += 8 + n
    return codes, payloads[2:-2]


def capi_drive_args(params, run) -> list:
    """capi_drive's --set and --at arguments for an API_RUNS entry."""
    props, _n, events, (w, h) = run
    args = ["--width", str(w), "--height", str(h)]
    for k, v in props.items():
        args += ["--set", f"{getattr(params, k)}={v}"]
    for i, items in sorted(events.items()):
        for k, v in items.items():
            args += ["--at", f"{i}:{getattr(params, k)}={v}"]
    return args


def child_env() -> dict:
    """The environment of a standalone C host of the port's library: its
    embedded interpreter computes its prefix from the program's location,
    not from this interpreter's (a venv's) site, so it gets this process's
    sys.path as PYTHONPATH, the repo root first."""
    paths = [ROOT] + [p for p in sys.path if p and p != ROOT]
    return dict(os.environ, PYTHONPATH=os.pathsep.join(paths))


def planes_sha(frame) -> str:
    """sha256 over the Y, U, V planes of a decoded picture."""
    return _sha_planes((frame.y, frame.u, frame.v))


def _sha_planes(planes) -> str:
    """sha256 over a picture's Y, U, V planes, as numpy arrays."""
    return hashlib.sha256(b"".join(
        np.ascontiguousarray(p).tobytes() for p in planes)).hexdigest()


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


def graph_ms(fn, reps: int = 50) -> float:
    """Device ms of one call of fn: a CUDA graph of the call replayed `reps`
    times between one event pair (no host work between the replays; the
    inputs stay warm in L2)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


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
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
          + ", ".join(f"{k} {sysconfig.get_config_var(k)}" for k in (
              "Py_ENABLE_SHARED", "LDLIBRARY", "LIBDIR")))
    return smi


# ptxas -v of this run's kernel build: mangled function name -> (stack
# frame, spill stores, spill loads) in bytes.
PTXAS: dict = {}


def _ptxas_spills(log: str) -> dict:
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and name:
            out[name] = tuple(int(v) for v in m.groups())
            name = None
    return out


def phase_build():
    import contextlib
    import io

    from media_tpu_torch import kernels

    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        lib, secs = kernels.build(verbose=True)
    print(log.getvalue(), end="")
    PTXAS.update(_ptxas_spills(log.getvalue()))
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

    # Two threads, each its own picture of this geometry 20 times through
    # route wave (the one CUDA graph of the geometry): every result equals
    # its picture's plain version.
    import threading

    from media_tpu_torch.ops.deblock_wave import deblock_wave_plain

    g2 = torch.Generator(device="cpu").manual_seed(12)
    pics = [planes, _smooth_planes(R, C, g2, dev)]  # the same strengths
    want = []
    for pic in pics:
        w = [p.clone() for p in pic]
        deblock_wave_plain(*w, meta, R, C)
        want.append(w)
    torch.cuda.synchronize()
    failures: list = []

    def work(i):
        try:
            for _ in range(20):
                got = deblock_frame(*pics[i], *args[3:], kernel="wave")
                torch.cuda.current_stream().synchronize()
                if not all(torch.equal(x, y) for x, y in zip(got, want[i])):
                    failures.append(i)
        except Exception as e:  # raised below, in the main thread
            failures.append(repr(e))

    before = deblock_wave_step.launches
    t0 = time.perf_counter()
    threads = [threading.Thread(target=work, args=(i,)) for i in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    t_threads = (time.perf_counter() - t0) * 1e3
    rec["launches_threaded"] = deblock_wave_step.launches - before
    if failures or rec["launches_threaded"] != 40 * n_waves(R, C):
        raise AssertionError(f"route wave in two threads: failures "
                             f"{failures}, {rec['launches_threaded']} "
                             "launches")
    print(f"[kernel] route wave in two threads, 20 pictures each (2 x 20 "
          f"graph replays, {rec['launches_threaded']} kernel nodes): every "
          f"result == its picture's plain version, {t_threads:.1f} ms on the "
          f"host clock | {smi}")
    return {"max_abs_err": max_err, **rec}


# The packer kernel's cases (csrc/device_cavlc.cu): (symbol options, out_words
# for n MBs, ratio, per-MB QP). Sparse levels; dense 28-bit escapes at ratio
# 1.0 into every chunk's full slot; a cap far below the stream (overflow); a
# stream that fits while groups of the bitcat tree overflow their level's
# capacity; all MBs skipped; a QP map with the slice QP a 0-d device tensor.
PACK_CASES = {
    "sparse": ({}, lambda n: 64 * n + 4096, 0.25, False),
    "escapes": ({"big": True, "density": 2}, lambda n: 432 * n + 64, 1.0,
                False),
    "overflow": ({}, lambda n: 8, 0.25, False),
    "level_cap": ({"big": True, "density": 1}, lambda n: 432 * n + 64, 0.25,
                  False),
    "all_skip": ({"skip_share": 1.0}, lambda n: 1 << 14, 0.25, False),
    "qp_map": ({"skip_share": 0.1}, lambda n: 64 * n + 4096, 0.25, True),
}
PACK_SHAPES = ((1, 1), (1, 5), (5, 1), (4, 6), (17, 120), (R_MB, C_MB),
               (135, 240))


def slice_symbols(R, C, seed, density=6, big=False, skip_share=0.3):
    """A packed (R, C, 386) int16 symbol tensor as the P core returns it:
    random MVs and sparse levels (|level| <= 2063, the quantiser's bound),
    a share of all-zero MBs of zero MV (skip runs)."""
    import torch

    rng = np.random.default_rng(seed)
    hi = 2063 if big else 8
    parts = [rng.integers(-35, 36, (R, C, 2))]
    for width, sparse in ((256, density), (8, 4), (120, 8)):
        parts.append((rng.integers(0, sparse, (R, C, width)) == 0)
                     * rng.integers(-hi, hi + 1, (R, C, width)))
    zero = rng.random((R, C)) < skip_share
    for a in parts:
        a[zero] = 0
    return torch.as_tensor(np.concatenate(parts, axis=2).astype(np.int16))


# Pictures the P-core kernel is held to its plain version on: a textured
# pan with sub-pel motion and noise; two-level planes (ties nearly
# everywhere); constant planes; stripes that match equally well at two
# candidates of the same cost; a pan by +-(rs - 1) samples that sends the
# edge MBs' MVs past the picture's far or near edges; and independent
# noise with chroma residuals near 255, whose chroma DC levels reach their
# clamp at QP 0.
PCORE_KINDS = ("moving", "flat", "constant", "periodic", "edge_far",
               "edge_near", "noise")
PCORE_SHAPES = ((1, 1), (1, 5), (5, 1), (6, 9), (R_MB, C_MB), (135, 240))


def _pcore_pictures(H, W, rs, seed, kind):
    """(ref, cur) luma pictures of H x W, int64."""
    rng = np.random.default_rng(seed)
    m = rs + 8  # the source's margin beyond the picture
    hm, wm = H + 2 * m, W + 2 * m

    def smooth():
        big = rng.integers(0, 256, (hm, wm)).astype(np.float64)
        for _ in range(2):
            big = (big + np.roll(big, 1, 0) + np.roll(big, 1, 1)) / 3
        return big

    def at(big, dy, dx):
        return big[m + dy : m + dy + H, m + dx : m + dx + W]

    if kind == "moving":
        big = smooth()
        cur = 0.5 * (at(big, 3, -2) + at(big, 4, -2)) + rng.normal(0, 2, (H, W))
        ref = at(big, 0, 0)
    elif kind == "flat":
        big = (rng.integers(0, 256, (hm, wm)) // 128) * 100
        ref, cur = at(big, 0, 0), at(big, 2, -3)
    elif kind == "constant":
        ref, cur = np.full((H, W), 90), np.full((H, W), 97)
    elif kind == "periodic":
        big = (np.where((np.arange(wm) // 2) % 2, 200, 40)[None, :]
               + np.where((np.arange(hm) // 2) % 2, 30, 0)[:, None])
        ref, cur = at(big, 0, 0), at(big, 2, 2)
    elif kind in ("edge_far", "edge_near"):
        s = max(rs - 1, 1) * (1 if kind == "edge_far" else -1)
        big = smooth()
        ref, cur = at(big, 0, 0), at(big, s, s)
    elif kind == "noise":
        ref, cur = (rng.integers(0, 256, (H, W)) for _ in range(2))
    else:
        raise ValueError(kind)
    return [np.asarray(p).round().clip(0, 255).astype(np.int64)
            for p in (ref, cur)]


def pcore_planes(R, C, rs, seed, kind="moving", tiles=1, tile=0):
    """The P core's six int32 inputs for an (R, C) MB grid, made with numpy
    from `seed`: cur y, u, v, and the reference's y, u, v extended above
    and below by rs + 4 and rs // 2 + 2 rows. With tiles > 1 the grid is
    row tile `tile` of a picture of tiles * R MB rows, whose extension rows
    are the picture's rows next to the tile (edge copies only at the
    picture's top and bottom), as parallel/sharding.py hands them over."""
    import torch

    hy, hc = rs + 4, rs // 2 + 2
    ref, cur = _pcore_pictures(16 * R * tiles, 16 * C, rs, seed, kind)
    out_cur, out_ref = [], []
    chroma = [(p[::2, ::2] // 2 + 40, p[1::2, 1::2] // 3 + 70)
              for p in (ref, cur)]
    if kind == "noise":  # chroma residuals near 255: the DC levels clamp
        chroma = [(0 * u, 0 * v) for u, v in chroma[:1]] + [
            (255 - u % 8, 255 - v % 8) for u, v in chroma[1:]]
    for p, size in ((cur, 16), (chroma[1][0], 8), (chroma[1][1], 8)):
        out_cur.append(p[size * R * tile : size * R * (tile + 1)])
    for p, size, h in ((ref, 16, hy), (chroma[0][0], 8, hc),
                       (chroma[0][1], 8, hc)):
        ext = np.pad(p, ((h, h), (0, 0)), mode="edge")
        out_ref.append(ext[size * R * tile : size * R * (tile + 1) + 2 * h])
    return [torch.as_tensor(np.ascontiguousarray(p), dtype=torch.int32)
            for p in out_cur + out_ref]


def pcore_qps(form: str, n: int, seed: int):
    """(qp, qp_c) in one of the P core's three forms: Python ints, 0-d int32
    tensors, or per-MB (n,) int32 maps drawn apart for luma and chroma;
    "low" is QP 0, where the levels reach their clamp."""
    import torch

    if form == "int":
        return 30, 29
    if form == "low":
        return 0, 0
    if form == "0d":
        return (torch.tensor(27, dtype=torch.int32),
                torch.tensor(26, dtype=torch.int32))
    rng = np.random.default_rng(seed)
    return (torch.as_tensor(rng.integers(0, 52, n), dtype=torch.int32),
            torch.as_tensor(rng.integers(0, 40, n), dtype=torch.int32))


# The search ranges the P-core kernel is held at beyond the session's 8 and
# 4: none, one sample, and the wrapper's widest, 32, with 16 between.
PCORE_RANGES = (0, 1, 16, 32)


def pcore_runs(R, C, device, ranges=(8, 4)):
    """Every picture kind of PCORE_KINDS at each search range of `ranges`
    (by default 8, the session's, and 4), with the QP in its three forms in
    turn (QP 0 on the noise): [(label, inputs, rs, qp, qp_c)] on
    `device`."""
    import torch

    runs = []
    forms = ("int", "0d", "map")
    for rs in ranges:
        for i, kind in enumerate(PCORE_KINDS):
            form = "low" if kind == "noise" else forms[(i + rs) % 3]
            seed = R * C + i + rs
            planes = [p.to(device) for p in pcore_planes(R, C, rs, seed, kind)]
            qp, qp_c = (q.to(device) if torch.is_tensor(q) else q
                        for q in pcore_qps(form, R * C, seed))
            runs.append((f"rs {rs} {kind} {form}", planes, rs, qp, qp_c))
    return runs


def pcore_whole_u8(planes, rs):
    """pcore_planes' six int32 planes (of one whole picture, tiles=1) as the
    encoder holds them: uint8, the reference without its edge-padded halo
    rows (pframe_core_whole's inputs)."""
    import torch

    hy, hc = rs + 4, rs // 2 + 2
    ref = [planes[3][hy:-hy], planes[4][hc:-hc], planes[5][hc:-hc]]
    return [p.to(torch.uint8).contiguous() for p in list(planes[:3]) + ref]


# The intra wavefront kernels' shapes: one MB, one row, one column, a small
# grid and 1080p with and without the I_4x4 decision; 4K (a plain I_4x4
# IDR there would take about a minute) without it.
INTRA_SHAPES = ((1, 1), (1, 5), (5, 1), (6, 9), (R_MB, C_MB))
INTRA_4K = (135, 240)


def intra_picture(R, C, seed, kind):
    """int32 (y, u, v) planes of an (R, C) MB grid, made with numpy from
    `seed`: "flat", one level a plane, where every mode ties; "structured",
    directional edges around a flat rectangle (where I_4x4 and I_16x16 MBs
    both win) and chroma in four levels; "noise", independent samples."""
    import torch

    rng = np.random.default_rng(seed)
    h, w = 16 * R, 16 * C
    if kind == "flat":
        planes = (np.full((h, w), 77), np.full((h // 2, w // 2), 90),
                  np.full((h // 2, w // 2), 150))
    elif kind == "noise":
        planes = [rng.integers(0, 256, s)
                  for s in ((h, w), (h // 2, w // 2), (h // 2, w // 2))]
    elif kind == "structured":
        yy, xx = np.mgrid[0:h, 0:w]
        y = (128 + 60 * np.sin(xx / 3.0) * (yy % 17 < 9)
             + 50 * ((xx + 2 * yy) % 23 < 7) + rng.integers(0, 6, (h, w)))
        y = y.round().clip(0, 255)
        y[16:32, 16:48] = 100
        u = (rng.integers(0, 256, (h // 2, w // 2)) // 64) * 40 + 40
        v = 150 - 5 * (xx[::2, ::2] % 7)
        planes = (y, u, v)
    else:
        raise ValueError(kind)
    return [torch.as_tensor(np.ascontiguousarray(p), dtype=torch.int32)
            for p in planes]


def intra_runs(R, C):
    """The pictures both intra kernels are held on at an (R, C) grid:
    [(label, (y, u, v), qp, slice_starts)]: flat planes at QP 36 (the
    shifting branch of dequant_dc_4x4) and the structured picture at QP 28
    with a slice start at row R // 2; below 1080p also noise at QP 0 and the
    structured picture at QP 51."""
    mid = (R // 2,) if R >= 2 else ()
    runs = [("flat QP36", intra_picture(R, C, R * C, "flat"), 36, ()),
            (f"structured QP28 slice starts {mid}",
             intra_picture(R, C, R * C + 1, "structured"), 28, mid)]
    if R * C < R_MB * C_MB:
        runs += [("noise QP0", intra_picture(R, C, R * C + 2, "noise"), 0, ()),
                 ("structured QP51",
                  intra_picture(R, C, R * C + 3, "structured"), 51, mid)]
    return runs


def intra_recon_args(R, C, sym, qp, starts):
    """decoder_tpu.intra_recon's arguments for the symbols of an encode, the
    I_4x4 fields where the encode had the decision."""
    i4 = (tuple(sym[k] for k in ("is_i4", "modes4", "luma4_levels"))
          if "is_i4" in sym else None)
    return (R, C, sym["mode16"], sym["chroma_mode"],
            (sym["dc_levels"], sym["ac_levels"]),
            (sym["cdc_levels"], sym["cac_levels"]), qp, starts, i4)


# The deblocking meta kernel's shapes below 1080p: one MB, one row, one
# column and two small grids (the tests' too); chip_smoke adds 1080p (the
# clip's symbols) and 4K.
META_SHAPES = ((1, 1), (1, 4), (3, 1), (2, 3), (3, 4))


def meta_symbols(R, C, seed, kind="sparse"):
    """A (R, C, 386) int16 P symbol tensor made with numpy from `seed`:
    "sparse" or "dense", a share of 4x4 luma blocks (0.15 or 0.9) with one
    nonzero level at a random zig-zag position, MVs in -6..6 (neighbours
    differ by 0 to 12 quarter-pels), chroma levels that the meta does not
    read; "steps", no level and MVs 3 quarter-pels apart along a row and 4
    down a column (bS 0 on every vertical MB edge, 1 on every horizontal
    one)."""
    import torch

    rng = np.random.default_rng(seed)
    sym = np.zeros((R, C, 386), np.int16)
    if kind == "steps":
        sym[..., 0] = 3 * np.arange(C)[None, :]
        sym[..., 1] = 4 * np.arange(R)[:, None]
        return torch.as_tensor(sym)
    share = {"sparse": 0.15, "dense": 0.9}[kind]
    sym[..., :2] = rng.integers(-6, 7, (R, C, 2))
    luma = np.zeros((R, C, 16, 16), np.int16)
    pos = rng.integers(0, 16, (R, C, 16, 1))
    val = rng.choice(np.array([-300, -1, 1, 2], np.int16), (R, C, 16, 1))
    np.put_along_axis(luma, pos, val * (rng.random((R, C, 16, 1)) < share),
                      axis=3)
    sym[..., 2:258] = luma.reshape(R, C, 256)
    sym[..., 258:] = rng.integers(-5, 6, (R, C, 128))
    return torch.as_tensor(sym)


def meta_qps(form: str, R: int, C: int, seed: int) -> tuple:
    """(qp, qp_c, qp_map) in one of the forms deblock_meta takes: Python
    ints ("int"; "low" QP 0, "high" QP 51), 0-d int32 tensors ("0d"), or a
    per-MB (R, C) map ("map" 0..51, "wide" -4..57, which the tables' clips
    bound)."""
    import torch

    if form in ("int", "low", "high"):
        q = {"int": 30, "low": 0, "high": 51}[form]
        return q, max(q - 1, 0), None
    if form == "0d":
        return (torch.tensor(27, dtype=torch.int32),
                torch.tensor(26, dtype=torch.int32), None)
    rng = np.random.default_rng(seed)
    lo, hi = (0, 52) if form == "map" else (-4, 58)
    return 30, 29, torch.as_tensor(rng.integers(lo, hi, (R, C)),
                                   dtype=torch.int32)


def meta_runs(R, C, device, symbols=None):
    """The cases the meta kernel is held to its plain version on at an
    (R, C) grid: [(label, deblock_meta's keyword arguments)] on `device`: P
    pictures of meta_symbols (or the given symbols) with the QP in every
    form, a slice start at row R // 2, QP 0 and 51, the "steps" MVs; I
    pictures with a slice start, a device QP and a QP map."""
    import torch

    mid = (R // 2,) if R >= 2 else ()
    runs = []
    for i, (kind, form, starts, intra) in enumerate((
            ("sparse", "int", (), False), ("dense", "0d", (), False),
            ("sparse", "map", mid, False), ("dense", "low", (), False),
            ("steps", "high", (), False), ("dense", "wide", mid, False),
            (None, "int", mid, True), (None, "0d", (), True),
            (None, "map", (), True))):
        seed = 100 * R + 10 * C + i
        qp, qp_c, qp_map = (q.to(device) if torch.is_tensor(q) else q
                            for q in meta_qps(form, R, C, seed))
        if intra:
            sym, kind = None, "I"
        elif symbols is not None:
            sym, kind = symbols, "clip P"
        else:
            sym = meta_symbols(R, C, seed, kind).to(device)
        where = f" slice starts {starts}" if starts else ""
        runs.append((f"{kind} {form}{where}",
                     dict(symbols=sym, qp=qp, qp_c=qp_c, slice_starts=starts,
                          qp_map=qp_map, intra=intra, device=device)))
    return runs


def _device_events(fn) -> list:
    """The device activities (kernels, memsets, copies) of one call of fn,
    by torch.profiler. The trace drops the first activities after it starts
    (on the H100 it listed 178 of a call's 187 launches, and none of a
    call's one), so 64 small kernels run first. A marker kernel
    (torch.cuda._sleep's spin kernel) runs just before fn and what starts
    after it on the device's own clock is fn's: a host range's start, on
    the host's clock, lost a 0.36 ms kernel's activities in one run. The
    range's own copy on the device timeline is not an activity. A trace
    that shows nothing of fn is taken again, up to three times."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    warm = torch.zeros(1, device="cuda")
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(64):
                warm.add_(1)
            torch.cuda.synchronize()
            with record_function("chip_smoke.measured"):
                torch.cuda._sleep(1000)
                fn()
                torch.cuda.synchronize()
        device = [e for e in prof.events() if e.device_type == DeviceType.CUDA
                  and e.name != "chip_smoke.measured"]
        marks = [e.time_range.start for e in device if "spin_kernel" in e.name]
        if marks:
            events = [e for e in device if e.time_range.start > max(marks)
                      and "spin_kernel" not in e.name]
        else:
            t0 = min(e.time_range.start for e in prof.events()
                     if e.name == "chip_smoke.measured")
            events = [e for e in device if e.time_range.start >= t0]
        if events:
            break
    return events


def _device_activities(fn, names: bool = False) -> tuple:
    """Device activities of one call of fn (_device_events) and the sum of
    their device times in ms; with `names` also the sorted set of their
    names."""
    events = _device_events(fn)
    out = (len(events), sum(e.time_range.elapsed_us() for e in events) / 1e3)
    return out + (sorted({e.name for e in events}),) if names else out


def _pack_bound(n_mbs: int, out_words: int, stream_bits: int) -> dict:
    """The least time the card could take to pack a slice without a QP map:
    the int32 symbols (386 a MB) read once, the int64 stream and the bit
    count written once, over the memory rate; against one operation per
    symbol and per stream bit over the ALU rate (a floor: the codewords'
    arithmetic is more)."""
    n_bytes = n_mbs * 386 * 4 + out_words * 8 + 8
    ops = n_mbs * 386 + stream_bits
    t_bytes, t_ops = n_bytes / PEAK_BYTES_S, ops / PEAK_OPS_S
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None}  # no PyTorch call codes CAVLC


def _stream_err(got, want) -> int:
    """max |difference| of two (stream, bits) results, words and bits."""
    return max(int((got[0] - want[0]).abs().max()),
               abs(int(got[1]) - int(want[1])))


def phase_kernel_pack(smi: str) -> dict:
    """The CAVLC P-slice packer kernel against its plain version on every
    case of PACK_CASES at every shape of PACK_SHAPES: stream words (all of
    them, overflow included) and bit counts equal. At 1080p both are timed
    on random symbols, and the kernel on an all-skip slice; one call of
    each through torch.profiler for its device activities and busy time."""
    import torch

    from media_tpu_torch.entropy.device_cavlc import (
        launch_pack_pslice, pack_pslice_device, pack_pslice_plain)
    from media_tpu_torch.pipeline.pframe_core import unpack_symbols_device

    dev = torch.device("cuda")
    max_err = 0
    for R, C in PACK_SHAPES:
        results = []
        for i, (name, (opts, words, ratio, per_mb)) in enumerate(
                PACK_CASES.items()):
            sym = unpack_symbols_device(
                slice_symbols(R, C, R * C + i, **opts).to(dev))
            kw = {}
            if per_mb:
                rng = np.random.default_rng(i)
                kw = {"qp_map": torch.as_tensor(rng.integers(20, 45, (R, C)),
                                                dtype=torch.int32, device=dev),
                      "slice_qp": torch.tensor(31, dtype=torch.int32,
                                               device=dev)}
            cap = words(R * C)
            got = launch_pack_pslice(*sym, cap, ratio=ratio, **kw)
            want = pack_pslice_plain(*sym, cap, ratio=ratio, **kw)
            err = _stream_err(got, want)
            max_err = max(max_err, err)
            bits = int(want[1])
            if err:
                raise AssertionError(f"packer kernel vs plain, {R}x{C} "
                                     f"{name}: max |err| {err}")
            if (name == "level_cap" or (name == "overflow" and R * C > 1)) \
                    != (bits > cap * 32):
                raise AssertionError(f"packer {R}x{C} {name}: {bits} bits "
                                     f"for a cap of {cap} words")
            results.append(f"{name} {bits}")
        print(f"[kernel] device_cavlc_pack R={R} C={C} equal=True (words and "
              f"bits): " + ", ".join(results))

    # 1080p: times on fresh copies of random symbols.
    R, C = R_MB, C_MB
    cap = 98742  # the session's full budget at 1080p (cap_words)
    packed = slice_symbols(R, C, 11).to(dev)

    def fresh():
        return unpack_symbols_device(packed.clone())

    rec = {"ms": _cuda_median_ms(lambda *a: launch_pack_pslice(*a, cap),
                                 fresh, 30),
           "plain_ms": _cuda_median_ms(lambda *a: pack_pslice_plain(*a, cap),
                                       fresh, 5)}
    sym = fresh()
    want = pack_pslice_plain(*sym, cap)
    rec["max_abs_err"] = max(max_err,
                             _stream_err(launch_pack_pslice(*sym, cap), want))
    skip = slice_symbols(R, C, 12, skip_share=1.0).to(dev)
    rec["all_skip_ms"] = _cuda_median_ms(
        lambda *a: launch_pack_pslice(*a, cap),
        lambda: unpack_symbols_device(skip.clone()), 30)
    # On an all-skip slice no chunk codes a bit: the device time of the
    # launches themselves, the floor of the kernel's dependent chain.
    rec["chain_floor_ms"] = _device_activities(
        lambda: launch_pack_pslice(*unpack_symbols_device(skip), cap))[1]
    (rec["device_activities_per_call"],
     rec["device_busy_ms"]) = _device_activities(
        lambda: launch_pack_pslice(*sym, cap))
    (rec["plain_device_activities_per_call"],
     rec["plain_device_busy_ms"]) = _device_activities(
        lambda: pack_pslice_plain(*sym, cap))
    rec.update(_pack_bound(R * C, cap, int(want[1])))
    before = pack_pslice_device.launches
    pack_pslice_device(*sym, cap)
    if pack_pslice_device.launches != before + 1:
        raise AssertionError("pack_pslice_device did not count its launch")
    print(f"[kernel] device_cavlc_pack 1080p (R={R}, C={C}, {int(want[1])} "
          f"bits of random symbols) kernel {rec['ms']:.4f} ms (median of 30, "
          f"each on fresh symbols, the wrapper's host work inside the event "
          f"pair), {rec['device_activities_per_call']} device activities a "
          f"call (4 kernels, 2 memsets) busy {rec['device_busy_ms']:.4f} ms "
          f"by the profiler; all-skip slice {rec['all_skip_ms']:.4f} ms, "
          f"busy {rec['chain_floor_ms']:.4f} ms (the chain floor); "
          f"plain {rec['plain_ms']:.3f} ms (median of 5), "
          f"{rec['plain_device_activities_per_call']} device activities busy "
          f"{rec['plain_device_busy_ms']:.3f} ms; bound "
          f"{rec['bound_ms']:.6f} ms by {rec['bound_by']} | {smi}")
    return rec


def peak_int_ops_s() -> float:
    """32-bit integer instructions a second of card 0: INT_LANES_PER_SM
    over its SMs at its highest SM clock (nvidia-smi clocks.max.sm)."""
    import torch

    mhz = float(subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], check=True, capture_output=True,
        text=True).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return INT_LANES_PER_SM * sms * mhz * 1e6


def _pcore_bound(planes, out, rs: int) -> dict:
    """The least time the card could take for the P core: the six input
    planes read once (uint8 on the encoder's entry), the symbols, recon
    planes and SAD total written once, over the memory rate; against the
    packed integer instructions its candidates need over the card's integer
    rate: one SAD instruction a word of four samples of every full-pel and
    quarter-pel candidate, and one byte average a word of the 40 quarter-pel
    candidates of 49 that lie off the full- and half-pel grid (a floor: the
    alignment, the 6-tap filters, the chroma MC and the transforms are
    more). scalar_bound_ms: the count of the earlier kernel's design, three
    operations (subtract, absolute value, accumulate) a sample at
    PEAK_OPS_S."""
    n_mbs = out["symbols"].shape[0] * out["symbols"].shape[1]
    n_bytes = _nbytes(*planes, *out.values())
    ops = n_mbs * ((2 * rs + 1) ** 2 + 49 + 40) * 64
    int_rate = peak_int_ops_s()
    t_bytes, t_ops = n_bytes / PEAK_BYTES_S, ops / int_rate
    scalar = n_mbs * ((2 * rs + 1) ** 2 + 49) * 256 * 3 / PEAK_OPS_S
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_bytes": n_bytes, "bound_ops": ops,
            "bound_int_ops_s": int_rate,
            "scalar_bound_ms": max(t_bytes, scalar) * 1e3,
            # No PyTorch call computes a first-minimum SAD search or this
            # transform chain.
            "library_ms": None}


def _core_err(got, want) -> int:
    """max |difference| over every output of two P-core results."""
    return max(int((got[k].long() - want[k].long()).abs().max())
               for k in want)


def phase_kernel_pcore(smi: str) -> dict:
    """The P-core kernel against its plain versions on every run of
    pcore_runs at every shape of PCORE_SHAPES and on two 17-row tiles of a
    1080p picture cut in four, whose halo rows are the neighbours' rows:
    every symbol, recon sample and SAD total, and the search alone's MVs,
    predictions and costs, equal; through the int32 entry and the uint8
    one (on the whole-picture reference whose rows the kernel clamps, and
    on the tiles' real halo rows). At 1080p both timed on fresh inputs, the
    uint8 whole-picture entry (the encoder's), the int32 entry and the
    search alone; one call of each through torch.profiler for its device
    activities and busy time; the kernel's registers, shared bytes, local
    bytes, spills (ptxas) and resident blocks an SM."""
    import torch

    from media_tpu_torch.pipeline.pframe_core import (
        kernel_resources, launch_pframe_core, launch_search_refine_luma,
        local_pframe_core, local_pframe_core_plain, pframe_core_whole,
        search_refine_luma_plain, to_mbs)

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    max_err = 0
    # Every run at the small shapes, at ranges 8 and 4 and those of
    # PCORE_RANGES; at 1080p and 4K (where the plain version's time and the
    # inputs' numpy build dominate the phase) every other run at ranges 8
    # and 4: both ranges, the three QP forms and QP 0, two-level, striped
    # and off-edge pictures still among them.
    cases = [(f"{R}x{C}", R, C,
              pcore_runs(R, C, dev)[::2] if R * C >= R_MB * C_MB else
              pcore_runs(R, C, dev, (8, 4) + PCORE_RANGES))
             for R, C in PCORE_SHAPES]
    tiles = []
    for rs, t in ((8, 1), (4, 2)):
        planes = [p.to(dev) for p in pcore_planes(17, C_MB, rs, t, "moving",
                                                  tiles=4, tile=t)]
        qp = torch.full((17 * C_MB,), 31, dtype=torch.int32, device=dev)
        tiles.append((f"rs {rs} tile {t} of 4", planes, rs, qp, 30))
    cases.append(("17x120 tiles", 17, C_MB, tiles))
    for what, R, C, runs in cases:
        labels = []
        for label, planes, rs, qp, qp_c in runs:
            got = launch_pframe_core(*planes, qp, qp_c, rs, R, C)
            want = local_pframe_core_plain(*planes, qp, qp_c, rs, R, C)
            if "tile" in label:  # uint8 with the real halo rows as given
                u8 = launch_pframe_core(*(p.to(torch.uint8) for p in planes),
                                        qp, qp_c, rs, R, C)
            else:  # uint8, the reference's rows clamped by the kernel
                u8 = launch_pframe_core(*pcore_whole_u8(planes, rs), qp,
                                        qp_c, rs, R, C, whole=True)
            cur = to_mbs(planes[0], R, C, 16)
            s_got = launch_search_refine_luma(cur, planes[3], rs, R, C)
            s_want = search_refine_luma_plain(cur, planes[3], rs, R, C)
            err = max(_core_err(got, want), _core_err(u8, want), *(
                int((a.long() - b.long()).abs().max())
                for a, b in zip(s_got, s_want)))
            if err or any(got[k].dtype != want[k].dtype
                          or u8[k].dtype != want[k].dtype for k in want):
                raise AssertionError(f"P-core kernel vs plain, {what} "
                                     f"{label}: max |err| {err}")
            max_err = max(max_err, err)
            labels.append(label)
        print(f"[kernel] pframe_core {what} equal=True (symbols, recon, "
              f"sad_total through the int32 and the uint8 entries; the "
              f"search's qmv, pred, cost) on {len(runs)} runs: "
              f"{', '.join(labels)}")

    # 1080p at the session's operating point: rs 8, QP 30.
    R, C, rs, qp, qp_c = R_MB, C_MB, 8, QP, 29
    planes = pcore_planes(R, C, rs, 21, "moving")
    planes = [p.to(dev) for p in planes]

    whole = pcore_whole_u8(planes, rs)

    def fresh():
        return [p.clone() for p in planes]

    def kernel(*a):  # the encoder's entry: uint8, whole-picture reference
        return launch_pframe_core(*a, qp, qp_c, rs, R, C, whole=True)

    def kernel_int32(*a):
        return launch_pframe_core(*a, qp, qp_c, rs, R, C)

    def plain(*a):
        return local_pframe_core_plain(*a, qp, qp_c, rs, R, C)

    rec = {"ms": _cuda_median_ms(kernel, lambda: [p.clone() for p in whole],
                                 30),
           "int32_ms": _cuda_median_ms(kernel_int32, fresh, 30),
           "plain_ms": _cuda_median_ms(plain, fresh, 5)}
    cur = to_mbs(planes[0], R, C, 16)
    rec["search_ms"] = _cuda_median_ms(
        lambda c, r: launch_search_refine_luma(c, r, rs, R, C),
        lambda: (cur.clone(), planes[3].clone()), 30)
    rec["search_plain_ms"] = _cuda_median_ms(
        lambda c, r: search_refine_luma_plain(c, r, rs, R, C),
        lambda: (cur.clone(), planes[3].clone()), 5)
    rec["graph_ms"] = graph_ms(lambda: kernel(*whole))
    rec["search_graph_ms"] = graph_ms(
        lambda: launch_search_refine_luma(cur, planes[3], rs, R, C))
    want = plain(*planes)
    rec["max_abs_err"] = max(max_err, _core_err(kernel(*whole), want),
                             _core_err(kernel_int32(*planes), want))
    (rec["device_activities_per_call"], rec["device_busy_ms"],
     activities) = _device_activities(lambda: kernel(*whole), names=True)
    (rec["int32_device_activities_per_call"],
     rec["int32_device_busy_ms"]) = _device_activities(
        lambda: kernel_int32(*planes))
    (rec["plain_device_activities_per_call"],
     rec["plain_device_busy_ms"]) = _device_activities(lambda: plain(*planes))
    rec.update(_pcore_bound(whole, want, rs))
    res = {kind: kernel_resources(rs, uint8=kind == "uint8")
           for kind in ("uint8", "int32")}
    spills = {("uint8" if "IhE" in name else "int32"): v
              for name, v in PTXAS.items() if "pframe_core_kernel" in name}
    for kind, r in res.items():
        rec.update({f"{kind}_{k}": v for k, v in r.items()})
        if kind in spills:
            rec[f"{kind}_spill_store_bytes"] = spills[kind][1]
    before = local_pframe_core.launches
    local_pframe_core(*planes, qp, qp_c, rs, R, C)
    pframe_core_whole(*whole, qp, qp_c, rs, R, C)
    if local_pframe_core.launches != before + 2:
        raise AssertionError("local_pframe_core or pframe_core_whole did not "
                             "count its launch")
    print(f"[kernel] pframe_core 1080p (R={R}, C={C}, rs {rs}, QP {qp}/{qp_c}, "
          f"a moving picture) kernel {rec['ms']:.4f} ms through the uint8 "
          f"entry on a whole-picture reference (the encoder's; median of 30, "
          f"each on fresh inputs, the wrapper's host work inside the event "
          f"pair), {rec['device_activities_per_call']} device activities a "
          f"call ({', '.join(activities)}) busy {rec['device_busy_ms']:.4f} "
          f"ms by the profiler; the int32 entry on extended planes "
          f"{rec['int32_ms']:.4f} ms (busy "
          f"{rec['int32_device_busy_ms']:.4f}); a CUDA graph of one call "
          f"replayed 50 times, the device's time alone: the uint8 entry "
          f"{rec['graph_ms']:.4f} ms, the search alone "
          f"{rec['search_graph_ms']:.4f} ms; the search alone "
          f"{rec['search_ms']:.4f} ms (plain "
          f"{rec['search_plain_ms']:.3f}); plain {rec['plain_ms']:.3f} ms "
          f"(median of 5), {rec['plain_device_activities_per_call']} device "
          f"activities busy {rec['plain_device_busy_ms']:.3f} ms; bound "
          f"{rec['bound_ms']:.6f} ms by {rec['bound_by']} "
          f"({rec['bound_bytes']} bytes, {rec['bound_ops']} packed integer "
          f"instructions at {rec['bound_int_ops_s'] / 1e12:.3f} T/s; three "
          f"operations a sample at {PEAK_OPS_S / 1e12:.0f} T/s, the earlier "
          f"count, {rec['scalar_bound_ms']:.6f} ms); "
          + "; ".join(
              f"{kind} instance {r['registers']} registers, "
              f"{r['static_shared_bytes']} static + "
              f"{r['dynamic_shared_bytes']} dynamic shared bytes, "
              f"{r['local_bytes']} local bytes, spill stores "
              f"{spills[kind][1] if kind in spills else 'not in this build'}"
              f", {r['threads']} threads a block, {r['blocks_per_sm']} "
              f"resident blocks an SM" for kind, r in res.items())
          + f"; phase {time.perf_counter() - t0:.1f} s | {smi}")
    return rec


def _intra_err(got, want) -> int:
    """max |difference| over every output of two intra encodes or two
    reconstructions (dicts or plane tuples); a dtype or a set of keys that
    differs counts as a difference."""
    if isinstance(want, dict):
        if set(got) != set(want):
            return 1 << 30
        got, want = [got[k] for k in want], list(want.values())
    err = 0
    for a, b in zip(got, want):
        if a.dtype != b.dtype:
            return 1 << 30
        err = max(err, int((a.long() - b.long()).abs().max()))
    return err


def _events_ms(fn) -> tuple:
    """(ms by one CUDA event pair, result) of one call of fn."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end), out


def _intra_bound(inputs, outputs, ops_per_mb: int, n_mbs: int) -> dict:
    """The least time the card could take: the inputs read once and the
    outputs written once over the memory rate, against `ops_per_mb` a MB
    over the ALU rate (a floor: three operations, subtract, absolute value
    and add, per sample of every candidate prediction the encoder costs;
    three per reconstructed sample in the decoder)."""
    n_bytes = _nbytes(*inputs, *outputs)
    ops = n_mbs * ops_per_mb
    t_bytes, t_ops = n_bytes / PEAK_BYTES_S, ops / PEAK_OPS_S
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_bytes": n_bytes, "bound_ops": ops}


def phase_kernel_intra(smi: str) -> tuple:
    """Both intra wavefront kernels against their plain loops on every run
    of intra_runs at every shape of INTRA_SHAPES, with and without the
    I_4x4 decision, and at 4K without it: every symbol array, is_i4,
    modes4 and recon sample of the encoder kernel, and every sample the
    recon kernel decodes from the plain encode's symbols, equal. At 1080p
    (the structured picture, QP 28) both kernels timed on fresh inputs
    (median of 10) beside one run of each plain loop, one call of each
    through torch.profiler for its device activities and busy time, and
    the bounds. Returns the records of intra_encode and intra_recon."""
    import torch

    from media_tpu_torch.ops.transform import chroma_qp
    from media_tpu_torch.pipeline.decoder_tpu import (
        intra_recon, intra_recon_plain, row_has_top)
    from media_tpu_torch.pipeline.encoder import intra_encode, intra_encode_plain
    from media_tpu_torch.pipeline.intra_wave import (
        launch_intra_encode, launch_intra_recon)

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    max_err = {"encode": 0, "recon": 0}
    for R, C in INTRA_SHAPES + (INTRA_4K,):
        labels = []
        for label, planes, qp, starts in intra_runs(R, C):
            planes = [p.to(dev) for p in planes]
            qp_c = int(chroma_qp(qp))
            has_top = row_has_top(R, starts, dev)
            for i4x4 in (False,) if (R, C) == INTRA_4K else (False, True):
                got = launch_intra_encode(*planes, qp, qp_c, has_top, i4x4)
                want = intra_encode_plain(*planes, qp, qp_c, has_top, i4x4)
                args = intra_recon_args(R, C, want, qp, starts)
                got_r = launch_intra_recon(*args[:7], qp_c, has_top,
                                           args[8])
                want_r = intra_recon_plain(*args)
                errs = (_intra_err(got, want), _intra_err(got_r, want_r))
                if any(errs):
                    raise AssertionError(
                        f"intra kernels vs plain, {R}x{C} {label} i4x4 "
                        f"{i4x4}: max |err| encode {errs[0]}, recon "
                        f"{errs[1]}")
                n_i4 = int(want["is_i4"].sum()) if i4x4 else 0
                labels.append(f"{label}{' I_4x4 ' + str(n_i4) if i4x4 else ''}")
        print(f"[kernel] intra_encode + intra_recon {R}x{C} equal=True "
              f"(every symbol array and recon sample; the decode of the "
              f"plain symbols) on {len(labels)} runs: {', '.join(labels)}")

    # 1080p: the structured picture at the operating point's IDR QP.
    R, C, qp = R_MB, C_MB, 28
    qp_c = int(chroma_qp(qp))
    planes = [p.to(dev) for p in intra_picture(R, C, 41, "structured")]
    has_top = row_has_top(R, (), dev)

    def fresh():
        return [p.clone() for p in planes]

    enc, rec = {"max_abs_err": 0}, {"max_abs_err": 0}
    for i4x4 in (False, True):
        sfx = "_i4x4" if i4x4 else ""
        waves = 2 * (R - 1) + C if i4x4 else R + C - 1

        def kernel(*p, _i4=i4x4):
            return launch_intra_encode(*p, qp, qp_c, has_top, _i4)

        enc["ms" + sfx] = _cuda_median_ms(kernel, fresh, 10)
        enc["plain_ms" + sfx], want = _events_ms(
            lambda: intra_encode_plain(*planes, qp, qp_c, has_top, i4x4))
        got = kernel(*planes)
        enc["max_abs_err"] = max(enc["max_abs_err"], _intra_err(got, want))
        (enc["device_activities_per_call" + sfx],
         enc["device_busy_ms" + sfx]) = _device_activities(
            lambda: kernel(*planes))
        enc["waves" + sfx] = waves
        enc["ms_per_wave" + sfx] = enc["ms" + sfx] / waves
        n_cand = 4 * 256 + 8 * 64 + (9 * 256 if i4x4 else 0)
        b = _intra_bound(planes, list(got.values()), 3 * n_cand, R * C)
        enc.update({k + sfx: v for k, v in b.items()})

        args = intra_recon_args(R, C, want, qp, ())
        sym = [args[2], args[3], *args[4], *args[5], *(args[8] or ())]

        def fresh_sym(_sym=sym):
            return [x.clone() for x in _sym]

        def recon(m16, cm, dc, ac, cdc, cac, *i4):
            return launch_intra_recon(R, C, m16, cm, (dc, ac), (cdc, cac), qp,
                                      qp_c, has_top, tuple(i4) or None)

        rec["ms" + sfx] = _cuda_median_ms(recon, fresh_sym, 10)
        rec["plain_ms" + sfx], want_r = _events_ms(
            lambda: intra_recon_plain(*args))
        got_r = recon(*sym)
        rec["max_abs_err"] = max(rec["max_abs_err"], _intra_err(got_r, want_r))
        (rec["device_activities_per_call" + sfx],
         rec["device_busy_ms" + sfx]) = _device_activities(
            lambda: recon(*sym))
        rec["waves" + sfx] = waves
        rec["ms_per_wave" + sfx] = rec["ms" + sfx] / waves
        b = _intra_bound(sym, got_r, 3 * 384, R * C)
        rec.update({k + sfx: v for k, v in b.items()})
        kind = (f"I_4x4 decision: {int(want['is_i4'].sum())} I_4x4 MBs"
                if i4x4 else "I_16x16")
        for what, r in (("intra_encode", enc), ("intra_recon", rec)):
            print(f"[kernel] {what} 1080p (R={R}, C={C}, QP {qp}, the "
                  f"structured picture, {kind}) "
                  f"kernel {r['ms' + sfx]:.4f} ms (median of 10, each on "
                  f"fresh inputs, the wrapper's host work inside the event "
                  f"pair), {r['ms_per_wave' + sfx]:.5f} ms a wave over "
                  f"{waves} waves; {r['device_activities_per_call' + sfx]} "
                  f"device activities a call busy "
                  f"{r['device_busy_ms' + sfx]:.4f} ms by the profiler; plain "
                  f"{r['plain_ms' + sfx]:.1f} ms (one run); bound "
                  f"{r['bound_ms' + sfx]:.6f} ms by {r['bound_by' + sfx]} "
                  f"({r['bound_bytes' + sfx]} bytes, {r['bound_ops' + sfx]} "
                  f"operations) | {smi}")
    err = max(enc["max_abs_err"], rec["max_abs_err"])
    if err:
        raise AssertionError(f"intra kernels vs plain at 1080p: max |err| "
                             f"{err}")
    # The timed figures of the contract's line are the I_16x16 IDR's.
    for r in (enc, rec):
        r["library_ms"] = None  # no PyTorch call computes an intra decision
    counts = (lambda: (intra_encode.launches, intra_encode.kernel_launches,
                       intra_recon.launches, intra_recon.kernel_launches))
    before = counts()
    out = intra_encode(*planes, qp, qp_c, has_top, False)
    intra_recon(*intra_recon_args(R, C, out, qp, ())[:8])
    got = [n - m for n, m in zip(counts(), before)]
    if got != [1, R + C - 1] * 2:
        raise AssertionError(f"the intra wrappers counted {got} (calls, "
                             f"kernel launches) for one call each")
    print(f"[kernel] intra phase {time.perf_counter() - t0:.1f} s | {smi}")
    return enc, rec


def _meta_bound(n_mbs: int, meta, qp_map=None) -> dict:
    """The least time the card could take for the meta of n_mbs MBs: the MV
    and the 256 luma levels of each MB (int16) and the QP map read once,
    the int32 meta written once, over the memory rate; against one
    operation per level (the nonzero test) and four per meta column (the
    strength, the table row, the lookup, the store) over the ALU rate."""
    n_bytes = n_mbs * (2 + 256) * 2 + _nbytes(meta) + (
        0 if qp_map is None else _nbytes(qp_map))
    ops = n_mbs * (256 + 4 * meta.shape[1])
    t_bytes, t_ops = n_bytes / PEAK_BYTES_S, ops / PEAK_OPS_S
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_bytes": n_bytes, "bound_ops": ops,
            "library_ms": None}  # no PyTorch call builds deblocking meta


def clip_pframe_symbols(bufs, qp: int = QP, rs: int = 8):
    """The 1080p clip's frame 1 coded against its frame 0 by the P-core
    kernel at `qp`: the (R, C, 386) int16 symbols on the card, uncounted."""
    import torch

    from media_tpu_torch.ops.transform import chroma_qp
    from media_tpu_torch.pipeline.pframe_core import launch_pframe_core
    from media_tpu_torch.utils import yuv

    planes = [torch.as_tensor(yuv.pad_to_mb_grid(p, s)).to("cuda")
              for buf in bufs[:2]
              for p, s in zip(yuv.split_i420(buf, WIDTH, HEIGHT), (16, 8, 8))]
    return launch_pframe_core(*planes[3:], *planes[:3], qp,
                              int(chroma_qp(qp)), rs, R_MB, C_MB,
                              whole=True)["symbols"]


def phase_kernel_meta(smi: str, bufs) -> dict:
    """The deblocking meta kernel against its plain version (build_meta
    over pframe_bs_grids or intra_bs_grids) on every run of meta_runs at
    every shape of META_SHAPES, at 4K, at 1080p on the clip's P symbols, and
    on the four 17-row tiles of those symbols with a device QP each (one
    with a QP map): every meta column equal. At 1080p the kernel timed by
    one CUDA event pair a launch (median of 30) at uniform QP, with a QP map
    and on an I picture, beside the plain version; one call of each through
    torch.profiler for its device activities and busy time."""
    import torch

    from media_tpu_torch.ops.transform import chroma_qp
    from media_tpu_torch.pipeline.deblock_apply import (
        deblock_meta, deblock_meta_plain, launch_deblock_meta)
    from media_tpu_torch.pipeline.pframe_core import chroma_qp_device

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    max_err = 0

    def check(what, R, C, runs):
        nonlocal max_err
        for label, kw in runs:
            got = launch_deblock_meta(**kw, R=R, C=C)
            want = deblock_meta_plain(**kw, R=R, C=C)
            err = int((got.long() - want.long()).abs().max())
            if err or got.dtype != want.dtype or got.shape != want.shape:
                bad = (got != want).any(dim=0).nonzero().flatten().tolist()
                raise AssertionError(f"meta kernel vs plain, {what} {label}: "
                                     f"max |err| {err}, columns {bad}")
            max_err = max(max_err, err)
        print(f"[kernel] deblock_meta {what} equal=True (every column) on "
              f"{len(runs)} runs: {', '.join(label for label, _ in runs)}")

    for R, C in META_SHAPES + ((135, 240),):
        check(f"{R}x{C}", R, C, meta_runs(R, C, dev))
    R, C = R_MB, C_MB
    qp, qp_c = QP, int(chroma_qp(QP))
    sym = clip_pframe_symbols(bufs)
    runs = meta_runs(R, C, dev, symbols=sym)
    check("1080p (the clip's P symbols)", R, C, runs)
    tiles = []
    for t in range(4):
        q = torch.tensor(28 + 2 * t, dtype=torch.int32, device=dev)
        tmap = None if t != 2 else (q + torch.arange(
            17 * C, device=dev).reshape(17, C) % 3 - 1)
        tiles.append((f"tile {t} of 4 device QP {28 + 2 * t}"
                      + (" QP map" if tmap is not None else ""),
                      dict(symbols=sym[17 * t : 17 * (t + 1)], qp=q,
                           qp_c=chroma_qp_device(q), qp_map=tmap)))
    check("17x120 tiles of the clip's P symbols", 17, C, tiles)

    qp_map = runs[2][1]["qp_map"]
    rec = {
        "ms": _cuda_median_ms(lambda s: launch_deblock_meta(s, qp, qp_c, R, C),
                              lambda: (sym,), 30),
        "plain_ms": _cuda_median_ms(
            lambda s: deblock_meta_plain(s, qp, qp_c, R, C), lambda: (sym,),
            10),
        "qp_map_ms": _cuda_median_ms(
            lambda s: launch_deblock_meta(s, qp, qp_c, R, C, qp_map=qp_map),
            lambda: (sym,), 30),
        "qp_map_plain_ms": _cuda_median_ms(
            lambda s: deblock_meta_plain(s, qp, qp_c, R, C, qp_map=qp_map),
            lambda: (sym,), 10),
        "intra_ms": _cuda_median_ms(
            lambda: launch_deblock_meta(None, qp, qp_c, R, C, intra=True,
                                        device=dev), lambda: (), 30),
        "intra_plain_ms": _cuda_median_ms(
            lambda: deblock_meta_plain(None, qp, qp_c, R, C, intra=True,
                                       device=dev), lambda: (), 10),
        "max_abs_err": max_err,
    }
    meta = launch_deblock_meta(sym, qp, qp_c, R, C)
    (rec["device_activities_per_call"], rec["device_busy_ms"],
     activities) = _device_activities(
        lambda: launch_deblock_meta(sym, qp, qp_c, R, C), names=True)
    (rec["plain_device_activities_per_call"],
     rec["plain_device_busy_ms"]) = _device_activities(
        lambda: deblock_meta_plain(sym, qp, qp_c, R, C))
    rec.update(_meta_bound(R * C, meta))
    before = deblock_meta.launches
    deblock_meta(sym, qp, qp_c, R, C)
    if deblock_meta.launches != before + 1:
        raise AssertionError("deblock_meta did not count its launch")
    print(f"[kernel] deblock_meta 1080p (R={R}, C={C}, the clip's P symbols, "
          f"QP {qp}/{qp_c}) kernel {rec['ms']:.4f} ms (median of 30, one "
          f"event pair a launch, the wrapper's host work inside it), with a "
          f"QP map {rec['qp_map_ms']:.4f}, an I picture "
          f"{rec['intra_ms']:.4f}; {rec['device_activities_per_call']} "
          f"device activities a call ({', '.join(activities)}) busy "
          f"{rec['device_busy_ms']:.4f} ms by the profiler; plain "
          f"{rec['plain_ms']:.3f} ms (median of 10; QP map "
          f"{rec['qp_map_plain_ms']:.3f}, I picture "
          f"{rec['intra_plain_ms']:.3f}), "
          f"{rec['plain_device_activities_per_call']} device activities busy "
          f"{rec['plain_device_busy_ms']:.3f} ms; bound "
          f"{rec['bound_ms']:.6f} ms by {rec['bound_by']} "
          f"({rec['bound_bytes']} bytes, {rec['bound_ops']} operations); "
          f"phase {time.perf_counter() - t0:.1f} s | {smi}")
    return rec


def _profile_frame(sess, bufs, what: str, smi: str) -> dict:
    """Three staged P frames of `sess` (1080p) from the three I420 `bufs`:
    a warm-up; one timed on the host clock to the device's synchronise (the
    wall ms); the next through torch.profiler (_device_events): its device
    activities by name and their device-busy ms; and the idle share 1 -
    busy / wall. The session goes on from the frames."""
    import torch

    sess.encode_frames_staged(sess.upload_frames(bufs[:1]))
    chunks = [sess.upload_frames([b]) for b in bufs[1:3]]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    aus = sess.encode_frames_staged(chunks[0])
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for e in _device_events(lambda: sess.encode_frames_staged(chunks[1])):
        n, ms = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, ms + e.time_range.elapsed_us() / 1e3)
    busy = sum(ms for _, ms in by_name.values())
    n_act = sum(n for n, _ in by_name.values())
    rec = {"activities": n_act, "busy_ms": busy, "wall_ms": wall,
           "idle_share": 1.0 - busy / wall, "bytes": len(aus[0])}
    names = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    print(f"[profile] {what}: a staged {WIDTH}x{HEIGHT} P frame "
          f"({rec['bytes']} B) after a warm-up frame, wall {wall:.3f} ms; "
          f"the next frame through torch.profiler: {n_act} device "
          f"activities, busy {busy:.4f} ms, idle share "
          f"{rec['idle_share']:.4f} of that wall; by name (count, ms): "
          + "; ".join(f"{name[:70]} x{n} {ms:.4f}"
                      for name, (n, ms) in names) + f" | {smi}")
    return rec


def _beside_plain(what: str, kernel, plain, err, *args, **kw) -> tuple:
    """ms of a kernel's raw launch and of its plain version on the same
    inputs (mean of 3 after a warm-up, each synchronised), after holding
    them equal (err(kernel's, plain's) == 0); and the kernel's result."""
    import torch

    box = {}
    t_kernel = _cuda_ms(lambda: box.update(kernel=kernel(*args, **kw)), 3)
    t_plain = _cuda_ms(lambda: box.update(plain=plain(*args, **kw)), 3)
    torch.cuda.synchronize()
    if err(box["kernel"], box["plain"]):
        raise AssertionError(f"{what}: kernel and plain version differ")
    return t_kernel, t_plain, box["kernel"]


def _pack_beside_plain(what: str, *args, **kw) -> tuple:
    from media_tpu_torch.entropy.device_cavlc import (
        launch_pack_pslice, pack_pslice_plain)

    return _beside_plain(what, launch_pack_pslice, pack_pslice_plain,
                         _stream_err, *args, **kw)


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


def _pcore_stage(enc, ref, frame, qp, qp_c, rs: int, what: str) -> tuple:
    """The P-core stage of one frame as FrameEncoder._pframe_core runs it on
    the card: the uint8 entry on the session's planes, the reference with no
    halo rows, no cast or pad step before it (mean of 3, each synchronised,
    beside the plain version, equal); the kernel alone by one event pair a
    launch (median of 20); and the int32 entry as the B core's callers use
    it, its casts and row pads apart. Returns ({ms}, the kernel's result)."""
    import torch

    from media_tpu_torch.pipeline.pframe_core import (
        launch_pframe_core, pframe_core_whole_plain)

    R, C = enc.n_rows, enc.n_cols
    t_stage, t_plain, out = _beside_plain(
        what, lambda *a: launch_pframe_core(*a, whole=True),
        pframe_core_whole_plain, _core_err, *frame, *ref, qp, qp_c, rs, R, C)
    t_kernel = _cuda_median_ms(
        lambda *a: launch_pframe_core(*a, qp, qp_c, rs, R, C, whole=True),
        lambda: (*frame, *ref), 20)
    box = {}

    def prep():  # the int32 entry's casts and row pads
        box["args"] = [p.to(torch.int32)
                       for p in (*frame, *enc._ref_ext(ref, rs))]

    t_prep = _cuda_ms(prep, 3)
    t_int32 = _cuda_ms(
        lambda: launch_pframe_core(*box["args"], qp, qp_c, rs, R, C), 3)
    return {"stage_ms": t_stage, "kernel_ms": t_kernel, "plain_ms": t_plain,
            "int32_prep_ms": t_prep, "int32_ms": t_int32}, out


def _pcore_text(t: dict) -> str:
    return (f"p_core {t['stage_ms']:.3f} (the uint8 entry on the session's "
            f"planes, no cast or pad step; the kernel alone "
            f"{t['kernel_ms']:.4f} by events, median of 20; plain "
            f"{t['plain_ms']:.3f}, same outputs; the int32 entry: casts and "
            f"row pads {t['int32_prep_ms']:.3f} + the kernel "
            f"{t['int32_ms']:.3f})")


def _deblock_stage(out, qp, qp_c, R: int, C: int, qp_map=None) -> dict:
    """The deblock stage of one frame as deblock_pframe_from_symbols runs it
    (mean of 3), and its parts: the meta kernel (median of 20 by events;
    held equal to, and beside, its plain version), the three uint8 plane
    copies of deblock_frame, and the whole-frame kernel on this frame's
    planes and meta (median of 20)."""
    import torch

    from media_tpu_torch.ops.deblock_wave import launch_deblock_wave
    from media_tpu_torch.pipeline.deblock_apply import (
        deblock_meta_plain, deblock_pframe_from_symbols, launch_deblock_meta)

    recon = (out["recon_y"], out["recon_u"], out["recon_v"])
    sym = out["symbols"]

    def copies():
        return [p.to(torch.uint8, copy=True).contiguous() for p in recon]

    t = {"stage_ms": _cuda_ms(lambda: deblock_pframe_from_symbols(
        *recon, sym, qp, qp_c, R, C, qp_map=qp_map), 3)}
    t["meta_ms"] = _cuda_median_ms(
        lambda s: launch_deblock_meta(s, qp, qp_c, R, C, qp_map=qp_map),
        lambda: (sym,), 20)
    t["meta_plain_ms"] = _cuda_ms(lambda: deblock_meta_plain(
        sym, qp, qp_c, R, C, qp_map=qp_map), 3)
    meta = launch_deblock_meta(sym, qp, qp_c, R, C, qp_map=qp_map)
    if not torch.equal(meta, deblock_meta_plain(sym, qp, qp_c, R, C,
                                                qp_map=qp_map)):
        raise AssertionError("the frame's meta: kernel and plain differ")
    t["copies_ms"] = _cuda_ms(copies, 3)
    t["kernel1_ms"] = _cuda_median_ms(
        lambda *w: launch_deblock_wave(*w, meta, R, C), copies, 20)
    return t


def _deblock_text(t: dict, mode: str = "") -> str:
    return (f"deblock {t['stage_ms']:.3f} (the meta kernel "
            f"{t['meta_ms']:.4f}, median of 20, plain "
            f"{t['meta_plain_ms']:.3f}; "
            f"the three plane copies {t['copies_ms']:.4f}; the whole-frame "
            f"kernel{mode}, median of 20 on this frame's planes, "
            f"{t['kernel1_ms']:.4f})")


def _stage_split(sess, frame_buf, smi: str):
    """ms per stage of one 1080p P frame, each stage run and synchronised
    on its own (outside the pipelined session loop)."""
    import torch

    from media_tpu_torch.ops.transform import chroma_qp
    from media_tpu_torch.pipeline.pframe_core import unpack_symbols_device

    enc = sess._frame_encoder
    R, C = enc.n_rows, enc.n_cols
    qp, qp_c, rs = QP, int(chroma_qp(QP)), 8
    frame = [torch.tensor(p, device="cuda") for p in sess._planes(frame_buf)]
    t_core, out = _pcore_stage(enc, sess.recon, frame, qp, qp_c, rs,
                               "constant-QP P frame")
    cap = sess._device_cap()
    t_pack, t_pack_plain, (stream, bits) = _pack_beside_plain(
        "constant-QP P frame", *unpack_symbols_device(out["symbols"]), cap)
    t_db = _deblock_stage(out, qp, qp_c, R, C)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    nbits = int(bits)
    words = stream[: (nbits + 31) // 32 + 1].cpu().numpy().astype(np.uint32)
    sess._pslice_au_packed(words, nbits)
    t_host = (time.perf_counter() - t0) * 1e3
    print(f"[stages] {WIDTH}x{HEIGHT} P frame ms: {_pcore_text(t_core)} "
          f"cavlc_pack {t_pack:.3f} (the kernel; plain {t_pack_plain:.3f}, "
          f"same stream and {nbits} bits) {_deblock_text(t_db)} host_au "
          f"{t_host:.3f} | {smi}")
    return ({"ms_clip_frame": t_pack, "plain_ms_clip_frame": t_pack_plain},
            {f"{k}_clip_frame": v for k, v in t_core.items()},
            {f"{k}_clip_frame": v for k, v in t_db.items()})


def phase_main_path(smi: str, golden: dict, bufs):
    """The constant-QP encode path. Returns (deblock launches, the IDR + P
    AUs of the first run, the recon after the IDR, the recon after that run,
    the staged AUs, the last recon as numpy planes, and the stage split's
    records of the packer, the P core and the deblock stage, the last with
    the [profile] of one whole staged P frame)."""
    import torch

    from media_tpu_torch.entropy.device_cavlc import pack_pslice_device
    from media_tpu_torch.ops.deblock_wave import deblock_wave
    from media_tpu_torch.pipeline.codec import EncoderConfig, EncoderSession

    sess = EncoderSession(EncoderConfig(width=WIDTH, height=HEIGHT, qp=QP,
                                        gop_size=300))  # default device
    if sess.device.type != "cuda":
        raise AssertionError(f"EncoderSession defaulted to {sess.device}")
    sess.PIPELINE_CHUNK = CHUNK
    staged_in = bufs[1 + N_CQ_P : 1 + 2 * N_CQ_P]

    deblock_wave.launches = pack_pslice_device.launches = 0
    t0 = time.perf_counter()
    aus = [sess.encode_frame(bufs[0])]
    t_idr = time.perf_counter() - t0
    recon_idr = [p.clone() for p in sess.recon]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    aus += sess.encode_frames(bufs[1 : 1 + N_CQ_P])
    torch.cuda.synchronize()
    t_frames = time.perf_counter() - t0
    recon_run = [p.clone() for p in sess.recon]
    chunks = sess.upload_frames(staged_in)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    staged = sess.encode_frames_staged(chunks)
    torch.cuda.synchronize()
    t_staged = time.perf_counter() - t0
    launches = deblock_wave.launches
    packs = pack_pslice_device.launches

    n_frames = len(aus) + len(staged)
    if launches != n_frames or packs < n_frames - 1:
        raise AssertionError(f"deblock kernel launched {launches} times, "
                             f"packer kernel {packs} times for {n_frames} "
                             "frames")
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
          f"packer launches {packs}/{n_frames - 1}, IDR {t_idr * 1e3:.1f} ms "
          f"(C++ I-slice writer)")
    print(f"[main] P-frame fps {N_CQ_P / t_staged:.3f} (staged, {N_CQ_P} "
          f"frames, {sum(len(a) for a in staged) * 8 / N_CQ_P / 1e3:.1f} "
          f"kbit/frame), {N_CQ_P / t_frames:.3f} through encode_frames, "
          f"PSNR(last Y) {psnr:.3f} dB | {smi}")
    # The same frames with the slice data written on the host (C++ CAVLC
    # writer on downloaded symbols): the same bytes, no packer launch.
    host = EncoderSession(EncoderConfig(width=WIDTH, height=HEIGHT, qp=QP,
                                        gop_size=300, entropy_mode="host"))
    host.PIPELINE_CHUNK = CHUNK
    before = pack_pslice_device.launches
    host_aus = [host.encode_frame(bufs[0])]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    host_aus += host.encode_frames(bufs[1 : 1 + 2 * N_CQ_P])
    torch.cuda.synchronize()
    t_host = time.perf_counter() - t0
    if host_aus != aus + staged or pack_pslice_device.launches != before:
        raise AssertionError(
            f"entropy_mode='host': AUs equal {host_aus == aus + staged}, "
            f"{pack_pslice_device.launches - before} packer launches")
    print(f"[main] entropy_mode='host' (C++ CAVLC writer on the host): AUs == "
          f"device route, no packer launch; P-frame fps {2 * N_CQ_P / t_host:.3f} "
          f"through encode_frames ({2 * N_CQ_P} frames) against "
          f"{N_CQ_P / t_frames:.3f} (device route, encode_frames) and "
          f"{N_CQ_P / t_staged:.3f} (device route, staged) | {smi}")
    del host
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

    pack_rec, core_rec, meta_rec = _stage_split(sess, bufs[2 * N_CQ_P + 1],
                                                smi)
    meta_rec.update({f"profile_{k}_cq": v for k, v in _profile_frame(
        sess, bufs[2 * N_CQ_P + 2 : 2 * N_CQ_P + 5],
        f"constant QP {QP}, CAVLC packed on the card", smi).items()})

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
    return (launches, aus, recon_idr, recon_run, staged, recon, pack_rec,
            core_rec, meta_rec)


def _split(timings, idr: bool) -> str:
    rows = [t for t in timings if t["idr"] == idr]
    mean = {k: sum(t[k] for t in rows) / len(rows)
            for k in ("parse_ms", "upload_ms", "device_ms")}
    return (f"{'I' if idr else 'P'} x{len(rows)}: host parse "
            f"{mean['parse_ms']:.1f} upload {mean['upload_ms']:.3f} device "
            f"recon+deblock {mean['device_ms']:.3f}")


def phase_decode_path(smi: str, golden: dict, aus, recon_idr, recon_run):
    """The decode path through both deblock routes. Returns the launches of
    (the whole-frame kernel, the wave-step kernel), and the route-frame
    decoder with its pictures, which phase 19 goes on with."""
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
    return frame_launches, step_launches, dec, frames


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
    the packer with a QP map, the deblock stage and its parts in per-MB-QP
    mode, and the host's transcode of the slice."""
    import torch

    from media_tpu_torch.entropy.device_cavlc import _last_coded
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
    t_core, out = _pcore_stage(enc, sess.recon, frame, qp_map,
                               chroma_qp_device(qp_map), 8,
                               "per-MB-QP P frame")
    mv, luma, cdc, cac = unpack_symbols_device(out["symbols"])
    cap = sess._device_cap()

    t_pack, t_pack_plain, (stream, bits) = _pack_beside_plain(
        "per-MB-QP P frame", mv, luma, cdc, cac, cap,
        qp_map=qp_map.reshape(R, C), slice_qp=qp)
    coded = ((luma != 0).any(dim=3).any(dim=2)
             | (cdc != 0).any(dim=3).any(dim=2)
             | (cac != 0).any(dim=4).any(dim=3).any(dim=2))
    eff = _last_coded(qp_map, coded.reshape(-1), qp).reshape(R, C)
    t_db = _deblock_stage(out, qp, chroma_qp_device(qp), R, C, qp_map=eff)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    nbits = int(bits)
    words = stream[: (nbits + 31) // 32 + 1].cpu().numpy().astype(np.uint32)
    au = sess._cabac_au_from_cavlc_stream(words, nbits, int(qp_f), 1)
    t_host = (time.perf_counter() - t0) * 1e3
    print(f"[stages] {WIDTH}x{HEIGHT} P frame of the CBR + CABAC path with "
          f"per-MB QP {int(qp_f)}/{int(qp_f) + 1} ms: {_pcore_text(t_core)} "
          f"cavlc_pack {t_pack:.3f} (the kernel; plain {t_pack_plain:.3f}, "
          f"same stream) {_deblock_text(t_db, ' in per-MB-QP mode')} host "
          f"download + C++ transcode + AU {t_host:.3f} ({nbits} CAVLC bits "
          f"-> {len(au)} B) | {smi}")
    return (t_db["kernel1_ms"],
            {"ms_per_mb_qp_clip_frame": t_pack,
             "plain_ms_per_mb_qp_clip_frame": t_pack_plain},
            {f"{k}_per_mb_qp_clip_frame": v for k, v in t_core.items()},
            {f"{k}_per_mb_qp_clip_frame": v for k, v in t_db.items()})


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
    `want`. Returns the whole-frame kernel's launches and the pictures."""
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
    return launches, frames


def _i4_idr_split(smi: str, bufs) -> None:
    """One 1080p IDR of the clip at QP 28 (the operating point's), with and
    without the I_4x4 decision: the whole encode_iframe (the wavefront
    kernels, the download of the symbols, deblocking) by the host clock;
    the wavefront kernel alone by CUDA events (median of 5, fresh inputs)
    and its device activities and busy time by the profiler; beside them
    one run of the plain loop on the same frame, and every output of the
    two equal."""
    import torch

    from media_tpu_torch.ops.transform import chroma_qp
    from media_tpu_torch.pipeline.encoder import (
        FrameEncoder, intra_encode_plain)
    from media_tpu_torch.pipeline.intra_wave import launch_intra_encode
    from media_tpu_torch.utils import yuv

    enc = FrameEncoder(C_MB * 16, R_MB * 16)
    planes = [torch.as_tensor(yuv.pad_to_mb_grid(p, size), dtype=torch.int32,
                              device=enc.device)
              for p, size in zip(yuv.split_i420(bufs[0], WIDTH, HEIGHT),
                                 (16, 8, 8))]
    qp = 28
    qp_c = int(chroma_qp(qp))
    has_top = enc._row_has_top
    for i4x4 in (True, False):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = enc.encode_iframe(*planes, qp, deblock=True, i4x4=i4x4)
        torch.cuda.synchronize()
        whole = (time.perf_counter() - t0) * 1e3

        def kernel(*p, _i4=i4x4):
            return launch_intra_encode(*p, qp, qp_c, has_top, _i4)

        ms = _cuda_median_ms(kernel, lambda: [p.clone() for p in planes], 5)
        n_act, busy = _device_activities(lambda: kernel(*planes))
        plain_ms, want = _events_ms(
            lambda: intra_encode_plain(*planes, qp, qp_c, has_top, i4x4))
        err = _intra_err(kernel(*planes), want)
        if err:
            raise AssertionError(f"[i4x4] wavefront kernel vs plain on the "
                                 f"clip's IDR, i4x4 {i4x4}: max |err| {err}")
        waves = 2 * (R_MB - 1) + C_MB if i4x4 else R_MB + C_MB - 1
        what = (f"with the I_4x4 decision ({int(res.is_i4.sum())} of "
                f"{R_MB * C_MB} MBs I_4x4)" if i4x4 else "I_16x16")
        print(f"[i4x4] IDR {WIDTH}x{HEIGHT} QP{qp} {what}: encode_iframe "
              f"{whole:.1f} ms by the host clock (deblock and symbol download "
              f"included); the wavefront kernel {ms:.4f} ms by events over "
              f"{waves} waves, {n_act} device activities busy {busy:.4f} ms; "
              f"the plain loop {plain_ms:.1f} ms on the same frame, every "
              f"output equal | {smi}")


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
    # The C++ CABAC P parser stops at a slice that ends above the picture's
    # last row (the Python parser then takes it): 3 of each P picture.
    refused = dict(native.fallbacks)
    if (deblock_wave.launches != 2 * n
            or refused != {"cabac_parse_pslice_native": 3 * (n - 1)}):
        raise AssertionError(f"{name}: {deblock_wave.launches} whole-frame "
                             f"launches after the decode, native fallbacks "
                             f"{refused}, expected 3 slices of each of "
                             f"{n - 1} P pictures")
    native.fallbacks.clear()
    print(f"[slices] {name} decode: {n} pictures == JAX TpuDecoder golden == "
          f"encoder recon; ms per picture: {_split(dec.timings, True)}; "
          f"{_split(dec.timings, False)} (C++ CABAC parsers; the Python "
          f"CABAC parser on the P slices that end above the picture's last "
          f"row: {refused['cabac_parse_pslice_native']} slices counted) | "
          f"{smi}")
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


def _check_api_record(name: str, enc_run, dec_run, want: dict) -> None:
    """Every code SUCCESS and the golden's; AUs and payloads the golden's;
    the encoder's QP after each frame the golden's (the rate controller's
    carry, within RATE_FLOAT_TOL: the integer QPs are in the AUs); no
    fallback to the oracle."""
    got = api_record(enc_run, dec_run)
    if got["codes"] != want["codes"] or any(got["codes"]):
        raise AssertionError(f"{name}: encoder codes {got['codes']}")
    if got["decode_codes"] != want["decode_codes"] or any(
            got["decode_codes"]):
        raise AssertionError(f"{name}: decoder codes {got['decode_codes']}")
    _first_difference(name, enc_run["aus"], want["au_sha256"],
                      want["au_bytes"])
    for i, (a, b) in enumerate(zip(got["qps"], want["qps"], strict=True)):
        if abs(a - b) > RATE_FLOAT_TOL * max(abs(a), abs(b), 1.0):
            raise AssertionError(f"{name}: QP after frame {i} {a!r} against "
                                 f"the golden's {b!r}")
    if got["decoded_sha256"] != want["decoded_sha256"]:
        raise AssertionError(f"{name}: decoded payloads differ from the JAX "
                             f"VideoDecoder's ({len(got['decoded_sha256'])} "
                             f"against {len(want['decoded_sha256'])})")
    if got["fallbacks"] or want["fallbacks"]:
        raise AssertionError(f"{name}: {got['fallbacks']} fallbacks to the "
                             "scalar oracle")


def phase_api(smi: str, golden: dict):
    """The public API at full width: VideoEncoder at the shipped property
    defaults and at 1080p on main, each stream back through VideoDecoder.
    Returns (the whole-frame kernel's launches, {run name: its decoder's
    events, P fps, both IDRs' ms and decode fps}) for phase 18."""
    import torch

    from media_tpu_torch import api
    from media_tpu_torch.core import log as media_log
    from media_tpu_torch.core import params
    from media_tpu_torch.ops.deblock_wave import deblock_wave

    sync = torch.cuda.synchronize
    launches = 0
    runs = {}
    for name, idr2, what in API_IDRS:
        bufs = api_clip(name)
        w, h = API_RUNS[name][3]
        # The media log's warning and error lines, as (level, tag, message).
        lines: list = []
        media_log.set_media_log_callback(
            lambda level, tag, msg: level >= media_log.LOG_WARN
            and lines.append((level, tag, msg)))
        deblock_wave.launches = 0
        enc_run = drive_api_encode(api, params, name, bufs, sync,
                                   device="cuda")
        dec_run = drive_api_decode(api, enc_run["aus"], 0, sync,
                                   device="cuda")
        n_launch = deblock_wave.launches
        media_log.set_media_log_callback(None)
        media_log.set_log_level(media_log.LOG_INFO)
        _check_api_record(name, enc_run, dec_run, golden[name])
        if lines:
            raise AssertionError(f"{name}: the media log reported {lines}")
        n = len(enc_run["aus"])
        if n_launch != 2 * n:
            raise AssertionError(f"{name}: {n_launch} whole-frame launches "
                                 f"for {n} pictures encoded and decoded")
        launches += n_launch
        runs[name] = api_speeds(enc_run, dec_run, idr2)
        runs[name]["events"] = dec_run["events"]
        ms = enc_run["ms"]
        st = enc_run["stats"]
        print(f"[api] {name} {w}x{h}: {n} frames through encode_one_frame, "
              f"every code SUCCESS, AUs and QPs == JAX golden (sizes "
              f"{[len(a) for a in enc_run['aus']]}, QPs "
              f"{[round(q, 3) for q in enc_run['qps']]}), stream through "
              f"VideoDecoder in {API_FEED}-byte pieces: {n} payloads == JAX "
              f"golden, no fallback, no warning or error in the media log; "
              f"deblock launches {n_launch} | {smi}")
        print(f"[api] {name}: IDR {ms[0]:.1f} ms, {what} {ms[idr2]:.1f} ms, "
              f"P frames {runs[name]['p_fps']:.3f} fps "
              f"(encode_one_frame, one frame a call), decode "
              f"{runs[name]['decode_fps']:.3f} fps through the API | {smi}")
        print(f"[api] {name} get_encoder_statistics: "
              f"{json.dumps({k: v for k, v in st.items() if k != 'statistics_ts'})}")
    return launches, runs


def _check_capi_record(name: str, enc_run, dec_run, want: dict) -> None:
    """What a run through the C ABI is held to, exactly: every code of
    both halves SUCCESS and the golden's, each AU's digest and size, each
    payload's digest."""
    if enc_run["codes"] != want["codes"] or any(enc_run["codes"]):
        raise AssertionError(f"{name} through C: encoder codes "
                             f"{enc_run['codes']}")
    if len(enc_run["aus"]) != len(want["au_sha256"]):
        raise AssertionError(f"{name} through C: {len(enc_run['aus'])} AUs")
    _first_difference(f"{name} through C", enc_run["aus"], want["au_sha256"],
                      want["au_bytes"])
    if dec_run["codes"] != want["decode_codes"]:
        raise AssertionError(f"{name} through C: decoder codes "
                             f"{dec_run['codes']}")
    got = [hashlib.sha256(p).hexdigest() for p in dec_run["payloads"]]
    if got != want["decoded_sha256"]:
        raise AssertionError(f"{name} through C: decoded payloads differ "
                             f"from the JAX VideoDecoder's ({len(got)} "
                             f"against {len(want['decoded_sha256'])})")


def phase_capi(smi: str, golden: dict, api_runs: dict, clip) -> int:
    """The C ABI on the card: (a) phase 13's two runs through the C
    functions of the port's libVideoCodec, loaded into this process, with
    the void factories (so "cuda"); (b) api_main_1080p through capi_drive,
    a C program, in a child process; (c) the C hop alone, P frames of
    `clip` through both routes in turns. Returns the whole-frame
    kernel's launches of (a) and (c)."""
    import tempfile

    import torch

    from media_tpu_torch import native
    from media_tpu_torch.api import decoder_api
    from media_tpu_torch.core import log as media_log
    from media_tpu_torch.core import params
    from media_tpu_torch.ops.deblock_wave import deblock_wave

    path, secs = native.build_capi()
    prog, secs_drive = native.build_capi_drive()
    lib = native.bind_capi(path)
    print(f"[capi] {os.path.relpath(path, ROOT)} g++ {secs:.2f} s, "
          f"{os.path.relpath(prog, ROOT)} gcc {secs_drive:.2f} s")
    sync = torch.cuda.synchronize
    # ---- (a) in process. The bridge runs in this interpreter, so the
    # decoder's hand-overs to the scalar oracle are counted on its class.
    fallbacks = []
    inner = decoder_api.VideoDecoder._fallback_to_reference

    def counted(self, chunk):
        fallbacks.append(len(chunk))
        return inner(self, chunk)

    decoder_api.VideoDecoder._fallback_to_reference = counted
    launches = 0
    try:
        for name, idr2, what in API_IDRS:
            bufs = api_clip(name)
            w, h = API_RUNS[name][3]
            lines: list = []
            media_log.set_media_log_callback(
                lambda level, tag, msg: level >= media_log.LOG_WARN
                and lines.append((level, tag, msg)))
            deblock_wave.launches = 0
            enc_run = drive_capi_encode(lib, lib.CreateVideoEncoder(), params,
                                        API_RUNS[name], bufs, sync)
            dec_run = drive_capi_decode(lib, lib.CreateVideoDecoder(),
                                        enc_run["aus"], (w, h), sync)
            n_launch = deblock_wave.launches
            media_log.set_media_log_callback(None)
            media_log.set_log_level(media_log.LOG_INFO)
            _check_capi_record(name, enc_run, dec_run, golden[name])
            if fallbacks or lines:
                raise AssertionError(f"{name} through C: {len(fallbacks)} "
                                     f"hand-overs to the oracle, media log "
                                     f"{lines}")
            events = [e[0] for e in dec_run["events"]]
            if events != api_runs[name]["events"]:
                raise AssertionError(f"{name} through C: events "
                                     f"{dec_run['events']} against phase "
                                     f"13's {api_runs[name]['events']}")
            n = len(enc_run["aus"])
            if n_launch != 2 * n:
                raise AssertionError(f"{name} through C: {n_launch} "
                                     f"whole-frame launches for {n} "
                                     "pictures encoded and decoded")
            launches += n_launch
            got, ref = api_speeds(enc_run, dec_run, idr2), api_runs[name]
            print(f"[capi] {name} {w}x{h} through the C ABI in process "
                  f"(CreateVideoEncoder / CreateVideoDecoder: cuda): {n} "
                  f"frames through EncodeOneFrame, every code SUCCESS, AUs "
                  f"== JAX golden; the stream through SendStreamData in "
                  f"{API_FEED}-byte pieces and RetrieveFrameData: {n} "
                  f"payloads == JAX golden, decoder codes == golden, events "
                  f"{dec_run['events']} == phase 13's, no hand-over, no "
                  f"warning or error in the media log; deblock launches "
                  f"{n_launch} | {smi}")
            print(f"[capi] {name}: P frames {got['p_fps']:.3f} fps through "
                  f"EncodeOneFrame against {ref['p_fps']:.3f} through "
                  f"encode_one_frame (phase 13); IDR {got['idr_ms'][0]:.1f} "
                  f"ms, {what} {got['idr_ms'][1]:.1f} ms (phase 13: "
                  f"{ref['idr_ms'][0]:.1f}, {ref['idr_ms'][1]:.1f}); decode "
                  f"{got['decode_fps']:.3f} fps through RetrieveFrameData "
                  f"against {ref['decode_fps']:.3f} | {smi}")
    finally:
        decoder_api.VideoDecoder._fallback_to_reference = inner

    # ---- (b) a C program in a child process, on api_main_1080p's frames.
    name = "api_main_1080p"
    run = API_RUNS[name]
    with tempfile.TemporaryDirectory(dir=os.path.dirname(prog)) as tmp:
        raw, out = os.path.join(tmp, "in.yuv"), os.path.join(tmp, "aus.bin")
        with open(raw, "wb") as f:
            f.write(b"".join(api_clip(name)))
        cmd = [prog, "--in", raw, "--out", out, "--device", "cuda",
               *capi_drive_args(params, run)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              env=child_env(), timeout=900)
        wall = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"capi_drive exited {proc.returncode}:\n"
                                 f"{proc.stdout[-2000:]}{proc.stderr[-4000:]}")
        codes, aus = read_capi_drive_output(out)
    want = golden[name]
    if codes != want["codes"] or len(aus) != len(want["au_sha256"]):
        raise AssertionError(f"capi_drive: codes {codes}, {len(aus)} AUs")
    _first_difference(f"{name} through capi_drive", aus, want["au_sha256"],
                      want["au_bytes"])
    t = json.loads(proc.stdout.strip().splitlines()[-1])
    enc_s = sum(t["frame_ms"]) / 1e3
    idr2 = dict((n, i) for n, i, _ in API_IDRS)[name]
    p_ms = [v for i, v in enumerate(t["frame_ms"]) if i not in (0, idr2)]
    print(f"[capi] {name} through capi_drive (a C program, --device cuda, "
          f"child process): every code SUCCESS, {len(aus)} AUs == JAX "
          f"golden; wall {wall:.2f} s: start-up {wall - enc_s:.2f} s "
          f"outside EncodeOneFrame (factory: interpreter and imports "
          f"{t['create_s']:.2f} s, InitEncoder + StartEncoder "
          f"{t['init_s']:.3f} s, the rest process start and exit), "
          f"encoding {enc_s:.2f} s (IDR {t['frame_ms'][0]:.1f} ms, reset "
          f"IDR {t['frame_ms'][idr2]:.1f} ms, P frames "
          f"{len(p_ms) / (sum(p_ms) / 1e3):.3f} fps) | {smi}")
    return launches + capi_hop(smi, golden, lib, clip)


def capi_hop(smi: str, golden: dict, lib, bufs) -> int:
    """Phase 18 (c): what the C hop costs a P frame. One encoder through
    encode_one_frame and one through EncodeOneFrame, both at
    api_main_1080p's properties without its reset, take the IDR and then
    the P frames of `bufs` in turns (Python, C, C, Python, ...), each frame
    timed alone between device synchronises; every AU of the two equal,
    the first six the golden's. Returns the whole-frame kernel's
    launches."""
    import ctypes

    import torch

    from media_tpu_torch import api
    from media_tpu_torch.core import params
    from media_tpu_torch.ops.deblock_wave import deblock_wave

    name = "api_main_1080p"
    props, _n, events, _geometry = API_RUNS[name]
    deblock_wave.launches = 0
    store = params.ParamStore({getattr(params, k): v
                               for k, v in props.items()})
    py = api.create_video_encoder(store, device="cuda")
    enc = lib.CreateVideoEncoder()
    if not enc:
        raise AssertionError("CreateVideoEncoder returned NULL")
    codes = [py.init_encoder(), py.start_encoder()]
    for k, v in props.items():
        codes.append(lib.MtpuEncoderSetParam(
            enc, getattr(params, k).encode(), str(v).encode()))
    codes += [lib.InitEncoder(enc), lib.StartEncoder(enc)]
    ptr = ctypes.POINTER(ctypes.c_uint8)()
    n_out = ctypes.c_uint32()

    def through_c(buf):
        code = lib.EncodeOneFrame(enc, buf, len(buf), ctypes.byref(ptr),
                                  ctypes.byref(n_out))
        return code, ctypes.string_at(ptr, n_out.value)

    routes = {"python": py.encode_one_frame, "c": through_c}
    aus = {"python": [], "c": []}
    ms = {"python": [], "c": []}
    for i, buf in enumerate(bufs):
        for route in (("python", "c") if i % 2 == 0 else ("c", "python")):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            code, au = routes[route](buf)
            torch.cuda.synchronize()
            ms[route].append((time.perf_counter() - t0) * 1e3)
            codes.append(code)
            aus[route].append(bytes(au))
    codes += [py.stop_encoder(), py.destroy_encoder(), lib.StopEncoder(enc),
              lib.DestroyVideoEncoder(enc)]
    launches = deblock_wave.launches
    if any(codes) or aus["c"] != aus["python"]:
        raise AssertionError(f"C hop: codes {codes}, AUs equal "
                             f"{aus['c'] == aus['python']}")
    n_same = min(events)  # the frames before the golden run's reset
    _first_difference(f"{name} C hop", aus["c"][:n_same],
                      golden[name]["au_sha256"], golden[name]["au_bytes"])
    if launches != 2 * len(bufs):
        raise AssertionError(f"C hop: {launches} whole-frame launches for "
                             f"2 x {len(bufs)} pictures")
    diff = [c - p for c, p in zip(ms["c"][1:], ms["python"][1:])]
    print(f"[capi] (c) the C hop alone, {name} without its reset, IDR + "
          f"{len(bufs) - 1} P frames through encode_one_frame and through "
          f"EncodeOneFrame in turns: AUs equal, the first {n_same} the "
          f"golden's; P frame ms, median: Python "
          f"{float(np.median(ms['python'][1:])):.3f}, C "
          f"{float(np.median(ms['c'][1:])):.3f}, C - Python per frame "
          f"median {float(np.median(diff)):.3f} (quartiles "
          f"{float(np.percentile(diff, 25)):.3f} / "
          f"{float(np.percentile(diff, 75)):.3f}), C faster on "
          f"{sum(d < 0 for d in diff)} of {len(diff)} frames; IDR "
          f"{ms['python'][0]:.1f} / {ms['c'][0]:.1f} ms | {smi}")
    return launches


def _crop(planes, w: int, h: int):
    """The displayed part of a picture's Y, U, V planes."""
    return (planes[0][:h, :w], planes[1][: h // 2, : w // 2],
            planes[2][: h // 2, : w // 2])


def avref_unavailable(message: str) -> bool:
    """Whether a failed shim build failed for want of libavcodec itself
    (its header or its library), the one failure phase 19 may report and
    pass over."""
    return bool(re.search(r"lib(avcodec|avutil)/\S+\.h: No such file|"
                          r"cannot find -lav(codec|util)", message))


def phase_avref(smi: str, golden: dict, cq, i4) -> int:
    """libavcodec (ffmpeg's H.264 decoder, through
    media_tpu_torch/testing/avref.py) on two whole 1080p streams of the
    port: phase 5's nine AUs, cq = (AUs, phase 6's route-frame decoder and
    its pictures, the encoder's last recon; the decoder goes on with the
    AUs it has not decoded), and phase 9's seventeen, i4 = (AUs, the
    encoder's last recon, phase 9's decoded pictures of the first nine).
    ffmpeg's pictures are the displayed 1920x1080 of the port's (1920x1088
    planes, cropped), the port's are the golden's, and ffmpeg's last is the
    encoder's last recon. Returns the whole-frame launches of the decoder
    going on."""
    from media_tpu_torch.ops.deblock_wave import deblock_wave
    from media_tpu_torch.testing import avref

    if not avref.available():
        msg = avref.build_error()
        if not avref_unavailable(msg):
            raise AssertionError(f"avref shim: {msg}")
        print(f"[avref] unavailable: {msg} | {smi}")
        return 0
    cq_aus, dec, cq_frames, cq_recon = cq
    deblock_wave.launches = 0
    cq_frames = cq_frames + [f for au in cq_aus[len(cq_frames):]
                             for f in dec.decode_annexb(au)]
    launches = deblock_wave.launches
    if len(cq_frames) != len(cq_aus) or launches != len(cq_aus) - N_CQ_P - 1:
        raise AssertionError(f"[avref] {len(cq_frames)} pictures and "
                             f"{launches} launches for {len(cq_aus)} AUs")
    i4_aus, i4_recon, i4_frames = i4
    streams = (
        ("phase 5 (constant QP 30, CAVLC)", cq_aus, cq_frames,
         golden["decoded_sha256"], cq_recon),
        ("phase 9 (CBR 8 Mbit/s, CABAC, I_4x4)", i4_aus, i4_frames,
         golden[I4_RUN]["decoded_sha256"], i4_recon))
    for what, aus, frames, want, recon in streams:
        t0 = time.perf_counter()
        ff = avref.decode(b"".join(aus))
        t_ff = time.perf_counter() - t0
        if len(ff) != len(aus):
            raise AssertionError(f"[avref] {what}: ffmpeg returned {len(ff)} "
                                 f"pictures for {len(aus)} AUs")
        shapes = [p.shape for p in ff[0]]
        if shapes != [(HEIGHT, WIDTH)] + [(HEIGHT // 2, WIDTH // 2)] * 2:
            raise AssertionError(f"[avref] {what}: ffmpeg's planes {shapes}")
        digests = [planes_sha(f) for f in frames]
        if digests != want:
            raise AssertionError(f"[avref] {what}: the port's pictures "
                                 "differ from the golden")
        for i, f in enumerate(frames):
            ours = _crop((f.y, f.u, f.v), WIDTH, HEIGHT)
            if _sha_planes(ff[i]) != _sha_planes(ours):
                raise AssertionError(f"[avref] {what}: ffmpeg's picture {i} "
                                     "differs from the port's")
        if _sha_planes(ff[-1]) != _sha_planes(_crop(recon, WIDTH, HEIGHT)):
            raise AssertionError(f"[avref] {what}: ffmpeg's last picture "
                                 "differs from the encoder's last recon")
        print(f"[avref] {what}: libavcodec decodes all {len(aus)} AUs; "
              f"pictures 0-{len(frames) - 1} == the port's TpuDecoder "
              f"pictures (cropped to {WIDTH}x{HEIGHT}) == JAX golden, "
              f"picture {len(aus) - 1} == the encoder's last recon; ffmpeg "
              f"{t_ff * 1e3 / len(aus):.1f} ms a picture on the host (one "
              f"thread) | {smi}")
    return launches


def phase_oracle(smi: str, golden: dict) -> int:
    """The port's scalar oracle on five 176x144 streams encoded on the card,
    and the API's hand-over to it. Returns the whole-frame kernel's
    launches."""
    import torch

    from media_tpu_torch import api
    from media_tpu_torch.ops.deblock_wave import deblock_wave
    from media_tpu_torch.pipeline.codec import EncoderConfig, EncoderSession
    from media_tpu_torch.pipeline.decoder_tpu import TpuDecoder
    from media_tpu_torch.ref.decoder import ReferenceDecoder

    deblock_wave.launches = 0
    streams = {}
    for name, (_fields, n) in ORACLE_RUNS.items():
        want = golden[name]
        bufs = clip_i420(ORACLE_W, ORACLE_H, n)[0]
        _sess, aus, recon = drive_oracle_run(EncoderSession, EncoderConfig,
                                             name, bufs)
        _first_difference(name, aus, want["au_sha256"], want["au_bytes"])
        t0 = time.perf_counter()
        dec = ReferenceDecoder()
        frames = [f for au in aus for f in dec.decode_annexb(au)]
        t_ms = (time.perf_counter() - t0) * 1e3 / len(frames)
        if [planes_sha(f) for f in frames] != want["decoded_sha256"]:
            raise AssertionError(f"{name}: the oracle's pictures differ from "
                                 "the JAX package's oracle's")
        for i, (f, r) in enumerate(zip(frames, recon)):
            if r is not None:
                _frame_equals(f, r, f"{name}: oracle picture {i} vs recon")
        streams[name] = (aus, frames, recon)
        held = ("== the encoder's recon" if recon[0] is not None else
                "(a B-GOP session keeps no recon of its B pictures)")
        print(f"[oracle] {name} {ORACLE_W}x{ORACLE_H} {len(aus)} AUs encoded "
              f"on cuda == JAX golden; ReferenceDecoder: {len(frames)} "
              f"pictures == JAX oracle golden {held}; {t_ms:.1f} ms a picture "
              f"on the host | {smi}")

    # The API: the device decoder refuses these streams, the oracle takes
    # over once and decodes every picture.
    sync = torch.cuda.synchronize
    for name in ORACLE_FALLBACK:
        aus, frames, _recon = streams[name]
        dec_run = drive_api_decode(api, aus, 0, sync, device="cuda")
        want = [hashlib.sha256(b"".join(np.ascontiguousarray(p).tobytes()
                                        for p in (f.y, f.u, f.v))).hexdigest()
                for f in frames]
        got = [hashlib.sha256(p).hexdigest() for p in dec_run["payloads"]]
        if dec_run["fallbacks"] != 1 or got != want or any(dec_run["codes"]):
            raise AssertionError(f"{name}: {dec_run['fallbacks']} fallbacks, "
                                 f"codes {dec_run['codes']}, payloads equal "
                                 f"{got == want}")
        print(f"[oracle] {name} through VideoDecoder(device='cuda'): "
              f"TpuDecoder refused the stream at its first picture, one "
              f"hand-over to the oracle, {len(got)} payloads == the oracle's "
              f"pictures | {smi}")
    # A hand-over in mid-stream: the device decoder's SPS, PPS and reference
    # planes (on the card) go to the oracle, which decodes the next P.
    aus, frames, recon = streams["oracle_cq"]
    dec = api.create_video_decoder(device="cuda")
    dec.create_decoder(0)
    if not isinstance(dec._decoder, TpuDecoder):
        raise AssertionError("VideoDecoder(device='cuda') has no TpuDecoder")
    dec._decoder.decode_annexb(aus[0])
    if dec._decoder.ref_planes[0].device.type != dec._decoder.device.type:
        raise AssertionError("the device decoder's reference is not on its "
                             "device")
    (f1,) = dec._fallback_to_reference(aus[1])
    if not isinstance(dec._decoder, ReferenceDecoder):
        raise AssertionError("no hand-over to the oracle")
    _frame_equals(f1, recon[1], "oracle_cq: P after a mid-stream hand-over")
    # A fault of the device path is DECODE_FAIL and no hand-over: the
    # whole-frame deblocking wrapper, raising before its launch, stands in
    # for any error of the reconstruction on the card.
    from media_tpu_torch.api.errors import DecoderRetCode
    from media_tpu_torch.pipeline import deblock_apply

    def broken(*args, **kwargs):
        raise ValueError("a fault of the device path")

    dec = api.create_video_decoder(device="cuda")
    handed: list = []
    dec._fallback_to_reference = handed.append
    codes = [dec.create_decoder(0), dec.init_decoder(), dec.start_decoder()]
    real, deblock_apply.deblock_wave = deblock_apply.deblock_wave, broken
    try:
        codes.append(dec.send_stream_data(aus[0] + b"\x00\x00\x00\x01"))
    finally:
        deblock_apply.deblock_wave = real
    if (any(codes[:3]) or codes[3] != DecoderRetCode.VIDEO_DECODER_DECODE_FAIL
            or handed or not isinstance(dec._decoder, TpuDecoder)):
        raise AssertionError(f"a device fault gave codes {codes} and "
                             f"{len(handed)} hand-overs to the oracle")
    print(f"[oracle] a fault of the device path (the deblocking wrapper "
          f"raising on cuda): DECODE_FAIL, no hand-over, the device decoder "
          f"kept | {smi}")
    # One per deblocked picture encoded (5 + 5 + 5 + the B-GOP's IDR and
    # two anchors; none lossless) and the IDR the device decoder decoded.
    launches = deblock_wave.launches
    if launches != 19:
        raise AssertionError(f"oracle phase: {launches} whole-frame launches, "
                             "expected 19")
    print(f"[oracle] mid-stream hand-over: the IDR decoded on cuda, its "
          f"SPS, PPS and reference planes to the oracle, which decodes the "
          f"next P to the encoder's recon; deblock launches {launches} | "
          f"{smi}")
    return launches


def phase_hevc(smi: str, golden: dict) -> None:
    """The format-2 slot through both factories: intra-only HEVC, host
    numpy in both packages."""
    from media_tpu_torch import api
    from media_tpu_torch.core import params

    name = "hevc_api"
    bufs = api_clip(name)
    w, h = API_RUNS[name][3]
    enc_run = drive_api_encode(api, params, name, bufs, device="cuda")
    dec_run = drive_api_decode(api, enc_run["aus"], api_codec_format(name),
                               device="cuda")
    _check_api_record(name, enc_run, dec_run, golden[name])
    n = len(enc_run["aus"])
    print(f"[hevc] {w}x{h} CBR {API_RUNS[name][0]['KEY_BITRATE']} bit/s, "
          f"{n} frames through create_video_encoder(format 2) and "
          f"VideoDecoder(H265): codes SUCCESS, AUs (sizes "
          f"{[len(a) for a in enc_run['aus']]}) and payloads == JAX golden; "
          f"encode {np.mean(enc_run['ms']):.1f} ms a frame, decode "
          f"{dec_run['s'] * 1e3 / n:.1f} ms a frame on the card's host | "
          f"{smi}")


def _check_sharded_record(name: str, aus, got: dict, want: dict,
                          target: float) -> None:
    """AUs, QPs and the tiles' bits exact; the final rate state within
    RATE_FLOAT_TOL. Names the first AU that differs."""
    _first_difference(name, aus, want["au_sha256"], want["au_bytes"])
    if (len(aus) != len(want["au_sha256"]) or got["qps"] != want["qps"]
            or got["bits"] != want["bits"]):
        raise AssertionError(f"{name}: {len(aus)} AUs, QPs {got['qps']}, "
                             f"bits {got['bits']} against "
                             f"{len(want['au_sha256'])}, {want['qps']}, "
                             f"{want['bits']}")
    for k, b in want["rc_final"].items():
        a = got["rc_final"][k]
        scale = max(abs(a), abs(b), target if k == "buf" else 0.0)
        if scale and abs(a - b) / scale > RATE_FLOAT_TOL:
            raise AssertionError(f"{name}: rate state {k} {a!r} against {b!r}")


def phase_sharded(smi: str, golden: dict, bufs) -> int:
    """Row tiles, one slice each, as several tiles on the one card: the
    four-slice golden, phase 5's golden on one tile, the tiled CBR run's own
    golden, and the API's forced placement. Returns the whole-frame
    kernel's launches (one per tile per picture, and the API stream's
    decode)."""
    import torch

    from media_tpu_torch import api
    from media_tpu_torch.core import log as media_log
    from media_tpu_torch.core import params
    from media_tpu_torch.ops.deblock_wave import deblock_wave
    from media_tpu_torch.parallel.sharding import (
        ShardedEncoderSession, get_pool)
    from media_tpu_torch.pipeline.codec import EncoderConfig
    from media_tpu_torch.pipeline.decoder_tpu import TpuDecoder

    sync = torch.cuda.synchronize
    launches = 0
    runs = (
        # (what, the golden's name, fields, tiles, frames)
        ("(a) slices4_cavlc on 4 tiles", "slices4_cavlc",
         TOOL_RUNS["slices4_cavlc"][0], SHARDED_TILES,
         TOOL_RUNS["slices4_cavlc"][1]),
        ("(b) phase 5 on 1 tile", None, {}, 1, 1 + N_CQ_P),
        (f"(c) {SHARDED_RUN} on {SHARDED_TILES} tiles", SHARDED_RUN,
         SHARDED_FIELDS, SHARDED_TILES, N_SHARDED),
    )
    for what, name, fields, tiles, n in runs:
        sess = ShardedEncoderSession(
            EncoderConfig(width=WIDTH, height=HEIGHT, qp=QP, gop_size=300,
                          **fields), devices=["cuda:0"] * tiles)
        if (sess.mesh != (torch.device("cuda", 0),) * tiles
                or [r0 for r0, _ in sess.base.slice_rows]
                != [i * R_MB // tiles for i in range(tiles)]):
            raise AssertionError(f"sharded {what}: mesh {sess.mesh}, slices "
                                 f"{sess.base.slice_rows}")
        deblock_wave.launches = 0
        run = drive_sharded_run(sess, bufs, n, sync)
        n_launch = deblock_wave.launches
        if name == SHARDED_RUN:
            got = sharded_record(sess, run["aus"], run["log"])
            _check_sharded_record(name, run["aus"], got, golden[name],
                                  sess.base._rc_target)
            detail = (f"AUs, QPs {got['qps']} and the tiles' bits == JAX "
                      f"golden (4 virtual CPU devices), rate state "
                      f"{ {k: round(v, 3) for k, v in got['rc_final'].items()} }")
        else:
            want = golden[name] if name else golden
            _first_difference(f"sharded {what}", run["aus"],
                              want["au_sha256"], want["au_bytes"])
            detail = f"AUs == the {name or 'phase 5'} golden"
        if n_launch != n * tiles:
            raise AssertionError(f"sharded {what}: {n_launch} whole-frame "
                                 f"launches for {n} pictures of {tiles} tiles")
        launches += n_launch
        recon = [p.cpu().numpy() for p in sess.recon]
        last = np.frombuffer(bufs[n - 1][: WIDTH * HEIGHT], np.uint8).reshape(
            HEIGHT, WIDTH)
        psnr = _psnr(recon[0][:HEIGHT, :WIDTH], last)
        if not psnr > 25.0:  # the CBR run's last frame is at QP 37
            raise AssertionError(f"sharded {what}: last recon PSNR {psnr:.2f}")
        print(f"[sharded] {what} {WIDTH}x{HEIGHT}, tiles of {R_MB // tiles} "
              f"MB rows on cuda:0: {detail}; deblock launches "
              f"{n_launch}/{n * tiles} (one per tile per picture); IDR "
              f"{run['t_idr'] * 1e3:.1f} ms, P frames "
              f"{(n - 1) / run['t_p']:.3f} fps, PSNR(last Y) {psnr:.3f} dB "
              f"| {smi}")

    # (d) the API's forced placement: one tile a CUDA device of the pool
    lines: list = []
    media_log.set_media_log_callback(
        lambda level, tag, msg: level >= media_log.LOG_WARN
        and lines.append((level, tag, msg)))
    w, h = 64, 64
    store = params.ParamStore({params.KEY_HW_WIDTH: w, params.KEY_HW_HEIGHT: h,
                               params.KEY_MULTICHIP: "1"})
    enc = api.create_video_encoder(store, device="cuda")
    codes = [enc.init_encoder(), enc.start_encoder()]
    sess = enc.session
    pool = get_pool()
    loads = pool.loads()
    small = clip_i420(w, h, 3, seed=7)[0]
    deblock_wave.launches = 0
    aus = []
    for buf in small:
        code, au = enc.encode_one_frame(buf)
        codes.append(code)
        aus.append(bytes(au))
    recon = [p.clone() for p in sess.recon]
    codes.append(enc.destroy_encoder())
    dec = TpuDecoder()
    decoded = [f for au in aus for f in dec.decode_annexb(au)]
    n_launch = deblock_wave.launches
    media_log.set_media_log_callback(None)
    media_log.set_log_level(media_log.LOG_INFO)
    if (not isinstance(sess, ShardedEncoderSession)
            or sess.mesh != (torch.device("cuda", 0),)
            or any(int(c) for c in codes) or lines
            or not any(loads) or any(pool.loads())):
        raise AssertionError(f"sharded (d): session {type(sess).__name__} on "
                             f"{getattr(sess, 'mesh', None)}, codes "
                             f"{[int(c) for c in codes]}, log {lines}, pool "
                             f"loads {loads} then {pool.loads()}")
    _frame_equals(decoded[-1], recon, "sharded (d): decoded vs recon")
    if n_launch != 2 * len(aus):
        raise AssertionError(f"sharded (d): {n_launch} whole-frame launches")
    launches += n_launch
    print(f"[sharded] (d) API {w}x{h} baseline, media.tpu.multichip=1: a "
          f"ShardedEncoderSession on {[str(d) for d in sess.mesh]} from the "
          f"pool (loads {loads} -> {pool.loads()} after destroy), no warning, "
          f"{len(aus)} frames through encode_one_frame, every code SUCCESS, "
          f"decoded == recon, deblock launches {n_launch} | {smi}")
    return launches


def phase_gop_dispatch(smi: str) -> tuple:
    """GOP dispatch at 1080p: one sequential session applying
    reset_gop_state per GOP, the thread dispatcher, and the process
    dispatcher with 1, 2 and 4 workers on the one card, every AU list equal
    to the sequential one. Returns the whole-frame kernel's launches and the
    packer, P-core, intra encode and meta kernels' launches in the worker
    processes."""
    import torch

    from media_tpu_torch.ops.deblock_wave import deblock_wave
    from media_tpu_torch.parallel.gop_dispatch import GopDispatcher
    from media_tpu_torch.parallel.gop_dispatch_mp import dispatch_multiprocess
    from media_tpu_torch.pipeline.codec import EncoderConfig, EncoderSession

    n = GOP_DISPATCH * GOPS_DISPATCH
    frames = clip_i420(n=n)[0]
    cfg_kwargs = dict(width=WIDTH, height=HEIGHT, qp=QP,
                      gop_size=GOP_DISPATCH)
    sync = torch.cuda.synchronize
    mps = "MPS off: the worker contexts time-slice the card"

    sess = EncoderSession(EncoderConfig(**cfg_kwargs))
    sess.encode_frames(frames[:2])  # warm: this geometry's first IDR
    deblock_wave.launches = 0
    sync()
    t0 = time.perf_counter()
    seq = []
    for g in range(GOPS_DISPATCH):
        sess.reset_gop_state(g)
        seq += sess.encode_frames(
            frames[g * GOP_DISPATCH : (g + 1) * GOP_DISPATCH])
    sync()
    t_seq = time.perf_counter() - t0
    launches = deblock_wave.launches
    if launches != n:
        raise AssertionError(f"gop sequential: {launches} launches for {n}")
    print(f"[gop] sequential EncoderSession {WIDTH}x{HEIGHT} QP{QP} CAVLC, "
          f"{GOPS_DISPATCH} GOPs of {GOP_DISPATCH}, reset_gop_state per GOP: "
          f"{n / t_seq:.3f} fps ({sum(len(a) for a in seq)} B) | {smi}")
    del sess

    deblock_wave.launches = 0
    disp = GopDispatcher(EncoderConfig(**cfg_kwargs), DISPATCH_THREADS)
    aus = disp.encode(frames)
    sync()
    rep = disp.report
    disp.close()
    if aus != seq or deblock_wave.launches != n:
        raise AssertionError(f"gop threads: AUs equal {aus == seq}, "
                             f"{deblock_wave.launches} launches for {n}")
    launches += deblock_wave.launches
    print(f"[gop] GopDispatcher {DISPATCH_THREADS} threads on cuda: AUs == "
          f"sequential; {n / rep.wall_s:.3f} fps, dispatch_overhead "
          f"{rep.dispatch_overhead:.4f}, scaling_efficiency "
          f"{rep.compute_s_total / DISPATCH_THREADS / rep.wall_s:.4f} "
          f"(busiest worker {rep.busiest_worker_s:.2f} s of {rep.wall_s:.2f} "
          f"s) | {smi}")

    worker_packs = worker_cores = worker_iencs = worker_ikernels = 0
    worker_metas = 0
    for k in DISPATCH_PROCS:
        aus, rep = dispatch_multiprocess(
            cfg_kwargs, frames, GOP_DISPATCH, n_procs=k,
            use_distributed=(k == 4), prewarm=True, device="cuda")
        if (aus != seq or rep.kernel_launches != n
                or rep.pack_launches != n - GOPS_DISPATCH
                or rep.core_launches != n - GOPS_DISPATCH
                or rep.intra_launches != GOPS_DISPATCH
                or rep.meta_launches != n
                or rep.distributed != (k == 4)):
            raise AssertionError(
                f"gop {k} processes: AUs equal {aus == seq}, "
                f"{rep.kernel_launches} deblock, {rep.pack_launches} "
                f"packer, {rep.core_launches} P-core, {rep.meta_launches} "
                f"meta and {rep.intra_launches} intra launches for {n} "
                f"frames, "
                f"process group {rep.distributed}")
        launches += rep.kernel_launches
        worker_packs += rep.pack_launches
        worker_cores += rep.core_launches
        worker_iencs += rep.intra_launches
        worker_ikernels += rep.intra_kernel_launches
        worker_metas += rep.meta_launches
        per = {}
        for g in rep.gops:
            per[g.worker] = per.get(g.worker, 0.0) + g.compute_s
        overhead = (rep.warm_wall_s - max(per.values())) / rep.warm_wall_s
        print(f"[gop] dispatch_multiprocess {k} process"
              f"{'es' if k > 1 else ''} on cuda"
              f"{', gloo process group' if k == 4 else ''}: AUs == "
              f"sequential; warm window {n / rep.warm_wall_s:.3f} fps, "
              f"scaling_efficiency {rep.scaling_efficiency:.4f}, "
              f"dispatch_overhead {overhead:.4f}, prewarm_s "
              f"{rep.prewarm_s:.3f}, wall with start-up {rep.wall_s:.2f} s "
              f"({mps}) | {smi}")
    return (launches, worker_packs, worker_cores, worker_iencs,
            worker_ikernels, worker_metas)


def main() -> None:
    smi = phase_environment()
    import torch

    sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with open(os.path.join(ROOT, "media_tpu_torch", "golden_1080p.json")) as f:
        golden = json.load(f)
    seconds = {}  # phase -> seconds of its run

    def timed(name, phase, *args):
        t0 = time.perf_counter()
        out = phase(*args)
        seconds[name] = seconds.get(name, 0.0) + time.perf_counter() - t0
        return out

    timed("build", phase_build)
    krec = timed("kernel", phase_kernel, smi)
    krec_step = timed("kernel_step", phase_kernel_step, smi)
    krec_pack = timed("kernel_pack", phase_kernel_pack, smi)
    krec_pcore = timed("kernel_pcore", phase_kernel_pcore, smi)
    krec_ienc, krec_irec = timed("kernel_intra", phase_kernel_intra, smi)
    bufs, clip_sha = clip_i420()
    if clip_sha != golden["clip_sha256"]:
        raise AssertionError(f"input clip digest {clip_sha} != recorded "
                             f"{golden['clip_sha256']} (numpy clip differs)")
    krec_meta = timed("kernel_meta", phase_kernel_meta, smi, bufs)
    if "--kernels" in sys.argv[1:]:
        return
    from media_tpu_torch.entropy.device_cavlc import pack_pslice_device
    from media_tpu_torch.pipeline.deblock_apply import deblock_meta
    from media_tpu_torch.pipeline.decoder_tpu import intra_recon
    from media_tpu_torch.pipeline.encoder import intra_encode
    from media_tpu_torch.pipeline.pframe_core import (
        local_pframe_core, search_refine_luma)

    # phase -> the launches in its run of the packer kernel, of the P-core
    # kernel as the P core, of the P-core kernel as the search alone, of the
    # deblocking meta kernel (one a deblocked picture or tile), and the
    # calls of the intra wavefront kernels (one a picture or tile) with the
    # kernels those calls enqueued (one a wave).
    packs, cores, searches, iencs, irecs, metas = {}, {}, {}, {}, {}, {}
    ienc_kernels, irec_kernels = {}, {}
    wrappers = ((packs, pack_pslice_device, "launches"),
                (metas, deblock_meta, "launches"),
                (cores, local_pframe_core, "launches"),
                (searches, search_refine_luma, "launches"),
                (iencs, intra_encode, "launches"),
                (ienc_kernels, intra_encode, "kernel_launches"),
                (irecs, intra_recon, "launches"),
                (irec_kernels, intra_recon, "kernel_launches"))

    def counted(name, phase, *args):
        """Run a phase with the launch counts set to 0 just before and read
        just after (its stage splits time the kernels through the uncounted
        launch_pack_pslice, launch_pframe_core, launch_deblock_meta and
        launch_intra_encode)."""
        for _, wrapper, attr in wrappers:
            setattr(wrapper, attr, 0)
        out = timed(name, phase, *args)
        for count, wrapper, attr in wrappers:
            count[name] = count.get(name, 0) + getattr(wrapper, attr)
        return out

    timed("native", phase_native, smi, bufs)
    (enc_launches, aus, recon_idr, recon_run, staged, recon_last, pack_rec,
     core_rec, meta_rec) = counted("encode_path", phase_main_path, smi, golden,
                                   bufs)
    dec_launches, step_launches, cq_dec, cq_frames = counted(
        "decode_path", phase_decode_path, smi, golden, aus, recon_idr,
        recon_run)
    rate_launches, keep = counted("rate_path", phase_rate_path, smi, golden,
                                  bufs, RATE_RUNS_PHASE7)
    sess, _run, got = keep["cbr_cabac_aq"]
    t_per_mb, rate_pack_rec, rate_core_rec, rate_meta_rec = timed(
        "rate_stage_split", _rate_stage_split, sess, bufs[5],
        got["rc_final"]["qp"], smi)
    pack_rec.update(rate_pack_rec)
    core_rec.update(rate_core_rec)
    meta_rec.update(rate_meta_rec)
    run = keep["cbr_cabac"][1]
    cabac_launches, _frames = counted(
        "cabac_decode_path", phase_cabac_decode, smi,
        golden["cbr_cabac"]["decoded_sha256"], run["aus"], run["recon_idr"],
        run["recon_run"])
    # One whole staged P frame of the operating point, after its run.
    meta_rec.update({f"profile_{k}_cbr_cabac": v for k, v in timed(
        "profile", _profile_frame, keep["cbr_cabac"][0], bufs[1:4],
        "CBR 8 Mbit/s + CABAC (the operating point)", smi).items()})
    del keep, sess, run, _frames
    i4_launches, keep = counted("i4x4_operating_point", phase_rate_path, smi,
                                golden, bufs, (I4_RUN,))
    sess, run, _got = keep[I4_RUN]
    n_launch, i4_frames = counted(
        "i4x4_operating_point", lambda: phase_cabac_decode(
            smi, golden[I4_RUN]["decoded_sha256"], run["aus"],
            run["recon_idr"], run["recon_run"], what="CABAC + I_4x4"))
    i4_launches += n_launch
    # Phase 19 takes the whole stream and the last recon.
    i4_stream = (run["aus"] + run["staged"], [_host(p) for p in sess.recon],
                 i4_frames)
    del keep, sess, run, _got, i4_frames
    timed("i4x4_idr_split", _i4_idr_split, smi, bufs)
    slice_launches, slice_step_launches = counted(
        "multislice", phase_multislice, smi, golden, bufs)
    bgop_launches = counted("bgop", phase_bgop, smi, golden, bufs)
    counted("lossless", phase_lossless, smi, golden, bufs)
    api_launches, api_runs = counted("api", phase_api, smi, golden)
    capi_launches = counted("capi", phase_capi, smi, golden, api_runs, bufs)
    avref_launches = counted(
        "avref", phase_avref, smi, golden,
        (aus + staged, cq_dec, cq_frames, recon_last), i4_stream)
    del cq_dec, cq_frames, i4_stream
    oracle_launches = counted("oracle_phase", phase_oracle, smi, golden)
    counted("hevc", phase_hevc, smi, golden)
    sharded_launches = counted("sharded", phase_sharded, smi, golden, bufs)
    (gop_launches, worker_packs, worker_cores, worker_iencs,
     worker_ikernels, worker_metas) = counted(
        "gop_dispatch", phase_gop_dispatch, smi)
    packs["gop_dispatch"] += worker_packs  # the spawned workers' launches
    metas["gop_dispatch"] += worker_metas
    cores["gop_dispatch"] += worker_cores
    iencs["gop_dispatch"] += worker_iencs
    ienc_kernels["gop_dispatch"] += worker_ikernels
    # The paths that code P slices on the device: each must have run
    # through the packer kernel.
    idle = [k for k in ("encode_path", "rate_path", "i4x4_operating_point",
                        "sharded", "gop_dispatch") if not packs[k]]
    if idle:
        raise AssertionError(f"packer kernel never launched in {idle}")
    # The phases that encode P frames on the card: each P frame through the
    # P-core kernel; the B-GOP's B pictures through its search alone.
    idle = [k for k in ("encode_path", "rate_path", "i4x4_operating_point",
                        "multislice", "bgop", "api", "capi", "oracle_phase",
                        "sharded", "gop_dispatch") if not cores[k]]
    if idle or not searches["bgop"]:
        raise AssertionError(f"P-core kernel never launched in {idle}, "
                             f"{searches['bgop']} searches in the B-GOP")
    # The phases that encode an IDR on the card, and those that decode an
    # I picture there: each through the intra wavefront kernels.
    idle = [k for k in ("encode_path", "decode_path", "rate_path",
                        "i4x4_operating_point", "multislice", "bgop", "api",
                        "capi", "oracle_phase", "sharded", "gop_dispatch")
            if not iencs[k]]
    idle += [k for k in ("decode_path", "cabac_decode_path",
                         "i4x4_operating_point", "multislice", "api", "capi")
             if not irecs[k]]
    if idle:
        raise AssertionError(f"intra kernels never launched in {idle}")
    # The phases that deblock pictures on the card: each picture's meta
    # through the meta kernel (phase 19 only where libavcodec is there).
    idle = [k for k in ("encode_path", "decode_path", "rate_path",
                        "cabac_decode_path", "i4x4_operating_point",
                        "multislice", "bgop", "api", "capi", "oracle_phase",
                        "sharded", "gop_dispatch") if not metas[k]]
    if avref_launches and not metas["avref"]:
        idle.append("avref")
    if idle:
        raise AssertionError(f"meta kernel never launched in {idle}")
    print("[time] seconds by phase: " + ", ".join(
        f"{k} {v:.1f}" for k, v in seconds.items()))
    print("[kernel] pframe_core launches by phase: " + ", ".join(
        f"{k} {v}" for k, v in cores.items()) + "; the search alone: "
        + ", ".join(f"{k} {v}" for k, v in searches.items()))
    print("[kernel] device_cavlc_pack launches by phase: " + ", ".join(
        f"{k} {v}" for k, v in packs.items()))
    print("[kernel] deblock_meta launches by phase: " + ", ".join(
        f"{k} {v}" for k, v in metas.items()))
    for what, calls, kernels in (("intra_encode", iencs, ienc_kernels),
                                 ("intra_recon", irecs, irec_kernels)):
        print(f"[kernel] {what} calls (kernel launches) by phase: "
              + ", ".join(f"{k} {v} ({kernels[k]})" for k, v in calls.items()))
    print(json.dumps({"kernels": [
        {"name": "deblock_wave", "route": "cuda",
         "source": "media_tpu_torch/csrc/deblock_wave.cu",
         "replaces": "media_tpu/ops/deblock_wave_pallas.py:230",
         "launches": (enc_launches + dec_launches + rate_launches
                      + cabac_launches + i4_launches + slice_launches
                      + bgop_launches + api_launches + capi_launches
                      + avref_launches + oracle_launches + sharded_launches
                      + gop_launches),
         "launches_encode_path": enc_launches,
         "launches_decode_path": dec_launches,
         "launches_rate_path": rate_launches,
         "launches_cabac_decode_path": cabac_launches,
         "launches_i4x4_operating_point": i4_launches,
         "launches_multislice": slice_launches,
         "launches_bgop": bgop_launches,
         "launches_api": api_launches,
         "launches_capi": capi_launches,
         "launches_avref": avref_launches,
         "launches_oracle_phase": oracle_launches,
         "launches_sharded": sharded_launches,
         "launches_gop_dispatch": gop_launches,
         "per_mb_qp_ms_on_clip_frame": t_per_mb, **krec},
        {"name": "deblock_wave_step", "route": "cuda",
         "source": "media_tpu_torch/csrc/deblock_wave_step.cu",
         "replaces": "media_tpu/ops/deblock_pallas.py:96",
         "launches": step_launches + slice_step_launches,
         "launches_decode_path": step_launches,
         "launches_multislice": slice_step_launches, **krec_step},
        {"name": "device_cavlc_pack", "route": "cuda",
         "source": "media_tpu_torch/csrc/device_cavlc.cu",
         "replaces": "media_tpu/entropy/device_cavlc.py:620 (XLA)",
         "launches": sum(packs.values()),
         **{f"launches_{k}": v for k, v in packs.items()},
         **krec_pack, **pack_rec},
        {"name": "pframe_core", "route": "cuda",
         "source": "media_tpu_torch/csrc/pframe_core.cu",
         "replaces": "media_tpu/pipeline/pframe_core.py:211 (XLA)",
         "launches": sum(cores.values()) + sum(searches.values()),
         **{f"launches_{k}": v for k, v in cores.items()},
         **{f"search_launches_{k}": v for k, v in searches.items()},
         **krec_pcore, **core_rec},
        {"name": "deblock_meta", "route": "cuda",
         "source": "media_tpu_torch/csrc/deblock_meta.cu",
         "replaces": "media_tpu/pipeline/deblock_apply.py:209 (XLA)",
         "launches": sum(metas.values()),
         **{f"launches_{k}": v for k, v in metas.items()},
         **krec_meta, **meta_rec},
        *({"name": name, "route": "cuda",
           "source": "media_tpu_torch/csrc/intra_wave.cu",
           "replaces": replaces,
           # The wrapper counts a call: one picture or tile, which enqueues
           # one kernel a wave (kernel_launches).
           "launches": sum(calls.values()), "launches_unit": "calls",
           "kernel_launches": sum(kernels.values()),
           **{f"launches_{k}": v for k, v in calls.items()},
           **{f"kernel_launches_{k}": v for k, v in kernels.items()}, **rec}
          for name, replaces, calls, kernels, rec in (
              ("intra_encode", "media_tpu/pipeline/encoder.py:451 (XLA)",
               iencs, ienc_kernels, krec_ienc),
              ("intra_recon",
               "media_tpu/pipeline/decoder_tpu.py:323, :430 (XLA)", irecs,
               irec_kernels, krec_irec)))]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
