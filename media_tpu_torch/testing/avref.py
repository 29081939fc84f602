"""Independent conformance oracle backed by the system libavcodec.

A copy of media_tpu/testing/avref.py for the port. decode runs our Annex-B
streams through ffmpeg's decoders —
a third-party, widely-deployed conformant implementation with no shared code
with this repo — and return the decoded planes. encode_h264 produces streams
from libx264 (an independent conformant *encoder*) to exercise our decoder
beyond its own encoder's output envelope.

This closes the "oracle independence" gap (a bug in our shared CAVLC tables
or MV prediction is invisible to our in-repo oracle, but not to ffmpeg), and
it is the acceptance test for CABAC interop: a CABAC stream counts as
conformant only if ffmpeg decodes it to our reconstruction bit-exactly.

Reference analog: the reference delegates to OpenH264/NETINT silicon and
inherits interop from them (video_codec/VideoEncoderOpenH264.cpp:344); we
assert it against libavcodec instead. Compiled on demand from
media_tpu_torch/csrc/avshim.c into media_tpu_torch/csrc/build/avshim_<hash>/;
available() is False when the shim does not build (libavcodec headers/libs
absent), and build_error() then holds the compiler's message.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
import threading

import numpy as np

_CSRC = os.path.normpath(
    os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "csrc"))
_LOCK = threading.Lock()
_LIB = None
_TRIED = False
_BUILD_ERROR = ""


def _build() -> str | None:
    """Build the shim into csrc/build/avshim_<hash>/ unless that exists; the
    hash covers the source and the command. A failed build removes only its
    own temporary file, never another process's or another build's."""
    global _BUILD_ERROR
    src = os.path.join(_CSRC, "avshim.c")
    cmd = ["gcc", "-O2", "-shared", "-fPIC", src, "-lavcodec", "-lavutil"]
    with open(src, "rb") as f:
        digest = hashlib.sha256(
            f.read() + " ".join(cmd).encode()).hexdigest()[:16]
    build_dir = os.path.join(_CSRC, "build", f"avshim_{digest}")
    so_path = os.path.join(build_dir, "libavshim.so")
    if os.path.exists(so_path):
        return so_path
    os.makedirs(build_dir, exist_ok=True)
    tmp = f"{so_path}.{os.getpid()}.tmp"
    try:
        proc = subprocess.run(cmd + ["-o", tmp], capture_output=True,
                              text=True, cwd=_CSRC)
    except OSError as e:
        _BUILD_ERROR = f"{' '.join(cmd)}: {e}"
    else:
        if proc.returncode == 0:
            os.replace(tmp, so_path)
            return so_path
        _BUILD_ERROR = f"{' '.join(cmd)}: {proc.stdout}{proc.stderr}".strip()
    sys.stderr.write(f"media_tpu_torch.testing.avref: build failed: "
                     f"{_BUILD_ERROR[:300]}\n")
    if os.path.exists(tmp):
        os.unlink(tmp)
    return None


def _load():
    global _LIB, _TRIED
    with _LOCK:
        if _TRIED:
            return _LIB
        _TRIED = True
        path = _build()
        if path is None:
            return None
        lib = ctypes.CDLL(path)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i32p = ctypes.POINTER(ctypes.c_int32)
        lib.avshim_decode.restype = ctypes.c_int64
        lib.avshim_decode.argtypes = [
            u8p, ctypes.c_int64, ctypes.c_char_p, u8p, ctypes.c_int64,
            i32p, i32p, ctypes.c_int32,
        ]
        lib.avshim_encode.restype = ctypes.c_int64
        lib.avshim_encode.argtypes = [
            u8p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_char_p, ctypes.c_char_p,
            u8p, ctypes.c_int64,
        ]
        _LIB = lib
        return _LIB


def available() -> bool:
    return _load() is not None


def build_error() -> str:
    """The failed build's command and compiler output ("" when the shim
    built or was not tried)."""
    return _BUILD_ERROR


def decode(annexb: bytes, codec: str = "h264",
           max_frames: int = 512) -> list[tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Decode an Annex-B stream with ffmpeg; returns [(y, u, v), ...].

    Raises RuntimeError if the stream is rejected — i.e. non-conformant as
    far as a third-party decoder is concerned.
    """
    lib = _load()
    if lib is None:
        raise RuntimeError("libavcodec shim unavailable")
    src = np.frombuffer(annexb, np.uint8)
    # Generous output budget: 512 frames at up to 4K would be huge; size the
    # buffer from the stream with a floor, growing on the (rare) overflow.
    cap = 64 << 20
    while True:
        out = np.empty(cap, np.uint8)
        w = ctypes.c_int32(0)
        h = ctypes.c_int32(0)
        n = lib.avshim_decode(
            src.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(annexb),
            codec.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            cap, ctypes.byref(w), ctypes.byref(h), max_frames)
        if n == -7 and cap < (2 << 30):
            cap *= 4
            continue
        break
    if n < 0:
        raise RuntimeError(f"ffmpeg {codec} decode failed (err {n})")
    w, h = w.value, h.value
    frames = []
    sz = w * h * 3 // 2
    for i in range(min(int(n), max_frames)):
        base = i * sz
        y = out[base : base + w * h].reshape(h, w).copy()
        u = out[base + w * h : base + w * h + w * h // 4].reshape(
            h // 2, w // 2).copy()
        v = out[base + w * h + w * h // 4 : base + sz].reshape(
            h // 2, w // 2).copy()
        frames.append((y, u, v))
    return frames


def encode_h264(frames, qp: int = 28, gop: int = 30,
                x264_params: str = "") -> bytes:
    """Encode [(y, u, v), ...] with libx264 into an Annex-B stream.

    x264_params appends raw x264 key=val pairs (":"-separated), e.g.
    "cabac=0:ref=1:partitions=none" for a baseline-ish stream or
    "bframes=2" to exercise B slices in our decoder.
    """
    lib = _load()
    if lib is None:
        raise RuntimeError("libavcodec shim unavailable")
    h, w = frames[0][0].shape
    packed = np.concatenate([
        np.concatenate([y.ravel(), u.ravel(), v.ravel()]).astype(np.uint8)
        for y, u, v in frames
    ])
    cap = max(len(packed) * 2, 4 << 20)
    out = np.empty(cap, np.uint8)
    n = lib.avshim_encode(
        packed.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        len(frames), w, h, qp, gop, b"libx264", x264_params.encode(),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), cap)
    if n < 0:
        raise RuntimeError(f"libx264 encode failed (err {n})")
    return out[:n].tobytes()
