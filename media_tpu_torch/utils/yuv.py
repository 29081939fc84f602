"""I420 frame helpers: packing/unpacking, padding to MB grid, PSNR.

The I420 layout matches the reference's frame contract: a contiguous
Y (w*h) + U (w/2*h/2) + V buffer, validated as w*h*3/2 per frame
(reference: VideoEncoderOpenH264.cpp:307 size guard).
"""

from __future__ import annotations

import numpy as np


def split_i420(data: bytes | np.ndarray, width: int, height: int):
    """Split a packed I420 buffer into (y, u, v) uint8 planes."""
    buf = np.frombuffer(data, dtype=np.uint8) if isinstance(data, (bytes, bytearray)) else np.asarray(data, np.uint8).ravel()
    ysize = width * height
    csize = (width // 2) * (height // 2)
    if buf.size < ysize + 2 * csize:
        raise ValueError(f"I420 buffer too small: {buf.size} < {ysize + 2 * csize}")
    y = buf[:ysize].reshape(height, width)
    u = buf[ysize : ysize + csize].reshape(height // 2, width // 2)
    v = buf[ysize + csize : ysize + 2 * csize].reshape(height // 2, width // 2)
    return y, u, v


def pack_i420(y: np.ndarray, u: np.ndarray, v: np.ndarray) -> bytes:
    return y.astype(np.uint8).tobytes() + u.astype(np.uint8).tobytes() + v.astype(np.uint8).tobytes()


def pad_to_mb_grid(plane: np.ndarray, mb_size: int = 16) -> np.ndarray:
    """Pad a plane to a multiple of mb_size by edge replication (the encoder
    analog of the reference's alignment-compensation crop window)."""
    h, w = plane.shape
    ph = (h + mb_size - 1) // mb_size * mb_size
    pw = (w + mb_size - 1) // mb_size * mb_size
    if ph == h and pw == w:
        return plane
    return np.pad(plane, ((0, ph - h), (0, pw - w)), mode="edge")


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    mse = np.mean((a - b) ** 2)
    if mse == 0:
        return float("inf")
    return 10.0 * np.log10(255.0 * 255.0 / mse)
