"""H.264 4x4 integer transform, Hadamard DC transforms, quant/dequant.

PyTorch twin of media_tpu/ops/transform.py. Everything is int32 and
bit-exact against Rec. ITU-T H.264 sections 8.5.10-8.5.12 with flat scaling
lists. Blocks have shape (..., 4, 4) (or (..., 2, 2) for chroma DC). QP is a
Python int (the port encodes at constant QP); the two dequantisers that the
decoder runs on adaptive-QP streams also take a per-MB (N,) QP tensor.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

# --- Quantization tables (spec 8.5.12.1, Table 8-15 normAdjust / JM MF) ------

# Forward multiplier MF by qp%6 and coefficient class (0: (0,0),(0,2),(2,0),(2,2);
# 1: (1,1),(1,3),(3,1),(3,3); 2: others).
_MF_CLASS = np.array(
    [
        [13107, 5243, 8066],
        [11916, 4660, 7490],
        [10082, 4194, 6554],
        [9362, 3647, 5825],
        [8192, 3355, 5243],
        [7282, 2893, 4559],
    ],
    dtype=np.int32,
)

# Dequant scale V (normAdjust4x4) by qp%6 and class.
_V_CLASS = np.array(
    [
        [10, 16, 13],
        [11, 18, 14],
        [13, 20, 16],
        [14, 23, 18],
        [16, 25, 20],
        [18, 29, 23],
    ],
    dtype=np.int32,
)

# Position-class map for a 4x4 block.
_POS_CLASS = np.array(
    [
        [0, 2, 0, 2],
        [2, 1, 2, 1],
        [0, 2, 0, 2],
        [2, 1, 2, 1],
    ],
    dtype=np.int32,
)

MF_4x4 = _MF_CLASS[:, _POS_CLASS]  # (6, 4, 4)
V_4x4 = _V_CLASS[:, _POS_CLASS]  # (6, 4, 4)

# Chroma QP mapping (spec Table 8-12): qPc as a function of clip3(0,51,qPi).
CHROMA_QP_TABLE = np.array(
    list(range(30)) + [29, 30, 31, 32, 32, 33, 34, 34, 35, 35, 36, 36, 37, 37,
                       37, 38, 38, 38, 39, 39, 39, 39],
    dtype=np.int32,
)

# Zig-zag scan for 4x4 blocks (spec Table 8-13, frame coding).
ZIGZAG_4x4 = np.array(
    [(0, 0), (0, 1), (1, 0), (2, 0), (1, 1), (0, 2), (0, 3), (1, 2),
     (2, 1), (3, 0), (3, 1), (2, 2), (1, 3), (2, 3), (3, 2), (3, 3)],
    dtype=np.int32,
)
ZIGZAG_FLAT = np.array([r * 4 + c for r, c in ZIGZAG_4x4], dtype=np.int32)
INV_ZIGZAG_FLAT = np.argsort(ZIGZAG_FLAT).astype(np.int32)

MAX_LEVEL = 2063  # keeps every CAVLC level codeword within the 28-bit escape


def chroma_qp(qp_y, chroma_qp_index_offset: int = 0):
    """Derive chroma QP from luma QP (spec 8.5.8)."""
    qpi = np.clip(qp_y + chroma_qp_index_offset, 0, 51)
    return CHROMA_QP_TABLE[qpi]


@functools.lru_cache(maxsize=None)
def _tables(device: torch.device):
    return {
        "mf": torch.as_tensor(MF_4x4, device=device),
        "v": torch.as_tensor(V_4x4, device=device),
        "zz": torch.as_tensor(ZIGZAG_FLAT, dtype=torch.long, device=device),
        "izz": torch.as_tensor(INV_ZIGZAG_FLAT, dtype=torch.long,
                               device=device),
    }


# --- Core transforms ---------------------------------------------------------


def _rows_fwd(v):
    a = v[..., 0, :] + v[..., 3, :]
    b = v[..., 1, :] + v[..., 2, :]
    c = v[..., 1, :] - v[..., 2, :]
    d = v[..., 0, :] - v[..., 3, :]
    return torch.stack([a + b, 2 * d + c, a - b, d - 2 * c], dim=-2)


def forward_4x4(x):
    """Forward 4x4 core transform W = Cf · X · Cf^T. x: int32 (..., 4, 4)."""
    x = x.to(torch.int32)
    t = _rows_fwd(x.transpose(-1, -2))
    return _rows_fwd(t.transpose(-1, -2))


def _stage_inv(v):
    e0 = v[..., 0, :] + v[..., 2, :]
    e1 = v[..., 0, :] - v[..., 2, :]
    e2 = (v[..., 1, :] >> 1) - v[..., 3, :]
    e3 = v[..., 1, :] + (v[..., 3, :] >> 1)
    return torch.stack([e0 + e3, e1 + e2, e1 - e2, e0 - e3], dim=-2)


def inverse_4x4(d):
    """Inverse 4x4 core transform incl. the final (x+32)>>6 (spec 8.5.12.2)."""
    d = d.to(torch.int32)
    h = _stage_inv(d.transpose(-1, -2))
    h = _stage_inv(h.transpose(-1, -2))
    return (h + 32) >> 6


def _rows_had(v):
    a = v[..., 0, :] + v[..., 3, :]
    b = v[..., 1, :] + v[..., 2, :]
    c = v[..., 1, :] - v[..., 2, :]
    d = v[..., 0, :] - v[..., 3, :]
    return torch.stack([a + b, d + c, a - b, d - c], dim=-2)


def hadamard_4x4(x):
    """4x4 Hadamard transform (intra16x16 luma DC), H · X · H."""
    x = x.to(torch.int32)
    t = _rows_had(x.transpose(-1, -2))
    return _rows_had(t.transpose(-1, -2))


def hadamard_2x2(x):
    """2x2 transform for chroma DC: [[1,1],[1,-1]] · X · [[1,1],[1,-1]]."""
    x = x.to(torch.int32)
    a, b = x[..., 0, 0], x[..., 0, 1]
    c, d = x[..., 1, 0], x[..., 1, 1]
    return torch.stack(
        [
            torch.stack([a + b + c + d, a - b + c - d], dim=-1),
            torch.stack([a + b - c - d, a - b - c + d], dim=-1),
        ],
        dim=-2,
    )


# --- Quantization ------------------------------------------------------------


def quant_4x4(w, qp: int, *, intra: bool):
    """Forward quantization (JM method), levels clamped to +-MAX_LEVEL."""
    w = w.to(torch.int32)
    qbits = 15 + qp // 6
    mf = _tables(w.device)["mf"][qp % 6]
    f = (1 << qbits) // (3 if intra else 6)
    level = (w.abs() * mf + f) >> qbits
    return torch.sign(w) * torch.clamp(level, max=MAX_LEVEL)


def quant_dc_4x4(w_dc, qp: int, *, intra: bool = True):
    """Quantize intra16x16 luma DC given the raw forward Hadamard output:
    (|W| * MF0 + 4f) >> (qbits + 2), unclamped (the I16 DC is host-packed,
    where extended level escapes are supported)."""
    w = w_dc.to(torch.int32)
    qbits = 15 + qp // 6
    mf0 = int(MF_4x4[qp % 6, 0, 0])
    f = (1 << qbits) // (3 if intra else 6)
    level = (w.abs() * mf0 + 4 * f) >> (qbits + 2)
    return torch.sign(w) * level


def quant_dc_2x2(w_dc, qp: int, *, intra: bool):
    """Quantize chroma DC after the 2x2 transform: (|W|*MF0 + 2f) >> (qbits+1)."""
    w = w_dc.to(torch.int32)
    qbits = 15 + qp // 6
    mf0 = int(MF_4x4[qp % 6, 0, 0])
    f = (1 << qbits) // (3 if intra else 6)
    level = (w.abs() * mf0 + 2 * f) >> (qbits + 1)
    return torch.sign(w) * torch.clamp(level, max=MAX_LEVEL)


def dequant_4x4(z, qp):
    """Dequantize 4x4 levels: d = z * V(qp%6, pos) << (qp/6). qp: int, or a
    (N,) integer tensor of per-MB QPs for z of shape (N, ..., 4, 4)."""
    z = z.to(torch.int32)
    v = _tables(z.device)["v"]
    if not torch.is_tensor(qp):
        return (z * v[qp % 6]) << (qp // 6)
    qp = qp.to(torch.long)
    n, mid = z.shape[0], (1,) * (z.dim() - 3)
    shift = (qp // 6).to(torch.int32).reshape(n, *mid, 1, 1)
    return (z * v[qp % 6].reshape(n, *mid, 4, 4)) << shift


def dequant_dc_4x4(f_dc, qp: int):
    """Dequantize intra16x16 luma DC after the decoder-side inverse Hadamard
    (spec 8.5.10)."""
    f = f_dc.to(torch.int32)
    ls = 16 * int(V_4x4[qp % 6, 0, 0])
    if qp >= 36:
        return (f * ls) << (qp // 6 - 6)
    return (f * ls + (1 << (5 - qp // 6))) >> (6 - qp // 6)


def dequant_dc_2x2(f_dc, qp):
    """Dequantize chroma DC after the decoder-side 2x2 transform (spec
    8.5.11): ((f * 16*V0) << (qp/6)) >> 5. qp: int, or a (N,) integer tensor
    of per-MB QPs for f_dc of shape (N, 2, 2)."""
    f = f_dc.to(torch.int32)
    if not torch.is_tensor(qp):
        v0 = int(V_4x4[qp % 6, 0, 0])
        return ((f * 16 * v0) << (qp // 6)) >> 5
    qp = qp.to(torch.long)
    v0 = _tables(f.device)["v"][qp % 6, 0, 0][:, None, None]
    return ((f * 16 * v0) << (qp // 6).to(torch.int32)[:, None, None]) >> 5


# --- Zig-zag -----------------------------------------------------------------


def zigzag(blocks):
    """(..., 4, 4) -> (..., 16) in zig-zag scan order."""
    flat = blocks.reshape(*blocks.shape[:-2], 16)
    return flat[..., _tables(flat.device)["zz"]]


def inverse_zigzag(scans):
    """(..., 16) zig-zag order -> (..., 4, 4)."""
    blocks = scans[..., _tables(scans.device)["izz"]]
    return blocks.reshape(*scans.shape[:-1], 4, 4)
