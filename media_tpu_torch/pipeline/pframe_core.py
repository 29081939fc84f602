"""P- and B-frame compute cores: ME + MC + transform/quant (+ the P
frame's reconstruction).

PyTorch twin of media_tpu/pipeline/pframe_core.py (the single-device paths).
The P core outputs one int16 symbol tensor per frame and uint8 recon planes
that stay on the device as the next frame's reference; the B core outputs
symbols only (mv0, mv1, then the P layout's levels: B_SYMBOLS_PER_MB).

Symbol layout per MB (int16, SYMBOLS_PER_MB total):
  [ mvx, mvy,
    luma levels  16 blocks x 16 coeffs (zig-zag, raster block order),
    chroma DC    2 comps x 4,
    chroma AC    2 comps x 4 blocks x 15 ]

Where the JAX package extracts per-MB windows with one-hot bf16 matmuls (an
element gather serialises on a TPU), this port indexes the padded plane
directly: the windows are the same samples.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import interp as interp_ops
from ..ops import me as me_ops
from ..ops import transform as T
from ..ops.pad import edge_pad


def chroma_qp_device(qp):
    """Chroma QP of a luma QP tensor (0-d or per-MB), on its device (spec
    Table 8-12), for the on-device rate control."""
    return T._tables(qp.device)["cqp"][qp.long().clamp(0, 51)]


# Extra halo beyond the full-pel search range: quarter-pel refinement moves
# the integer base by up to 1 pixel and the 6-tap interpolation reaches 3
# more samples.
INTERP_HALO = 4

SYMBOLS_PER_MB = 2 + 256 + 8 + 120  # = 386
_OFF_MV = 0
_OFF_LUMA = 2
_OFF_CDC = 2 + 256
_OFF_CAC = 2 + 256 + 8


def _mb_blocks(mb):
    """(N, 16, 16) -> (N, 16, 4, 4): raster-ordered 4x4 blocks."""
    n = mb.shape[0]
    return mb.reshape(n, 4, 4, 4, 4).transpose(2, 3).reshape(n, 16, 4, 4)


def _blocks_mb(blocks):
    """(N, 16, 4, 4) -> (N, 16, 16)."""
    n = blocks.shape[0]
    return blocks.reshape(n, 4, 4, 4, 4).transpose(2, 3).reshape(n, 16, 16)


def _mb_blocks8(mb):
    """(N, 8, 8) -> (N, 4, 4, 4): raster-ordered 4x4 blocks of an 8x8."""
    n = mb.shape[0]
    return mb.reshape(n, 2, 4, 2, 4).transpose(2, 3).reshape(n, 4, 4, 4)


def _blocks8_mb(blocks):
    n = blocks.shape[0]
    return blocks.reshape(n, 2, 2, 4, 4).transpose(2, 3).reshape(n, 8, 8)


def to_mbs(plane, R: int, C: int, size: int):
    """(R*size, C*size) plane -> (R*C, size, size) raster-ordered MBs."""
    return (plane.reshape(R, size, C, size).transpose(1, 2)
            .reshape(R * C, size, size))


def from_mbs(x, R: int, C: int, size: int):
    """(R*C, size, size) MBs -> (R*size, C*size) plane."""
    return (x.reshape(R, C, size, size).transpose(1, 2)
            .reshape(R * size, C * size))


def unpack_symbols(symbols):
    """(R, C, SYMBOLS_PER_MB) int16 -> dict of int32 numpy arrays."""
    s = np.asarray(symbols.cpu() if torch.is_tensor(symbols) else symbols)
    R, C = s.shape[:2]
    return {
        "mv": s[..., _OFF_MV:_OFF_LUMA].astype(np.int32),
        "luma_levels": s[..., _OFF_LUMA:_OFF_CDC].reshape(R, C, 16, 16).astype(np.int32),
        "cdc_levels": s[..., _OFF_CDC:_OFF_CAC].reshape(R, C, 2, 4).astype(np.int32),
        "cac_levels": s[..., _OFF_CAC:].reshape(R, C, 2, 4, 15).astype(np.int32),
    }


def unpack_symbols_device(symbols):
    """Device-side view of the packed symbol tensor: int32 (mv, luma, cdc,
    cac) for the on-device entropy packer and the deblocking bS."""
    R, C = symbols.shape[:2]
    s = symbols.to(torch.int32)
    return (
        s[..., _OFF_MV:_OFF_LUMA],
        s[..., _OFF_LUMA:_OFF_CDC].reshape(R, C, 16, 16),
        s[..., _OFF_CDC:_OFF_CAC].reshape(R, C, 2, 4),
        s[..., _OFF_CAC:].reshape(R, C, 2, 4, 15),
    )


def _windows(plane, row0, col0, size: int):
    """(N, size, size) windows of `plane` at per-MB origins (row0, col0)."""
    ar = torch.arange(size, device=plane.device)
    rows = row0.long()[:, None, None] + ar[None, :, None]
    cols = col0.long()[:, None, None] + ar[None, None, :]
    return plane[rows, cols]


def _mb_origins(R: int, C: int, size: int, device):
    n = torch.arange(R * C, device=device, dtype=torch.int32)
    return (n // C) * size, (n % C) * size


def mc_chroma_ext(ref_c_ext, mv, R: int, C: int, halo: int):
    """Chroma MC against a plane extended with `halo` rows above and below.

    mv is in quarter-pel luma units == 1/8-pel chroma units (spec 8.4.2.2.2).
    halo = search_range//2 + 2 bounds the integer chroma displacement, so
    every 9x9 bilinear patch lies inside the edge-padded plane.
    """
    ix = mv[:, 0] >> 3
    iy = mv[:, 1] >> 3
    fx = (mv[:, 0] & 7)[:, None, None]
    fy = (mv[:, 1] & 7)[:, None, None]
    plane = edge_pad(ref_c_ext, 0, 0, halo, halo)
    r0, c0 = _mb_origins(R, C, 8, mv.device)
    patch = _windows(plane, halo + r0 + iy, halo + c0 + ix, 9).to(torch.int32)
    a = patch[:, :8, :8]
    b = patch[:, :8, 1:9]
    cc = patch[:, 1:9, :8]
    d = patch[:, 1:9, 1:9]
    return ((8 - fx) * (8 - fy) * a + fx * (8 - fy) * b
            + (8 - fx) * fy * cc + fx * fy * d + 32) >> 6


# (xf, yf) -> up to two taps of (plane, px, py); spec Table 8-12 positions,
# the same map as media_tpu/ops/interp.py:subpel_value.
_TAPS = {
    (0, 0): (("g", 0, 0),),
    (1, 0): (("g", 0, 0), ("b", 0, 0)),
    (2, 0): (("b", 0, 0),),
    (3, 0): (("b", 0, 0), ("g", 1, 0)),
    (0, 1): (("g", 0, 0), ("h", 0, 0)),
    (1, 1): (("b", 0, 0), ("h", 0, 0)),
    (2, 1): (("b", 0, 0), ("j", 0, 0)),
    (3, 1): (("b", 0, 0), ("h", 1, 0)),
    (0, 2): (("h", 0, 0),),
    (1, 2): (("h", 0, 0), ("j", 0, 0)),
    (2, 2): (("j", 0, 0),),
    (3, 2): (("j", 0, 0), ("h", 1, 0)),
    (0, 3): (("h", 0, 0), ("g", 0, 1)),
    (1, 3): (("h", 0, 0), ("b", 0, 1)),
    (2, 3): (("j", 0, 0), ("b", 0, 1)),
    (3, 3): (("h", 1, 0), ("b", 0, 1)),
}
_DELTAS = [(dx, dy) for dy in range(-3, 4) for dx in range(-3, 4)]


def refine_subpel(cur, plane_g, plane_b, plane_h, plane_j, mv_full, R, C,
                  rs: int, lambda_q: int = 1):
    """Quarter-pel refinement: all 49 (dx, dy) in [-3,3]^2 around the
    full-pel best, cost SAD + lambda_q * |qmv|_1, first minimum on ties.

    Planes are padded by rs + INTERP_HALO on all sides (luma). Returns
    (qmv (N,2) quarter-pel, pred (N,16,16) int32, cost (N,) int32).
    """
    n = R * C
    pad_off = rs + INTERP_HALO
    # Window row 0 sits at (mv - 1) relative to the MB origin.
    r0, c0 = _mb_origins(R, C, 16, mv_full.device)
    row0 = pad_off + r0 + mv_full[:, 1] - 1
    col0 = pad_off + c0 + mv_full[:, 0] - 1

    shifts = {}
    for name, plane in (("g", plane_g), ("b", plane_b), ("h", plane_h),
                        ("j", plane_j)):
        w16 = _windows(plane, row0, col0, 18).to(torch.int16)
        shifts[name] = {(oy, ox): w16[:, oy : oy + 16, ox : ox + 16].reshape(n, 256)
                        for oy in range(3) for ox in range(3)}
    cur_f = cur.to(torch.int16).reshape(n, 256)

    def pred_flat(dx, dy):
        ox = 1 + (dx >> 2)
        oy = 1 + (dy >> 2)
        vals = [shifts[p][(oy + py, ox + px)]
                for p, px, py in _TAPS[(dx & 3, dy & 3)]]
        if len(vals) == 1:
            return vals[0]
        return (vals[0] + vals[1] + 1) >> 1  # int16-safe: a+b+1 <= 511

    base_q = 4 * mv_full  # (N, 2)
    preds = torch.stack([pred_flat(dx, dy) for dx, dy in _DELTAS], dim=1)
    d_tab = torch.tensor(_DELTAS, dtype=torch.int32, device=cur.device)
    sad = (preds - cur_f[:, None, :]).abs().sum(dim=2, dtype=torch.int32)
    mv_rate = lambda_q * ((base_q[:, None, 0] + d_tab[None, :, 0]).abs()
                          + (base_q[:, None, 1] + d_tab[None, :, 1]).abs())
    costs = sad + mv_rate  # (N, 49)
    best = torch.argmin(costs, dim=1)
    best_cost = torch.gather(costs, 1, best[:, None])[:, 0]
    best_pred = preds[torch.arange(n, device=cur.device), best]
    return (base_q + d_tab[best], best_pred.reshape(n, 16, 16).to(torch.int32),
            best_cost)


def search_refine_luma(cur, ref_y_ext, search_range: int, R: int, C: int):
    """Full-pel search + quarter-pel refinement against one reference.

    cur: (N, 16, 16) int32 MBs; ref_y_ext: reference luma extended by
    search_range + INTERP_HALO rows above and below. Returns (qmv (N, 2)
    quarter-pel, pred (N, 16, 16), cost (N,))."""
    rs = search_range
    # Full-pel search uses exactly `rs` halo; the extra INTERP_HALO rows are
    # for sub-pel interpolation reach.
    pad = edge_pad(ref_y_ext[INTERP_HALO:-INTERP_HALO], 0, 0, rs, rs)
    span = 16 + 2 * rs
    windows = pad.unfold(0, span, 16).unfold(1, span, 16).reshape(
        R * C, span, span)
    mv_full, _cost = me_ops.full_search(cur, windows, rs)

    pad_i = edge_pad(ref_y_ext, 0, 0, rs + INTERP_HALO, rs + INTERP_HALO)
    hp_b, hp_h, hp_j = interp_ops.half_pel_planes(pad_i)
    return refine_subpel(cur, pad_i, hp_b, hp_h, hp_j, mv_full, R, C, rs)


def _chroma_levels(o_c, pred_c, qp_c):
    """Chroma residual of one component against its prediction, quantized:
    (transform coefficients, DC levels (N, 2, 2), AC levels (N, 4, 4, 4))."""
    w_c = T.forward_4x4(_mb_blocks8(o_c - pred_c))
    dc2 = w_c[:, :, 0, 0].reshape(-1, 2, 2)
    z2 = T.quant_dc_2x2(T.hadamard_2x2(dc2), qp_c, intra=False)
    z_cac = T.quant_4x4(w_c, qp_c, intra=False)
    z_cac[:, :, 0, 0] = 0
    return z2, z_cac


def _chroma_code(o_c, pred_c, qp_c):
    z2, z_cac = _chroma_levels(o_c, pred_c, qp_c)
    d2 = T.dequant_dc_2x2(T.hadamard_2x2(z2), qp_c)
    d_c = T.dequant_4x4(z_cac, qp_c)
    d_c[:, :, 0, 0] = d2.reshape(-1, 4)
    recon_c = (pred_c + _blocks8_mb(T.inverse_4x4(d_c))).clamp(0, 255)
    return z2.reshape(-1, 4), z_cac, recon_c


def local_pframe_core(cur_y, cur_u, cur_v, ref_y_ext, ref_u_ext, ref_v_ext,
                      qp, qp_c, search_range: int, n_rows: int, n_cols: int):
    """P-frame encode of an (n_rows, n_cols) MB grid.

    qp, qp_c: luma and chroma QP as Python ints, as 0-d tensors (a QP the
    rate loop computed on the device) or as per-MB (R*C,) tensors.

    ref_y_ext has `search_range + INTERP_HALO` extra rows above/below;
    ref_[uv]_ext have `search_range // 2 + 2`. MVs are refined to quarter-pel
    precision. Returns {"symbols" (R, C, 386) int16 (mv in quarter-pel),
    "recon_y/u/v" uint8 planes, "sad_total"}.
    """
    R, C = n_rows, n_cols
    n = R * C
    rs = search_range
    halo_c = rs // 2 + 2
    cur = to_mbs(cur_y, R, C, 16).to(torch.int32)
    cu = to_mbs(cur_u, R, C, 8).to(torch.int32)
    cv = to_mbs(cur_v, R, C, 8).to(torch.int32)

    qmv, pred, cost = search_refine_luma(cur, ref_y_ext, rs, R, C)

    pred_u = mc_chroma_ext(ref_u_ext, qmv, R, C, halo_c)
    pred_v = mc_chroma_ext(ref_v_ext, qmv, R, C, halo_c)

    z = T.quant_4x4(T.forward_4x4(_mb_blocks(cur - pred)), qp, intra=False)
    recon = (pred + _blocks_mb(T.inverse_4x4(T.dequant_4x4(z, qp)))).clamp(0, 255)
    zdc_u, zac_u, rec_u = _chroma_code(cu, pred_u, qp_c)
    zdc_v, zac_v, rec_v = _chroma_code(cv, pred_v, qp_c)

    symbols = torch.cat(
        [
            qmv,
            T.zigzag(z).reshape(n, 256),
            torch.stack([zdc_u, zdc_v], dim=1).reshape(n, 8),
            torch.stack([T.zigzag(zac_u)[..., 1:], T.zigzag(zac_v)[..., 1:]],
                        dim=1).reshape(n, 120),
        ],
        dim=-1,
    ).to(torch.int16).reshape(R, C, SYMBOLS_PER_MB)
    return {
        "symbols": symbols,
        "recon_y": from_mbs(recon, R, C, 16).to(torch.uint8),
        "recon_u": from_mbs(rec_u, R, C, 8).to(torch.uint8),
        "recon_v": from_mbs(rec_v, R, C, 8).to(torch.uint8),
        "sad_total": cost.sum(dtype=torch.int32),
    }


B_SYMBOLS_PER_MB = 4 + 256 + 8 + 120  # = 388: mv0, mv1, luma, cdc, cac


def local_bframe_core(cur_y, cur_u, cur_v, ref0_ext, ref1_ext, qp, qp_c,
                      search_range: int, n_rows: int, n_cols: int):
    """B-frame encode core (B_Bi_16x16 everywhere): independent ME against
    both references, default bi-prediction (spec 8.4.2.3.2: the rounded
    average of the two prediction signals), transform/quant of the bi
    residual.

    ref0_ext/ref1_ext: (y_ext, u_ext, v_ext) triples padded like the P
    core's references. Returns the (R, C, B_SYMBOLS_PER_MB) int16 symbols;
    no reconstruction: B frames are non-reference in this GOP structure, so
    their recon never feeds prediction."""
    R, C = n_rows, n_cols
    n = R * C
    rs = search_range
    halo_c = rs // 2 + 2
    cur = to_mbs(cur_y, R, C, 16).to(torch.int32)
    cu = to_mbs(cur_u, R, C, 8).to(torch.int32)
    cv = to_mbs(cur_v, R, C, 8).to(torch.int32)

    qmv0, pred0, _ = search_refine_luma(cur, ref0_ext[0], rs, R, C)
    qmv1, pred1, _ = search_refine_luma(cur, ref1_ext[0], rs, R, C)
    pred = (pred0 + pred1 + 1) >> 1
    pu = (mc_chroma_ext(ref0_ext[1], qmv0, R, C, halo_c)
          + mc_chroma_ext(ref1_ext[1], qmv1, R, C, halo_c) + 1) >> 1
    pv = (mc_chroma_ext(ref0_ext[2], qmv0, R, C, halo_c)
          + mc_chroma_ext(ref1_ext[2], qmv1, R, C, halo_c) + 1) >> 1

    z = T.quant_4x4(T.forward_4x4(_mb_blocks(cur - pred)), qp, intra=False)
    zdc_u, zac_u = _chroma_levels(cu, pu, qp_c)
    zdc_v, zac_v = _chroma_levels(cv, pv, qp_c)
    return torch.cat(
        [
            qmv0,
            qmv1,
            T.zigzag(z).reshape(n, 256),
            torch.stack([zdc_u, zdc_v], dim=1).reshape(n, 8),
            torch.stack([T.zigzag(zac_u)[..., 1:], T.zigzag(zac_v)[..., 1:]],
                        dim=1).reshape(n, 120),
        ],
        dim=-1,
    ).to(torch.int16).reshape(R, C, B_SYMBOLS_PER_MB)


def unpack_b_symbols(symbols):
    """(R, C, B_SYMBOLS_PER_MB) int16 -> dict of int32 numpy arrays."""
    s = np.asarray(symbols.cpu() if torch.is_tensor(symbols) else symbols)
    R, C = s.shape[:2]
    return {
        "mv0": s[..., 0:2].astype(np.int32),
        "mv1": s[..., 2:4].astype(np.int32),
        "luma_levels": s[..., 4:260].reshape(R, C, 16, 16).astype(np.int32),
        "cdc_levels": s[..., 260:268].reshape(R, C, 2, 4).astype(np.int32),
        "cac_levels": s[..., 268:].reshape(R, C, 2, 4, 15).astype(np.int32),
    }
