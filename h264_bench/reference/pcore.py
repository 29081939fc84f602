"""The P-frame core in plain PyTorch: the exhaustive full-pel SAD search
(+-8), the quarter-pel refinement over 49 candidates, chroma MC, the 4x4
transforms, quantisation and the reconstruction before deblocking.

A frozen copy of media_tpu_torch/pipeline/pframe_core.py's plain path
(pframe_core_whole_plain, local_pframe_core_plain, search_refine_luma_plain,
refine_subpel, mc_chroma_ext) with ops/me.py:full_search,
ops/interp.py:half_pel_planes and ops/pad.py:edge_pad. Nothing of the
program is imported.
"""

from __future__ import annotations

import torch

from . import transform as T
from .intra import _blocks8_mb, _blocks_mb, _mb_blocks, _mb_blocks8


def edge_pad(x, top: int, bottom: int, left: int, right: int):
    """Pad a (H, W) plane by replicating its border rows and columns."""
    h, w = x.shape
    rows = torch.arange(-top, h + bottom, device=x.device).clamp(0, h - 1)
    cols = torch.arange(-left, w + right, device=x.device).clamp(0, w - 1)
    return x[rows[:, None], cols[None, :]]



def full_search(cur_mbs, windows, radius: int, lambda_mv: int = 4):
    """Full-pel exhaustive SAD search.

    cur_mbs: (N, 16, 16) int current MBs; windows: (N, 16+2R, 16+2R) int
    reference windows. Returns (mv (N, 2) int32 (mvx, mvy), cost (N,) int32),
    cost = SAD + lambda * |mv|_1. Ties go to the first minimum in (dy, dx)
    raster order, as in the JAX package (argmin keeps the first minimum).
    """
    K = 2 * radius + 1
    dev = cur_mbs.device
    cur16 = cur_mbs.to(torch.int16)
    win16 = windows.to(torch.int16)
    mvx_cost = lambda_mv * (torch.arange(K, device=dev, dtype=torch.int32)
                            - radius).abs()
    rows = []
    for dy in range(K):
        # (N, 16, K, 16) candidate blocks of this row, a view of the window.
        cand = win16[:, dy : dy + 16, :].unfold(2, 16, 1)
        sad = (cand - cur16[:, :, None, :]).abs().sum(
            dim=(1, 3), dtype=torch.int32)
        rows.append(sad + mvx_cost[None, :] + lambda_mv * abs(dy - radius))
    flat = torch.stack(rows, dim=1).reshape(-1, K * K)
    idx = torch.argmin(flat, dim=1)
    cost = torch.gather(flat, 1, idx[:, None])[:, 0]
    idx = idx.to(torch.int32)
    mv = torch.stack([idx % K - radius, idx // K - radius], dim=-1)
    return mv, cost


def _hfilter(a):
    w = a.shape[1]
    return (a[:, 0 : w - 5] - 5 * a[:, 1 : w - 4] + 20 * a[:, 2 : w - 3]
            + 20 * a[:, 3 : w - 2] - 5 * a[:, 4 : w - 1] + a[:, 5:w])


def _vfilter(a):
    h = a.shape[0]
    return (a[0 : h - 5] - 5 * a[1 : h - 4] + 20 * a[2 : h - 3]
            + 20 * a[3 : h - 2] - 5 * a[4 : h - 1] + a[5:h])


def half_pel_planes(ref):
    """ref: (H, W) integer plane. Returns int32 (b, h, j) planes of the same
    shape: b[y,x] = half-pel at (x+1/2, y); h[y,x] = (x, y+1/2);
    j[y,x] = (x+1/2, y+1/2). Taps past the border replicate the edge."""
    H, W = ref.shape
    p = edge_pad(ref.to(torch.int32), 3, 3, 3, 3)  # taps reach -2..+3
    b1_rows = _hfilter(p)  # (H+6, W+1): col i -> x = i - 1
    b = ((b1_rows[3 : 3 + H, 1 : 1 + W] + 16) >> 5).clamp(0, 255)
    h1 = _vfilter(p)[1 : 1 + H, 3 : 3 + W]  # row i -> y = i - 1
    h = ((h1 + 16) >> 5).clamp(0, 255)
    j1 = _vfilter(b1_rows)[1 : 1 + H, 1 : 1 + W]
    j = ((j1 + 512) >> 10).clamp(0, 255)
    return b, h, j


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


def to_mbs(plane, R: int, C: int, size: int):
    """(R*size, C*size) plane -> (R*C, size, size) raster-ordered MBs."""
    return (plane.reshape(R, size, C, size).transpose(1, 2)
            .reshape(R * C, size, size))


def from_mbs(x, R: int, C: int, size: int):
    """(R*C, size, size) MBs -> (R*size, C*size) plane."""
    return (x.reshape(R, C, size, size).transpose(1, 2)
            .reshape(R * size, C * size))



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


def search_refine_luma_plain(cur, ref_y_ext, search_range: int, R: int,
                             C: int):
    """Full-pel search + quarter-pel refinement against one reference, in
    plain PyTorch (search_refine_luma's CPU path and the kernel's spec).

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
    mv_full, _cost = full_search(cur, windows, rs)

    pad_i = edge_pad(ref_y_ext, 0, 0, rs + INTERP_HALO, rs + INTERP_HALO)
    hp_b, hp_h, hp_j = half_pel_planes(pad_i)
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


def local_pframe_core_plain(cur_y, cur_u, cur_v, ref_y_ext, ref_u_ext,
                            ref_v_ext, qp, qp_c, search_range: int,
                            n_rows: int, n_cols: int):
    """P-frame encode of an (n_rows, n_cols) MB grid, in plain PyTorch
    (local_pframe_core's CPU path and the kernel's spec).

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

    qmv, pred, cost = search_refine_luma_plain(cur, ref_y_ext, rs, R, C)

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


def _whole_to_ext(planes, rs: int):
    """The six planes of a whole-picture call as int32 copies, the
    reference extended by edge padding: local_pframe_core's inputs."""
    hy, hc = rs + INTERP_HALO, rs // 2 + 2
    y, u, v, ry, ru, rv = (p.to(torch.int32) for p in planes)
    return (y, u, v, edge_pad(ry, hy, hy, 0, 0), edge_pad(ru, hc, hc, 0, 0),
            edge_pad(rv, hc, hc, 0, 0))


def pframe_core_whole_plain(cur_y, cur_u, cur_v, ref_y, ref_u, ref_v, qp,
                            qp_c, search_range: int, n_rows: int,
                            n_cols: int):
    """pframe_core_whole in plain PyTorch (its CPU path and the spec of the
    kernel's whole-picture entry)."""
    planes = (cur_y, cur_u, cur_v, ref_y, ref_u, ref_v)
    return local_pframe_core_plain(*_whole_to_ext(planes, search_range), qp,
                                   qp_c, search_range, n_rows, n_cols)

