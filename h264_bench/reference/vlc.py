"""CAVLC slice data (spec 7.3.4, 7.3.5, 9.2) of an I_16x16 IDR slice and a
P_L0_16x16 / P_Skip slice, from per-MB symbol tensors, in plain PyTorch and
NumPy.

Every syntax element of the slice becomes a (value, length) codeword slot:
the MB header's Exp-Golomb codes and each residual block's coeff_token,
trailing-one signs, levels (with the suffix-length adaptation run as a
loop over the level index, across all blocks at once), total_zeros and
run_before codes. The slots are laid out in bitstream order, the empty ones
dropped, and the bits concatenated. nC (9.2.1) comes from the grids of
nonzero counts, which are final before any block is written: a block's
left and top neighbours precede it in the MB scan.

block_codes is a frozen copy of the program's plain packer
(media_tpu_torch/entropy/device_cavlc.py:encode_block_codes); the slice
layout, the I_16x16 header and the bit concatenation are the benchmark's
own. Nothing of the program is imported.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import cavlc_tables as tables

ZSCAN = [0, 1, 4, 5, 2, 3, 6, 7, 8, 9, 12, 13, 10, 11, 14, 15]

# coeff_token: [ctx 0..2][t1 0..3][tc 0..16] -> len/code; chroma DC apart.
_LEN_CT = np.zeros((3, 4, 17), np.int64)
_COD_CT = np.zeros((3, 4, 17), np.int64)
for _ctx in range(3):
    for (_t1, _tc), (_l, _c) in tables.COEFF_TOKEN[_ctx].items():
        _LEN_CT[_ctx, _t1, _tc] = _l
        _COD_CT[_ctx, _t1, _tc] = _c
_LEN_CDC = np.zeros((4, 5), np.int64)
_COD_CDC = np.zeros((4, 5), np.int64)
for (_t1, _tc), (_l, _c) in tables.COEFF_TOKEN_CHROMA_DC.items():
    _LEN_CDC[_t1, _tc] = _l
    _COD_CDC[_t1, _tc] = _c
_LEN_TZ = np.zeros((15, 16), np.int64)
_COD_TZ = np.zeros((15, 16), np.int64)
for _tc in range(15):
    for _tz, (_l, _c) in enumerate(tables.TOTAL_ZEROS[_tc]):
        _LEN_TZ[_tc, _tz] = _l
        _COD_TZ[_tc, _tz] = _c
_LEN_TZC = np.zeros((3, 4), np.int64)
_COD_TZC = np.zeros((3, 4), np.int64)
for _tc in range(3):
    for _tz, (_l, _c) in enumerate(tables.TOTAL_ZEROS_CHROMA_DC[_tc]):
        _LEN_TZC[_tc, _tz] = _l
        _COD_TZC[_tc, _tz] = _c
_LEN_RB = np.zeros((7, 15), np.int64)
_COD_RB = np.zeros((7, 15), np.int64)
for _zl in range(7):
    for _r, (_l, _c) in enumerate(tables.RUN_BEFORE[_zl]):
        _LEN_RB[_zl, _r] = _l
        _COD_RB[_zl, _r] = _c
# run_before for zerosLeft 1..6 as one packed (len << 12 | code) entry per
# (zl_idx, run); zl_idx 6 (zerosLeft > 6) is regular and computed instead.
_RB_PACKED = np.zeros(7 * 15, np.int64)
_RB_PACKED[:90] = ((_LEN_RB[:6] << 12) | _COD_RB[:6]).reshape(-1)


@functools.lru_cache(maxsize=None)
def _tables(device: torch.device):
    def t(a):
        return torch.as_tensor(np.asarray(a, np.int64), device=device)

    return {
        "len_ct": t(_LEN_CT), "cod_ct": t(_COD_CT),
        "len_cdc": t(_LEN_CDC), "cod_cdc": t(_COD_CDC),
        "len_tz": t(_LEN_TZ), "cod_tz": t(_COD_TZ),
        "len_tzc": t(_LEN_TZC), "cod_tzc": t(_COD_TZC),
        "rb_packed": t(_RB_PACKED),
        "cbp_inter": t(tables.CBP_TO_CODE_INTER),
        "zscan": t(ZSCAN),
    }


def block_codes(levels, n_c, *, max_coeff: int, chroma_dc: bool):
    """Per-block CAVLC codewords as (vals, lens) slot arrays.

    levels: (N, max_coeff) zig-zag coefficients, |level| <= 2063, so every
    level codeword fits 28 bits. Slot layout: [coeff_token, T1-signs, mc
    levels, total_zeros, mc-1 runs]."""
    tb = _tables(levels.device)
    dev = levels.device
    mc = max_coeff
    levels = levels.to(torch.int64)
    n_c = n_c.to(torch.int64)
    nzb = levels != 0
    nz = nzb.to(torch.int64)
    total_coeff = nz.sum(dim=1)
    pos = torch.arange(mc, device=dev)
    last = torch.where(nzb, pos[None, :], -1).amax(dim=1)
    total_zeros = torch.where(total_coeff > 0, last + 1 - total_coeff, 0)

    # k-th nonzero from the end; level and position packed into one integer
    # ((level + 4096) << 5 | pos) so one masked reduction yields both.
    rev_cum = torch.cumsum(nz.flip(1), dim=1).flip(1)
    sel = (rev_cum[:, None, :] == (pos[None, :, None] + 1)) & nzb[:, None, :]
    packed = ((levels + 4096) << 5) | pos[None, :]
    packed_from_end = torch.where(sel, packed[:, None, :], 0).sum(dim=2)
    # Empty slots decode to level -4096 / pos 0; every use is gated on
    # slot < total_coeff, and -4096 never looks like a trailing one.
    level_from_end = (packed_from_end >> 5) - 4096
    pos_from_end = packed_from_end & 31

    is_one = (level_from_end.abs() == 1).to(torch.int64)
    t1_run = torch.cumprod(is_one, dim=1)
    trailing_ones = torch.minimum(t1_run.sum(dim=1).clamp(max=3), total_coeff)

    # slot 0: coeff_token
    if chroma_dc:
        ct_len = tb["len_cdc"][trailing_ones, total_coeff]
        ct_val = tb["cod_cdc"][trailing_ones, total_coeff]
    else:
        ctx = torch.where(n_c < 2, 0, torch.where(n_c < 4, 1, 2))
        tbl_len = tb["len_ct"][ctx, trailing_ones, total_coeff]
        tbl_val = tb["cod_ct"][ctx, trailing_ones, total_coeff]
        flc_val = torch.where(total_coeff == 0, 3,
                              ((total_coeff - 1) << 2) | trailing_ones)
        ct_len = torch.where(n_c >= 8, 6, tbl_len)
        ct_val = torch.where(n_c >= 8, flc_val, tbl_val)

    # slot 1: trailing-one signs
    sign_bits = torch.zeros_like(total_coeff)
    for k in range(3):
        bit = (level_from_end[:, k] < 0).to(torch.int64)
        sign_bits = torch.where(k < trailing_ones, (sign_bits << 1) | bit,
                                sign_bits)

    # slots 2..2+mc-1: levels, carrying only suffix_length. The k-th coded
    # level is level_from_end[t1 + k].
    n_rem = total_coeff - trailing_ones
    t1c = trailing_ones[:, None]
    lev_seq = torch.where(
        t1c == 0, level_from_end,
        torch.where(t1c == 1, torch.roll(level_from_end, -1, 1),
                    torch.where(t1c == 2, torch.roll(level_from_end, -2, 1),
                                torch.roll(level_from_end, -3, 1))))
    suf = torch.where((total_coeff > 10) & (trailing_ones < 3), 1, 0)
    lev_vals, lev_lens = [], []
    for k in range(mc):
        lev = lev_seq[:, k]
        active = k < n_rem
        lc = torch.where(lev > 0, 2 * lev - 2, -2 * lev - 1)
        if k == 0:
            lc = torch.where(trailing_ones < 3, lc - 2, lc)
        v0 = torch.where(lc < 14, 1,
                         torch.where(lc < 30, (1 << 4) | (lc - 14),
                                     (1 << 12) | (lc - 30).clamp(0, 4095)))
        l0 = torch.where(lc < 14, lc + 1, torch.where(lc < 30, 19, 28))
        sc = suf.clamp(0, 15)
        one_sc = torch.ones_like(sc) << sc
        pfx = lc >> sc
        vs = torch.where(pfx < 15, one_sc | (lc & (one_sc - 1)),
                         (1 << 12) | (lc - 15 * one_sc).clamp(0, 4095))
        ls = torch.where(pfx < 15, pfx + 1 + suf, 28)
        lev_vals.append(torch.where(suf == 0, v0, vs))
        lev_lens.append(torch.where(active, torch.where(suf == 0, l0, ls), 0))
        new_suf = torch.where(suf == 0, 1, suf)
        new_suf = torch.where(
            (lev.abs() > (3 * torch.ones_like(new_suf)
                          << (new_suf - 1).clamp(0, 5)))
            & (new_suf < 6),
            new_suf + 1, new_suf)
        suf = torch.where(active, new_suf, suf)

    # slot 2+mc: total_zeros
    tc_idx = (total_coeff - 1).clamp(0, 2 if chroma_dc else 14)
    tz_idx = total_zeros.clamp(0, 3 if chroma_dc else 15)
    if chroma_dc:
        tz_len = tb["len_tzc"][tc_idx, tz_idx]
        tz_val = tb["cod_tzc"][tc_idx, tz_idx]
    else:
        tz_len = tb["len_tz"][tc_idx, tz_idx]
        tz_val = tb["cod_tz"][tc_idx, tz_idx]
    tz_len = torch.where((total_coeff > 0) & (total_coeff < mc), tz_len, 0)

    # remaining slots: run_before codes. Runs past the point where zeros are
    # exhausted are genuinely 0, so a plain cumsum gives the zerosLeft chain.
    kk = torch.arange(mc - 1, device=dev)
    nxt = (kk + 1).clamp(0, mc - 1)
    runs = torch.where((kk[None, :] + 1) < total_coeff[:, None],
                       pos_from_end[:, :-1] - pos_from_end[:, nxt] - 1, 0)
    runs = runs.clamp(0, 14)
    zl = total_zeros[:, None] - (torch.cumsum(runs, dim=1) - runs)
    active = (kk[None, :] < total_coeff[:, None] - 1) & (zl > 0)
    zl_idx = (torch.minimum(zl, torch.full_like(zl, 7)) - 1).clamp(0, 6)
    rb_packed = tb["rb_packed"][zl_idx * 15 + runs]
    rb_len = torch.where(zl_idx == 6, torch.where(runs < 7, 3, runs - 3),
                         rb_packed >> 12)
    rb_val = torch.where(zl_idx == 6, torch.where(runs < 7, 7 - runs, 1),
                         rb_packed & 0xFFF)
    rb_len = torch.where(active, rb_len, 0)

    vals = torch.cat([ct_val[:, None], sign_bits[:, None],
                      torch.stack(lev_vals, 1), tz_val[:, None], rb_val], 1)
    lens = torch.cat([ct_len[:, None], trailing_ones[:, None],
                      torch.stack(lev_lens, 1), tz_len[:, None], rb_len], 1)
    return vals, lens


def _blocks(levels, n_c, include, *, max_coeff: int, chroma_dc: bool,
            batch: int = 1 << 17):
    """block_codes over (n, k, max_coeff) levels in batches of blocks, the
    lengths of blocks not `include`d set to 0: (vals, lens) (n, k * S)."""
    n, k = levels.shape[:2]
    flat = levels.reshape(n * k, max_coeff)
    ncf = n_c.reshape(n * k)
    parts = [block_codes(flat[i:i + batch], ncf[i:i + batch],
                         max_coeff=max_coeff, chroma_dc=chroma_dc)
             for i in range(0, n * k, batch)]
    vals = torch.cat([p[0] for p in parts]).reshape(n, -1)
    lens = torch.cat([p[1] for p in parts]).reshape(n, k, -1)
    lens = torch.where(include.reshape(n, k, 1), lens, 0)
    return vals, lens.reshape(n, -1)


def ue(x):
    """ue(x) as two slots (zeros prefix, payload), each under 32 bits."""
    code = x.to(torch.int64) + 1
    n = torch.zeros_like(code)
    for k in range(1, 18):
        n = n + (code >= (1 << k)).to(torch.int64)
    return [(torch.zeros_like(code), n), (code, n + 1)]


def se(x):
    x = x.to(torch.int64)
    return ue(torch.where(x > 0, 2 * x - 1, -2 * x))


def nc_grid(grid):
    """nC of every block position of an nnz grid (spec 9.2.1), one slice."""
    h, w = grid.shape
    na = torch.cat([grid.new_zeros((h, 1)), grid[:, :-1]], dim=1)
    nb = torch.cat([grid.new_zeros((1, w)), grid[:-1, :]], dim=0)
    a_av = (torch.arange(w, device=grid.device) > 0)[None, :]
    b_av = (torch.arange(h, device=grid.device) > 0)[:, None]
    both = (na + nb + 1) >> 1
    return torch.where(a_av & b_av, both,
                       torch.where(a_av, na, torch.where(b_av, nb, 0)))


def _grids(blk_counts, cac, R: int, C: int):
    """nC of the luma blocks (n, 16, raster) and of the chroma AC blocks
    (n, 2, 4), from the (R, C, 16) luma block counts and the AC levels."""
    n = R * C
    luma = blk_counts.reshape(R, C, 4, 4).transpose(1, 2).reshape(R * 4, C * 4)
    nc_l = nc_grid(luma).reshape(R, 4, C, 4).transpose(1, 2).reshape(n, 16)
    cnt = (cac != 0).sum(dim=-1).reshape(R, C, 2, 4)
    nc_c = []
    for comp in range(2):
        g = cnt[:, :, comp].reshape(R, C, 2, 2).transpose(1, 2)
        nc_c.append(nc_grid(g.reshape(R * 2, C * 2)).reshape(R, 2, C, 2)
                    .transpose(1, 2).reshape(n, 4))
    return nc_l, torch.stack(nc_c, dim=1)


def _chroma_slots(cdc, cac, cbp_chroma, nc_c, active):
    n = cdc.shape[0] * cdc.shape[1]
    dev = cdc.device
    dv, dl = _blocks(cdc.reshape(n, 2, 4),
                     torch.zeros((n, 2), dtype=torch.int64, device=dev),
                     ((cbp_chroma > 0) & active)[:, None].expand(n, 2),
                     max_coeff=4, chroma_dc=True)
    av, al = _blocks(cac.reshape(n, 8, 15), nc_c.reshape(n, 8),
                     ((cbp_chroma == 2) & active)[:, None].expand(n, 8),
                     max_coeff=15, chroma_dc=False)
    return [(dv, dl), (av, al)]


def _cbp_chroma(cdc, cac):
    n = cdc.shape[0] * cdc.shape[1]
    cac_any = (cac != 0).reshape(n, -1).any(dim=1)
    cdc_any = (cdc != 0).reshape(n, -1).any(dim=1)
    return torch.where(cac_any, 2, torch.where(cdc_any, 1, 0))


def pack_bits(slots) -> tuple[int, int]:
    """Concatenate slot groups [(vals (n, s), lens (n, s)), ...] in MB-major
    order (per MB: each group's slots in turn) into one bit string:
    (value, nbits), MSB first."""
    vals = torch.cat([v.reshape(v.shape[0], -1) for v, _ in slots], dim=1)
    lens = torch.cat([ln.reshape(ln.shape[0], -1) for _, ln in slots], dim=1)
    vals, lens = vals.reshape(-1), lens.reshape(-1)
    keep = lens > 0
    vals, lens = vals[keep], lens[keep]
    total = int(lens.sum())
    if total == 0:
        return 0, 0
    owner = torch.repeat_interleave(torch.arange(len(lens), device=lens.device),
                                    lens)
    start = torch.cumsum(lens, 0) - lens
    shift = lens[owner] - 1 - (torch.arange(total, device=lens.device)
                               - start[owner])
    bits = ((vals[owner] >> shift) & 1).to(torch.uint8).cpu().numpy()
    data = np.packbits(bits).tobytes()
    return int.from_bytes(data, "big") >> (len(data) * 8 - total), total


def islice_data(mode16, chroma_mode, dc, ac, cdc, cac) -> tuple[int, int]:
    """The slice_data bits of an I_16x16 slice covering the picture:
    mode16, chroma_mode (R, C); dc (R, C, 16) and ac (R, C, 16, 15)
    zig-zag levels (raster blocks); cdc (R, C, 2, 4); cac (R, C, 2, 4, 15).
    Returns (value, nbits)."""
    R, C = mode16.shape
    n = R * C
    dev = mode16.device
    yes = torch.ones(n, dtype=torch.bool, device=dev)
    ac = ac.reshape(n, 16, 15)
    cbp_luma = (ac != 0).reshape(n, -1).any(dim=1)
    cbp_chroma = _cbp_chroma(cdc, cac)
    mb_type = (1 + mode16.reshape(n).to(torch.int64) + 4 * cbp_chroma
               + 12 * cbp_luma.to(torch.int64))
    nc_l, nc_c = _grids((ac != 0).sum(dim=-1).reshape(R, C, 16), cac, R, C)
    one = torch.ones(n, dtype=torch.int64, device=dev)
    slots = [*ue(mb_type), *ue(chroma_mode.reshape(n)),
             (one, one)]  # mb_qp_delta se(0)
    zs = _tables(dev)["zscan"]
    slots.append(_blocks(dc.reshape(n, 1, 16), nc_l[:, :1], yes[:, None],
                         max_coeff=16, chroma_dc=False))
    slots.append(_blocks(ac[:, zs], nc_l[:, zs],
                         cbp_luma[:, None].expand(n, 16),
                         max_coeff=15, chroma_dc=False))
    slots += _chroma_slots(cdc, cac, cbp_chroma, nc_c, yes)
    return pack_bits([(v.reshape(n, -1), ln.reshape(n, -1))
                      for v, ln in slots])


def _median3(a, b, c):
    return torch.maximum(torch.minimum(a, b),
                         torch.minimum(torch.maximum(a, b), c))


def _mv_prediction(mv, R: int, C: int):
    """The median predictor of every MB's 16x16 MV (8.4.1.3) and the MV a
    P_Skip MB takes (8.4.1.1), every MB being inter: (pred, skip_mv)."""
    dev = mv.device
    z = torch.zeros((R, C, 2), dtype=torch.int64, device=dev)
    mv_a = torch.cat([z[:, :1], mv[:, :-1]], dim=1)  # left
    mv_b = torch.cat([z[:1], mv[:-1]], dim=0)  # top
    mv_c = torch.cat([z[:1], torch.cat([mv[:-1, 1:], z[:-1, :1]], dim=1)])
    mv_d = torch.cat([z[:1], torch.cat([z[:-1, :1], mv[:-1, :-1]], dim=1)])
    rr = torch.arange(R, device=dev)[:, None]
    cc = torch.arange(C, device=dev)[None, :]
    c_direct = (rr > 0) & (cc + 1 < C)
    c_sub = (rr > 0) & (cc > 0)  # D stands in for C (6.4.11.7)
    mv_c = torch.where(c_direct[..., None], mv_c,
                       torch.where(c_sub[..., None], mv_d, 0))
    pred = _median3(mv_a, mv_b, mv_c)
    # B and C unavailable, A available: mvA (8.4.1.3.1).
    pred = torch.where(((rr == 0) & (cc > 0))[..., None], mv_a, pred)
    if C == 1:  # only B available: B alone (8.4.1.3.1)
        pred = torch.where(((rr > 0) & (cc == 0))[..., None], mv_b, pred)
    a_zero = (mv_a == 0).all(dim=2) & (cc > 0)
    b_zero = (mv_b == 0).all(dim=2) & (rr > 0)
    border = (rr == 0) | (cc == 0)
    skip = torch.where((border | a_zero | b_zero)[..., None], 0, pred)
    return pred, skip


def pslice_data(mv, luma, cdc, cac) -> tuple[int, int]:
    """The slice_data bits of a P slice covering the picture, every MB
    P_L0_16x16 or P_Skip at the slice QP: mv (R, C, 2) quarter-pel; luma
    (R, C, 16, 16) zig-zag levels (raster blocks); cdc, cac as in
    islice_data. Returns (value, nbits)."""
    R, C = mv.shape[:2]
    n = R * C
    dev = mv.device
    mv = mv.to(torch.int64)
    luma = luma.reshape(n, 16, 16)
    counts = (luma != 0).sum(dim=-1)  # (n, 16) raster
    zs = _tables(dev)["zscan"]
    g8 = (counts[:, zs].reshape(n, 4, 4) > 0).any(dim=2)  # z-order groups
    cbp_luma = (g8.to(torch.int64)
                * torch.tensor([1, 2, 4, 8], device=dev)).sum(dim=1)
    cbp_chroma = _cbp_chroma(cdc, cac)
    cbp = cbp_luma | (cbp_chroma << 4)
    pred, skip_mv = _mv_prediction(mv, R, C)
    skip = ((cbp == 0) & (mv == skip_mv).all(dim=2).reshape(n))
    act = ~skip
    idx = torch.arange(n, device=dev)
    marks = torch.where(act, idx, -1)
    prev = torch.cat([marks.new_full((1,), -1),
                      torch.cummax(marks, dim=0).values[:-1]])
    run = idx - prev - 1  # skipped MBs just before each coded one
    trailing = n - 1 - int(marks.max())
    a = act.to(torch.int64)
    mvd = mv.reshape(n, 2) - pred.reshape(n, 2)
    hdr = [*ue(run), *ue(torch.zeros_like(run)), *se(mvd[:, 0]),
           *se(mvd[:, 1]),
           *ue(_tables(dev)["cbp_inter"][cbp]),
           (torch.ones_like(run), (cbp > 0).to(torch.int64))]
    slots = [(v, ln * a) for v, ln in hdr]
    nc_l, nc_c = _grids(counts.reshape(R, C, 16), cac, R, C)
    inc = g8.repeat_interleave(4, dim=1) & act[:, None]
    slots.append(_blocks(luma[:, zs], nc_l[:, zs], inc, max_coeff=16,
                         chroma_dc=False))
    slots += _chroma_slots(cdc, cac, cbp_chroma, nc_c, act)
    value, nbits = pack_bits([(v.reshape(n, -1), ln.reshape(n, -1))
                              for v, ln in slots])
    if trailing:
        tail = torch.tensor([trailing], device=dev)
        tv, tn = pack_bits([(v[:, None], ln[:, None]) for v, ln in ue(tail)])
        value, nbits = (value << tn) | tv, nbits + tn
    return value, nbits
