"""On-device CAVLC entropy coding for P slices, in PyTorch.

Twin of media_tpu/entropy/device_cavlc.py:pack_pslice_device (uniform QP):

  stage 1 (parallel): per-MB metadata: CBP, skip flags and runs, median MV
      prediction, per-block nC from neighbour-nnz grids;
  stage 2 (parallel): every residual block and every MB header becomes a
      (words, nbits) bit buffer; the level suffix-length adaptation runs as a
      16-step loop across all blocks at once;
  stage 3 (bitcat tree): chunks are concatenated by an 8-ary reduction that
      barrel-shifts each chunk by the bit count before it and ORs it in.

The host prepends the slice header bits, then `merge_slice_data` appends the
stream and the RBSP stop bit. Bit buffers are MSB-first 32-bit words held in
int64 tensors masked to 32 bits: PyTorch implements neither shifts nor
comparisons for torch.uint32. The per-level capacity schedule of the tree is
the JAX package's, so the overflow decision (and with it the session's
retry) is the same.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import cavlc_tables as tables
from ..pipeline.encoder import ZSCAN_TO_RASTER

MASK32 = 0xFFFFFFFF

# ---- table tensors ----------------------------------------------------------
# coeff_token: [ctx 0..2][t1 0..3][tc 0..16] -> len/code ; chroma DC separate.
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

BLOCK_WORDS = 16  # 512 bits; worst-case 16-coeff block is ~480 bits
HDR_WORDS = 4


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
        "zscan": t(ZSCAN_TO_RASTER),
    }


# ---- bit buffers ------------------------------------------------------------


def _ue_bits(x):
    """(value, length) of ue(x) for x up to 2^16-2."""
    code = x.to(torch.int64) + 1
    n = torch.zeros_like(code)
    for k in range(1, 18):
        n = n + (code >= (1 << k)).to(torch.int64)
    return code, 2 * n + 1


def _bitshift_right(words, s):
    """Shift (..., W) MSB-first bit buffers right by s in [0, 31] bits.

    s broadcasts over the leading dims. Returns (..., W + 1) words (one
    spill word)."""
    s = s[..., None]
    inv = (32 - s) & 31  # safe left-shift amount when s > 0
    prev = torch.cat([torch.zeros_like(words[..., :1]), words[..., :-1]], -1)
    hi = torch.where(s > 0, (words >> s) | ((prev << inv) & MASK32), words)
    last = torch.where(s[..., 0] > 0, (words[..., -1] << inv[..., 0]) & MASK32,
                       torch.zeros_like(words[..., -1]))
    return torch.cat([hi, last[..., None]], dim=-1)


def _wordshift_right(words, o, max_shift: int):
    """Shift (..., W) word buffers right by o words (0 <= o <= max_shift)
    through its binary decomposition."""
    out = words
    W = words.shape[-1]
    for k in range(max(1, max_shift.bit_length() if max_shift else 1)):
        sh = 1 << k
        if sh > max_shift:
            break
        if sh >= W:
            rolled = torch.zeros_like(out)
        else:
            rolled = torch.cat([torch.zeros_like(out[..., :sh]),
                                out[..., :-sh]], dim=-1)
        out = torch.where((((o >> k) & 1) == 1)[..., None], rolled, out)
    return out


def _bitcat_caps(n: int, leaf_w: int, out_cap: int, ratio: float,
                 arity: int):
    """Static per-level capacity schedule for bitcat_reduce."""
    caps = []
    w, leaves = leaf_w, 1
    while n > 1:
        leaves *= arity
        want = int(np.ceil(ratio * leaf_w * leaves))
        w_next = max(w + 1,
                     min(arity * w + 1, max(want, 8), max(out_cap, w + 1)))
        caps.append(w_next)
        w = w_next
        n = (n + arity - 1) // arity
    return caps


def bitcat_reduce(words, bits, out_cap: int, ratio: float = 1.0,
                  arity: int = 8):
    """Concatenate (..., N, W) MSB-first bit chunks along axis -2.

    words must be zero beyond each chunk's `bits` (..., N) valid bits. In an
    `arity`-way tree each chunk of a group is shifted by the exclusive prefix
    sum of the group's bit counts and ORed in. Per-level capacities follow
    _bitcat_caps; content whose spans exceed a level cap sets ok=False (the
    caller falls back to host packing).

    Returns (words (..., W_top), bits (...,), ok (...,) bool).
    """
    bits = bits.to(torch.int64)
    caps = _bitcat_caps(words.shape[-2], words.shape[-1], out_cap, ratio,
                        arity)
    ok = torch.ones(words.shape[:-2], dtype=torch.bool, device=words.device)
    for cap in caps:
        n = words.shape[-2]
        pad_n = (-n) % arity
        if pad_n:
            words = torch.cat([words, words.new_zeros(
                words.shape[:-2] + (pad_n, words.shape[-1]))], dim=-2)
            bits = torch.cat([bits, bits.new_zeros(
                bits.shape[:-1] + (pad_n,))], dim=-1)
        n = words.shape[-2]
        g_w = words.reshape(words.shape[:-2] + (n // arity, arity,
                                                words.shape[-1]))
        g_b = bits.reshape(bits.shape[:-1] + (n // arity, arity))
        w_prev = g_w.shape[-1]
        prefix = torch.cumsum(g_b, dim=-1) - g_b
        bs = _bitshift_right(g_w, prefix & 31)
        if bs.shape[-1] < cap:
            bs = torch.cat([bs, bs.new_zeros(bs.shape[:-1]
                                             + (cap - bs.shape[-1],))], -1)
        else:
            bs = bs[..., :cap]
        bs = _wordshift_right(bs, prefix >> 5, (arity - 1) * w_prev)
        words = bs[..., 0, :]
        for g in range(1, arity):
            words = words | bs[..., g, :]
        bits = g_b.sum(dim=-1)
        ok = ok & torch.all(bits <= 32 * cap, dim=-1)
    return words[..., 0, :], bits[..., 0], ok


def _pack_codes(vals, lens, n_words: int):
    """Concatenate per-row codeword sequences (N, S), each < 32 bits (lens may
    be 0), into bit buffers. Returns (words (N, n_words), nbits (N,))."""
    lens = lens.to(torch.int64)
    cl = lens.clamp(0, 31)
    vals = vals.to(torch.int64) & ((torch.ones_like(cl) << cl) - 1)
    # MSB-first leaf words: the codeword's first bit at bit 0.
    leaf = torch.where(lens > 0, (vals << ((32 - cl) & 31)) & MASK32,
                       torch.zeros_like(vals))
    words, nbits, _ = bitcat_reduce(leaf[..., None], lens, n_words, ratio=1.0)
    if words.shape[-1] < n_words:
        words = torch.cat([words, words.new_zeros(
            words.shape[:-1] + (n_words - words.shape[-1],))], dim=-1)
    return words[..., :n_words], nbits


# ---- per-block CAVLC --------------------------------------------------------


def encode_block_codes(levels, n_c, *, max_coeff: int, chroma_dc: bool):
    """Per-block CAVLC codewords as (vals, lens) slot arrays (no packing).

    levels: (N, max_coeff) zig-zag coefficients, |level| <= 2063 (the
    quantiser's MAX_LEVEL), so every level codeword fits 28 bits.
    Slot layout: [coeff_token, T1-signs, mc levels, total_zeros, mc-1 runs].
    """
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
            (lev.abs() > (3 * torch.ones_like(new_suf) << (new_suf - 1).clamp(0, 5)))
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


def encode_blocks(levels, n_c, *, max_coeff: int, chroma_dc: bool):
    """CAVLC for a batch of residual blocks -> (words (N, BLOCK_WORDS),
    nbits (N,))."""
    vals, lens = encode_block_codes(levels, n_c, max_coeff=max_coeff,
                                    chroma_dc=chroma_dc)
    return _pack_codes(vals, lens, BLOCK_WORDS)


# ---- MB headers and frame assembly ------------------------------------------


def _median3(a, b, c):
    return torch.maximum(torch.minimum(a, b),
                         torch.minimum(torch.maximum(a, b), c))


def _mb_metadata(mv, luma_levels, cdc_levels, cac_levels, R, C):
    """Stage 1: CBP, skip flags/runs, MV prediction.

    mv: (R, C, 2) quarter-pel; luma_levels: (R, C, 16, 16) zig-zag (raster
    blocks); cdc: (R, C, 2, 4); cac: (R, C, 2, 4, 15)."""
    dev = mv.device
    qmv = mv.to(torch.int64)
    zscan = _tables(dev)["zscan"]
    blk_nnz = (luma_levels != 0).sum(dim=3)  # (R, C, 16) per raster block
    nnz_z = blk_nnz[:, :, zscan]
    g8_any = (nnz_z.reshape(R, C, 4, 4) > 0).any(dim=3)  # (R, C, 4)
    cbp_luma = (g8_any.to(torch.int64) * torch.tensor(
        [1, 2, 4, 8], device=dev)).sum(dim=2)
    cac_any = (cac_levels != 0).any(dim=4).any(dim=3).any(dim=2)
    cdc_any = (cdc_levels != 0).any(dim=3).any(dim=2)
    cbp_chroma = torch.where(cac_any, 2, torch.where(cdc_any, 1, 0))
    cbp = cbp_luma | (cbp_chroma << 4)

    # Neighbour MVs (all MBs are inter in these P frames).
    zmv = torch.zeros((R, C, 2), dtype=torch.int64, device=dev)
    mv_a = torch.cat([zmv[:, :1], qmv[:, :-1]], dim=1)  # left
    mv_b = torch.cat([zmv[:1], qmv[:-1]], dim=0)  # top
    mv_c = torch.cat([qmv[:-1, 1:], zmv[:-1, :1]], dim=1)  # top-right
    mv_c = torch.cat([zmv[:1], mv_c], dim=0)
    mv_d = torch.cat([zmv[:, :1], qmv[:, :-1]], dim=1)  # top-left
    mv_d = torch.cat([zmv[:1], mv_d[:-1]], dim=0)

    rr = torch.arange(R, device=dev)[:, None]
    cc = torch.arange(C, device=dev)[None, :]
    c_avail_direct = (rr > 0) & (cc + 1 < C)
    c_avail_sub = (rr > 0) & (cc > 0)
    mv_c_eff = torch.where(c_avail_direct[..., None], mv_c,
                           torch.where(c_avail_sub[..., None], mv_d, 0))
    med = _median3(mv_a, mv_b, mv_c_eff)
    only_a = (rr == 0) & (cc > 0)
    pred = torch.where(only_a[..., None], mv_a, med)
    # 8.4.1.3.2 rule 2 for single-MB-column pictures: only B is available.
    if C == 1:
        only_b = (rr > 0) & (cc == 0)
        pred = torch.where(only_b[..., None], mv_b, pred)

    a_zero = (mv_a == 0).all(dim=2) & (cc > 0)
    b_zero = (mv_b == 0).all(dim=2) & (rr > 0)
    border = (rr == 0) | (cc == 0)
    skipmv = torch.where((border | a_zero | b_zero)[..., None], 0, pred)
    is_skip = (cbp == 0) & (qmv == skipmv).all(dim=2)

    # skip runs: for each non-skip MB, #consecutive skips before it (raster).
    flat_skip = is_skip.reshape(-1)
    n = R * C
    idxs = torch.arange(n, device=dev)
    marks = torch.where(~flat_skip, idxs, -1)
    prev_nonskip = torch.cummax(marks, dim=0).values
    prev_excl = torch.cat([prev_nonskip.new_full((1,), -1),
                           prev_nonskip[:-1]])
    skip_run = (idxs - prev_excl - 1).reshape(R, C)
    trailing_run = n - 1 - marks.max()

    luma_nnz_grid = (blk_nnz.reshape(R, C, 4, 4).transpose(1, 2)
                     .reshape(R * 4, C * 4))
    cac_nnz = (cac_levels != 0).sum(dim=4)  # (R, C, 2, 4)
    chroma_nnz_grid = (
        cac_nnz.permute(2, 0, 1, 3).reshape(2, R, C, 2, 2)
        .transpose(2, 3).reshape(2, R * 2, C * 2)
    )
    return {
        "qmv": qmv,
        "cbp": cbp,
        "cbp_luma": cbp_luma,
        "cbp_chroma": cbp_chroma,
        "pred_mv": pred,
        "is_skip": is_skip,
        "skip_run": skip_run,
        "trailing_run": trailing_run,
        "luma_nnz_grid": luma_nnz_grid,
        "chroma_nnz_grid": chroma_nnz_grid,
    }


def _nc_grid_full(grid):
    """nC for every block position of an nnz grid (spec 9.2.1)."""
    h, w = grid.shape
    na = torch.cat([grid.new_zeros((h, 1)), grid[:, :-1]], dim=1)
    nb = torch.cat([grid.new_zeros((1, w)), grid[:-1, :]], dim=0)
    a_av = (torch.arange(w, device=grid.device) > 0)[None, :]
    b_av = (torch.arange(h, device=grid.device) > 0)[:, None]
    both = (na + nb + 1) >> 1
    return torch.where(a_av & b_av, both,
                       torch.where(a_av, na, torch.where(b_av, nb, 0)))


def _ue_split(x):
    """ue(x) as two slots (zeros prefix, payload) so long symbols stay < 32b."""
    code, length = _ue_bits(x)
    nzeros = (length - 1) >> 1
    return (torch.zeros_like(code), nzeros), (code, nzeros + 1)


def _se_split(x):
    x = x.to(torch.int64)
    return _ue_split(torch.where(x > 0, 2 * x - 1, -2 * x))


def _last_coded(vals, coded, seed):
    """Running "last coded value": out[i] = vals[j] for the last j <= i with
    coded[j], else `seed` (the scan the JAX package writes as an associative
    "keep the right operand if it is set"). Carries the index of the last
    coded element with a cummax and gathers."""
    idx = torch.arange(vals.shape[0], device=vals.device)
    last = torch.cummax(torch.where(coded, idx, -1), dim=0).values
    return torch.where(last >= 0, vals[last.clamp(min=0)], seed)


def _encode_headers(meta, R, C, qp_map=None, slice_qp=None):
    """Stage 2b: per-MB header codeword slots -> packed bit buffers.

    qp_map: optional (R, C) per-MB QP tensor: mb_qp_delta is then coded on
    every cbp != 0 MB against the running QP, which starts at slice_qp (int
    or 0-d tensor). Without it the delta is se(0), one '1' bit."""
    n = R * C
    active = (~meta["is_skip"].reshape(-1)).to(torch.int64)
    skip_run = meta["skip_run"].reshape(-1)
    qmv = meta["qmv"].reshape(n, 2)
    pred = meta["pred_mv"].reshape(n, 2)
    cbp = meta["cbp"].reshape(-1)
    cbp_code = _tables(cbp.device)["cbp_inter"][cbp.clamp(0, 47)]

    slots = [(v, l * active) for v, l in (
        *_ue_split(skip_run),
        *_ue_split(torch.zeros_like(skip_run)),  # mb_type = P_L0_16x16
        *_se_split(qmv[:, 0] - pred[:, 0]),
        *_se_split(qmv[:, 1] - pred[:, 1]),
        *_ue_split(cbp_code),
    )]
    delta_active = (cbp > 0).to(torch.int64) * active
    if qp_map is None:
        slots.append((torch.ones_like(skip_run), delta_active))
    else:
        qp_flat = qp_map.reshape(-1).to(torch.int64)
        seed = torch.as_tensor(slice_qp, device=qp_flat.device).to(torch.int64)
        incl = _last_coded(qp_flat, delta_active > 0, seed)
        prev = torch.cat([seed.reshape(1), incl[:-1]])
        delta = qp_flat - prev
        # mod-52 wrap into the normative [-26, 25] window
        delta = torch.where(delta > 25, delta - 52,
                            torch.where(delta < -26, delta + 52, delta))
        slots += [(v, l * delta_active) for v, l in _se_split(delta)]
    vals = torch.stack([v for v, _ in slots], dim=1)
    lens = torch.stack([l for _, l in slots], dim=1)
    return _pack_codes(vals, lens, HDR_WORDS)


def _pad_words(w, target: int):
    return torch.cat([w, w.new_zeros((w.shape[0], target - w.shape[1]))], 1)


def pack_pslice_device(mv, luma_levels, cdc_levels, cac_levels,
                       out_words: int, qp_map=None, slice_qp=None,
                       ratio: float = 0.25):
    """Full on-device P-slice packer.

    Inputs are the (R, C, ...) int32 symbol tensors. qp_map/slice_qp select
    per-MB QP coding (see _encode_headers). Returns (stream
    (out_words,) int64 words holding uint32 values, slice_data bits
    MSB-first from bit 0, and total_bits () int64). total_bits >
    out_words*32 signals overflow: the caller falls back to host packing.
    """
    R, C = mv.shape[:2]
    n = R * C
    dev = mv.device
    zscan = _tables(dev)["zscan"]
    meta = _mb_metadata(mv, luma_levels, cdc_levels, cac_levels, R, C)
    not_skip = ~meta["is_skip"].reshape(-1)

    # --- luma blocks in z-scan order, nC from the nnz grid.
    nc_full = _nc_grid_full(meta["luma_nnz_grid"])  # (4R, 4C)
    nc_raster = nc_full.reshape(R, 4, C, 4).transpose(1, 2).reshape(n, 16)
    nc_luma = nc_raster[:, zscan].reshape(-1)
    luma_z = luma_levels.reshape(n, 16, 16)[:, zscan].reshape(n * 16, 16)
    lw, lb = encode_blocks(luma_z, nc_luma, max_coeff=16, chroma_dc=False)
    g8 = torch.arange(16, device=dev) // 4
    luma_inc = (((meta["cbp_luma"].reshape(-1)[:, None] >> g8[None, :]) & 1)
                == 1) & not_skip[:, None]
    lb = torch.where(luma_inc.reshape(-1), lb, 0)

    # --- chroma DC blocks (u then v per MB)
    dw, db = encode_blocks(cdc_levels.reshape(n * 2, 4),
                           torch.zeros(n * 2, dtype=torch.int64, device=dev),
                           max_coeff=4, chroma_dc=True)
    cdc_inc = ((meta["cbp_chroma"].reshape(-1) > 0)
               & not_skip).repeat_interleave(2)
    db = torch.where(cdc_inc, db, 0)

    # --- chroma AC blocks (u: 4 raster blocks, then v)
    def nc_c_of(grid):
        full = _nc_grid_full(grid)  # (2R, 2C)
        return full.reshape(R, 2, C, 2).transpose(1, 2).reshape(n, 4)

    nc_c = torch.stack([nc_c_of(meta["chroma_nnz_grid"][0]),
                        nc_c_of(meta["chroma_nnz_grid"][1])], dim=1)
    aw, ab = encode_blocks(cac_levels.reshape(n * 8, 15), nc_c.reshape(-1),
                           max_coeff=15, chroma_dc=False)
    cac_inc = ((meta["cbp_chroma"].reshape(-1) == 2)
               & not_skip).repeat_interleave(8)
    ab = torch.where(cac_inc, ab, 0)

    # --- headers + trailing skip-run chunk
    hw, hb = _encode_headers(meta, R, C, qp_map=qp_map, slice_qp=slice_qp)
    trailing = meta["trailing_run"].reshape(1)
    (tz_v, tz_l), (tc_v, tc_l) = _ue_split(trailing)
    t_active = (trailing > 0).to(torch.int64)
    tw, tb = _pack_codes(torch.stack([tz_v, tc_v], dim=1),
                         torch.stack([tz_l * t_active, tc_l * t_active], 1),
                         HDR_WORDS)

    # --- assembly: chunk order per MB = header, 16 luma, 2 cdc, 8 cac.
    W = BLOCK_WORDS
    chunks_w = torch.cat([
        _pad_words(hw, W).reshape(n, 1, W),
        lw.reshape(n, 16, W),
        dw.reshape(n, 2, W),
        aw.reshape(n, 8, W),
    ], dim=1).reshape(n * 27, W)
    chunks_b = torch.cat([hb.reshape(n, 1), lb.reshape(n, 16),
                          db.reshape(n, 2), ab.reshape(n, 8)],
                         dim=1).reshape(n * 27)
    chunks_w = torch.cat([chunks_w, _pad_words(tw, W)], dim=0)
    chunks_b = torch.cat([chunks_b, tb], dim=0)
    # Excluded chunks still hold their codeword bits; the OR tree needs them
    # zero.
    chunks_w = torch.where((chunks_b > 0)[:, None], chunks_w, 0)
    stream, total_bits, ok = bitcat_reduce(chunks_w, chunks_b, out_words,
                                           ratio=ratio)
    if stream.shape[-1] < out_words:
        stream = torch.cat([stream, stream.new_zeros(
            out_words - stream.shape[-1])])
    total_bits = torch.where(ok, total_bits, out_words * 32 + 1)
    return stream[:out_words], total_bits


# ---- host-side merge --------------------------------------------------------


def merge_slice_data(bw, stream_words, total_bits: int) -> None:
    """Append `total_bits` bits from the device stream (32-bit words,
    MSB-first from bit 0) to a BitWriter holding the slice header, then add
    the RBSP stop bit. A copy of the JAX package's host merge."""
    data = np.asarray(stream_words, dtype=np.uint32).byteswap().tobytes()
    nfull = total_bits // 8
    rem = total_bits % 8
    s = bw._nbits
    if nfull:
        arr = np.frombuffer(data[:nfull], np.uint8)
        if s == 0:
            bw._buf.extend(arr.tobytes())
        else:
            a16 = arr.astype(np.uint16)
            prev = np.empty_like(a16)
            prev[0] = bw._acc
            prev[1:] = a16[:-1]
            out = (((prev << (8 - s)) & 0xFF) | (a16 >> s)).astype(np.uint8)
            bw._buf.extend(out.tobytes())
            bw._acc = int(arr[-1]) & ((1 << s) - 1)
    if rem:
        last = data[nfull]
        bw.u(rem, last >> (8 - rem))
    bw.rbsp_trailing_bits()
