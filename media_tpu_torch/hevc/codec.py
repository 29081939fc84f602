"""Intra-only HEVC encoder/decoder skeleton.

Scope (documented precisely — this is the format-2 capability slot, spec
plumbing first, TPU port of the hot loops rides the H.264 machinery later):

  * 16x16 CTUs == CUs (no quadtree bins), PART_2Nx2N intra, the FULL 35
    luma prediction modes (planar, DC, angular 2..34 per spec 8.4.4.2.4-6,
    including the DC and pure-H/V boundary filters for luma), chroma
    derived mode (DM).
  * 4x4 TUs (split inferred by min==max TB size 4): DST-VII for intra luma
    (spec 8.6.4.2), DCT-II for chroma, HEVC quantizer scale tables, the
    spec's chroma-QP mapping (Table 8-10), reference-sample substitution
    from the reconstruction mask.
  * Entropy: the shared CABAC engine (entropy/cabac_engine.py);
    mode-dependent coefficient scans (diagonal/horizontal/vertical by
    predModeIntra, spec 7.4.9.11) and hierarchical chroma cbf (cbf_cb/cr
    coded once at the CU root with per-TB cbf only under a set root — the
    transform-tree inference shape of 7.3.8.8); last_sig_coeff prefixes,
    sig map, greater1/greater2, sign bypass, Golomb-Rice remainders with
    Rice adaptation.

  Remaining documented deviation: context initialization is uniform (same
  stance and provenance note as the H.264 CABAC init tables, PARITY.md).
  Encoder and decoder mirror exactly: round trips are bit-exact
  (tests/test_hevc.py), and an INDEPENDENT scalar oracle
  (hevc/ref_decoder.py) re-implements the reconstruction math from the
  spec formulas.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..entropy.cabac_contexts import ContextModels
import numpy as _np

# HEVC context init: a uniform table (pStateIdx 0, MPS 0 at every
# qp) — explicitly NOT the H.264 Table 9-12 constants, so HEVC
# bitstreams cannot silently change when the H.264 tables do
# (both coder and oracle pass this same table).
from ..entropy.cabac_init_tables import NUM_CTX as _NUM_CTX
UNIFORM_INIT = _np.zeros((_NUM_CTX, 2), _np.int32)
UNIFORM_INIT[:, 1] = 64
from ..entropy.cabac_engine import CabacDecoder, CabacEncoder
from ..core.bitstream import BitReader, BitWriter
from . import syntax as S

# --------------------------------------------------------------- transforms

# DST-VII (intra luma 4x4, spec 8.6.4.2) and DCT-II rows (others).
DST4 = np.array([[29, 55, 74, 84], [74, 74, 0, -74],
                 [84, -29, -74, 55], [55, -84, 74, -29]], np.int64)
DCT4 = np.array([[64, 64, 64, 64], [83, 36, -36, -83],
                 [64, -64, -64, 64], [36, -83, 83, -36]], np.int64)

# quantizer scales by qp % 6 (spec 8.6.3 / Table: levelScale)
QUANT_SCALE = np.array([26214, 23302, 20560, 18396, 16384, 14564], np.int64)
DEQUANT_SCALE = np.array([40, 45, 51, 57, 64, 72], np.int64)


def _fwd4(res, mat):
    # stage shifts for 4x4, 8-bit (spec: shift1 = 1, shift2 = 8)
    t = (mat @ res.astype(np.int64) + (1 << 0)) >> 1
    return (t @ mat.T + (1 << 7)) >> 8


def _inv4(coef, mat):
    # inverse shifts: 7 then 20 - bitdepth = 12
    t = (mat.T @ coef.astype(np.int64) + (1 << 6)) >> 7
    return (t @ mat + (1 << 11)) >> 12


def _quant4(coef, qp):
    qbits = 19 + qp // 6  # 14 + qp/6 + transformShift(5) for 4x4, 8-bit
    f = 171 << (qbits - 9)  # intra rounding (~1/3)
    lev = (np.abs(coef) * QUANT_SCALE[qp % 6] + f) >> qbits
    return (np.sign(coef) * lev).astype(np.int64)


def _dequant4(lev, qp):
    # spec 8.6.3: m=16 (flat lists), bdShift = bitDepth + log2TbSize - 5 = 5
    scale = 16 * (DEQUANT_SCALE[qp % 6] << (qp // 6))
    return (lev.astype(np.int64) * scale + 16) >> 5


# HEVC chroma QP mapping (spec Table 8-10), qPi -> QpC.
_CHROMA_QP = list(range(30)) + [29, 30, 31, 32, 33, 33, 34, 34, 35, 35,
                                36, 36, 37, 37]


def hevc_chroma_qp(qp: int) -> int:
    qp = int(np.clip(qp, 0, 51))
    return _CHROMA_QP[qp] if qp < 44 else qp - 6


# HEVC up-right diagonal scan for a 4x4 block, DC-first (y, x) pairs.
DIAG_SCAN = [(0, 0), (1, 0), (0, 1), (2, 0), (1, 1), (0, 2), (3, 0), (2, 1),
             (1, 2), (0, 3), (3, 1), (2, 2), (1, 3), (3, 2), (2, 3), (3, 3)]
# horizontal / vertical scans (spec 6.5.4) for mode-dependent selection.
HOR_SCAN = [(y, x) for y in range(4) for x in range(4)]
VER_SCAN = [(y, x) for x in range(4) for y in range(4)]


def scan_for_mode(mode: int):
    """Mode-dependent scan for 4x4 intra TBs (spec 7.4.9.11 shape):
    near-horizontal angular modes use the vertical scan and vice versa."""
    if 6 <= mode <= 14:
        return VER_SCAN
    if 22 <= mode <= 30:
        return HOR_SCAN
    return DIAG_SCAN

# ctx indices in the shared context space (HEVC slice-local models)
CTX_PART = 0
CTX_PREV_LUMA = 1
CTX_CHROMA = 2
CTX_CBF_LUMA = 3
CTX_CBF_CHROMA = 4
CTX_CBF_CHROMA_ROOT = 5
CTX_LAST_X = 10  # +0..2
CTX_LAST_Y = 14
CTX_SIG = 20  # + scan pos (0..15)
CTX_GT1 = 40  # + min(count,3)
CTX_GT2 = 46


# ------------------------------------------------------------ intra predict


def _refs_for_tu(plane, mask, x0, y0, n):
    """Reference samples (top 2n + corner + left 2n) with the spec's
    substitution: availability == already-reconstructed (mask) and inside
    the picture. Returns (top (2n,), left (2n,), corner) int64."""
    h, w = plane.shape
    coords_l = [(y0 + i, x0 - 1) for i in range(2 * n)]
    coords_t = [(y0 - 1, x0 + i) for i in range(2 * n)]
    corner = (y0 - 1, x0 - 1)

    def get(yx):
        y, x = yx
        if 0 <= y < h and 0 <= x < w and mask[y, x]:
            return int(plane[y, x])
        return None

    # scan order: left bottom-up is reversed -> bottom-left first
    seq = [get(c) for c in reversed(coords_l)] + [get(corner)] + \
          [get(c) for c in coords_t]
    if all(v is None for v in seq):
        seq = [128] * len(seq)
    else:
        first = next(v for v in seq if v is not None)
        prev = first
        for i, v in enumerate(seq):
            if v is None:
                seq[i] = prev
            else:
                prev = v
    left = np.array(list(reversed(seq[: 2 * n])), np.int64)
    corner_v = seq[2 * n]
    top = np.array(seq[2 * n + 1 :], np.int64)
    return top, left, corner_v


# intraPredAngle per mode 2..34 (spec Table 8-4) and invAngle (Table 8-5).
_PRED_ANGLE = [32, 26, 21, 17, 13, 9, 5, 2, 0, -2, -5, -9, -13, -17, -21,
               -26, -32, -26, -21, -17, -13, -9, -5, -2, 0, 2, 5, 9, 13,
               17, 21, 26, 32]
_INV_ANGLE = {-2: -4096, -5: -1638, -9: -910, -13: -630, -17: -482,
              -21: -390, -26: -315, -32: -256}


def _pred_tu(mode, top, left, corner, n, luma_filter=False):
    """Intra prediction for an n x n TU: planar (0), DC (1) and angular
    (2..34) per spec 8.4.4.2.4-6. luma_filter: apply the DC / pure-H/V
    boundary filters (luma TBs < 32, spec 8.4.4.2.5-6)."""
    sh = n.bit_length() - 1
    if mode == 0:  # planar (8.4.4.2.4)
        p = np.zeros((n, n), np.int64)
        tr = int(top[n])
        bl = int(left[n])
        for y in range(n):
            for x in range(n):
                p[y, x] = ((n - 1 - x) * left[y] + (x + 1) * tr
                           + (n - 1 - y) * top[x] + (y + 1) * bl + n) >> (sh + 1)
        return p
    if mode == 1:  # DC (8.4.4.2.5)
        dc = (int(top[:n].sum()) + int(left[:n].sum()) + n) >> (sh + 1)
        p = np.full((n, n), dc, np.int64)
        if luma_filter:
            p[0, 0] = (left[0] + 2 * dc + top[0] + 2) >> 2
            for x in range(1, n):
                p[0, x] = (top[x] + 3 * dc + 2) >> 2
            for y in range(1, n):
                p[y, 0] = (left[y] + 3 * dc + 2) >> 2
        return p
    # angular (8.4.4.2.6)
    angle = _PRED_ANGLE[mode - 2]
    p = np.zeros((n, n), np.int64)
    if mode >= 18:  # vertical-ish: main reference is the top row
        ref = np.zeros(2 * n + 1, np.int64)  # ref[k] = sample at x = k - 1
        ref[0] = corner
        ref[1 : 2 * n + 1] = top[: 2 * n]
        if angle < 0:
            inv = _INV_ANGLE[angle]
            ext = np.zeros(n + 1, np.int64)  # ref[0], ref[-1] .. ref[-n]
            ext[0] = corner
            for k in range(1, n + 1):
                # ref[-k] = p[-1 + ((-k*invAngle+128)>>8)][-1] (8.4.4.2.6)
                idx = (k * -inv + 128) >> 8
                ext[k] = left[min(idx - 1, 2 * n - 1)] if idx >= 1 else corner
            ref = np.concatenate([ext[:0:-1], ref])
            base = n  # array[base + t] == ref[t]
        else:
            base = 0
        ref = np.concatenate([ref, ref[-1:]])  # pad: i0+1 unused when fact==0
        for y in range(n):
            pos = (y + 1) * angle
            idx = pos >> 5
            fact = pos & 31
            for x in range(n):
                i0 = base + x + idx + 1
                p[y, x] = ((32 - fact) * ref[i0] + fact * ref[i0 + 1] + 16) >> 5
        if mode == 26 and luma_filter:  # pure vertical edge filter
            for y in range(n):
                p[y, 0] = np.clip(top[0] + ((left[y] - corner) >> 1), 0, 255)
        return p
    # horizontal-ish: mirror roles of top/left, then transpose
    ref = np.zeros(2 * n + 1, np.int64)
    ref[0] = corner
    ref[1 : 2 * n + 1] = left[: 2 * n]
    if angle < 0:
        inv = _INV_ANGLE[angle]
        ext = np.zeros(n + 1, np.int64)
        ext[0] = corner
        for k in range(1, n + 1):
            idx = (k * -inv + 128) >> 8
            ext[k] = top[min(idx - 1, 2 * n - 1)] if idx >= 1 else corner
        ref = np.concatenate([ext[:0:-1], ref])
        base = n
    else:
        base = 0
    ref = np.concatenate([ref, ref[-1:]])  # pad: i0+1 unused when fact==0
    for x in range(n):
        pos = (x + 1) * angle
        idx = pos >> 5
        fact = pos & 31
        for y in range(n):
            i0 = base + y + idx + 1
            p[y, x] = ((32 - fact) * ref[i0] + fact * ref[i0 + 1] + 16) >> 5
    if mode == 10 and luma_filter:  # pure horizontal edge filter
        for x in range(n):
            p[0, x] = np.clip(left[0] + ((top[x] - corner) >> 1), 0, 255)
    return p


# ------------------------------------------------------- residual coding


def _enc_residual4(enc, ctx, lev4, scan_tab=None):
    """4x4 TB residual (spec 7.3.8.11 shape, single coefficient group).
    scan_tab: mode-dependent scan (diagonal default)."""
    scan_tab = DIAG_SCAN if scan_tab is None else scan_tab
    scan = [lev4[y, x] for (y, x) in scan_tab]
    nz = [i for i, v in enumerate(scan) if v]
    last = nz[-1]
    lx, ly = scan_tab[last][1], scan_tab[last][0]
    for prefix, base in ((lx, CTX_LAST_X), (ly, CTX_LAST_Y)):
        for k in range(prefix):
            enc.encode_bin(ctx, base + min(k, 2), 1)
        if prefix < 3:
            enc.encode_bin(ctx, base + min(prefix, 2), 0)
    for i in range(last - 1, -1, -1):
        enc.encode_bin(ctx, CTX_SIG + i, 1 if scan[i] else 0)
    coeffs = [scan[i] for i in reversed(nz)]  # high-frequency first
    gt1_count = 0
    gt1_flags = []
    for k, v in enumerate(coeffs[:8]):
        flag = 1 if abs(v) > 1 else 0
        enc.encode_bin(ctx, CTX_GT1 + min(gt1_count, 3), flag)
        gt1_flags.append(flag)
        if flag:
            gt1_count += 1
    first_gt1 = next((k for k, f in enumerate(gt1_flags) if f), None)
    if first_gt1 is not None:
        enc.encode_bin(ctx, CTX_GT2, 1 if abs(coeffs[first_gt1]) > 2 else 0)
    gt2 = (1 if first_gt1 is not None and abs(coeffs[first_gt1]) > 2 else 0)
    for v in coeffs:
        enc.encode_bypass(1 if v < 0 else 0)
    rice = 0
    for k, v in enumerate(coeffs):
        # remainder coded iff the flags do not pin |v| exactly:
        #   k >= 8 -> base 1; gt1 non-first -> base 2; first with gt2 -> 3
        if k < 8:
            if not gt1_flags[k]:
                continue  # |v| == 1
            if k == first_gt1 and not gt2:
                continue  # |v| == 2
            base = 3 if k == first_gt1 else 2
        else:
            base = 1
        rem = abs(v) - base
        q = rem >> rice
        for _ in range(min(q, 4)):
            enc.encode_bypass(1)
        if q < 4:
            enc.encode_bypass(0)
            for i in range(rice - 1, -1, -1):
                enc.encode_bypass((rem >> i) & 1)
        else:
            e = rem - (4 << rice)  # exp-golomb escape
            kk = rice + 1
            while e >= (1 << kk):
                enc.encode_bypass(1)
                e -= 1 << kk
                kk += 1
            enc.encode_bypass(0)
            for i in range(kk - 1, -1, -1):
                enc.encode_bypass((e >> i) & 1)
        if abs(v) > (3 << rice):
            rice = min(rice + 1, 4)


def _dec_residual4(dec, ctx, scan_tab=None):
    scan_tab = DIAG_SCAN if scan_tab is None else scan_tab

    def tr_prefix(base):
        v = 0
        while v < 3 and dec.decode_bin(ctx, base + min(v, 2)):
            v += 1
        return v

    lx = tr_prefix(CTX_LAST_X)
    ly = tr_prefix(CTX_LAST_Y)
    last = next(i for i, (y, x) in enumerate(scan_tab) if (x, y) == (lx, ly))
    scan = [0] * 16
    sig = [last]
    for i in range(last - 1, -1, -1):
        if dec.decode_bin(ctx, CTX_SIG + i):
            sig.append(i)
    sig_rev = sorted(sig, reverse=True)  # high-frequency first
    ncoef = len(sig_rev)
    gt1_count = 0
    gt1_flags = []
    for k in range(min(ncoef, 8)):
        flag = dec.decode_bin(ctx, CTX_GT1 + min(gt1_count, 3))
        gt1_flags.append(flag)
        if flag:
            gt1_count += 1
    first_gt1 = next((k for k, f in enumerate(gt1_flags) if f), None)
    gt2 = 0
    if first_gt1 is not None:
        gt2 = dec.decode_bin(ctx, CTX_GT2)
    signs = [dec.decode_bypass() for _ in range(ncoef)]
    rice = 0
    for k in range(ncoef):
        if k < 8:
            if not gt1_flags[k]:
                val = 1
                base = None
            elif k == first_gt1 and not gt2:
                val = 2
                base = None
            else:
                base = 3 if k == first_gt1 else 2
        else:
            base = 1
        if base is not None:
            q = 0
            while q < 4 and dec.decode_bypass():
                q += 1
            if q < 4:
                rem = q << rice
                suffix = 0
                for _ in range(rice):
                    suffix = (suffix << 1) | dec.decode_bypass()
                rem |= suffix
            else:
                kk = rice + 1
                e = 0
                while dec.decode_bypass():
                    e += 1 << kk
                    kk += 1
                suffix = 0
                for _ in range(kk):
                    suffix = (suffix << 1) | dec.decode_bypass()
                rem = (4 << rice) + e + suffix
            val = base + rem
        if signs[k]:
            val = -val
        scan[sig_rev[k]] = val
        if abs(val) > (3 << rice):
            rice = min(rice + 1, 4)
    lev4 = np.zeros((4, 4), np.int64)
    for i, (y, x) in enumerate(scan_tab):
        lev4[y, x] = scan[i]
    return lev4


# ------------------------------------------------------------ CTU walkers

# z-order of the four 8x8 quadrants in a 16x16 CU, and of 4x4 TUs within.
_Z4 = [(0, 0), (0, 1), (1, 0), (1, 1)]  # (qy, qx)


def _mpm_list(left_mode, top_mode):
    """Spec 8.4.2 MPM candidate list for {planar, DC} emitting modes."""
    a = left_mode if left_mode is not None else 1  # DC when unavailable
    b = top_mode if top_mode is not None else 1
    if a == b:
        if a < 2:  # planar/DC
            return [0, 1, 26]
        return [a, 2 + ((a + 29) % 32), 2 + ((a - 2 + 1) % 32)]
    out = [a, b]
    out.append(0 if 0 not in out else (1 if 1 not in out else 26))
    return out


class _CtuCoder:
    """Shared CTU walk (encoder and decoder subclass-free twin drivers)."""

    def __init__(self, w_pad, h_pad, qp):
        self.Rc = h_pad // 16
        self.Cc = w_pad // 16
        self.qp = qp
        self.qp_c = hevc_chroma_qp(qp)  # spec Table 8-10, zero offsets
        self.y = np.zeros((h_pad, w_pad), np.int64)
        self.u = np.zeros((h_pad // 2, w_pad // 2), np.int64)
        self.v = np.zeros((h_pad // 2, w_pad // 2), np.int64)
        self.mask_y = np.zeros((h_pad, w_pad), bool)
        self.mask_c = np.zeros((h_pad // 2, w_pad // 2), bool)
        self.modes = np.full((self.Rc, self.Cc), -1, np.int32)


def encode_slice_data(orig_y, orig_u, orig_v, qp: int):
    """Encode all CTUs; returns (payload bytes, recon (y, u, v) int64)."""
    h, w = orig_y.shape
    st = _CtuCoder(w, h, qp)
    ctx = ContextModels(qp, table=UNIFORM_INIT)
    enc = CabacEncoder()
    oy = orig_y.astype(np.int64)
    ou = orig_u.astype(np.int64)
    ov = orig_v.astype(np.int64)

    for r in range(st.Rc):
        for c in range(st.Cc):
            x0, y0 = c * 16, r * 16
            left_m = int(st.modes[r, c - 1]) if c > 0 else None
            top_m = int(st.modes[r - 1, c]) if r > 0 else None
            left_m = None if left_m == -1 else left_m
            top_m = None if top_m == -1 else top_m
            # CU mode decision over ALL 35 modes on a 16x16 one-shot
            # prediction proxy (the TU chain would need two passes).
            top16, left16, corner16 = _refs_for_tu(st.y, st.mask_y, x0, y0, 16)
            best_mode, best_sad = 1, None
            for m in range(35):
                pred = _pred_tu(m, top16, left16, corner16, 16)
                sad = int(np.abs(oy[y0:y0 + 16, x0:x0 + 16] - pred).sum())
                if best_sad is None or sad < best_sad:
                    best_mode, best_sad = m, sad
            mode = best_mode
            st.modes[r, c] = mode
            scan_tab = scan_for_mode(mode)

            enc.encode_bin(ctx, CTX_PART, 1)  # part_mode = PART_2Nx2N
            mpm = _mpm_list(left_m, top_m)
            if mode in mpm:
                enc.encode_bin(ctx, CTX_PREV_LUMA, 1)
                idx = mpm.index(mode)
                enc.encode_bypass(1 if idx else 0)
                if idx:
                    enc.encode_bypass(idx - 1)
            else:
                enc.encode_bin(ctx, CTX_PREV_LUMA, 0)
                rem = mode - sum(1 for m in sorted(mpm) if m < mode)
                for i in range(4, -1, -1):
                    enc.encode_bypass((rem >> i) & 1)
            enc.encode_bin(ctx, CTX_CHROMA, 0)  # chroma DM

            # luma TUs: quadrants in z-order, 4x4 TUs in z-order
            for qy, qx in _Z4:
                for ty, tx in _Z4:
                    bx = x0 + qx * 8 + tx * 4
                    by = y0 + qy * 8 + ty * 4
                    top, left, corner = _refs_for_tu(st.y, st.mask_y, bx, by, 4)
                    pred = _pred_tu(mode, top, left, corner, 4,
                                    luma_filter=True)
                    res = oy[by:by + 4, bx:bx + 4] - pred
                    lev = _quant4(_fwd4(res, DST4), qp)
                    cbf = 1 if np.any(lev) else 0
                    enc.encode_bin(ctx, CTX_CBF_LUMA, cbf)
                    if cbf:
                        _enc_residual4(enc, ctx, lev, scan_tab)
                        rq = _inv4(_dequant4(lev, qp), DST4)
                    else:
                        rq = 0
                    st.y[by:by + 4, bx:bx + 4] = np.clip(pred + rq, 0, 255)
                    st.mask_y[by:by + 4, bx:bx + 4] = True
            # chroma TUs (one 4x4 per 8x8 luma quadrant per component):
            # pass 1 computes levels/recon along the TU chain, then the
            # root cbf_cb/cbf_cr gate per-TB cbf coding (the transform
            # tree's cbf inheritance, spec 7.3.8.8).
            for comp, (plane, orig) in enumerate(((st.u, ou), (st.v, ov))):
                tbs = []
                for qy, qx in _Z4:
                    bx = (x0 >> 1) + qx * 4
                    by = (y0 >> 1) + qy * 4
                    top, left, corner = _refs_for_tu(
                        plane, st.mask_c, bx, by, 4)
                    pred = _pred_tu(mode, top, left, corner, 4)
                    res = orig[by:by + 4, bx:bx + 4] - pred
                    lev = _quant4(_fwd4(res, DCT4), st.qp_c)
                    cbf = 1 if np.any(lev) else 0
                    rq = _inv4(_dequant4(lev, st.qp_c), DCT4) if cbf else 0
                    plane[by:by + 4, bx:bx + 4] = np.clip(pred + rq, 0, 255)
                    tbs.append((lev, cbf))
                root = 1 if any(cbf for _lev, cbf in tbs) else 0
                enc.encode_bin(ctx, CTX_CBF_CHROMA_ROOT, root)
                if root:
                    for lev, cbf in tbs:
                        enc.encode_bin(ctx, CTX_CBF_CHROMA, cbf)
                        if cbf:
                            _enc_residual4(enc, ctx, lev, scan_tab)
                if comp == 1:
                    st.mask_c[(y0 >> 1):(y0 >> 1) + 8,
                              (x0 >> 1):(x0 >> 1) + 8] = True
            enc.encode_terminate(
                1 if (r == st.Rc - 1 and c == st.Cc - 1) else 0)
    return enc.get_bytes(), (st.y, st.u, st.v)


def decode_slice_data(data: bytes, bitpos: int, w_pad: int, h_pad: int,
                      qp: int):
    """Mirror of encode_slice_data. Returns (y, u, v) int64 planes."""
    st = _CtuCoder(w_pad, h_pad, qp)
    ctx = ContextModels(qp, table=UNIFORM_INIT)
    dec = CabacDecoder(data, bitpos)

    for r in range(st.Rc):
        for c in range(st.Cc):
            x0, y0 = c * 16, r * 16
            left_m = int(st.modes[r, c - 1]) if c > 0 else None
            top_m = int(st.modes[r - 1, c]) if r > 0 else None
            left_m = None if left_m == -1 else left_m
            top_m = None if top_m == -1 else top_m
            if not dec.decode_bin(ctx, CTX_PART):
                raise ValueError("PART_NxN unsupported in the skeleton")
            mpm = _mpm_list(left_m, top_m)
            if dec.decode_bin(ctx, CTX_PREV_LUMA):
                idx = dec.decode_bypass()
                if idx:
                    idx += dec.decode_bypass()
                mode = mpm[idx]
            else:
                rem = 0
                for _ in range(5):
                    rem = (rem << 1) | dec.decode_bypass()
                mode = rem
                for m in sorted(mpm):
                    if mode >= m:
                        mode += 1
            if dec.decode_bin(ctx, CTX_CHROMA):
                raise ValueError("non-DM chroma mode unsupported")
            st.modes[r, c] = mode
            scan_tab = scan_for_mode(mode)

            for qy, qx in _Z4:
                for ty, tx in _Z4:
                    bx = x0 + qx * 8 + tx * 4
                    by = y0 + qy * 8 + ty * 4
                    top, left, corner = _refs_for_tu(st.y, st.mask_y, bx, by, 4)
                    pred = _pred_tu(mode, top, left, corner, 4,
                                    luma_filter=True)
                    if dec.decode_bin(ctx, CTX_CBF_LUMA):
                        lev = _dec_residual4(dec, ctx, scan_tab)
                        rq = _inv4(_dequant4(lev, qp), DST4)
                    else:
                        rq = 0
                    st.y[by:by + 4, bx:bx + 4] = np.clip(pred + rq, 0, 255)
                    st.mask_y[by:by + 4, bx:bx + 4] = True
            for comp, plane in ((0, st.u), (1, st.v)):
                root = dec.decode_bin(ctx, CTX_CBF_CHROMA_ROOT)
                levs = []
                for _ in range(4):
                    if root and dec.decode_bin(ctx, CTX_CBF_CHROMA):
                        levs.append(_dec_residual4(dec, ctx, scan_tab))
                    else:
                        levs.append(None)
                for (qy, qx), lev in zip(_Z4, levs):
                    bx = (x0 >> 1) + qx * 4
                    by = (y0 >> 1) + qy * 4
                    top, left, corner = _refs_for_tu(
                        plane, st.mask_c, bx, by, 4)
                    pred = _pred_tu(mode, top, left, corner, 4)
                    rq = (_inv4(_dequant4(lev, st.qp_c), DCT4)
                          if lev is not None else 0)
                    plane[by:by + 4, bx:bx + 4] = np.clip(pred + rq, 0, 255)
                if comp == 1:
                    st.mask_c[(y0 >> 1):(y0 >> 1) + 8,
                              (x0 >> 1):(x0 >> 1) + 8] = True
            if dec.decode_terminate():
                if not (r == st.Rc - 1 and c == st.Cc - 1):
                    raise ValueError("early slice termination")
    return st.y, st.u, st.v


# ------------------------------------------------------------------ session


@dataclass
class HevcDecodedFrame:
    y: np.ndarray
    u: np.ndarray
    v: np.ndarray


class HevcEncoderSession:
    """Intra-only HEVC session: frames in, Annex-B AUs out (VPS+SPS+PPS on
    the first AU). The reference's format-2 slot (VideoCodecApi.cpp:23-38)."""

    def __init__(self, width: int, height: int, qp: int = 30):
        self.width, self.height, self.qp = width, height, qp
        self.w_pad = (width + 15) // 16 * 16
        self.h_pad = (height + 15) // 16 * 16
        self.sps = S.HevcSPS(width=self.w_pad, height=self.h_pad,
                             conf_right=(self.w_pad - width) // 2,
                             conf_bottom=(self.h_pad - height) // 2)
        self.pps = S.HevcPPS(init_qp=qp)
        self._sent_headers = False
        self.recon = None
        self._rc = None

    def enable_cbr(self, bitrate: int, framerate: int) -> None:
        """All-intra CBR: the same virtual-buffer + complexity feedback as
        the H.264 session's rate loop, applied per frame via the slice QP
        (slice_qp_delta carries it; init_qp stays put). Honors the bitrate
        property instead of degrading to fixed QP — the reference's
        format-2 slot is a CBR encoder (VideoEncoderNetint.cpp:107-117)."""
        self._rc = {"target": bitrate / max(framerate, 1), "buf": 0.0,
                    "cplx": None}

    def _rc_update(self, bits: int) -> None:
        rc = self._rc
        qstep = 0.625 * 2.0 ** (self.qp / 6.0)
        sample = bits * qstep
        rc["cplx"] = (sample if rc["cplx"] is None
                      else 0.7 * rc["cplx"] + 0.3 * sample)
        rc["buf"] += bits - rc["target"]
        adj = max(rc["target"] - 0.35 * rc["buf"], 0.25 * rc["target"])
        want = min(max(rc["cplx"] / adj, 0.625), 1024.0)
        self.qp = int(np.clip(round(6.0 * np.log2(want / 0.625)), 10, 49))

    def _headers(self) -> bytes:
        out = b""
        for obj, t in ((S.HevcVPS(), S.NAL_VPS), (self.sps, S.NAL_SPS),
                       (self.pps, S.NAL_PPS)):
            w = BitWriter()
            obj.write(w)
            w.rbsp_trailing_bits()
            out += S.wrap_hevc_nal(t, w.get_bytes())
        return out

    def encode_frame(self, y, u, v) -> bytes:
        yp = np.zeros((self.h_pad, self.w_pad), np.uint8)
        up = np.zeros((self.h_pad // 2, self.w_pad // 2), np.uint8)
        vp = np.zeros_like(up)
        yp[: self.height, : self.width] = y
        up[: self.height // 2, : self.width // 2] = u
        vp[: self.height // 2, : self.width // 2] = v

        w = BitWriter()
        S.write_slice_header(w, self.pps.pps_id, self.qp, self.pps.init_qp)
        payload, recon = encode_slice_data(yp, up, vp, self.qp)
        self.recon = tuple(np.clip(p, 0, 255).astype(np.uint8) for p in recon)
        nal = S.wrap_hevc_nal(S.NAL_IDR_W_RADL, w.get_bytes() + payload)
        hdr = b"" if self._sent_headers else self._headers()
        self._sent_headers = True
        if self._rc is not None:
            self._rc_update(len(nal) * 8)
        return hdr + nal


class HevcRefDecoder:
    """Mirror decoder for the skeleton's streams."""

    def __init__(self):
        self.sps = None
        self.pps = None

    def decode_annexb(self, data: bytes):
        out = []
        for nal_type, rbsp in S.parse_hevc_nals(data):
            if nal_type == S.NAL_SPS:
                self.sps = S.HevcSPS.parse(BitReader(rbsp))
            elif nal_type == S.NAL_PPS:
                self.pps = S.HevcPPS.parse(BitReader(rbsp))
            elif nal_type == S.NAL_IDR_W_RADL:
                r = BitReader(rbsp)
                hdr = S.parse_slice_header(r)
                qp = self.pps.init_qp + hdr["qp_delta"]
                y, u, v = decode_slice_data(
                    rbsp, hdr["bitpos"], self.sps.width, self.sps.height, qp)
                out.append(HevcDecodedFrame(
                    y=np.clip(y, 0, 255).astype(np.uint8),
                    u=np.clip(u, 0, 255).astype(np.uint8),
                    v=np.clip(v, 0, 255).astype(np.uint8)))
        return out
