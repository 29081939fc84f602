"""Independent scalar HEVC intra decoder — the oracle for hevc/codec.py.

A from-the-spec re-implementation of the decode side, written separately
from the encoder/mirror module: its own prediction functions (vectorized
formulations of 8.4.4.2.4-6 rather than the codec's scalar loops), its own
reference-sample substitution, dequant/inverse-transform chain and residual
parser. It shares only normative CONSTANTS (transform matrices, scan
tables, context indices, the arithmetic decoder engine) — the same
discipline as the H.264 oracle (ref/decoder.py), which shares CAVLC tables
but no reconstruction code. A mirror bug in hevc/codec.py's decoder cannot
hide here.
"""

from __future__ import annotations

import numpy as np

from ..core.bitstream import BitReader
from ..entropy.cabac_contexts import ContextModels
import numpy as _np

# HEVC context init: a uniform table (pStateIdx 0, MPS 0 at every
# qp) — explicitly NOT the H.264 Table 9-12 constants, so HEVC
# bitstreams cannot silently change when the H.264 tables do
# (both coder and oracle pass this same table).
from ..entropy.cabac_init_tables import NUM_CTX as _NUM_CTX
UNIFORM_INIT = _np.zeros((_NUM_CTX, 2), _np.int32)
UNIFORM_INIT[:, 1] = 64
from ..entropy.cabac_engine import CabacDecoder
from . import syntax as S
from .codec import (CTX_CBF_CHROMA, CTX_CBF_CHROMA_ROOT, CTX_CBF_LUMA,
                    CTX_CHROMA, CTX_GT1, CTX_GT2, CTX_LAST_X, CTX_LAST_Y,
                    CTX_PART, CTX_PREV_LUMA, CTX_SIG, DCT4, DEQUANT_SCALE,
                    DIAG_SCAN, DST4, HOR_SCAN, VER_SCAN, _INV_ANGLE,
                    _PRED_ANGLE, hevc_chroma_qp)

_Z4 = [(0, 0), (0, 1), (1, 0), (1, 1)]


def _dequant(lev, qp):
    scale = 16 * (int(DEQUANT_SCALE[qp % 6]) << (qp // 6))
    return (lev.astype(np.int64) * scale + 16) >> 5


def _itx(coef, mat):
    t = (mat.T @ coef.astype(np.int64) + 64) >> 7
    return (t @ mat + 2048) >> 12


def _subst_refs(plane, mask, x0, y0, n):
    """Reference-sample substitution (8.4.4.2.2), vectorized scan."""
    h, w = plane.shape
    vals = []
    ok = []
    # bottom-left upward, corner, then top rightward (the spec's scan)
    for i in range(2 * n - 1, -1, -1):
        y, x = y0 + i, x0 - 1
        inside = 0 <= y < h and 0 <= x < w and mask[y, x]
        vals.append(int(plane[y, x]) if inside else 0)
        ok.append(inside)
    y, x = y0 - 1, x0 - 1
    inside = 0 <= y < h and 0 <= x < w and mask[y, x]
    vals.append(int(plane[y, x]) if inside else 0)
    ok.append(inside)
    for i in range(2 * n):
        y, x = y0 - 1, x0 + i
        inside = 0 <= y < h and 0 <= x < w and mask[y, x]
        vals.append(int(plane[y, x]) if inside else 0)
        ok.append(inside)
    vals = np.array(vals, np.int64)
    ok = np.array(ok, bool)
    if not ok.any():
        vals[:] = 128
    else:
        first = int(vals[np.argmax(ok)])
        prev = first
        for i in range(len(vals)):
            if ok[i]:
                prev = int(vals[i])
            else:
                vals[i] = prev
    left = vals[:2 * n][::-1].copy()
    corner = int(vals[2 * n])
    top = vals[2 * n + 1 :].copy()
    return top, left, corner


def _predict(mode, top, left, corner, n, luma: bool):
    """Intra prediction 8.4.4.2.4-6, vectorized over sample positions."""
    xs = np.arange(n)
    if mode == 0:  # planar
        tr, bl = int(top[n]), int(left[n])
        sh = n.bit_length()  # log2(n) + 1
        a = (n - 1 - xs)[None, :] * left[:n, None]
        b = (xs + 1)[None, :] * tr
        c = (n - 1 - xs)[:, None] * top[None, :n]
        d = (xs + 1)[:, None] * bl
        return (a + b + c + d + n) >> sh
    if mode == 1:  # DC
        dc = (int(top[:n].sum()) + int(left[:n].sum()) + n) >> n.bit_length()
        p = np.full((n, n), dc, np.int64)
        if luma:
            p[0, 1:] = (top[1:n] + 3 * dc + 2) >> 2
            p[1:, 0] = (left[1:n] + 3 * dc + 2) >> 2
            p[0, 0] = (int(left[0]) + 2 * dc + int(top[0]) + 2) >> 2
        return p
    angle = _PRED_ANGLE[mode - 2]
    vert = mode >= 18
    main, side = (top, left) if vert else (left, top)
    ref = np.zeros(3 * n + 2, np.int64)  # index base n: ref[n + t] == ref_t
    ref[n] = corner
    ref[n + 1 : n + 1 + 2 * n] = main[: 2 * n]
    ref[n + 1 + 2 * n] = main[2 * n - 1]  # pad (unused when fact == 0)
    if angle < 0:
        inv = _INV_ANGLE[angle]
        for k in range(1, n + 1):
            idx = (k * -inv + 128) >> 8
            ref[n - k] = side[min(idx - 1, 2 * n - 1)] if idx >= 1 else corner
    pos = (np.arange(1, n + 1) * angle)
    idxs = pos >> 5
    facts = pos & 31
    p = np.zeros((n, n), np.int64)
    for j in range(n):  # j = y for vertical modes, x for horizontal
        i0 = n + np.arange(n) + int(idxs[j]) + 1
        row = ((32 - int(facts[j])) * ref[i0]
               + int(facts[j]) * ref[i0 + 1] + 16) >> 5
        if vert:
            p[j, :] = row
        else:
            p[:, j] = row
    if luma:
        if mode == 26:  # pure vertical
            p[:, 0] = np.clip(int(top[0]) + ((left[:n] - corner) >> 1), 0, 255)
        elif mode == 10:  # pure horizontal
            p[0, :] = np.clip(int(left[0]) + ((top[:n] - corner) >> 1), 0, 255)
    return p


def _parse_residual(dec, ctx, scan_tab):
    def prefix(base):
        v = 0
        while v < 3 and dec.decode_bin(ctx, base + min(v, 2)):
            v += 1
        return v

    lx, ly = prefix(CTX_LAST_X), prefix(CTX_LAST_Y)
    last = next(i for i, (y, x) in enumerate(scan_tab) if (x, y) == (lx, ly))
    sig = [last]
    for i in range(last - 1, -1, -1):
        if dec.decode_bin(ctx, CTX_SIG + i):
            sig.append(i)
    order = sorted(sig, reverse=True)
    flags = []
    cnt = 0
    for k in range(min(len(order), 8)):
        f = dec.decode_bin(ctx, CTX_GT1 + min(cnt, 3))
        flags.append(f)
        cnt += f
    g1 = next((k for k, f in enumerate(flags) if f), None)
    g2 = dec.decode_bin(ctx, CTX_GT2) if g1 is not None else 0
    signs = [dec.decode_bypass() for _ in order]
    out = np.zeros((4, 4), np.int64)
    rice = 0
    for k, si in enumerate(order):
        base = None
        if k < 8:
            if not flags[k]:
                val = 1
            elif k == g1 and not g2:
                val = 2
            else:
                base = 3 if k == g1 else 2
        else:
            base = 1
        if base is not None:
            q = 0
            while q < 4 and dec.decode_bypass():
                q += 1
            if q < 4:
                sfx = 0
                for _ in range(rice):
                    sfx = (sfx << 1) | dec.decode_bypass()
                rem = (q << rice) | sfx
            else:
                kk = rice + 1
                e = 0
                while dec.decode_bypass():
                    e += 1 << kk
                    kk += 1
                sfx = 0
                for _ in range(kk):
                    sfx = (sfx << 1) | dec.decode_bypass()
                rem = (4 << rice) + e + sfx
            val = base + rem
        if signs[k]:
            val = -val
        y, x = scan_tab[si]
        out[y, x] = val
        if abs(val) > (3 << rice):
            rice = min(rice + 1, 4)
    return out


def _scan_of(mode):
    if 6 <= mode <= 14:
        return VER_SCAN
    if 22 <= mode <= 30:
        return HOR_SCAN
    return DIAG_SCAN


class HevcOracleDecoder:
    """Annex-B HEVC intra decoder (independent implementation)."""

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
                out.append(self._decode_slice(rbsp, hdr["bitpos"], qp))
        return out

    def _decode_slice(self, rbsp, bitpos, qp):
        w, h = self.sps.width, self.sps.height
        qp_c = hevc_chroma_qp(qp)
        y = np.zeros((h, w), np.int64)
        u = np.zeros((h // 2, w // 2), np.int64)
        v = np.zeros((h // 2, w // 2), np.int64)
        my = np.zeros((h, w), bool)
        mc = np.zeros((h // 2, w // 2), bool)
        modes = np.full((h // 16, w // 16), -1, np.int32)
        ctx = ContextModels(qp, table=UNIFORM_INIT)
        dec = CabacDecoder(rbsp, bitpos)

        for r in range(h // 16):
            for c in range(w // 16):
                x0, y0 = c * 16, r * 16
                if not dec.decode_bin(ctx, CTX_PART):
                    raise ValueError("PART_NxN unsupported")
                lm = modes[r, c - 1] if c > 0 else -1
                tm = modes[r - 1, c] if r > 0 else -1
                mode = self._parse_mode(dec, ctx, int(lm), int(tm))
                if dec.decode_bin(ctx, CTX_CHROMA):
                    raise ValueError("non-DM chroma unsupported")
                modes[r, c] = mode
                scan_tab = _scan_of(mode)
                for qy, qx in _Z4:
                    for ty, tx in _Z4:
                        bx, by = x0 + qx * 8 + tx * 4, y0 + qy * 8 + ty * 4
                        top, left, corner = _subst_refs(y, my, bx, by, 4)
                        pred = _predict(mode, top, left, corner, 4, True)
                        if dec.decode_bin(ctx, CTX_CBF_LUMA):
                            lev = _parse_residual(dec, ctx, scan_tab)
                            pred = pred + _itx(_dequant(lev, qp), DST4)
                        y[by : by + 4, bx : bx + 4] = np.clip(pred, 0, 255)
                        my[by : by + 4, bx : bx + 4] = True
                for plane in (u, v):
                    root = dec.decode_bin(ctx, CTX_CBF_CHROMA_ROOT)
                    levs = []
                    for _ in range(4):
                        if root and dec.decode_bin(ctx, CTX_CBF_CHROMA):
                            levs.append(_parse_residual(dec, ctx, scan_tab))
                        else:
                            levs.append(None)
                    for (qy, qx), lev in zip(_Z4, levs):
                        bx, by = (x0 >> 1) + qx * 4, (y0 >> 1) + qy * 4
                        top, left, corner = _subst_refs(plane, mc, bx, by, 4)
                        pred = _predict(mode, top, left, corner, 4, False)
                        if lev is not None:
                            pred = pred + _itx(_dequant(lev, qp_c), DCT4)
                        plane[by : by + 4, bx : bx + 4] = np.clip(pred, 0, 255)
                    if plane is v:
                        mc[(y0 >> 1) : (y0 >> 1) + 8,
                           (x0 >> 1) : (x0 >> 1) + 8] = True
                if dec.decode_terminate():
                    if not (r == h // 16 - 1 and c == w // 16 - 1):
                        raise ValueError("early termination")
        from .codec import HevcDecodedFrame

        return HevcDecodedFrame(
            y=np.clip(y, 0, 255).astype(np.uint8),
            u=np.clip(u, 0, 255).astype(np.uint8),
            v=np.clip(v, 0, 255).astype(np.uint8))

    @staticmethod
    def _parse_mode(dec, ctx, left_mode, top_mode):
        a = left_mode if left_mode >= 0 else 1
        b = top_mode if top_mode >= 0 else 1
        if a == b:
            mpm = ([0, 1, 26] if a < 2
                   else [a, 2 + ((a + 29) % 32), 2 + ((a - 2 + 1) % 32)])
        else:
            mpm = [a, b, 0 if 0 not in (a, b)
                   else (1 if 1 not in (a, b) else 26)]
        if dec.decode_bin(ctx, CTX_PREV_LUMA):
            idx = dec.decode_bypass()
            if idx:
                idx += dec.decode_bypass()
            return mpm[idx]
        rem = 0
        for _ in range(5):
            rem = (rem << 1) | dec.decode_bypass()
        mode = rem
        for m in sorted(mpm):
            if mode >= m:
                mode += 1
        return mode
