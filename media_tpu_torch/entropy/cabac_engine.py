"""CABAC binary arithmetic coding engine (Rec. ITU-T H.264 section 9.3.4).

Implements the normative encoder (9.3.4.2-9.3.4.5) and decoder (9.3.3.2)
state machines: 64 probability states with MPS/LPS transitions, 9-bit range /
10-bit low with outstanding-bit renormalization, bypass and terminate modes.

Table provenance: RANGE_TAB_LPS (Table 9-44) and TRANS_IDX_LPS (Table 9-45)
are reproduced from the spec as used identically across public decoders.
Encode->decode round trips validate the engine's internal consistency
(tests/test_cabac.py); cross-decoder conformance additionally depends on the
context initialization values in cabac_contexts.py (see the provenance note
there).

The reference runs its software path with CABAC on
(video_codec/VideoEncoderOpenH264.cpp:291); this module is the first-party
equivalent. A copy of media_tpu/entropy/cabac_engine.py (numpy only).
"""

from __future__ import annotations

import numpy as np

# Table 9-44: rangeTabLPS[pStateIdx][qCodIRangeIdx]
RANGE_TAB_LPS = np.array([
    [128, 176, 208, 240], [128, 167, 197, 227], [128, 158, 187, 216],
    [123, 150, 178, 205], [116, 142, 169, 195], [111, 135, 160, 185],
    [105, 128, 152, 175], [100, 122, 144, 166], [95, 116, 137, 158],
    [90, 110, 130, 150], [85, 104, 123, 142], [81, 99, 117, 135],
    [77, 94, 111, 128], [73, 89, 105, 122], [69, 85, 100, 116],
    [66, 80, 95, 110], [62, 76, 90, 104], [59, 72, 86, 99],
    [56, 69, 81, 94], [53, 65, 77, 89], [51, 62, 73, 85],
    [48, 59, 69, 80], [46, 56, 66, 76], [43, 53, 63, 72],
    [41, 50, 59, 69], [39, 48, 56, 65], [37, 45, 54, 62],
    [35, 43, 51, 59], [33, 41, 48, 56], [32, 39, 46, 53],
    [30, 37, 43, 50], [29, 35, 41, 48], [27, 33, 39, 45],
    [26, 31, 37, 43], [24, 30, 35, 41], [23, 28, 33, 39],
    [22, 27, 32, 37], [21, 26, 30, 35], [20, 24, 29, 33],
    [19, 23, 27, 31], [18, 22, 26, 30], [17, 21, 25, 28],
    [16, 20, 23, 27], [15, 19, 22, 25], [14, 18, 21, 24],
    [14, 17, 20, 23], [13, 16, 19, 22], [12, 15, 18, 21],
    [12, 14, 17, 20], [11, 14, 16, 19], [11, 13, 15, 18],
    [10, 12, 15, 17], [10, 12, 14, 16], [9, 11, 13, 15],
    [9, 11, 12, 14], [8, 10, 12, 14], [8, 9, 11, 13],
    [7, 9, 11, 12], [7, 9, 10, 12], [7, 8, 10, 11],
    [6, 8, 9, 11], [6, 7, 9, 10], [6, 7, 8, 9], [2, 2, 2, 2],
], dtype=np.int32)

# Table 9-45: state transition on LPS; MPS transition is min(state+1, 62).
TRANS_IDX_LPS = np.array([
    0, 0, 1, 2, 2, 4, 4, 5, 6, 7, 8, 9, 9, 11, 11, 12,
    13, 13, 15, 15, 16, 16, 18, 18, 19, 19, 21, 21, 22, 22, 23, 24,
    24, 25, 26, 26, 27, 27, 28, 29, 29, 30, 30, 30, 31, 32, 32, 33,
    33, 33, 34, 34, 35, 35, 35, 36, 36, 36, 37, 37, 37, 38, 38, 63,
], dtype=np.int32)

# Table 9-45 transIdxMPS: +1 capped at 62; state 63 (the terminate ctx's
# fixed state) maps to itself.
TRANS_IDX_MPS = np.minimum(np.arange(64) + 1, 62).astype(np.int32)
TRANS_IDX_MPS[62] = 62
TRANS_IDX_MPS[63] = 63


class CabacEncoder:
    """9.3.4 encoding engine. Bins go in; RBSP bytes come out via get_bytes().

    The caller owns byte alignment of whatever precedes the CABAC payload
    (cabac_alignment_one_bit, 7.3.4)."""

    def __init__(self):
        self.low = 0
        self.range = 510
        self.bits_outstanding = 0
        self.first_bit = True
        self._bits: list[int] = []
        # Optional (NUM_CTX, 2) bin counter for init-table fitting
        # (tools/fit_cabac_init.py); None on the normal path.
        self.stats = None

    # -- bit plumbing (9.3.4.3: PutBit) --
    def _put_bit(self, b: int) -> None:
        if self.first_bit:
            self.first_bit = False
        else:
            self._bits.append(b)
        while self.bits_outstanding > 0:
            self._bits.append(1 - b)
            self.bits_outstanding -= 1

    def _renorm(self) -> None:
        while self.range < 256:
            if self.low >= 512:
                self._put_bit(1)
                self.low -= 512
            elif self.low < 256:
                self._put_bit(0)
            else:
                self.low -= 256
                self.bits_outstanding += 1
            self.low <<= 1
            self.range <<= 1

    # -- normative coding modes --
    def encode_bin(self, ctx, idx: int, bin_val: int) -> None:
        """Regular (context-coded) bin. ctx: ContextModels; idx: ctxIdx."""
        if self.stats is not None:
            self.stats[idx, 1 if bin_val else 0] += 1
        state = ctx.state[idx]
        mps = ctx.mps[idx]
        q = (self.range >> 6) & 3
        r_lps = int(RANGE_TAB_LPS[state, q])
        self.range -= r_lps
        if bin_val != mps:
            self.low += self.range
            self.range = r_lps
            if state == 0:
                ctx.mps[idx] = 1 - mps
            ctx.state[idx] = int(TRANS_IDX_LPS[state])
        else:
            ctx.state[idx] = int(TRANS_IDX_MPS[state])
        self._renorm()

    def encode_bypass(self, bin_val: int) -> None:
        self.low <<= 1
        if bin_val:
            self.low += self.range
        if self.low >= 1024:
            self._put_bit(1)
            self.low -= 1024
        elif self.low < 512:
            self._put_bit(0)
        else:
            self.low -= 512
            self.bits_outstanding += 1

    def encode_terminate(self, bin_val: int) -> None:
        self.range -= 2
        if bin_val:
            self.low += self.range
            self.range = 2
            # EncodeFlush (9.3.4.5)
            self._renorm()
            self._put_bit((self.low >> 9) & 1)
            self._bits.extend([(self.low >> 8) & 1, 1])  # rbsp stop bit incl.
        else:
            self._renorm()

    def get_bytes(self) -> bytes:
        """RBSP bytes after the final encode_terminate(1): bit string padded
        with cabac_zero-free alignment zeros."""
        bits = self._bits
        n = len(bits)
        out = bytearray((n + 7) // 8)
        for i, b in enumerate(bits):
            if b:
                out[i >> 3] |= 0x80 >> (i & 7)
        return bytes(out)


class CabacDecoder:
    """9.3.3.2 decoding engine over an RBSP byte string."""

    def __init__(self, data: bytes, bitpos: int = 0):
        self._data = data
        self._pos = bitpos
        self.range = 510
        self.offset = 0
        for _ in range(9):
            self.offset = (self.offset << 1) | self._bit()

    def _bit(self) -> int:
        p = self._pos
        self._pos += 1
        byte = self._data[p >> 3] if (p >> 3) < len(self._data) else 0
        return (byte >> (7 - (p & 7))) & 1

    def decode_bin(self, ctx, idx: int) -> int:
        state = ctx.state[idx]
        mps = ctx.mps[idx]
        q = (self.range >> 6) & 3
        r_lps = int(RANGE_TAB_LPS[state, q])
        self.range -= r_lps
        if self.offset >= self.range:
            bin_val = 1 - mps
            self.offset -= self.range
            self.range = r_lps
            if state == 0:
                ctx.mps[idx] = 1 - mps
            ctx.state[idx] = int(TRANS_IDX_LPS[state])
        else:
            bin_val = mps
            ctx.state[idx] = int(TRANS_IDX_MPS[state])
        while self.range < 256:
            self.range <<= 1
            self.offset = (self.offset << 1) | self._bit()
        return bin_val

    def decode_bypass(self) -> int:
        self.offset = (self.offset << 1) | self._bit()
        if self.offset >= self.range:
            self.offset -= self.range
            return 1
        return 0

    def decode_terminate(self) -> int:
        self.range -= 2
        if self.offset >= self.range:
            return 1
        while self.range < 256:
            self.range <<= 1
            self.offset = (self.offset << 1) | self._bit()
        return 0
