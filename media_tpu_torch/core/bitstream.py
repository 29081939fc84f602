"""Raw bitstream I/O: MSB-first bit packing, Exp-Golomb codes, RBSP trailing.

This is the H.264 (Rec. ITU-T H.264) bit-level layer. The reference framework
(see SURVEY.md C12) delegates all bitstream generation to vendor libraries; here
it is first-party. The Python classes are the *reference implementation* used by
tests and the slow path; the hot encode path packs bits in the native C++ core
(csrc/) fed by symbol arrays produced on TPU.
"""

from __future__ import annotations


class BitWriter:
    """MSB-first bit writer accumulating into a bytearray.

    Bits are appended into an integer accumulator and flushed to bytes; this
    keeps per-call overhead low for the pure-Python path.
    """

    __slots__ = ("_buf", "_acc", "_nbits")

    def __init__(self) -> None:
        self._buf = bytearray()
        self._acc = 0  # bit accumulator, MSB side is older
        self._nbits = 0  # number of valid bits in _acc

    def u(self, n: int, value: int) -> None:
        """Write ``value`` as ``n`` unsigned bits, MSB first."""
        if n < 0 or (value >> n):
            raise ValueError(f"u({n}) cannot hold value {value}")
        self._acc = (self._acc << n) | value
        self._nbits += n
        while self._nbits >= 8:
            self._nbits -= 8
            self._buf.append((self._acc >> self._nbits) & 0xFF)
        self._acc &= (1 << self._nbits) - 1

    def flag(self, value: bool | int) -> None:
        self.u(1, 1 if value else 0)

    def ue(self, value: int) -> None:
        """Unsigned Exp-Golomb (spec 9.1): codeNum = value."""
        if value < 0:
            raise ValueError(f"ue() requires value >= 0, got {value}")
        code = value + 1
        nbits = code.bit_length()
        self.u(2 * nbits - 1, code)

    def se(self, value: int) -> None:
        """Signed Exp-Golomb (spec 9.1.1): v>0 -> 2v-1, v<=0 -> -2v."""
        self.ue(2 * value - 1 if value > 0 else -2 * value)

    def te(self, value: int, max_value: int) -> None:
        """Truncated Exp-Golomb: 1-bit inverted flag when range is [0,1]."""
        if max_value == 1:
            self.u(1, 1 - value)
        else:
            self.ue(value)

    @property
    def bit_position(self) -> int:
        return len(self._buf) * 8 + self._nbits

    def byte_aligned(self) -> bool:
        return self._nbits == 0

    def put_bytes(self, data) -> None:
        """Append raw bytes (writer must be byte-aligned) — the fast path
        for pcm_sample_* payloads (spec 7.3.5: I_PCM)."""
        if self._nbits:
            raise ValueError("put_bytes requires byte alignment")
        self._buf += data

    def rbsp_trailing_bits(self) -> None:
        """rbsp_stop_one_bit + zero pad to byte boundary (spec 7.3.2.11)."""
        self.u(1, 1)
        if self._nbits:
            self.u(8 - self._nbits, 0)

    def get_bytes(self) -> bytes:
        if self._nbits:
            raise ValueError("bitstream not byte-aligned; call rbsp_trailing_bits()")
        return bytes(self._buf)


class BitReader:
    """MSB-first bit reader over a bytes-like RBSP (already de-escaped)."""

    __slots__ = ("_data", "_pos")

    def __init__(self, data: bytes) -> None:
        self._data = data
        self._pos = 0  # bit position

    def u(self, n: int) -> int:
        end = self._pos + n
        if end > len(self._data) * 8:
            raise EOFError("read past end of bitstream")
        value = 0
        pos = self._pos
        while n > 0:
            byte = self._data[pos >> 3]
            bit_off = pos & 7
            take = min(8 - bit_off, n)
            chunk = (byte >> (8 - bit_off - take)) & ((1 << take) - 1)
            value = (value << take) | chunk
            pos += take
            n -= take
        self._pos = pos
        return value

    def flag(self) -> bool:
        return bool(self.u(1))

    def ue(self) -> int:
        zeros = 0
        while self.u(1) == 0:
            zeros += 1
            if zeros > 31:
                raise ValueError("corrupt Exp-Golomb code")
        return ((1 << zeros) | self.u(zeros) if zeros else 1) - 1

    def se(self) -> int:
        code = self.ue()
        return (code + 1) >> 1 if code & 1 else -(code >> 1)

    def te(self, max_value: int) -> int:
        if max_value == 1:
            return 1 - self.u(1)
        return self.ue()

    @property
    def bit_position(self) -> int:
        return self._pos

    def byte_aligned(self) -> bool:
        return (self._pos & 7) == 0

    def read_bytes(self, n: int) -> bytes:
        """Read n raw bytes (reader must be byte-aligned) — the fast path
        for pcm_sample_* payloads (spec 7.3.5: I_PCM)."""
        if self._pos & 7:
            raise ValueError("read_bytes requires byte alignment")
        start = self._pos >> 3
        if start + n > len(self._data):
            raise EOFError("read past end of bitstream")
        self._pos += n * 8
        return bytes(self._data[start : start + n])

    def bits_remaining(self) -> int:
        return len(self._data) * 8 - self._pos

    def more_rbsp_data(self) -> bool:
        """True if there is RBSP data beyond the rbsp_stop_one_bit (7.2)."""
        remaining = self.bits_remaining()
        if remaining <= 0:
            return False
        # Find the last 1 bit in the stream (the stop bit); data remains iff
        # the current position is before it.
        total_bits = len(self._data) * 8
        last_one = -1
        for byte_idx in range(len(self._data) - 1, -1, -1):
            byte = self._data[byte_idx]
            if byte:
                low = byte & -byte
                last_one = byte_idx * 8 + (7 - low.bit_length() + 1)
                break
        if last_one < 0:
            return False
        return self._pos < last_one
