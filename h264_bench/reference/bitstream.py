"""MSB-first bit writing with Exp-Golomb codes and the RBSP trailing bits
(spec 7.2, 9.1). A frozen copy of media_tpu_torch/core/bitstream.py's
BitWriter."""

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

    def rbsp_trailing_bits(self) -> None:
        """rbsp_stop_one_bit + zero pad to byte boundary (spec 7.3.2.11)."""
        self.u(1, 1)
        if self._nbits:
            self.u(8 - self._nbits, 0)

    def get_bytes(self) -> bytes:
        if self._nbits:
            raise ValueError("bitstream not byte-aligned; call rbsp_trailing_bits()")
        return bytes(self._buf)
