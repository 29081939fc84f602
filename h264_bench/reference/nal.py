"""NAL units: start code, header byte and emulation prevention (spec
7.3.1, 7.4.1.1). A frozen copy of media_tpu_torch/core/nal.py's writer."""

from __future__ import annotations

import re


_ESCAPE_RE = re.compile(rb"\x00\x00(?=[\x00-\x03])")


def escape_rbsp(rbsp: bytes) -> bytes:
    """Insert emulation_prevention_three_byte (spec 7.4.1.1).

    A 0x03 is inserted after every 0x00 0x00 pair that would otherwise be
    followed by a byte in {0x00, 0x01, 0x02, 0x03}. One left-to-right regex
    pass: a match consumes its two zeros, as the byte-wise walk resets its
    zero count after each insertion.
    """
    return _ESCAPE_RE.sub(b"\x00\x00\x03", bytes(rbsp))


def wrap_nal(nal_type: int, rbsp: bytes, *, nal_ref_idc: int = 3) -> bytes:
    """Build a full H.264 NAL unit: 4-byte start code + header byte + escaped
    RBSP."""
    header = bytes([((nal_ref_idc & 3) << 5) | (nal_type & 0x1F)])
    return b"\x00\x00\x00\x01" + escape_rbsp(header + rbsp)


