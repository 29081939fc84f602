"""NAL unit layer: start codes, emulation prevention, NAL scanning.

Implements the H.264/H.265 NAL semantics the reference relies on:
  - NAL unit types (reference: video_decoder/VideoDecoderNetint.cpp:94-182)
  - start-code scanning over 3- and 4-byte codes (ref: FindNalStartCode,
    VideoDecoderNetint.cpp:844-860)
  - non-VCL NAL splitting used for header save/flush-resume (ref:
    FindNextNonVclNalu, VideoDecoderNetint.cpp:794-842)
"""

from __future__ import annotations

import enum
import re
from dataclasses import dataclass


class H264NalType(enum.IntEnum):
    """H.264 nal_unit_type (T-REC-H.264 Table 7-1)."""

    UNSPECIFIED = 0
    SLICE = 1  # non-IDR coded slice (VCL)
    DPA = 2
    DPB = 3
    DPC = 4
    IDR_SLICE = 5  # IDR coded slice (VCL)
    SEI = 6
    SPS = 7
    PPS = 8
    AUD = 9
    END_SEQUENCE = 10
    END_STREAM = 11
    FILLER_DATA = 12
    SPS_EXT = 13
    PREFIX = 14
    SUBSET_SPS = 15
    AUX_SLICE = 19


class H265NalType(enum.IntEnum):
    """H.265 nal_unit_type (T-REC-H.265 Table 7-1), subset used by the framework."""

    TRAIL_N = 0
    TRAIL_R = 1
    BLA_W_LP = 16
    IDR_W_RADL = 19
    IDR_N_LP = 20
    CRA_NUT = 21
    VPS = 32
    SPS = 33
    PPS = 34
    AUD = 35
    EOS = 36
    EOB = 37
    FD = 38
    PREFIX_SEI = 39
    SUFFIX_SEI = 40


H264_VCL_TYPES = frozenset(range(1, 6))


_ESCAPE_RE = re.compile(rb"\x00\x00(?=[\x00-\x03])")
_UNESCAPE_RE = re.compile(rb"\x00\x00\x03(?=[\x00-\x03])")


def escape_rbsp(rbsp: bytes) -> bytes:
    """Insert emulation_prevention_three_byte (spec 7.4.1.1).

    A 0x03 is inserted after every 0x00 0x00 pair that would otherwise be
    followed by a byte in {0x00, 0x01, 0x02, 0x03}. One left-to-right regex
    pass: a match consumes its two zeros, as the byte-wise walk resets its
    zero count after each insertion.
    """
    return _ESCAPE_RE.sub(b"\x00\x00\x03", bytes(rbsp))


def unescape_rbsp(data: bytes) -> bytes:
    """Remove emulation_prevention_three_byte sequences."""
    return _UNESCAPE_RE.sub(b"\x00\x00", bytes(data))


def wrap_nal(nal_type: int, rbsp: bytes, *, nal_ref_idc: int = 3,
             long_start_code: bool = True) -> bytes:
    """Build a full H.264 NAL unit: start code + header byte + escaped RBSP."""
    header = bytes([((nal_ref_idc & 3) << 5) | (nal_type & 0x1F)])
    start = b"\x00\x00\x00\x01" if long_start_code else b"\x00\x00\x01"
    return start + escape_rbsp(header + rbsp)


@dataclass(frozen=True)
class NalUnit:
    nal_type: int
    nal_ref_idc: int
    rbsp: bytes  # de-escaped payload (header byte stripped)
    offset: int  # byte offset of the start code in the source buffer
    size: int  # total size including start code


def find_start_code(data: bytes, pos: int = 0) -> tuple[int, int]:
    """Find the next 3- or 4-byte start code at/after ``pos``.

    Returns (offset, start_code_len), or (-1, 0) if none. Mirrors the
    reference's FindNalStartCode (VideoDecoderNetint.cpp:844-860): a 4-byte
    code 00 00 00 01 is preferred over its embedded 3-byte suffix.
    """
    idx = data.find(b"\x00\x00\x01", pos)
    if idx == -1:
        return -1, 0
    if idx - 1 >= pos and data[idx - 1] == 0:
        return idx - 1, 4
    return idx, 3


def iter_nal_units(data: bytes):
    """Yield NalUnit for every NAL in an Annex-B byte stream."""
    pos, sc_len = find_start_code(data, 0)
    while pos != -1:
        payload_start = pos + sc_len
        next_pos, next_len = find_start_code(data, payload_start)
        end = next_pos if next_pos != -1 else len(data)
        if payload_start < end:
            header = data[payload_start]
            yield NalUnit(
                nal_type=header & 0x1F,
                nal_ref_idc=(header >> 5) & 3,
                rbsp=unescape_rbsp(data[payload_start + 1 : end]),
                offset=pos,
                size=end - pos,
            )
        pos, sc_len = next_pos, next_len


def split_parameter_sets(data: bytes) -> tuple[bytes, bytes]:
    """Split an Annex-B stream into (non-VCL header NALs, rest-from-first-VCL).

    Mirrors the reference decoder's header-saving walk (FindNextNonVclNalu,
    VideoDecoderNetint.cpp:794-842): leading SPS/PPS/SEI/AUD NALs are collected
    so a session can persist them across Flush; the remainder starts at the
    first VCL NAL.
    """
    first_vcl = len(data)
    for nal in iter_nal_units(data):
        if nal.nal_type in H264_VCL_TYPES:
            first_vcl = nal.offset
            break
    return data[:first_vcl], data[first_vcl:]
