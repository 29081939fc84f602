"""CAVLC residual block encoding/decoding (Rec. ITU-T H.264 9.2).

Python reference implementation, the oracle for the native C++ packer used on
the hot path. Blocks are given as coefficient arrays in zig-zag scan order
(lowest frequency first); nC selects the coeff_token context exactly as in
spec 9.2.1 (the MB layer computes nC from neighbor TotalCoeffs).
"""

from __future__ import annotations

from ..core.bitstream import BitReader, BitWriter
from . import cavlc_tables as tables


def encode_block(bw: BitWriter, coeffs, n_c: int) -> int:
    """Encode one residual block; returns TotalCoeff (for nC propagation).

    coeffs: sequence of ints in zig-zag order; length 16 (LumaLevel4x4 /
    Intra16x16DCLevel), 15 (Intra16x16ACLevel / ChromaACLevel) or 4
    (ChromaDCLevel, with n_c == -1).
    """
    coeffs = list(coeffs)
    max_coeff = len(coeffs)
    nz = [i for i, c in enumerate(coeffs) if c != 0]
    total_coeff = len(nz)

    if total_coeff == 0:
        length, code = tables.coeff_token_code(n_c, 0, 0)
        bw.u(length, code)
        return 0

    last = nz[-1]
    total_zeros = last + 1 - total_coeff

    # Trailing ones: up to three |1| coefficients at the high-frequency end.
    trailing_ones = 0
    for idx in reversed(nz):
        if abs(coeffs[idx]) == 1 and trailing_ones < 3:
            trailing_ones += 1
        else:
            break

    length, code = tables.coeff_token_code(n_c, trailing_ones, total_coeff)
    bw.u(length, code)

    # Signs of trailing ones, highest frequency first (1 = negative).
    for k in range(trailing_ones):
        bw.u(1, 1 if coeffs[nz[-1 - k]] < 0 else 0)

    # Remaining levels, highest frequency first, with adaptive suffix length.
    suffix_length = 1 if total_coeff > 10 and trailing_ones < 3 else 0
    remaining = [coeffs[i] for i in nz[: total_coeff - trailing_ones]]
    for i, level in enumerate(reversed(remaining)):
        level_code = 2 * level - 2 if level > 0 else -2 * level - 1
        if i == 0 and trailing_ones < 3:
            level_code -= 2
        _write_level(bw, level_code, suffix_length)
        if suffix_length == 0:
            suffix_length = 1
        if abs(level) > (3 << (suffix_length - 1)) and suffix_length < 6:
            suffix_length += 1

    # total_zeros
    if total_coeff < max_coeff:
        if n_c == -1:
            length, code = tables.TOTAL_ZEROS_CHROMA_DC[total_coeff - 1][total_zeros]
        else:
            length, code = tables.TOTAL_ZEROS[total_coeff - 1][total_zeros]
        bw.u(length, code)

    # run_before per coefficient, highest frequency first, except the last.
    zeros_left = total_zeros
    for k in range(total_coeff - 1):
        if zeros_left <= 0:
            break
        idx = nz[-1 - k]
        prev_idx = nz[-2 - k]
        run = idx - prev_idx - 1
        length, code = tables.RUN_BEFORE[min(zeros_left, 7) - 1][run]
        bw.u(length, code)
        zeros_left -= run

    return total_coeff


def _write_level(bw: BitWriter, level_code: int, suffix_length: int) -> None:
    """level_prefix/level_suffix encoding (spec 9.2.2.1, inverted)."""
    if suffix_length == 0:
        if level_code < 14:
            bw.u(level_code + 1, 1)  # level_code zeros then a 1
        elif level_code < 30:
            bw.u(15, 1)  # level_prefix = 14
            bw.u(4, level_code - 14)
        else:
            _write_escape(bw, level_code - 30)
    else:
        if (level_code >> suffix_length) < 15:
            prefix = level_code >> suffix_length
            bw.u(prefix + 1, 1)
            bw.u(suffix_length, level_code & ((1 << suffix_length) - 1))
        else:
            _write_escape(bw, level_code - (15 << suffix_length))


def _write_escape(bw: BitWriter, rem: int) -> None:
    """Escape codes: level_prefix >= 15 with (prefix-3)-bit suffix; prefix
    grows past 15 for very large levels (spec 9.2.2.1 levelCode derivation)."""
    prefix = 15
    # Prefix p covers rem in [base, base + 2^(p-3)) where base(15) = 0 and
    # base(p) = 2^(p-3) - 4096 for p >= 16 (contiguous ranges).
    while True:
        base = 0 if prefix == 15 else (1 << (prefix - 3)) - 4096
        span = 1 << (prefix - 3)
        if rem < base + span:
            break
        prefix += 1
    bw.u(prefix + 1, 1)
    bw.u(prefix - 3, rem - base)


def decode_block(br: BitReader, n_c: int, max_coeff: int):
    """Decode one residual block; returns (coeffs list in zig-zag order,
    total_coeff)."""
    trailing_ones, total_coeff = _read_coeff_token(br, n_c)
    coeffs = [0] * max_coeff
    if total_coeff == 0:
        return coeffs, 0

    levels = []
    for k in range(trailing_ones):
        levels.append(-1 if br.u(1) else 1)

    suffix_length = 1 if total_coeff > 10 and trailing_ones < 3 else 0
    for i in range(total_coeff - trailing_ones):
        level_prefix = 0
        while br.u(1) == 0:
            level_prefix += 1
            if level_prefix > 32:
                raise ValueError("corrupt level_prefix")
        if level_prefix >= 15:
            suffix_size = level_prefix - 3
        elif level_prefix == 14 and suffix_length == 0:
            suffix_size = 4
        else:
            suffix_size = suffix_length
        level_suffix = br.u(suffix_size) if suffix_size else 0
        level_code = (min(15, level_prefix) << suffix_length) + level_suffix
        if level_prefix >= 15 and suffix_length == 0:
            level_code += 15
        if level_prefix >= 16:
            level_code += (1 << (level_prefix - 3)) - 4096
        if i == 0 and trailing_ones < 3:
            level_code += 2
        if level_code % 2 == 0:
            level = (level_code + 2) >> 1
        else:
            level = -((level_code + 1) >> 1)
        levels.append(level)
        if suffix_length == 0:
            suffix_length = 1
        if abs(level) > (3 << (suffix_length - 1)) and suffix_length < 6:
            suffix_length += 1

    if total_coeff < max_coeff:
        if n_c == -1:
            total_zeros = _read_vlc(br, tables.TOTAL_ZEROS_CHROMA_DC[total_coeff - 1])
        else:
            total_zeros = _read_vlc(br, tables.TOTAL_ZEROS[total_coeff - 1])
    else:
        total_zeros = 0

    # Place coefficients: walk from highest frequency down.
    runs = []
    zeros_left = total_zeros
    for k in range(total_coeff - 1):
        if zeros_left > 0:
            run = _read_vlc(br, tables.RUN_BEFORE[min(zeros_left, 7) - 1])
        else:
            run = 0
        runs.append(run)
        zeros_left -= run
    runs.append(zeros_left)  # run before the lowest-frequency coefficient

    pos = total_coeff - 1 + total_zeros  # index of the highest-freq coefficient
    for k in range(total_coeff):
        coeffs[pos] = levels[k]
        pos -= 1 + runs[k]
    return coeffs, total_coeff


def _read_coeff_token(br: BitReader, n_c: int):
    if n_c >= 8:
        code = br.u(6)
        if code == 3:
            return 0, 0
        return code & 3, (code >> 2) + 1
    table = (
        tables.COEFF_TOKEN_CHROMA_DC
        if n_c == -1
        else tables.COEFF_TOKEN[0 if n_c < 2 else (1 if n_c < 4 else 2)]
    )
    # Longest codeword is 16 bits; match incrementally.
    value = 0
    for length in range(1, 17):
        value = (value << 1) | br.u(1)
        for (t1, tc), (l, c) in table.items():
            if l == length and c == value:
                return t1, tc
    raise ValueError(f"invalid coeff_token (nC={n_c})")


def _read_vlc(br: BitReader, row) -> int:
    value = 0
    for length in range(1, 17):
        value = (value << 1) | br.u(1)
        for symbol, (l, c) in enumerate(row):
            if l == length and c == value:
                return symbol
    raise ValueError("invalid VLC code")
