"""The on-device CAVLC pack (csrc/device_cavlc.cu, entropy/device_cavlc.py):
four kernels a call, one call a P frame unless the adaptive stream cap
overflows and the frame is packed again.

Its work is bytes: the int16 symbols (386 an MB) and the QP read once,
the stream's bits written once (each P frame's access unit, its few
header bytes included), at the memory rate. A repeated call is not work."""

from __future__ import annotations

PATTERN = (r"\b(mb_meta_kernel|mb_scan_kernel|chunk_bits_kernel|"
           r"chunk_write_kernel)\b")


def bound_s(run) -> float:
    n_bytes = (run.p_frames * (run.R * run.C * 386 * 2 + 4)
               + run.au_bytes["p"])
    return run.hbm_s(n_bytes)
