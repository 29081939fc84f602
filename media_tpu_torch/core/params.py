"""Typed runtime-mutable parameter store with the reference's property-key
semantics.

The reference's entire config system is Android system properties, read at
init AND polled per frame, with invalid persisted values repaired in place
(SURVEY.md §5-config; VideoEncoderOpenH264.cpp:62-122,159-195,111-115). This
module reproduces those semantics process-locally: the same keys, the same
validation envelope, the same write-back repair, and per-frame polling hooks —
without process-global state (each store instance is a session's view).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass

# Property keys (reference key table, SURVEY.md §5).
KEY_ENCODE_FORMAT = "ro.vmi.demo.video.encode.format"  # 0=SW-ref 1=TPU H264 2=TPU H265
KEY_CLOUDPHONE_MODE = "ro.sys.vmi.cloudphone"  # "video" | "instruction"
KEY_HW_WIDTH = "ro.hardware.width"
KEY_HW_HEIGHT = "ro.hardware.height"
KEY_HW_FPS = "ro.hardware.fps"
KEY_PERSIST_WIDTH = "persist.vmi.demo.video.encode.width"
KEY_PERSIST_HEIGHT = "persist.vmi.demo.video.encode.height"
KEY_PERSIST_FPS = "persist.vmi.demo.video.encode.framerate"
KEY_BITRATE = "persist.vmi.demo.video.encode.bitrate"
KEY_GOPSIZE = "persist.vmi.demo.video.encode.gopsize"
KEY_PROFILE = "persist.vmi.demo.video.encode.profile"
KEY_PARAM_ADJUSTING = "persist.vmi.video.encode.param_adjusting"
KEY_FORCE_KEYFRAME = "persist.vmi.video.encode.keyframe"
# Extension key (no reference analog — the reference's multi-ASIC placement
# is implicit in ni_rsrc_allocate_auto): "1" forces multi-chip session
# placement, "0" disables, unset = auto (real backend with >1 device).
KEY_MULTICHIP = "media.tpu.multichip"

# Validation envelope. The SW reference caps dimensions at 4096
# (VideoEncoderOpenH264.cpp:16-23,159-195); the HW parameter envelope goes
# to 8192 (vendor/netint/ni_device_api.h:100-103) and the TPU backend has
# no 4K limit (8K = 32 GB/s of uint8 planes at 60 fps, well inside HBM
# bandwidth), so the wider HW envelope is adopted.
MIN_DIM, MAX_DIM = 16, 8192
VALID_FPS = (30, 60)
MIN_BITRATE, MAX_BITRATE = 1_000_000, 10_000_000
MIN_GOP, MAX_GOP = 30, 3000
VALID_PROFILES = ("baseline", "main", "high")

DEFAULTS = {
    KEY_CLOUDPHONE_MODE: "video",
    KEY_HW_WIDTH: "720",
    KEY_HW_HEIGHT: "1280",
    KEY_HW_FPS: "30",
    KEY_BITRATE: "5000000",
    KEY_GOPSIZE: "30",
    KEY_PROFILE: "baseline",
    KEY_PARAM_ADJUSTING: "0",
    KEY_FORCE_KEYFRAME: "0",
    KEY_ENCODE_FORMAT: "1",
}


def str_to_int(value: str, default: int = -1) -> int:
    """The reference's StrToInt: -1 on unparsable (Property.cpp:16-19)."""
    try:
        return int(str(value).strip())
    except (TypeError, ValueError):
        return default


class ParamStore:
    """Session-scoped key/value store with get/set + typed accessors."""

    def __init__(self, initial: dict | None = None):
        self._values = dict(DEFAULTS)
        if initial:
            self._values.update({k: str(v) for k, v in initial.items()})
        self._lock = threading.Lock()

    def get_str(self, key: str, default: str = "") -> str:
        with self._lock:
            return self._values.get(key, default)

    def get_int(self, key: str, default: int = -1) -> int:
        return str_to_int(self.get_str(key, ""), default)

    def set(self, key: str, value) -> None:
        with self._lock:
            self._values[key] = str(value)


@dataclass
class EncodeParams:
    """Validated encoder parameters (the reference's Ro+Persist param set)."""

    width: int = 720
    height: int = 1280
    framerate: int = 30
    bitrate: int = 5_000_000
    gop_size: int = 30
    profile: str = "baseline"


def read_encode_params(store: ParamStore, *, repair: bool = True) -> EncodeParams:
    """Read + validate all encode params; invalid persisted values are
    repaired in place (write-back), mirroring VideoEncoderOpenH264.cpp:111-115.

    Raises ValueError for invalid *read-only* geometry (the reference fails
    init on those rather than repairing them).
    """
    mode = store.get_str(KEY_CLOUDPHONE_MODE, "video")
    if mode == "video":
        width = store.get_int(KEY_HW_WIDTH, 720)
        height = store.get_int(KEY_HW_HEIGHT, 1280)
        fps = store.get_int(KEY_HW_FPS, 30)
    else:
        width = store.get_int(KEY_PERSIST_WIDTH, 720)
        height = store.get_int(KEY_PERSIST_HEIGHT, 1280)
        fps = store.get_int(KEY_PERSIST_FPS, 30)

    if not (MIN_DIM <= width <= MAX_DIM) or not (MIN_DIM <= height <= MAX_DIM):
        raise ValueError(f"invalid geometry {width}x{height}")
    if fps not in VALID_FPS:
        raise ValueError(f"invalid framerate {fps} (must be one of {VALID_FPS})")

    defaults = EncodeParams()
    bitrate = store.get_int(KEY_BITRATE, defaults.bitrate)
    if not (MIN_BITRATE <= bitrate <= MAX_BITRATE):
        bitrate = defaults.bitrate
        if repair:
            store.set(KEY_BITRATE, bitrate)
    gop = store.get_int(KEY_GOPSIZE, defaults.gop_size)
    if not (MIN_GOP <= gop <= MAX_GOP):
        gop = defaults.gop_size
        if repair:
            store.set(KEY_GOPSIZE, gop)
    profile = store.get_str(KEY_PROFILE, defaults.profile)
    if profile not in VALID_PROFILES:
        profile = defaults.profile
        if repair:
            store.set(KEY_PROFILE, profile)

    return EncodeParams(
        width=width, height=height, framerate=fps,
        bitrate=bitrate, gop_size=gop, profile=profile,
    )
