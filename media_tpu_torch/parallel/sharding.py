"""Load-aware session placement over the local devices.

The port's share of media_tpu/parallel/sharding.py: `DevicePool` and
`get_pool` only. The row-sharded encoder session beside them in the
original is not ported yet, so the encoder API places every session on
one device (api/encoder_api.py:_place_session) and nothing calls the pool
yet.
"""

from __future__ import annotations

import torch

from ..device import resolve_device


class DevicePool:
    """Load-aware session placement over the local devices — the analog of
    the reference's shared-memory device pool with least-load auto-allocation
    (ni_rsrc_allocate_auto, EN_ALLOC_LEAST_LOAD, vendor/netint/
    ni_rsrc_api.h:57-61,343-348) and its pixel-rate load model
    (`xcode_load_pixel`, ni_rsrc_api.h:106).

    Load unit: pixels/second of admitted work (width*height*fps per
    session). allocate() returns the n least-loaded devices for a new
    session; release() returns the capacity.

    devices: the caller's list (e.g. ["cpu"] * n), else every CUDA device;
    without CUDA and without a list it raises, as every entry point of the
    port does.
    """

    def __init__(self, devices=None):
        if devices is None:
            resolve_device("cuda")
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
        self._devices = list(devices)
        self._load = {i: 0 for i in range(len(self._devices))}
        self._sessions: dict[int, tuple] = {}
        self._next_id = 0

    def loads(self) -> list[int]:
        return [self._load[i] for i in range(len(self._devices))]

    def allocate(self, width: int, height: int, fps: int = 30,
                 n_devices: int = 1):
        """Least-load placement: returns (session_id, [devices])."""
        if n_devices > len(self._devices):
            raise ValueError("not enough devices in the pool")
        per_dev = (width * height * fps) // n_devices
        order = sorted(range(len(self._devices)), key=lambda i: self._load[i])
        chosen = sorted(order[:n_devices])  # mesh order stays stable
        for i in chosen:
            self._load[i] += per_dev
        sid = self._next_id
        self._next_id += 1
        self._sessions[sid] = (tuple(chosen), per_dev)
        return sid, [self._devices[i] for i in chosen]

    def release(self, session_id: int) -> None:
        chosen, per_dev = self._sessions.pop(session_id)
        for i in chosen:
            self._load[i] -= per_dev


_POOL = None


def get_pool() -> "DevicePool":
    """Process-global pool over the CUDA devices — the analog of the
    reference's host-wide shared-memory resource pool
    (vendor/netint/ni_rsrc_api.h:92-96; one pool per host, sessions from
    any factory call draw from it)."""
    global _POOL
    if _POOL is None:
        _POOL = DevicePool()
    return _POOL
