"""The port's DevicePool (media_tpu_torch/parallel/sharding.py) and the
encoder API's placement over it.

The cases of tests/test_device_pool.py on the port, the pool over
["cpu"] * n standing for a host of n cards, each placement also made by the
JAX package's pool on the same handles (tolerance 0); and a forced
media.tpu.multichip=1 on one device, which logs the failed multi-device
placement and keeps the plain EncoderSession.
"""

import pytest
import torch

from media_tpu.parallel import sharding as jsharding
from media_tpu_torch.api import encoder_api as tenc
from media_tpu_torch.api.errors import EncoderRetCode
from media_tpu_torch.core import log as tlog
from media_tpu_torch.core import params as P
from media_tpu_torch.parallel import sharding
from media_tpu_torch.parallel.sharding import DevicePool
from media_tpu_torch.pipeline.codec import EncoderSession


def _placements(pool):
    out = []
    s1, d1 = pool.allocate(1920, 1080, 30, n_devices=2)
    out.append(d1)
    out.append(pool.allocate(1280, 720, 30, n_devices=1)[1])
    out.append(pool.allocate(640, 480, 30, n_devices=1)[1])
    out.append(pool.allocate(640, 480, 60, n_devices=2)[1])
    pool.release(s1)
    out.append(pool.allocate(320, 240, 30, n_devices=2)[1])
    return out, pool.loads()


def test_least_load_placement():
    got = _placements(DevicePool(devices=list(range(4))))
    assert got == _placements(jsharding.DevicePool(devices=list(range(4))))
    assert got[0] == [[0, 1], [2], [3], [2, 3], [0, 1]]
    assert all(v >= 0 for v in got[1])


@pytest.mark.parametrize("n", [1, 2])
def test_pool_over_cpu_devices(n):
    pool = DevicePool(devices=["cpu"] * n)
    sid, devs = pool.allocate(128, 128, 30, n_devices=n)
    assert devs == ["cpu"] * n
    with pytest.raises(ValueError):
        pool.allocate(128, 128, 30, n_devices=n + 1)
    pool.release(sid)
    assert all(v == 0 for v in pool.loads())


def test_default_pool_is_the_cuda_devices_and_raises_without_them(
        monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("checks a host without CUDA")
    monkeypatch.setattr(sharding, "_POOL", None)
    for call in (DevicePool, sharding.get_pool):
        with pytest.raises(RuntimeError, match="cuda"):
            call()


def test_forced_multichip_on_one_device_keeps_the_plain_session(monkeypatch):
    lines = []
    monkeypatch.setattr(tlog._manager, "_callback",
                        lambda lvl, tag, msg: lines.append((lvl, tag, msg)))
    monkeypatch.setattr(tlog._manager, "_level", tlog.LOG_DEBUG)
    store = P.ParamStore({P.KEY_HW_WIDTH: 64, P.KEY_HW_HEIGHT: 48,
                          P.KEY_MULTICHIP: "1"})
    enc = tenc.create_video_encoder(store, device="cpu")
    assert enc.init_encoder() == EncoderRetCode.VIDEO_ENCODER_SUCCESS
    assert type(enc.session) is EncoderSession
    assert getattr(enc.session, "_pool_sid", None) is None
    warns = [m for lvl, tag, m in lines
             if lvl == tlog.LOG_WARN and tag == "VideoEncoder"]
    assert len(warns) == 1
    assert warns[0].startswith("multi-chip placement failed (")
    assert warns[0].endswith("; single chip")
    assert enc.destroy_encoder() == EncoderRetCode.VIDEO_ENCODER_SUCCESS
