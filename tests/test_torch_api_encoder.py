"""The port's VideoEncoder (media_tpu_torch/api/encoder_api.py) against
media_tpu's.

Two configurations of the reference policy, `baseline` (CAVLC) and `main`
(CABAC), both CBR at 64x48 over 6 frames of the smoke clip's scene, with a
forced keyframe before frame 3 and a parameter adjust (a new bitrate, so a
reset) before frame 5: every return code, every AU and the encoder's QP
after every frame equal the JAX package's, byte for byte (tolerance 0). The
JAX side is read from tests/golden_torch/ (jax_run says what it was asked;
tests/jax_golden.py); the JAX package's host helpers (_bitrate_to_qp, the
policy, the params module) run live. Then the cases of
tests/test_api.py's encoder classes and test_encoder_statistics_surface on
the port (device="cpu"), and what the port keeps literally: the catch-all
of encode_one_frame, _bitrate_to_qp, and the device rule of its entry
points.
"""

import numpy as np
import pytest
import torch

import chip_smoke as cs
from jax_golden import Golden
from media_tpu.api import encoder_api as jenc
from media_tpu.core import params as jP
from media_tpu_torch import api as tapi
from media_tpu_torch.api import encoder_api as tenc
from media_tpu_torch.api.errors import CodecFormat, EncoderRetCode
from media_tpu_torch.core import log as tlog
from media_tpu_torch.core import nal as tnal
from media_tpu_torch.core import params as P
from media_tpu_torch.pipeline.codec import EncoderSession
from media_tpu_torch.utils import yuv

W, H, N = 64, 48, 6
FRAMES = cs.clip_i420(W, H, N)[0]
EVENTS = {3: {"KEY_FORCE_KEYFRAME": "1"},
          5: {"KEY_BITRATE": "2000000", "KEY_PARAM_ADJUSTING": "1"}}
CONFIGS = ("baseline", "main")
STATS = ("input_frame_count", "encoded_bytes", "average_frame_qp",
         "idr_req_num", "width", "height")


def drive(api, params, profile, **kw):
    """The configuration's 6 frames through create_video_encoder ->
    init -> start -> encode_one_frame -> stop -> destroy."""
    store = params.ParamStore({params.KEY_HW_WIDTH: W, params.KEY_HW_HEIGHT: H,
                               params.KEY_PROFILE: profile})
    enc = api.create_video_encoder(store, **kw)
    codes = [enc.init_encoder(), enc.start_encoder()]
    cfg = enc.session.cfg
    aus, qps = [], []
    for i, buf in enumerate(FRAMES):
        for k, v in EVENTS.get(i, {}).items():
            store.set(getattr(params, k), v)
        code, au = enc.encode_one_frame(buf)
        codes.append(code)
        aus.append(bytes(au))
        qps.append(enc._current_qp())
    stats = enc.get_encoder_statistics()
    codes += [enc.stop_encoder(), enc.destroy_encoder()]
    return {"codes": [int(c) for c in codes], "aus": aus, "qps": qps,
            "stats": stats, "cfg": (cfg.rc_mode, cfg.cabac, cfg.i4x4,
                                    cfg.bitrate, cfg.profile)}


# The JAX side deblocks one wave per scan step: the same bytes from smaller
# programs.
GOLDEN = Golden(__file__, env={"MEDIA_TPU_DEBLOCK_UNROLL": "1"})


@GOLDEN.recipe(cases=CONFIGS)
def jax_run(profile):
    """drive() through the JAX package's API; of the statistics, the
    counters (not the clock's rates)."""
    from media_tpu import api as japi

    run = drive(japi, jP, profile)
    run["stats"] = {k: run["stats"][k] for k in STATS}
    return run


@pytest.mark.parametrize("profile", CONFIGS)
def test_api_stream_equals_jax(profile):
    want = GOLDEN.read(jax_run, profile)
    got = drive(tapi, P, profile, device="cpu")
    assert got["codes"] == want["codes"] == [0] * (N + 4)
    assert got["cfg"] == want["cfg"]
    assert got["cfg"][:3] == ("cbr", profile == "main", True)
    for i, (a, b) in enumerate(zip(got["aus"], want["aus"])):
        assert a == b, f"AU {i} differs"
    assert got["qps"] == want["qps"]
    # Frames 0, 3 (forced) and 5 (reset) are IDRs with their parameter
    # sets in front; the others one non-IDR slice.
    types = [[nu.nal_type for nu in tnal.iter_nal_units(a)]
             for a in got["aus"]]
    assert [5 in t for t in types] == [True, False, False, True, False, True]
    assert types[5][:2] == [7, 8] and types[3][-1] == 5
    for k in STATS:
        assert got["stats"][k] == want["stats"][k], k


# ------------------------------------------- tests/test_api.py on the port


def small_store(w=W, h=H):
    store = P.ParamStore()
    store.set(P.KEY_HW_WIDTH, w)
    store.set(P.KEY_HW_HEIGHT, h)
    store.set(P.KEY_HW_FPS, 30)
    store.set(P.KEY_GOPSIZE, 30)
    return store


def frame_bytes(w, h, seed=0):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 256, (h, w)).astype(np.uint8)
    u = rng.integers(0, 256, (h // 2, w // 2)).astype(np.uint8)
    v = rng.integers(0, 256, (h // 2, w // 2)).astype(np.uint8)
    return yuv.pack_i420(y, u, v)


def started(store):
    enc = tapi.VideoEncoder(store, device="cpu")
    assert enc.init_encoder() == EncoderRetCode.VIDEO_ENCODER_SUCCESS
    assert enc.start_encoder() == EncoderRetCode.VIDEO_ENCODER_SUCCESS
    return enc


class TestEncoderLifecycle:
    def test_full_lifecycle(self):
        enc = tapi.create_video_encoder(small_store(), device="cpu")
        assert enc is not None
        assert enc.init_encoder() == EncoderRetCode.VIDEO_ENCODER_SUCCESS
        assert enc.start_encoder() == EncoderRetCode.VIDEO_ENCODER_SUCCESS
        code, data = enc.encode_one_frame(FRAMES[0])
        assert code == EncoderRetCode.VIDEO_ENCODER_SUCCESS
        assert data.startswith(b"\x00\x00\x00\x01")
        assert isinstance(enc.session, EncoderSession)
        assert enc.session.device == torch.device("cpu")
        assert enc.stop_encoder() == EncoderRetCode.VIDEO_ENCODER_SUCCESS
        assert enc.destroy_encoder() == EncoderRetCode.VIDEO_ENCODER_SUCCESS
        # destroy is idempotent
        assert enc.destroy_encoder() == EncoderRetCode.VIDEO_ENCODER_SUCCESS

    def test_encode_before_init_fails(self):
        enc = tapi.VideoEncoder(small_store(), device="cpu")
        code, _ = enc.encode_one_frame(b"")
        assert code == EncoderRetCode.VIDEO_ENCODER_NOT_INITED

    def test_input_size_guard(self):
        enc = started(small_store())
        code, _ = enc.encode_one_frame(b"\x00" * 10)
        assert code == EncoderRetCode.VIDEO_ENCODER_ENCODE_FAIL

    def test_force_keyframe_poll(self):
        store = small_store()
        enc = started(store)
        enc.encode_one_frame(FRAMES[0])
        _, p1 = enc.encode_one_frame(FRAMES[1])
        assert p1[4] & 0x1F == 1  # P frame: single non-IDR NAL
        store.set(P.KEY_FORCE_KEYFRAME, "1")
        _, p2 = enc.encode_one_frame(FRAMES[2])
        assert 5 in [n.nal_type for n in tnal.iter_nal_units(p2)]
        assert store.get_str(P.KEY_FORCE_KEYFRAME) == "0"  # poll consumed

    def test_param_adjust_triggers_reset(self):
        store = small_store()
        enc = started(store)
        enc.encode_one_frame(FRAMES[0])
        store.set(P.KEY_GOPSIZE, "60")
        store.set(P.KEY_PARAM_ADJUSTING, "1")
        code, data = enc.encode_one_frame(FRAMES[1])
        assert code == EncoderRetCode.VIDEO_ENCODER_SUCCESS
        assert enc.session.cfg.gop_size == 60
        assert data[4] & 0x1F == 7  # reset implies a fresh IDR, SPS first

    def test_invalid_param_repair(self):
        store = small_store()
        store.set(P.KEY_BITRATE, "999")  # below envelope -> repaired
        enc = tapi.VideoEncoder(store, device="cpu")
        assert enc.init_encoder() == EncoderRetCode.VIDEO_ENCODER_SUCCESS
        assert store.get_int(P.KEY_BITRATE) == 5_000_000  # written back

    def test_invalid_geometry_fails_init(self):
        enc = tapi.VideoEncoder(small_store(w=8, h=8), device="cpu")
        assert enc.init_encoder() == EncoderRetCode.VIDEO_ENCODER_INIT_FAIL

    def test_factory_format_select(self):
        store = small_store()
        store.set(P.KEY_ENCODE_FORMAT, "2")
        enc265 = tapi.create_video_encoder(store, device="cpu")
        assert enc265 is not None and enc265._codec == CodecFormat.H265
        store.set(P.KEY_ENCODE_FORMAT, "1")
        assert tapi.create_video_encoder(store, device="cpu") is not None
        store.set(P.KEY_ENCODE_FORMAT, "7")
        assert tapi.create_video_encoder(store, device="cpu") is None


class TestReferencePolicyConfig:
    def test_factory_builds_reference_policy(self):
        store = small_store()
        store.set(P.KEY_PROFILE, "main")
        store.set(P.KEY_BITRATE, 2_000_000)
        enc = tapi.create_video_encoder(store, device="cpu")
        assert enc.init_encoder() == EncoderRetCode.VIDEO_ENCODER_SUCCESS
        cfg = enc.session.cfg
        assert (cfg.rc_mode, cfg.bitrate, cfg.cabac, cfg.deblock, cfg.i4x4,
                cfg.gop_size, cfg.framerate) == ("cbr", 2_000_000, True, True,
                                                 True, 30, 30)

    def test_baseline_profile_disables_cabac(self):
        store = small_store()
        store.set(P.KEY_PROFILE, "baseline")
        enc = tapi.create_video_encoder(store, device="cpu")
        enc.init_encoder()
        assert enc.session.cfg.cabac is False
        assert enc.session.cfg.rc_mode == "cbr"

    def test_api_stream_hits_target_bitrate(self):
        store = small_store(w=64, h=64)
        store.set(P.KEY_PROFILE, "main")
        store.set(P.KEY_BITRATE, 1_000_000)
        enc = tapi.create_video_encoder(store, device="cpu")
        enc.init_encoder()
        enc.start_encoder()
        total, n = 0, 10
        for i in range(n):
            code, data = enc.encode_one_frame(frame_bytes(64, 64, seed=i))
            assert code == EncoderRetCode.VIDEO_ENCODER_SUCCESS
            total += len(data)
        assert total * 8 / n < 4 * 1_000_000 / 30


def test_encoder_statistics_surface():
    store = small_store()
    enc = started(store)
    for i in range(3):
        code, _ = enc.encode_one_frame(FRAMES[i])
        assert code == EncoderRetCode.VIDEO_ENCODER_SUCCESS
    store.set(P.KEY_FORCE_KEYFRAME, "1")
    enc.encode_one_frame(FRAMES[3])
    st = enc.get_encoder_statistics()
    assert st["width"] == 64 and st["height"] == 48
    assert st["input_frame_count"] == 4
    assert st["encoded_bytes"] > 0
    assert st["average_frame_qp"] > 0
    assert st["average_frame_speed_ms"] > 0
    assert st["idr_req_num"] == 1
    assert set(st) == set(jenc.VideoEncoder().get_encoder_statistics())


# ------------------------------------------- what the port keeps literally


def test_encode_failure_is_a_code_and_an_error_line(monkeypatch):
    """encode_one_frame catches every exception of the session and returns
    ENCODE_FAIL (the C contract), and says so through the logger."""
    lines = []
    monkeypatch.setattr(tlog._manager, "_callback",
                        lambda lvl, tag, msg: lines.append((lvl, tag, msg)))
    monkeypatch.setattr(tlog._manager, "_level", tlog.LOG_DEBUG)
    enc = started(small_store())

    def boom(data):
        raise RuntimeError("kernel launch failed")

    monkeypatch.setattr(enc.session, "encode_frame", boom)
    code, data = enc.encode_one_frame(FRAMES[0])
    assert (code, data) == (EncoderRetCode.VIDEO_ENCODER_ENCODE_FAIL, b"")
    assert (tlog.LOG_ERROR, "VideoEncoder",
            "encode failed: kernel launch failed") in lines


def test_bitrate_to_qp_and_policy_equal_the_original():
    for br in (1, 999, 1_000_000, 5_000_000, 10_000_000, 10 ** 9):
        for w, h, fps in ((64, 48, 30), (720, 1280, 30), (1920, 1080, 60)):
            assert (tenc._bitrate_to_qp(br, w, h, fps)
                    == jenc._bitrate_to_qp(br, w, h, fps))
    for profile in ("baseline", "main", "high"):
        p = P.EncodeParams(profile=profile)
        a = tenc.VideoEncoder._reference_policy_config(p, 30)
        b = jenc.VideoEncoder._reference_policy_config(jP.EncodeParams(
            profile=profile), 30)
        assert vars(a) == vars(b)


def test_params_module_equals_the_original():
    assert P.DEFAULTS == jP.DEFAULTS
    keys = [k for k in vars(jP) if k.startswith(("KEY_", "MIN_", "MAX_",
                                                  "VALID_"))]
    assert len(keys) > 15
    for k in keys:
        assert getattr(P, k) == getattr(jP, k), k
    for init in ({}, {P.KEY_BITRATE: "999", P.KEY_GOPSIZE: "5",
                      P.KEY_PROFILE: "x"},
                 {P.KEY_CLOUDPHONE_MODE: "instruction",
                  P.KEY_PERSIST_WIDTH: "320", P.KEY_PERSIST_HEIGHT: "240"}):
        a, b = P.ParamStore(init), jP.ParamStore(init)
        assert vars(P.read_encode_params(a)) == vars(jP.read_encode_params(b))
        assert a._values == b._values  # the same repairs written back
    with pytest.raises(ValueError):
        P.read_encode_params(P.ParamStore({P.KEY_HW_FPS: "25"}))


def test_entry_points_default_to_cuda_and_raise_without_it():
    if torch.cuda.is_available():
        pytest.skip("checks a host without CUDA")
    for call in (lambda: tapi.VideoEncoder(small_store()),
                 lambda: tapi.create_video_encoder(small_store()),
                 lambda: tapi.create_video_encoder(
                     P.ParamStore({P.KEY_ENCODE_FORMAT: "7"}))):
        with pytest.raises(RuntimeError, match="cuda"):
            call()
