"""The port's VideoDecoder (media_tpu_torch/api/decoder_api.py) against
media_tpu's.

Each scenario below drives a decoder through the lifecycle API and returns
its trace: every return code, every event, and the sha256 of every payload
handed out. The scenarios are the decoder cases of tests/test_api.py and
the two API cases of tests/test_decoder_robustness.py (flow control, the
leftover assembly, flush-resume, BAD_PIC_SIZE with its event, recovery
from a corrupt AU, the H.265 route, EOS), plus the hand-over to the scalar
oracle on a B-GOP stream and on a lossless stream. The streams are the
port's own (device="cpu"), at 64x48. The JAX VideoDecoder's trace of
every scenario is read from tests/golden_torch/ (jax_scenarios says what it
was asked; tests/jax_golden.py); the port's must give the same trace
(tolerance 0), and the payloads must be the encoder's recon.
"""

import hashlib
import types

import numpy as np
import pytest
import torch

import chip_smoke as cs
from jax_golden import Golden
from media_tpu_torch import api as tapi
from media_tpu_torch.api import decoder_api as tdec
from media_tpu_torch.api.errors import (CodecFormat, DecoderEvent,
                                        DecoderRetCode)
from media_tpu_torch.core import log as tlog
from media_tpu_torch.core import nal as tnal
from media_tpu_torch.core import params as P
from media_tpu_torch.hevc import HevcEncoderSession
from media_tpu_torch.pipeline.codec import EncoderConfig, EncoderSession
from media_tpu_torch.pipeline.decoder_tpu import TpuDecoder
from media_tpu_torch.ref.decoder import ReferenceDecoder

W, H = 64, 48
SC = b"\x00\x00\x00\x01"
D = DecoderRetCode
FRAMES = cs.clip_i420(W, H, 6)[0]


def _session_stream(n, **kw):
    s = EncoderSession(EncoderConfig(width=W, height=H, qp=30, **kw),
                       device="cpu")
    aus, recon = [], []
    for buf in FRAMES[:n]:
        aus.append(s.encode_frame(buf))
        recon.append(tuple(np.asarray(p.cpu() if hasattr(p, "cpu") else p)
                           for p in s.recon))
    return aus, recon


def _api_stream():
    """IDR, P, P, a forced IDR, P through the port's VideoEncoder."""
    store = P.ParamStore({P.KEY_HW_WIDTH: W, P.KEY_HW_HEIGHT: H})
    enc = tapi.create_video_encoder(store, device="cpu")
    enc.init_encoder()
    enc.start_encoder()
    aus = []
    for i, buf in enumerate(FRAMES[:5]):
        if i == 3:
            store.set(P.KEY_FORCE_KEYFRAME, "1")
        aus.append(bytes(enc.encode_one_frame(buf)[1]))
    return aus


def _hevc_au():
    rng = np.random.default_rng(0)
    w, h = 96, 64
    y = (rng.integers(0, 256, (h, w)) // 2 + 60).astype(np.uint8)
    s = HevcEncoderSession(w, h, qp=30)
    au = s.encode_frame(y, (y[::2, ::2] // 2 + 40).astype(np.uint8),
                        (y[::2, ::2] // 3 + 70).astype(np.uint8))
    return au, tuple(np.asarray(p) for p in s.recon)


def make_streams():
    # The B-GOP's B pictures are not reference pictures: the recon after
    # each AU is the last anchor's, so the payloads are checked against
    # the oracle's own decode instead.
    out = {"api": _api_stream(),
           "gop3": _session_stream(6, gop_size=3)[0],
           "bgop": _session_stream(5, b_frames=1)[0]}
    out["lossless"], out["lossless_recon"] = _session_stream(2, lossless=True)
    out["hevc"], out["hevc_recon"] = _hevc_au()
    return out


@pytest.fixture(scope="module")
def streams():
    return make_streams()


# ------------------------------------------------------------ the scenarios


def _sha(payload) -> str:
    return hashlib.sha256(payload).hexdigest()


def _started(api, kw, trace, fmt=0, **params):
    dec = api.create_video_decoder(**kw)
    trace.append(int(dec.create_decoder(fmt)))
    trace.append(int(dec.init_decoder()))
    dec.set_callbacks(lambda ev, info: trace.append(
        ("event", int(ev), info["width"], info["height"])))
    if params:
        trace.append(int(dec.set_decode_params(**params)))
    trace.append(int(dec.start_decoder()))
    return dec


def _drain(dec, trace):
    while True:
        code, payload, _info = dec.retrieve_frame_data()
        trace.append((int(code), _sha(payload) if payload else None))
        if code not in (D.VIDEO_DECODER_SUCCESS, D.VIDEO_DECODER_BAD_PIC_SIZE):
            return


def full_decode_loop(api, kw, s):
    trace = []
    dec = _started(api, kw, trace, width=W, height=H)
    for au in s["api"][:3]:
        trace.append(int(dec.send_stream_data(au + SC)))
        code, payload, _info = dec.retrieve_frame_data()
        trace.append((int(code), _sha(payload) if payload else None))
    return trace


def underflow_then_eos(api, kw, s):
    trace = []
    dec = _started(api, kw, trace)
    trace.append(int(dec.retrieve_frame_data()[0]))
    trace.append(int(dec.send_stream_data(b"")))  # EOS marker
    trace.append(int(dec.retrieve_frame_data()[0]))
    trace.append(int(dec.retrieve_frame_data()[0]))
    return trace


def pic_info_change_event(api, kw, s):
    trace = []
    dec = _started(api, kw, trace, width=128, height=96)
    trace.append(int(dec.send_stream_data(s["api"][0] + SC)))
    _drain(dec, trace)
    trace.append(dec.get_decode_params())
    return trace


def partial_nal_leftover_assembly(api, kw, s):
    trace = []
    dec = _started(api, kw, trace, width=W, height=H)
    stream = b"".join(s["api"][:2]) + SC
    for i in range(0, len(stream), 37):  # chunks that split NALs
        trace.append(int(dec.send_stream_data(stream[i : i + 37])))
    _drain(dec, trace)
    return trace


def flush_resume_with_saved_headers(api, kw, s):
    trace = []
    dec = _started(api, kw, trace, width=W, height=H)
    trace.append(int(dec.send_stream_data(s["api"][0] + SC)))
    _drain(dec, trace)
    trace.append(int(dec.flush()))
    # The forced IDR without its parameter sets: the saved headers decode it.
    idr_only = b"".join(
        tnal.wrap_nal(n.nal_type, n.rbsp, nal_ref_idc=n.nal_ref_idc)
        for n in tnal.iter_nal_units(s["api"][3]) if n.nal_type == 5)
    trace.append(int(dec.send_stream_data(idr_only + SC)))
    _drain(dec, trace)
    return trace


def write_overflow(api, kw, s):
    """Twelve AUs fed without a retrieve: WRITE_OVERFLOW once eight frames
    wait, then the queue drains and the stream ends."""
    trace = []
    dec = _started(api, kw, trace, width=W, height=H)
    for au in s["gop3"] * 2:
        trace.append(int(dec.send_stream_data(au)))
    _drain(dec, trace)
    trace.append(int(dec.send_stream_data(b"")))
    _drain(dec, trace)
    return trace


def corrupt_au_keeps_session_alive(api, kw, s):
    aus = s["gop3"]  # IDR P P IDR P P
    trace = []
    dec = _started(api, kw, trace, width=W, height=H)
    for au in aus[:3]:
        trace.append(int(dec.send_stream_data(au)))
    trace.append(int(dec.send_stream_data(b"")))
    _drain(dec, trace)
    bad = bytearray(aus[3])
    bad[len(bad) // 2 :] = bytes(len(bad) - len(bad) // 2)
    trace.append(int(dec.send_stream_data(bytes(bad))))
    trace.append(int(dec.send_stream_data(aus[3])))
    trace.append(int(dec.send_stream_data(aus[3])))
    for au in aus[4:]:
        trace.append(int(dec.send_stream_data(au)))
    trace.append(int(dec.send_stream_data(b"")))
    _drain(dec, trace)
    trace.append(int(dec.stop_decoder()))
    return trace


def h265_route(api, kw, s):
    trace = []
    dec = _started(api, kw, trace, fmt=CodecFormat.H265, width=96, height=64)
    trace.append(int(dec.send_stream_data(s["hevc"])))
    trace.append(int(dec.send_stream_data(b"")))
    _drain(dec, trace)
    return trace


def _fallback(name):
    def scenario(api, kw, s):
        trace = []
        dec = _started(api, kw, trace, width=W, height=H)
        inner = dec._fallback_to_reference

        def counted(chunk):
            trace.append(("fallback", _sha(chunk)))
            return inner(chunk)

        dec._fallback_to_reference = counted
        for au in s[name]:
            trace.append(int(dec.send_stream_data(au)))
        trace.append(int(dec.send_stream_data(b"")))
        _drain(dec, trace)
        trace.append(type(dec._decoder).__name__)
        return trace
    scenario.__name__ = f"fallback_{name}"
    return scenario


SCENARIOS = {f.__name__: f for f in (
    full_decode_loop, underflow_then_eos, pic_info_change_event,
    partial_nal_leftover_assembly, flush_resume_with_saved_headers,
    write_overflow, corrupt_au_keeps_session_alive, h265_route,
    _fallback("bgop"), _fallback("lossless"))}


# The JAX side deblocks one wave per scan step: the same planes from smaller
# programs.
GOLDEN = Golden(__file__, env={"MEDIA_TPU_DEBLOCK_UNROLL": "1"})


@GOLDEN.recipe
def jax_scenarios():
    """Every scenario through the JAX package's VideoDecoder on the port's
    streams (make_streams), and the streams' digest."""
    from media_tpu import api as japi

    streams = make_streams()
    return {"streams": streams_digest(streams),
            "traces": {name: f(japi, {}, streams)
                       for name, f in SCENARIOS.items()}}


def streams_digest(streams) -> str:
    """sha256 over make_streams()'s AUs and recon planes."""
    h = hashlib.sha256()

    def feed(x):
        if isinstance(x, bytes):
            h.update(x)
        elif isinstance(x, (list, tuple)):
            for y in x:
                feed(y)
        else:
            h.update(np.ascontiguousarray(x, np.uint8).tobytes())

    for k in sorted(streams):
        h.update(k.encode())
        feed(streams[k])
    return h.hexdigest()


@pytest.fixture(scope="module")
def jax_traces(streams):
    jax = GOLDEN.read(jax_scenarios)
    assert jax["streams"] == streams_digest(streams), \
        "the port's streams are not the recorded ones"
    return jax["traces"]


def payloads(trace):
    return [x[1] for x in trace
            if isinstance(x, tuple) and x[0] == D.VIDEO_DECODER_SUCCESS]


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_scenario_equals_jax(jax_traces, streams, name):
    got = SCENARIOS[name](tapi, {"device": "cpu"}, streams)
    assert got == jax_traces[name]
    if name == "full_decode_loop":
        assert len(payloads(got)) >= 2
    elif name == "underflow_then_eos":
        assert got[-3:] == [D.VIDEO_DECODER_SUCCESS, D.VIDEO_DECODER_EOS,
                            D.VIDEO_DECODER_READ_UNDERFLOW]
    elif name == "pic_info_change_event":
        assert ("event", DecoderEvent.INDEX_PIC_INFO_CHANGE, W, H) in got
        assert (D.VIDEO_DECODER_BAD_PIC_SIZE, None) in got
        assert len(payloads(got)) == 1 and got[-1]["width"] == W
    elif name == "partial_nal_leftover_assembly":
        assert len(payloads(got)) == 2
    elif name == "flush_resume_with_saved_headers":
        assert len(payloads(got)) == 2
    elif name == "write_overflow":
        assert D.VIDEO_DECODER_WRITE_OVERFLOW in got
        assert got[-1] == (D.VIDEO_DECODER_EOS, None)
    elif name == "corrupt_au_keeps_session_alive":
        assert D.VIDEO_DECODER_DECODE_FAIL in got
        assert len(payloads(got)) >= 6 and got[-1] == D.VIDEO_DECODER_SUCCESS
    elif name == "h265_route":
        assert len(payloads(got)) == 1
    else:
        fallbacks = [x for x in got if isinstance(x, tuple)
                     and x[0] == "fallback"]
        assert len(fallbacks) == 1 and got[-1] == "ReferenceDecoder"


def _payload(planes):
    return b"".join(np.ascontiguousarray(p, np.uint8).tobytes()
                    for p in planes)


def test_payloads_are_the_encoders_recon(streams):
    """The API's payloads are the encoder's recon: the lossless stream
    through the oracle after the hand-over, the H.265 picture, and the
    H.264 stream through the device decoder."""
    trace = _fallback("lossless")(tapi, {"device": "cpu"}, streams)
    assert payloads(trace) == [_sha(_payload(r))
                               for r in streams["lossless_recon"]]
    trace = h265_route(tapi, {"device": "cpu"}, streams)
    assert payloads(trace) == [_sha(_payload(streams["hevc_recon"]))]


def test_fallback_carries_state_to_the_oracle(streams, monkeypatch):
    """_fallback_to_reference hands the oracle the device decoder's SPS,
    PPS and reference planes (taken to the host as int32), then decodes the
    chunk with it."""
    dec = tdec.VideoDecoder(device="cpu")
    dec.create_decoder(0)
    aus = streams["api"]
    dec._decoder.decode_annexb(aus[0])
    old = dec._decoder
    frames = dec._fallback_to_reference(aus[1])
    ref = dec._decoder
    assert isinstance(ref, ReferenceDecoder) and isinstance(old, TpuDecoder)
    assert ref.sps is old.sps and ref.pps is old.pps
    assert len(frames) == 1
    want = TpuDecoder(device="cpu")
    want.decode_annexb(aus[0])
    (f,) = want.decode_annexb(aus[1])
    np.testing.assert_array_equal(np.asarray(frames[0].y), f.y)


def test_device_path_error_is_decode_fail_not_a_fallback(streams,
                                                          monkeypatch):
    """An error of the device reconstruction (here the deblocking wrapper
    raising the ValueError of its own plane checks) fails that chunk with
    DECODE_FAIL and an error line; the device decoder stays, and nothing
    goes to the scalar oracle. Only the parse hands a stream over."""
    from media_tpu_torch.pipeline import deblock_apply

    def broken(*args, **kwargs):
        raise ValueError("planes do not match the picture's geometry")

    lines = []
    monkeypatch.setattr(tlog._manager, "_callback",
                        lambda lvl, tag, msg: lines.append((lvl, tag, msg)))
    monkeypatch.setattr(tlog._manager, "_level", tlog.LOG_DEBUG)
    monkeypatch.setattr(deblock_apply, "deblock_wave", broken)
    with pytest.raises(ValueError, match="geometry"):
        TpuDecoder(device="cpu").decode_annexb(streams["api"][0])
    dec = tdec.VideoDecoder(device="cpu")
    fallbacks = []
    dec._fallback_to_reference = fallbacks.append
    for code in (dec.create_decoder(0), dec.init_decoder(),
                 dec.set_decode_params(width=W, height=H),
                 dec.start_decoder()):
        assert code == D.VIDEO_DECODER_SUCCESS
    assert (dec.send_stream_data(streams["api"][0] + SC)
            == D.VIDEO_DECODER_DECODE_FAIL)
    assert fallbacks == [] and isinstance(dec._decoder, TpuDecoder)
    assert dec.retrieve_frame_data()[0] == D.VIDEO_DECODER_READ_UNDERFLOW
    said = [(lvl, m) for lvl, tag, m in lines if tag == "VideoDecoder"]
    assert said == [(tlog.LOG_ERROR, "decode failed: planes do not match "
                     "the picture's geometry")]


def test_backend_values_as_the_code_reads_them():
    """Only "ref" selects the scalar oracle; any other value (the docstring
    names "tpu" and "reference") the device decoder, as in the original."""
    assert isinstance(tdec.VideoDecoder("ref", device="cpu")._decoder,
                      ReferenceDecoder)
    for backend in ("auto", "tpu", "reference"):
        d = tdec.VideoDecoder(backend, device="cpu")._decoder
        assert isinstance(d, TpuDecoder) and d.device == torch.device("cpu")


def test_perf_dec_fps_log_once_a_second(streams, monkeypatch):
    lines = []
    monkeypatch.setattr(tlog._manager, "_callback",
                        lambda lvl, tag, msg: lines.append((tag, msg)))
    monkeypatch.setattr(tlog._manager, "_level", tlog.LOG_DEBUG)
    clock = iter([100.0, 100.4, 101.5, 101.6])
    monkeypatch.setattr(tdec, "time", types.SimpleNamespace(
        monotonic=lambda: next(clock)))
    dec = tdec.VideoDecoder(device="cpu")  # reads 100.0
    dec.create_decoder(0)
    dec.init_decoder()
    dec.set_decode_params(width=W, height=H)
    dec.start_decoder()
    dec.send_stream_data(b"".join(streams["api"][:3]) + SC)
    for _ in range(3):  # frames at 100.4, 101.5 (a line: 2 in 1.5 s), 101.6
        assert dec.retrieve_frame_data()[0] == D.VIDEO_DECODER_SUCCESS
    assert [m for t, m in lines if t == "VideoDecoder"] == [
        "PERF-DEC-FPS: 1.33"]


def test_ret_code_values_match_reference():
    from media_tpu.api import errors as jerr
    from media_tpu_torch.api import errors as terr

    for cls in ("EncoderRetCode", "DecoderRetCode", "DecoderEvent",
                "PixelFormat", "CodecFormat"):
        a, b = getattr(jerr, cls), getattr(terr, cls)
        assert [(m.name, int(m)) for m in a] == [(m.name, int(m)) for m in b]
    E, Dc = terr.EncoderRetCode, terr.DecoderRetCode
    assert [int(x) for x in list(E)[:11]] == list(range(0x0B))
    assert [int(x) for x in list(Dc)[:15]] == list(range(15))
    assert int(E.VIDEO_ENCODER_NOT_INITED) >= 0x100
    assert int(Dc.VIDEO_DECODER_NOT_INITED) >= 0x100


def test_entry_points_default_to_cuda_and_raise_without_it():
    if torch.cuda.is_available():
        pytest.skip("checks a host without CUDA")
    for call in (tapi.create_video_decoder, tapi.VideoDecoder,
                 lambda: tdec.VideoDecoder("ref")):
        with pytest.raises(RuntimeError, match="cuda"):
            call()
