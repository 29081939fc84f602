"""Third-party conformance of the port: its streams through libavcodec, and
libx264 streams through its decoders. The twin of tests/test_conformance.py,
case for case, on media_tpu_torch (EncoderSession(device="cpu"),
ref.decoder.ReferenceDecoder, testing.avref).

The port's in-repo oracle (ref/decoder.py) shares CAVLC tables and MV
prediction with its encoder, and the JAX package shares them too, so a
transcription fault in a shared layer is invisible to both and to any
comparison between them. ffmpeg's h264 decoder is independent: every
encoder feature must give streams that ffmpeg reconstructs BIT-EXACTLY to
the port's reconstruction, and the port's decoders must match ffmpeg bit
for bit on streams of the independent libx264 encoder. One case more than
the original: the port's VideoDecoder (the device decoder behind the API,
on the CPU) on the libx264 streams, handing over to the scalar oracle as
often as the JAX VideoDecoder does (its hand-overs read from
tests/golden_torch/; jax_x264_handovers says what it was asked;
tests/jax_golden.py). Skipped where the system libavcodec is unavailable,
as the original is.
"""

import numpy as np
import pytest

import chip_smoke as cs
from jax_golden import Digest, Golden
from media_tpu_torch import api as tapi
from media_tpu_torch.pipeline.codec import EncoderConfig, EncoderSession
from media_tpu_torch.ref.decoder import ReferenceDecoder
from media_tpu_torch.testing import avref
from media_tpu_torch.utils import yuv


@pytest.fixture(autouse=True, scope="module")
def _needs_libavcodec():
    if not avref.available():
        pytest.skip(f"libavcodec shim unavailable: {avref.build_error()}")


def _smooth(w, h, seed):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (h + 40, w + 40)).astype(np.float64)
    for _ in range(2):
        base = (base + np.roll(base, 1, 0) + np.roll(base, 1, 1)) / 3
    frames = []
    for t in range(4):
        y = base[t : t + h, 2 * t : 2 * t + w]
        y = ((y - y.min()) / (base.max() - base.min() + 1e-9) * 200 + 20)
        y = y.astype(np.uint8)
        u = (y[::2, ::2] // 2 + 40).astype(np.uint8)
        v = (y[::2, ::2] // 3 + 60).astype(np.uint8)
        frames.append((y, u, v))
    return frames


def _session(w, h, **kw):
    return EncoderSession(EncoderConfig(width=w, height=h, **kw),
                          device="cpu")


def _assert_ffmpeg_exact(sess, aus, w, h):
    dec = avref.decode(b"".join(aus))
    assert len(dec) == len(aus)
    ry = cs._host(sess.recon[0])[:h, :w]
    ru = cs._host(sess.recon[1])[: h // 2, : w // 2]
    rv = cs._host(sess.recon[2])[: h // 2, : w // 2]
    np.testing.assert_array_equal(ry, dec[-1][0])
    np.testing.assert_array_equal(ru, dec[-1][1])
    np.testing.assert_array_equal(rv, dec[-1][2])


def _encode_each(sess, frames):
    return [sess.encode_frame(yuv.pack_i420(*f)) for f in frames]


@pytest.mark.parametrize("deblock", [False, True])
@pytest.mark.parametrize("i4x4", [False, True])
def test_intra_stream_ffmpeg_exact(deblock, i4x4):
    w, h = 48, 48
    sess = _session(w, h, qp=28, gop_size=1, deblock=deblock, i4x4=i4x4)
    aus = _encode_each(sess, _smooth(w, h, 1))
    _assert_ffmpeg_exact(sess, aus, w, h)


@pytest.mark.parametrize("deblock", [False, True])
def test_ippp_stream_ffmpeg_exact(deblock):
    w, h = 64, 48
    sess = _session(w, h, qp=28, gop_size=30, deblock=deblock)
    aus = _encode_each(sess, _smooth(w, h, 2))
    _assert_ffmpeg_exact(sess, aus, w, h)


@pytest.mark.slow
def test_ippp_1080p_class_ffmpeg_exact():
    """A larger multi-MB-row frame: exercises nC propagation, skip runs and
    deblock across many wavefronts."""
    w, h = 176, 96
    sess = _session(w, h, qp=30, gop_size=30, deblock=True, i4x4=True)
    aus = _encode_each(sess, _smooth(w, h, 3))
    _assert_ffmpeg_exact(sess, aus, w, h)


def test_cavlc_block_fuzz_ffmpeg_exact():
    """Differential fuzz of the CAVLC residual layer: single-MB I16 streams
    with crafted coefficient arrays, the port's oracle against ffmpeg (the
    harness that caught the TOTAL_ZEROS tc=4 transcription fault)."""
    from media_tpu_torch.core.bitstream import BitWriter
    from media_tpu_torch.core.nal import H264NalType, wrap_nal
    from media_tpu_torch.core.syntax import PPS, SPS, SliceHeader
    from media_tpu_torch.pipeline import slice_coder

    rng = np.random.default_rng(7)

    def rand_block(n, density, mag):
        b = np.zeros(n, np.int32)
        k = rng.integers(0, max(1, int(n * density)) + 1)
        pos = rng.choice(n, size=k, replace=False)
        b[pos] = rng.integers(1, mag + 1, size=k) * rng.choice([-1, 1], size=k)
        return b

    sps = SPS.for_size(16, 16)
    pps = PPS(pic_init_qp=28, deblocking_filter_control_present=True)
    sps_w = BitWriter(); sps.write(sps_w); sps_w.rbsp_trailing_bits()
    pps_w = BitWriter(); pps.write(pps_w); pps_w.rbsp_trailing_bits()
    head = (wrap_nal(H264NalType.SPS, sps_w.get_bytes())
            + wrap_nal(H264NalType.PPS, pps_w.get_bytes()))
    mode16 = np.full((1, 1), 2, np.int32)
    cm = np.zeros((1, 1), np.int32)
    for t in range(60):
        density = [0.1, 0.4, 1.0][t % 3]
        mag = [1, 3, 8][(t // 3) % 3]
        dc = np.zeros((1, 1, 16), np.int32)
        dc[0, 0] = rand_block(16, density, mag)
        ac = np.zeros((1, 1, 16, 15), np.int32)
        for b in range(16):
            ac[0, 0, b] = rand_block(15, density, mag)
        cdc = np.zeros((1, 1, 2, 4), np.int32)
        cac = np.zeros((1, 1, 2, 4, 15), np.int32)
        for comp in range(2):
            cdc[0, 0, comp] = rand_block(4, density, mag)
            for b in range(4):
                cac[0, 0, comp, b] = rand_block(15, density, mag)
        bw = BitWriter()
        SliceHeader(slice_type=7, idr=True, frame_num=0,
                    slice_qp_delta=0,
                    disable_deblocking_filter_idc=1).write(bw, sps, pps)
        slice_coder.write_islice_mbs(
            bw, mode16=mode16, chroma_mode=cm, dc_levels=dc, ac_levels=ac,
            cdc_levels=cdc, cac_levels=cac)
        bw.rbsp_trailing_bits()
        bs = head + wrap_nal(H264NalType.IDR_SLICE, bw.get_bytes(),
                             nal_ref_idc=3)
        ours = ReferenceDecoder().decode_annexb(bs)[0]
        ff = avref.decode(bs)[0]
        np.testing.assert_array_equal(ours.y, ff[0], err_msg=f"trial {t}")
        np.testing.assert_array_equal(ours.u, ff[1], err_msg=f"trial {t}")
        np.testing.assert_array_equal(ours.v, ff[2], err_msg=f"trial {t}")


@pytest.mark.parametrize("idc", [0, 1, 2])
def test_cabac_ippp_ffmpeg_exact(idc):
    """CABAC end to end: the engine's tables, the init tables and the
    ctxIdxInc rules."""
    w, h = 64, 48
    sess = _session(w, h, qp=28, gop_size=30, deblock=True, cabac=True,
                    cabac_init_idc=idc)
    aus = _encode_each(sess, _smooth(w, h, 5 + idc))
    _assert_ffmpeg_exact(sess, aus, w, h)


def test_cabac_i4x4_cbr_ffmpeg_exact():
    """The reference operating point (CABAC + CBR + deblock + I4x4) must be
    third-party decodable."""
    w, h = 64, 48
    sess = _session(w, h, qp=28, gop_size=30, deblock=True, cabac=True,
                    i4x4=True, rc_mode="cbr", bitrate=300_000, framerate=30)
    aus = _encode_each(sess, _smooth(w, h, 9))
    _assert_ffmpeg_exact(sess, aus, w, h)


X264_BASELINE = ("cabac=0:ref=1:partitions=none:me=dia:subme=0:trellis=0:"
                 "weightp=0:8x8dct=0:scenecut=0:bframes=0:threads=1:"
                 "sliced-threads=0")
X264_COMMON = ("cabac=0:me=hex:subme=4:trellis=0:weightp=0:8x8dct=0:"
               "scenecut=0:bframes=0:threads=1:sliced-threads=0")


def _x264_streams():
    """The libx264 streams of the original's two decoder-direction tests:
    (name, stream)."""
    frames = _smooth(64, 48, 4)
    out = [("baseline", avref.encode_h264(frames, qp=26, gop=30,
                                          x264_params=X264_BASELINE))]
    frames = _smooth(96, 64, 13)
    frames = frames + [frames[1], frames[0]]  # some reordering-ish motion
    for name, params in (("ref1", X264_COMMON + ":ref=1"),
                         ("ref3_p8x8", X264_COMMON
                          + ":ref=3:partitions=p8x8,i4x4")):
        out.append((name, avref.encode_h264(frames, qp=26, gop=30,
                                            x264_params=params)))
    return out


def _assert_equal_to_ffmpeg(frames, ff, what):
    assert len(frames) == len(ff)
    for i, (f, (fy, fu, fv)) in enumerate(zip(frames, ff)):
        np.testing.assert_array_equal(f.y, fy, err_msg=f"Y {i} {what}")
        np.testing.assert_array_equal(f.u, fu, err_msg=f"U {i} {what}")
        np.testing.assert_array_equal(f.v, fv, err_msg=f"V {i} {what}")


def test_x264_stream_our_decoder_exact():
    """Decoder direction: an independent encoder's (libx264) stream must
    decode bit-exactly to what ffmpeg decodes, within the supported
    envelope (baseline-ish: CAVLC, 1 ref, 16x16 partitions)."""
    bs = _x264_streams()[0][1]
    _assert_equal_to_ffmpeg(ReferenceDecoder().decode_annexb(bs),
                            avref.decode(bs), "baseline")


def test_lossless_roundtrip_ffmpeg_exact():
    """Lossless (I_PCM) reproduces the INPUT samples exactly through an
    independent decoder."""
    w, h = 64, 48
    frames = _smooth(w, h, 7)[:3]
    sess = _session(w, h, lossless=True)
    dec = avref.decode(b"".join(_encode_each(sess, frames)))
    assert len(dec) == len(frames)
    for (y, u, v), (dy, du, dv) in zip(frames, dec):
        np.testing.assert_array_equal(y, dy)
        np.testing.assert_array_equal(u, du)
        np.testing.assert_array_equal(v, dv)


def test_cabac_adaptive_qp_cbr_ffmpeg_exact():
    """CABAC + CBR + per-MB adaptive QP in one stream: mb_qp_delta through
    the CABAC path."""
    w, h = 64, 48
    sess = _session(w, h, qp=28, gop_size=30, deblock=True, cabac=True,
                    adaptive_qp=True, rc_mode="cbr", bitrate=300_000,
                    framerate=30)
    aus = _encode_each(sess, _smooth(w, h, 11))
    _assert_ffmpeg_exact(sess, aus, w, h)


def test_x264_partitions_multiref_our_decoder_exact():
    """x264 streams with default partitioning (16x8/8x16/P_8x8 with all
    sub-shapes) and multi-reference P (ref=3) decode bit-exactly to
    ffmpeg."""
    for name, bs in _x264_streams()[1:]:
        _assert_equal_to_ffmpeg(ReferenceDecoder().decode_annexb(bs),
                                avref.decode(bs), name)


def test_bframes_ffmpeg_exact():
    """The IBPBP GOP decodes bit-exactly in ffmpeg and in the port's
    oracle, with and without anchor deblocking."""
    frames = _smooth(64, 48, 17)[:4] + _smooth(64, 48, 18)[:3]
    for deblock in (False, True):
        sess = _session(64, 48, qp=28, gop_size=30, deblock=deblock,
                        b_frames=1)
        aus = sess.encode_frames([yuv.pack_i420(*f) for f in frames])
        assert len(aus) == len(frames)
        stream = b"".join(aus)
        ours = sorted(ReferenceDecoder().decode_annexb(stream),
                      key=lambda f: f.poc)
        _assert_equal_to_ffmpeg(ours, avref.decode(stream),
                                f"deblock={deblock}")


# ------------------------------------------- the API's decoder on x264


@pytest.fixture(scope="module")
def x264():
    return dict(_x264_streams())


# The JAX device decoder deblocks one wave per scan step.
GOLDEN = Golden(__file__, env={"MEDIA_TPU_DEBLOCK_UNROLL": "1"})


@GOLDEN.recipe
def jax_x264_handovers():
    """The JAX VideoDecoder's hand-overs to its scalar oracle on each
    libx264 stream, and each stream's digest."""
    from media_tpu import api as japi

    return {name: {"stream": Digest.of(np.frombuffer(bs, np.uint8)),
                   "fallbacks": cs.drive_api_decode(japi, [bs])["fallbacks"]}
            for name, bs in _x264_streams()}


@pytest.fixture(scope="module")
def jax_handovers(x264):
    want = GOLDEN.read(jax_x264_handovers)
    for name, bs in x264.items():
        assert want[name]["stream"] == np.frombuffer(bs, np.uint8), \
            f"libx264 made another {name} stream than the recorded one"
    return {name: w["fallbacks"] for name, w in want.items()}


@pytest.mark.parametrize("name", ["baseline", "ref1", "ref3_p8x8"])
def test_x264_stream_through_the_api_decoder(x264, jax_handovers, name):
    """The port's VideoDecoder on the CPU: every payload is ffmpeg's
    picture, and it hands the stream to the scalar oracle exactly as often
    as the JAX VideoDecoder does on the same stream."""
    got = cs.drive_api_decode(tapi, [x264[name]], device="cpu")
    ff = avref.decode(x264[name])
    assert not any(got["codes"])
    assert got["payloads"] == [y.tobytes() + u.tobytes() + v.tobytes()
                               for y, u, v in ff]
    assert got["fallbacks"] == jax_handovers[name]
    if name == "baseline":
        assert got["fallbacks"] == 1


def test_avref_reports_its_build_error(tmp_path, monkeypatch):
    """A shim that does not build: available() is False and build_error()
    holds the compiler's message, for chip_smoke.py to print (and to pass
    over only when libavcodec itself is what is missing)."""
    (tmp_path / "avshim.c").write_text("#include <no_such_header.h>\n")
    monkeypatch.setattr(avref, "_CSRC", str(tmp_path))
    monkeypatch.setattr(avref, "_LIB", None)
    monkeypatch.setattr(avref, "_TRIED", False)
    monkeypatch.setattr(avref, "_BUILD_ERROR", "")
    assert not avref.available()
    assert "no_such_header.h" in avref.build_error()
    assert not cs.avref_unavailable(avref.build_error())
    assert cs.avref_unavailable(
        "avshim.c:16:10: fatal error: libavcodec/avcodec.h: No such file or "
        "directory")
    assert cs.avref_unavailable("/usr/bin/ld: cannot find -lavcodec: No "
                                "such file or directory")
