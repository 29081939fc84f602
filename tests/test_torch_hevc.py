"""The port's HEVC slot (media_tpu_torch/hevc/) against media_tpu.hevc.

The cases of tests/test_hevc.py on the port, each also run through the JAX
package's copy on the same seeded input: parameter sets, AUs and CBR frame
sizes byte for byte, the planes of the mirror decoder and of the
independent oracle decoder equal, and both equal to the encoder's recon.
Then the format-2 factories of both APIs. Tolerance 0 (numpy on both
sides).
"""

import numpy as np
import pytest

from media_tpu import hevc as jhevc
from media_tpu.api import encoder_api as jenc
from media_tpu.core import params as jP
from media_tpu.hevc import codec as jcodec
from media_tpu.hevc import ref_decoder as jref
from media_tpu.hevc import syntax as jS
from media_tpu_torch import api as tapi
from media_tpu_torch.api.errors import CodecFormat, EncoderRetCode
from media_tpu_torch.core.bitstream import BitReader, BitWriter
from media_tpu_torch.core import params as P
from media_tpu_torch.hevc import HevcEncoderSession, HevcRefDecoder
from media_tpu_torch.hevc import codec as tcodec
from media_tpu_torch.hevc import ref_decoder as tref
from media_tpu_torch.hevc import syntax as S
from media_tpu_torch.utils import yuv


def _same_planes(a, b):
    for p in "yuv":
        np.testing.assert_array_equal(np.asarray(getattr(a, p)),
                                      np.asarray(getattr(b, p)), p)


def test_parameter_set_roundtrip():
    out = []
    for syn in (S, jS):
        sets = (syn.HevcSPS(width=1920, height=1088, conf_bottom=4),
                syn.HevcPPS(init_qp=33), syn.HevcVPS())
        raw = []
        for ps in sets:
            w = BitWriter()
            ps.write(w)
            w.rbsp_trailing_bits()
            raw.append(w.get_bytes())
        out.append(raw)
    assert out[0] == out[1]
    sps, pps, vps = (cls.parse(BitReader(r)) for cls, r in zip(
        (S.HevcSPS, S.HevcPPS, S.HevcVPS), out[0]))
    assert (sps.width, sps.height, sps.conf_bottom) == (1920, 1088, 4)
    assert pps.init_qp == 33 and vps.vps_id == 0


def scene(w, h, seed=0):
    rng = np.random.default_rng(seed)
    big = rng.integers(0, 256, (h + 8, w + 8)).astype(np.int32)
    big = (big + np.roll(big, 1, 0) + np.roll(big, 1, 1)
           + np.roll(big, 3, 1)) // 4
    y = big[:h, :w].astype(np.uint8)
    u = (big[: h // 2, : w // 2] // 2 + 40).astype(np.uint8)
    v = (big[: h // 2, : w // 2] // 3 + 70).astype(np.uint8)
    return y, u, v


@pytest.mark.parametrize("qp", [24, 34])
def test_hevc_frame_roundtrip(qp):
    w, h = 64, 48
    y, u, v = scene(w, h)
    sess = HevcEncoderSession(w, h, qp=qp)
    jsess = jhevc.HevcEncoderSession(w, h, qp=qp)
    au = sess.encode_frame(y, u, v)
    assert au == jsess.encode_frame(y, u, v)
    assert [t for t, _ in S.parse_hevc_nals(au)] == [
        S.NAL_VPS, S.NAL_SPS, S.NAL_PPS, S.NAL_IDR_W_RADL]
    dec, jdec = HevcRefDecoder(), jhevc.HevcRefDecoder()
    (f,), (g,) = dec.decode_annexb(au), jdec.decode_annexb(au)
    _same_planes(f, g)
    for p, r in zip((f.y, f.u, f.v), sess.recon):
        np.testing.assert_array_equal(p, r)
    assert yuv.psnr(f.y[:h, :w], y) > (37 if qp == 24 else 26)
    # The second AU omits the parameter sets but still decodes.
    au2 = sess.encode_frame(y, u, v)
    assert au2 == jsess.encode_frame(y, u, v)
    assert [t for t, _ in S.parse_hevc_nals(au2)] == [S.NAL_IDR_W_RADL]
    np.testing.assert_array_equal(dec.decode_annexb(au2)[0].y, sess.recon[0])


def test_hevc_oracle_matches_mirror_and_recon():
    w, h = 96, 64
    rng = np.random.default_rng(7)
    base = rng.integers(0, 256, (h + 32, w + 32)).astype(np.int32)
    for _ in range(2):
        base = (base + np.roll(base, 1, 0) + np.roll(base, 1, 1)) // 3
    gy, gx = np.mgrid[0:h, 0:w]
    y = np.clip(base[:h, :w] // 2 + (gx + 2 * gy) % 200, 0,
                255).astype(np.uint8)
    u = (y[::2, ::2] // 2 + 40).astype(np.uint8)
    v = (y[::2, ::2] // 3 + 70).astype(np.uint8)
    s = HevcEncoderSession(w, h, qp=28)
    au = s.encode_frame(y, u, v)
    assert au == jhevc.HevcEncoderSession(w, h, qp=28).encode_frame(y, u, v)
    mir = HevcRefDecoder().decode_annexb(au)[0]
    ora = tref.HevcOracleDecoder().decode_annexb(au)[0]
    _same_planes(mir, ora)
    _same_planes(ora, jref.HevcOracleDecoder().decode_annexb(au)[0])
    np.testing.assert_array_equal(np.asarray(s.recon[0]), ora.y)
    np.testing.assert_array_equal(np.asarray(s.recon[1]), ora.u)


def test_hevc_angular_modes_used():
    gy, gx = np.mgrid[0:64, 0:64]
    y = ((gx + 3 * gy) % 220).astype(np.int64)
    u = np.full((32, 32), 90, np.int64)
    v = np.full((32, 32), 120, np.int64)
    payload, recon = tcodec.encode_slice_data(y, u, v, 28)
    jpayload, jrecon = jcodec.encode_slice_data(y, u, v, 28)
    assert payload == jpayload
    for a, b in zip(recon, jrecon):
        np.testing.assert_array_equal(a, b)
    yv, _uv, _vv = tcodec.decode_slice_data(payload, 0, 64, 64, 28)
    np.testing.assert_array_equal(np.clip(recon[0], 0, 255), yv)


def test_hevc_cbr_honors_bitrate():
    """Format-2 CBR: the slice QP adapts per frame to the bitrate; the
    frame sizes are the JAX session's, frame for frame."""
    rng = np.random.default_rng(0)
    w, h, fps, bitrate = 96, 64, 30, 600_000
    s, js = HevcEncoderSession(w, h, qp=30), jhevc.HevcEncoderSession(w, h,
                                                                       qp=30)
    s.enable_cbr(bitrate, fps)
    js.enable_cbr(bitrate, fps)
    dec = tref.HevcOracleDecoder()
    base = rng.integers(0, 256, (h + 16, w + 16)).astype(np.float64)
    for _ in range(2):
        base = (base + np.roll(base, 1, 0) + np.roll(base, 1, 1)) / 3
    sizes = []
    for t in range(12):
        y = base[t : t + h, t : t + w].astype(np.uint8)
        u = (y[::2, ::2] // 2 + 40).astype(np.uint8)
        v = (y[::2, ::2] // 3 + 60).astype(np.uint8)
        au = s.encode_frame(y, u, v)
        assert au == js.encode_frame(y, u, v), t
        sizes.append(len(au) * 8)
        frames = dec.decode_annexb(au)
        np.testing.assert_array_equal(np.asarray(frames[0].y),
                                      np.asarray(s.recon[0]))
    target = bitrate / fps
    avg = sum(sizes[4:]) / len(sizes[4:])
    assert abs(avg - target) / target < 0.25, (avg, target, sizes)


def _store(params, w=64, h=48):
    store = params.ParamStore()
    store.set(params.KEY_ENCODE_FORMAT, "2")
    store.set(params.KEY_HW_WIDTH, str(w))
    store.set(params.KEY_HW_HEIGHT, str(h))
    return store


def test_factory_format_2():
    """The format-2 slot of both APIs: the same codes, the same AU, and the
    port's decoder API returns the encoder's recon."""
    y, u, v = scene(64, 48)
    buf = yuv.pack_i420(y, u, v)
    out = []
    for api, params, kw in ((tapi, P, {"device": "cpu"}),
                            (jenc, jP, {})):
        enc = api.create_video_encoder(_store(params), **kw)
        assert enc is not None and enc._codec == CodecFormat.H265
        codes = [enc.init_encoder(), enc.start_encoder()]
        code, au = enc.encode_one_frame(buf)
        out.append(([int(c) for c in codes + [code]], au))
    assert out[0] == out[1]
    assert out[0][0] == [EncoderRetCode.VIDEO_ENCODER_SUCCESS] * 3
    assert HevcRefDecoder().decode_annexb(out[0][1])
    dec = tapi.create_video_decoder(device="cpu")
    dec.create_decoder(CodecFormat.H265)
    dec.init_decoder()
    dec.set_decode_params(width=64, height=48)
    dec.start_decoder()
    dec.send_stream_data(out[0][1])
    dec.send_stream_data(b"")
    code, payload, _info = dec.retrieve_frame_data()
    assert code == 0
    want = jhevc.HevcRefDecoder().decode_annexb(out[0][1])[0]
    assert payload == want.y.tobytes() + want.u.tobytes() + want.v.tobytes()
