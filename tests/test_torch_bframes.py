"""media_tpu_torch's B-GOP and lossless sessions against media_tpu's:
byte-identical access units.

b_frames=1 (IBPBP in display order, every B coded after its future anchor)
over an odd and an even run with an IDR falling inside it, the SPS with POC
type 0 compared on its own, the B core and the B-slice writer on their own,
load_reference_state mid-B-GOP; lossless (all I_PCM), single- and
multi-slice and on the all-zero frame whose bytes need emulation prevention.
media_tpu's ReferenceDecoder decodes the port's B stream to the source order
and the lossless stream to the exact input; the port's TpuDecoder refuses
both as the JAX one does. The JAX sessions and B core are read from
tests/golden_torch/ (the recipes say what they were asked;
tests/jax_golden.py); they deblocked one wave per scan step (same bytes,
smaller programs). The JAX package's B-slice writer, its configuration
checks and its decoder's refusals run live. Tolerance 0.
"""

import numpy as np
import pytest

from jax_golden import Golden
from media_tpu.core.bitstream import BitWriter as JBitWriter
from media_tpu.pipeline import decoder_tpu as jdec
from media_tpu.pipeline import slice_coder as jsc
from media_tpu.pipeline.codec import EncoderConfig as JaxConfig
from media_tpu.pipeline.codec import EncoderSession as JaxSession
from media_tpu.ref.decoder import ReferenceDecoder
from media_tpu_torch.core import nal as tnal
from media_tpu_torch.core.bitstream import BitWriter
from media_tpu_torch.pipeline import decoder_tpu as tdec
from media_tpu_torch.pipeline import encoder as tenc
from media_tpu_torch.pipeline import slice_coder as tsc
from media_tpu_torch.pipeline.codec import EncoderConfig, EncoderSession
from media_tpu_torch.utils import yuv

W, H, QP, GOP = 64, 48, 28, 4
GOLDEN = Golden(__file__, env={"MEDIA_TPU_DEBLOCK_UNROLL": "1"})


def clip(n, w=W, h=H, seed=0):
    """Textured pan with a moving bright block (I420 buffers)."""
    rng = np.random.default_rng(seed)
    big = rng.integers(0, 256, (h + 48, w + 48)).astype(np.float64)
    for _ in range(2):
        big = (big + np.roll(big, 1, 0) + np.roll(big, 1, 1)) / 3
    out = []
    for t in range(n):
        y = big[2 * t : 2 * t + h, 3 * t : 3 * t + w].copy()
        y[10:22, 5 + 5 * t : 17 + 5 * t] = 235
        y = (y + rng.normal(0, 1.5, y.shape)).round().clip(0, 255).astype(
            np.uint8)
        out.append(yuv.pack_i420(y, (y[::2, ::2] // 2 + 40).astype(np.uint8),
                                 (y[::2, ::2] // 3 + 70).astype(np.uint8)))
    return out


FRAMES = clip(7)


def bcfg(cls, **kw):
    return cls(width=W, height=H, qp=QP, gop_size=GOP, b_frames=1, **kw)


# ------------------------------------------------------------------ B-GOP


@GOLDEN.recipe(cases=[6, 7])
def jax_bgop(n):
    """The JAX B-GOP session's AUs of n frames in one encode_frames call,
    and its counters after them."""
    js = JaxSession(bcfg(JaxConfig))
    aus = js.encode_frames(FRAMES[:n])
    return {"aus": aus, "counters": [js._display_since_idr,
                                     js._ref_frame_num, js.frame_idx]}


@pytest.mark.parametrize("n", [6, 7])
def test_bgop_session_matches_jax(n):
    """gop_size 4: the IDR due at display 4 falls inside the run; the odd
    run ends on a lone anchor."""
    js = GOLDEN.read(jax_bgop, n)
    want = js["aus"]
    for coder in ("native", "python"):
        s = EncoderSession(bcfg(EncoderConfig), device="cpu",
                           host_coder=coder)
        got = s.encode_frames(FRAMES[:n])
        assert got == want, coder
    assert len(got) == n
    assert [s._display_since_idr, s._ref_frame_num,
            s.frame_idx] == js["counters"]
    # The SPS NAL on its own: POC type 0, two reference frames.
    sps_j, sps_t = (next(nu for nu in tnal.iter_nal_units(aus[0])
                         if nu.nal_type == 7).rbsp for aus in (want, got))
    assert sps_j == sps_t
    assert s.sps.pic_order_cnt_type == 0 and s.sps.max_num_ref_frames == 2
    idrs = [i for i, au in enumerate(got)
            if any(nu.nal_type == 5 for nu in tnal.iter_nal_units(au))]
    assert idrs == [0, 4]


@GOLDEN.recipe
def jax_single_frame_calls():
    """The JAX B-GOP session's AUs of three encode_frame calls."""
    js = JaxSession(bcfg(JaxConfig))
    return [js.encode_frame(buf) for buf in FRAMES[:3]]


def test_single_frame_calls_in_b_mode_encode_anchors():
    s = EncoderSession(bcfg(EncoderConfig), device="cpu")
    want = GOLDEN.read(jax_single_frame_calls)
    assert [s.encode_frame(buf) for buf in FRAMES[:3]] == want


@GOLDEN.recipe
def jax_bgop_state():
    """The JAX B-GOP session's state after IDR, P, B and its AUs of the
    rest of FRAMES."""
    js = JaxSession(bcfg(JaxConfig))
    js.encode_frames(FRAMES[:3])  # IDR, P, B
    state = {
        "recon": tuple(np.asarray(p) for p in js.recon),
        "frame_idx": js.frame_idx, "frame_idx_of_idr": js.frame_idx_of_idr,
        "idr_pic_id": js.idr_pic_id, "_bits_hwm": js._bits_hwm,
        "_display_since_idr": js._display_since_idr,
        "_ref_frame_num": js._ref_frame_num,
    }
    return state, js.encode_frames(FRAMES[3:])


def test_load_reference_state_continues_a_jax_bgop():
    state, want = GOLDEN.read(jax_bgop_state)
    s = EncoderSession(bcfg(EncoderConfig), device="cpu")
    s.load_reference_state(state)
    assert s.encode_frames(FRAMES[3:]) == want


def test_b_requires_cavlc_cq_single_slice():
    for kw in (dict(cabac=True), dict(rc_mode="cbr"), dict(num_slices=2)):
        for cls, cfg_cls, extra in ((JaxSession, JaxConfig, {}),
                                    (EncoderSession, EncoderConfig,
                                     {"device": "cpu"})):
            with pytest.raises(ValueError, match="b_frames requires"):
                cls(bcfg(cfg_cls, **kw), **extra)


@GOLDEN.recipe
def jax_bframe_core():
    """The JAX FrameEncoder's encode_bframe on three frames of seed 4."""
    from media_tpu.pipeline import encoder as jenc

    ref0, cur, ref1 = [yuv.split_i420(b, W, H) for b in clip(3, seed=4)]
    out = jenc.FrameEncoder(W, H).encode_bframe(*cur, ref0, ref1, QP + 2)
    return {k: np.asarray(v) for k, v in out.items()}


def test_bframe_core_matches_jax():
    frames = [yuv.split_i420(b, W, H) for b in clip(3, seed=4)]
    ref0, cur, ref1 = frames
    want = GOLDEN.read(jax_bframe_core)
    got = tenc.FrameEncoder(W, H, "cpu").encode_bframe(*cur, ref0, ref1,
                                                       QP + 2)
    assert want.keys() == got.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert np.any(got["mv0"] != got["mv1"]) and np.any(got["luma_levels"])


def test_bslice_writer_copy_matches_original():
    rng = np.random.default_rng(3)
    R, C = 2, 3
    sym = dict(mv0=rng.integers(-20, 21, (R, C, 2)),
               mv1=rng.integers(-20, 21, (R, C, 2)),
               luma_levels=rng.integers(-2, 3, (R, C, 16, 16))
               * (rng.random((R, C, 16, 1)) < 0.3),
               cdc_levels=rng.integers(-2, 3, (R, C, 2, 4)),
               cac_levels=rng.integers(-1, 2, (R, C, 2, 4, 15))
               * (rng.random((R, C, 1, 1, 1)) < 0.5))
    sym = {k: v.astype(np.int32) for k, v in sym.items()}
    out = []
    for writer, bw in ((jsc.write_bslice_mbs, JBitWriter()),
                       (tsc.write_bslice_mbs, BitWriter())):
        writer(bw, **sym)
        bw.rbsp_trailing_bits()
        out.append(bw.get_bytes())
    assert out[0] == out[1] and len(out[0]) > 50


def test_reference_decoder_plays_the_ports_b_stream_in_source_order():
    s = EncoderSession(bcfg(EncoderConfig), device="cpu")
    aus = s.encode_frames(FRAMES[:5])
    frames = ReferenceDecoder().decode_annexb(b"".join(aus))
    assert len(frames) == 5
    # Coding order IDR, P(2), B(1), P(3) lone anchor, then the IDR due at
    # display 4: POCs 0, 4, 2, 6, 0. Display order = by (IDR period, POC).
    pocs = [f.poc for f in frames]
    assert pocs == [0, 4, 2, 6, 0]
    order = [0, 2, 1, 3, 4]  # decoded index of display frame 0..4
    for t, i in enumerate(order):
        src = yuv.split_i420(FRAMES[t], W, H)[0].astype(np.float64)
        mse = np.mean((frames[i].y[:H, :W].astype(np.float64) - src) ** 2)
        assert 10 * np.log10(255.0 ** 2 / mse) > 30.0, (t, i)
    # The last decoded picture is the last anchor: the encoder's reference.
    np.testing.assert_array_equal(frames[-1].y, s.recon[0].numpy())


# --------------------------------------------------------------- lossless


def _zero_frame():
    return bytes(W * H * 3 // 2)


LOSSLESS_CASES = ["one-slice", "two-slices", "all-zero", "odd-size"]


def lossless_case(case):
    """(width, height, config fields, frames) of a lossless case."""
    w, h = (44, 30) if case == "odd-size" else (W, H)
    kw = dict(width=w, height=h, qp=QP, lossless=True,
              num_slices=2 if case == "two-slices" else 1,
              insert_aud=case == "two-slices")
    bufs = ([_zero_frame()] * 2 if case == "all-zero"
            else clip(2, w, h, seed=6))
    return w, h, kw, bufs


@GOLDEN.recipe(cases=LOSSLESS_CASES)
def jax_lossless(case):
    """The JAX lossless session's AUs of a case, in one encode_frames."""
    _w, _h, kw, bufs = lossless_case(case)
    return JaxSession(JaxConfig(**kw)).encode_frames(bufs)


@pytest.mark.parametrize("case", LOSSLESS_CASES)
def test_lossless_matches_jax_and_decodes_to_the_input(case):
    w, h, kw, bufs = lossless_case(case)
    tcfg = EncoderConfig(**kw, cabac=True, rc_mode="cbr")
    want = GOLDEN.read(jax_lossless, case)
    s = EncoderSession(tcfg, device="cpu")
    got = [s.encode_frame(bufs[0])] + s.encode_frames(bufs[1:])
    assert got == want
    # lossless forces CAVLC, constant QP and no deblocking on the config.
    assert (tcfg.cabac, tcfg.rc_mode, tcfg.deblock) == (False, "cq", False)
    assert all(isinstance(p, np.ndarray) for p in s.recon)
    if case == "all-zero":
        assert b"\x00\x00\x03" in got[0]  # emulation prevention at work
    frames = ReferenceDecoder().decode_annexb(b"".join(got))
    assert len(frames) == 2
    for f, buf in zip(frames, bufs):
        for plane, src in zip((f.y, f.u, f.v), yuv.split_i420(buf, w, h)):
            np.testing.assert_array_equal(
                plane[: src.shape[0], : src.shape[1]], src)


@pytest.mark.parametrize("kw", [dict(b_frames=1), dict(lossless=True)],
                         ids=["b", "ipcm"])
def test_device_decoder_refuses_b_and_ipcm_as_jax_does(kw):
    s = EncoderSession(EncoderConfig(width=W, height=H, qp=QP, **kw),
                       device="cpu")
    aus = s.encode_frames(FRAMES[:3])
    for make, unsupported in ((jdec.TpuDecoder, jdec.UnsupportedStream),
                              (lambda: tdec.TpuDecoder(device="cpu"),
                               tdec.UnsupportedStream)):
        dec = make()
        with pytest.raises(unsupported):
            for au in aus:
                dec.decode_annexb(au)
        assert dec.frames == []
