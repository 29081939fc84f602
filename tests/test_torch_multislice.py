"""media_tpu_torch's multi-slice sessions against media_tpu's: byte-identical
access units.

num_slices 2 and 3 x {CAVLC, CABAC} x deblock_across_slices {True, False}
(disable_deblocking_filter_idc 0 and 2) at constant QP; two slices under
CBR with CABAC (the per-frame host rate loop) and with CAVLC (the device
loop's QPs, then host entropy at their mean); the slice bounds themselves;
and media_tpu's ReferenceDecoder (a numpy oracle, live) on the port's
multi-slice stream. One JAX session per configuration, read from
tests/golden_torch/ (jax_encode says what it was asked; tests/jax_golden.py);
the JAX side deblocked one wave per scan step (same bytes, smaller
programs). Tolerance 0; the host rate loop's floats 1e-9 relative (Python
floats on both sides).

The port's ShardedEncoderSession (parallel/sharding.py: one MB-row tile a
slice, each on its own device of a list) at constant QP is held to the
same JAX sessions: over three CPU "devices" at 64x48 (one MB row a tile)
against the three-slice, slice-local-deblocking session, through the
device packer and through the overflow route; and over two at 64x64.
"""

import numpy as np
import pytest
import torch

import chip_smoke as cs
from jax_golden import Golden
from media_tpu.ref.decoder import ReferenceDecoder
from media_tpu_torch.core import nal as tnal
from media_tpu_torch.core import syntax as tsyn
from media_tpu_torch.core.bitstream import BitReader
from media_tpu_torch.parallel.sharding import ShardedEncoderSession
from media_tpu_torch.pipeline.codec import EncoderConfig, EncoderSession
from media_tpu_torch.utils import yuv

W, H, QP, N = 64, 48, 28, 3
GOLDEN = Golden(__file__, env={"MEDIA_TPU_DEBLOCK_UNROLL": "1"})


def clip(n, seed=0):
    """Textured pan with a moving bright block (I420 buffers)."""
    rng = np.random.default_rng(seed)
    big = rng.integers(0, 256, (H + 48, W + 48)).astype(np.float64)
    for _ in range(2):
        big = (big + np.roll(big, 1, 0) + np.roll(big, 1, 1)) / 3
    out = []
    for t in range(n):
        y = big[2 * t : 2 * t + H, 3 * t : 3 * t + W].copy()
        y[10:22, 5 + 7 * t : 17 + 7 * t] = 235
        y = (y + rng.normal(0, 1.5, y.shape)).round().clip(0, 255).astype(
            np.uint8)
        out.append(yuv.pack_i420(y, (y[::2, ::2] // 2 + 40).astype(np.uint8),
                                 (y[::2, ::2] // 3 + 70).astype(np.uint8)))
    return out


FRAMES = clip(N)


def cfg(cls, **kw):
    return cls(width=W, height=H, qp=QP, gop_size=30, **kw)


def encode(cls, kw, cfg_cls=EncoderConfig, **session_kw):
    s = cls(cfg(cfg_cls, **kw), **session_kw)
    return s, [s.encode_frame(FRAMES[0])] + s.encode_frames(FRAMES[1:])


SESSION_KWS = [dict(num_slices=n, cabac=cabac, deblock_across_slices=across,
                    entropy_mode="host")
               for n in (2, 3) for cabac in (False, True)
               for across in (True, False)]
CABAC_CBR = dict(num_slices=2, cabac=True, cabac_init_idc=1, rc_mode="cbr",
                 bitrate=150_000, framerate=30)
CAVLC_CBR = dict(num_slices=2, rc_mode="cbr", bitrate=150_000, framerate=30)


@GOLDEN.recipe(cases=[tuple(kw.items())
                      for kw in SESSION_KWS + [CABAC_CBR, CAVLC_CBR]])
def jax_encode(*items):
    """The JAX session of a configuration on FRAMES (IDR through
    encode_frame, the rest through encode_frames): its AUs, slice rows,
    recon and rate state."""
    from media_tpu.pipeline.codec import EncoderConfig as JaxConfig
    from media_tpu.pipeline.codec import EncoderSession as JaxSession

    js, aus = encode(JaxSession, dict(items), JaxConfig)
    return {"aus": aus, "slice_rows": js.slice_rows,
            "recon": tuple(np.asarray(p) for p in js.recon),
            "rc_state": dict(js.rc_state)}


def jax_encoded(kw) -> dict:
    return GOLDEN.read(jax_encode, *kw.items())


def slice_headers(aus):
    """Per AU, the (first_mb_in_slice, disable_deblocking_filter_idc) of
    every slice."""
    sps = pps = None
    out = []
    for au in aus:
        out.append([])
        for nu in tnal.iter_nal_units(au):
            if nu.nal_type == 7:
                sps = tsyn.SPS.parse(BitReader(nu.rbsp))
            elif nu.nal_type == 8:
                pps = tsyn.PPS.parse(BitReader(nu.rbsp))
            elif nu.nal_type in (1, 5):
                hdr = tsyn.SliceHeader.parse(BitReader(nu.rbsp), sps, pps,
                                             nal_type=nu.nal_type,
                                             nal_ref_idc=nu.nal_ref_idc)
                out[-1].append((hdr.first_mb_in_slice,
                                hdr.disable_deblocking_filter_idc))
    return out


@pytest.mark.parametrize("across", [True, False])
@pytest.mark.parametrize("cabac", [False, True])
@pytest.mark.parametrize("num_slices", [2, 3])
def test_multislice_session_matches_jax(num_slices, cabac, across):
    kw = dict(num_slices=num_slices, cabac=cabac,
              deblock_across_slices=across, entropy_mode="host")
    js = jax_encoded(kw)
    want = js["aus"]
    for coder in ("native", "python"):
        s, got = encode(EncoderSession, kw, device="cpu", host_coder=coder)
        assert got == want, coder
    assert s.slice_rows == [tuple(r) for r in js["slice_rows"]]
    assert len(s.slice_rows) == num_slices
    for a, b in zip(s.recon, js["recon"]):
        np.testing.assert_array_equal(a.numpy(), b)
    # Every picture carries one NAL per slice, with the idc of the config.
    idc = 0 if across else 2
    for heads in slice_headers(got):
        assert heads == [(r0 * (W // 16), idc) for r0, _ in s.slice_rows]


# The configuration a sharded session over n tiles codes (sharding.py).
SHARDED3 = dict(num_slices=3, cabac=False, deblock_across_slices=False,
                entropy_mode="host")


@pytest.mark.parametrize("overflow", [False, True])
def test_sharded_session_equals_the_jax_multislice_session(overflow):
    """Three tiles on three CPU "devices" at 64x48: the AUs of the JAX
    three-slice session with slice-local deblocking, through the tiles'
    device packers, and through the constant-QP overflow route (a per-tile
    cap too small for any P slice sends each P run to the base session's
    single-device host path)."""
    s = ShardedEncoderSession(cfg(EncoderConfig), devices=["cpu"] * 3)
    assert s.mesh == (torch.device("cpu"),) * 3 and s.rows_local == 1
    assert (s.cfg.num_slices, s.cfg.deblock_across_slices,
            s.cfg.entropy_mode) == (3, False, "host")
    host_runs = []
    if overflow:
        s.cap_local = 0
        inner = s.base._frame_encoder.encode_pframes_batch

        def host_path(*a, **kw):
            host_runs.append(len(a[0]))
            return inner(*a, **kw)

        s.base._frame_encoder.encode_pframes_batch = host_path
    got = [s.encode_frame(FRAMES[0])] + s.encode_frames(FRAMES[1:])
    assert got == jax_encoded(SHARDED3)["aus"]
    assert host_runs == ([N - 1] if overflow else [])
    rs, _ = encode(EncoderSession, SHARDED3, device="cpu")
    for a, b in zip(s.recon, rs.recon):
        assert torch.equal(a, b)


TWO_TILES = dict(width=64, height=64, qp=QP, gop_size=30)


def two_tile_clip():
    return cs.clip_i420(64, 64, N, seed=5)[0]


@GOLDEN.recipe
def jax_two_slice_64x64():
    """The JAX two-slice session with slice-local deblocking at 64x64: its
    AUs and recon."""
    from media_tpu.pipeline.codec import EncoderConfig as JaxConfig
    from media_tpu.pipeline.codec import EncoderSession as JaxSession

    bufs = two_tile_clip()
    js = JaxSession(JaxConfig(num_slices=2, deblock_across_slices=False,
                              entropy_mode="host", **TWO_TILES))
    aus = [js.encode_frame(bufs[0])] + js.encode_frames(bufs[1:])
    return {"aus": aus, "recon": tuple(np.asarray(p) for p in js.recon)}


def test_two_tile_sharded_session_equals_the_jax_two_slice_session():
    bufs = two_tile_clip()
    s = ShardedEncoderSession(EncoderConfig(**TWO_TILES), devices=["cpu"] * 2)
    got = [s.encode_frame(bufs[0])] + s.encode_frames(bufs[1:])
    js = GOLDEN.read(jax_two_slice_64x64)
    assert got == js["aus"]
    assert [r0 for r0, _ in s.base.slice_rows] == [0, 2]
    for a, b in zip(s.recon, js["recon"]):
        np.testing.assert_array_equal(a.numpy(), b)


def test_slice_bounds_round_as_python_does():
    """round(i * n_rows / ns): half-way cases go to the even row, and a
    slice count above the row count gives one slice per row."""
    def rows(height, ns):
        return EncoderSession(EncoderConfig(width=32, height=height,
                                            num_slices=ns),
                              device="cpu").slice_rows

    assert rows(96, 4) == [(0, 2), (2, 3), (3, 4), (4, 6)]  # 1.5 -> 2, 4.5 -> 4
    assert rows(48, 2) == [(0, 2), (2, 3)]
    assert rows(48, 7) == [(0, 1), (1, 2), (2, 3)]
    assert rows(1080, 4) == [(0, 17), (17, 34), (34, 51), (51, 68)]


def test_multislice_cabac_cbr_host_loop_matches_jax():
    js = jax_encoded(CABAC_CBR)
    s, got = encode(EncoderSession, CABAC_CBR, device="cpu")
    assert got == js["aus"]
    for k in ("qp", "buf", "cplx"):
        assert s.rc_state[k] == pytest.approx(js["rc_state"][k], rel=1e-9), k
    with pytest.raises(RuntimeError, match="single-slice"):
        s.encode_frames_staged(s.upload_frames(FRAMES[1:]))


def test_multislice_cavlc_cbr_takes_the_mean_qp_route():
    js = jax_encoded(CAVLC_CBR)
    s, got = encode(EncoderSession, CAVLC_CBR, device="cpu")
    assert got == js["aus"]
    for k in ("qp", "buf", "cplx"):
        assert s.rc_state[k] == pytest.approx(js["rc_state"][k], rel=1e-6), k


@pytest.mark.parametrize("across", [True, False])
def test_reference_decoder_decodes_the_ports_multislice_stream(across):
    s, aus = encode(EncoderSession, dict(num_slices=3, entropy_mode="host",
                                         deblock_across_slices=across),
                    device="cpu")
    frames = ReferenceDecoder().decode_annexb(b"".join(aus))
    assert len(frames) == len(aus)
    f = frames[-1]
    for plane, rec in zip((f.y, f.u, f.v), s.recon):
        np.testing.assert_array_equal(plane, rec.numpy())


def test_cabac_p_slices_the_cpp_parser_stops_at_are_counted():
    """A four-slice CABAC P picture at 64x64 (one MB row a slice): the C++
    CABAC P parser stops at the end of each of the three upper slices, the
    Python parser takes them, and each is counted in native.fallbacks under
    the parser's name, as the CAVLC route counts its parser's refusals."""
    from media_tpu_torch import native
    from media_tpu_torch.pipeline.decoder_tpu import TpuDecoder

    bufs = [yuv.pack_i420(*f) for f in cs.synthetic_video(64, 64, 2)]
    s = EncoderSession(EncoderConfig(width=64, height=64, qp=QP, cabac=True,
                                     num_slices=4), device="cpu")
    assert s.slice_rows == [(0, 1), (1, 2), (2, 3), (3, 4)]
    aus = [s.encode_frame(b) for b in bufs]
    dec = TpuDecoder(device="cpu")
    before = native.fallbacks.copy()
    dec.decode_annexb(aus[0])
    assert native.fallbacks == before  # the I slices parse in C++
    (f,) = dec.decode_annexb(aus[1])
    added = native.fallbacks - before
    assert dict(added) == {"cabac_parse_pslice_native": 3}
    np.testing.assert_array_equal(f.y, s.recon[0].numpy())
