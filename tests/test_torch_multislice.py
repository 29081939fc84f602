"""media_tpu_torch's multi-slice sessions against media_tpu's: byte-identical
access units.

num_slices 2 and 3 x {CAVLC, CABAC} x deblock_across_slices {True, False}
(disable_deblocking_filter_idc 0 and 2) at constant QP; two slices under
CBR with CABAC (the per-frame host rate loop) and with CAVLC (the device
loop's QPs, then host entropy at their mean); the slice bounds themselves;
and media_tpu's ReferenceDecoder on the port's multi-slice stream. One JAX
session per configuration; the JAX side deblocks one wave per scan step
(same bytes, smaller programs). Tolerance 0; the host rate loop's floats
1e-9 relative (Python floats on both sides).
"""

import numpy as np
import pytest

from media_tpu.pipeline.codec import EncoderConfig as JaxConfig
from media_tpu.pipeline.codec import EncoderSession as JaxSession
from media_tpu.ref.decoder import ReferenceDecoder
from media_tpu_torch.core import nal as tnal
from media_tpu_torch.core import syntax as tsyn
from media_tpu_torch.core.bitstream import BitReader
from media_tpu_torch.pipeline.codec import EncoderConfig, EncoderSession
from media_tpu_torch.utils import yuv

W, H, QP, N = 64, 48, 28, 3


@pytest.fixture(autouse=True, scope="module")
def _small_jax_deblock():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MEDIA_TPU_DEBLOCK_UNROLL", "1")
        yield


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


def encode(cls, kw, **session_kw):
    s = cls(cfg(JaxConfig if cls is JaxSession else EncoderConfig, **kw),
            **session_kw)
    return s, [s.encode_frame(FRAMES[0])] + s.encode_frames(FRAMES[1:])


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
    js, want = encode(JaxSession, kw)
    for coder in ("native", "python"):
        s, got = encode(EncoderSession, kw, device="cpu", host_coder=coder)
        assert got == want, coder
    assert s.slice_rows == js.slice_rows and len(s.slice_rows) == num_slices
    for a, b in zip(s.recon, js.recon):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # Every picture carries one NAL per slice, with the idc of the config.
    idc = 0 if across else 2
    for heads in slice_headers(got):
        assert heads == [(r0 * (W // 16), idc) for r0, _ in s.slice_rows]


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
    kw = dict(num_slices=2, cabac=True, cabac_init_idc=1, rc_mode="cbr",
              bitrate=150_000, framerate=30)
    js, want = encode(JaxSession, kw)
    s, got = encode(EncoderSession, kw, device="cpu")
    assert got == want
    for k in ("qp", "buf", "cplx"):
        assert s.rc_state[k] == pytest.approx(js.rc_state[k], rel=1e-9), k
    with pytest.raises(RuntimeError, match="single-slice"):
        s.encode_frames_staged(s.upload_frames(FRAMES[1:]))


def test_multislice_cavlc_cbr_takes_the_mean_qp_route():
    kw = dict(num_slices=2, rc_mode="cbr", bitrate=150_000, framerate=30)
    js, want = encode(JaxSession, kw)
    s, got = encode(EncoderSession, kw, device="cpu")
    assert got == want
    for k in ("qp", "buf", "cplx"):
        assert s.rc_state[k] == pytest.approx(js.rc_state[k], rel=1e-6), k


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
