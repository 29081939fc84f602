"""media_tpu_torch's TpuDecoder on I_4x4 streams against media_tpu's
TpuDecoder and against the encoder's recon: exact equality.

The streams come from the port's session (tests/test_torch_i4x4.py holds its
bytes to the JAX session's): CAVLC and CABAC, one slice and two (with the
filter kept inside each slice), IDR + P. Both deblock routes and both host
parsers of the port must give the planes of the JAX TpuDecoder, and picture
0 and the last one the encoder's recon. The JAX TpuDecoder's pictures are
read from tests/golden_torch/ (jax_decoded says what it was asked;
tests/jax_golden.py); it ran its per-wave Pallas deblock kernel in
interpret mode (a smaller program than the wave-major scan). Tolerance 0.
"""

import functools

import numpy as np
import pytest

from jax_golden import Golden
from media_tpu_torch.pipeline import decoder_tpu as tdec
from media_tpu_torch.pipeline.codec import EncoderConfig, EncoderSession
from media_tpu_torch.utils import yuv

W, H, QP = 64, 48, 28


def structured_scene(w, h, seed=1, shift=0):
    """Strong directional edges (the content where I_4x4 wins) around a flat
    rectangle (where I_16x16 wins)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    xx = xx + shift
    y = (128 + 60 * np.sin(xx / 3.0) * (yy % 17 < 9)
         + 50 * ((xx + 2 * yy) % 23 < 7)).clip(0, 255).astype(np.uint8)
    y += rng.integers(0, 6, (h, w)).astype(np.uint8)
    y[16:32, 16:48] = 100
    u = np.full((h // 2, w // 2), 90, np.uint8)
    v = np.full((h // 2, w // 2), 150, np.uint8)
    return y, u, v


FRAMES = [yuv.pack_i420(*structured_scene(W, H, shift=2 * t))
          for t in range(3)]

STREAMS = {
    "cavlc": dict(),
    "cabac": dict(cabac=True),
    "cavlc-2slices-idc2": dict(num_slices=2, deblock_across_slices=False),
    "cabac-2slices-idc2": dict(cabac=True, num_slices=2,
                               deblock_across_slices=False),
}


@functools.lru_cache(maxsize=None)
def port_stream(name):
    """(AUs of IDR + 2 P, recon after the IDR, recon after the last P)."""
    s = EncoderSession(EncoderConfig(width=W, height=H, qp=QP, gop_size=30,
                                     i4x4=True, **STREAMS[name]),
                       device="cpu")
    aus = [s.encode_frame(FRAMES[0])]
    recon_idr = tuple(p.numpy().copy() for p in s.recon)
    aus += s.encode_frames(FRAMES[1:3])
    return aus, recon_idr, tuple(p.numpy() for p in s.recon)


def planes(frame):
    return tuple(np.asarray(p) for p in (frame.y, frame.u, frame.v))


def assert_planes(got, want, what):
    for a, b, name in zip(got, want, "yuv"):
        np.testing.assert_array_equal(a, b, err_msg=f"{what} {name}")


GOLDEN = Golden(__file__, env={"MEDIA_TPU_DEBLOCK_KERNEL": "pallas"})


@GOLDEN.recipe(cases=list(STREAMS))
def jax_decoded(name):
    """The JAX TpuDecoder's pictures of the port's stream (port_stream),
    and that stream."""
    from media_tpu.pipeline import decoder_tpu as jdec

    aus = port_stream(name)[0]
    jd = jdec.TpuDecoder()
    return {"aus": aus,
            "planes": [planes(f) for au in aus for f in jd.decode_annexb(au)]}


@pytest.mark.parametrize("name", list(STREAMS))
def test_i4x4_decode_matches_jax_and_the_encoder(name):
    aus, recon_idr, recon_last = port_stream(name)
    jd = GOLDEN.read(jax_decoded, name)
    assert aus == jd["aus"], "the port's stream is not the recorded one"
    want = jd["planes"]
    assert len(want) == len(aus)
    dec = tdec.TpuDecoder(device="cpu")
    got = [planes(f) for au in aus for f in dec.decode_annexb(au)]
    for i, (a, b) in enumerate(zip(got, want)):
        assert_planes(a, b, f"picture {i}")
    assert_planes(got[0], recon_idr, "IDR vs encoder recon")
    assert_planes(got[-1], recon_last, "last P vs encoder recon")


@pytest.mark.parametrize("parser", ["native", "python"])
@pytest.mark.parametrize("kernel", ["frame", "wave"])
@pytest.mark.parametrize("name", list(STREAMS))
def test_i4x4_decode_routes_and_parsers(name, kernel, parser):
    aus, recon_idr, recon_last = port_stream(name)
    dec = tdec.TpuDecoder(device="cpu", deblock_kernel=kernel,
                          host_parser=parser)
    got = [planes(f) for au in aus for f in dec.decode_annexb(au)]
    assert_planes(got[0], recon_idr, "IDR vs encoder recon")
    assert_planes(got[-1], recon_last, "last P vs encoder recon")


def test_mixed_picture_has_both_mb_types():
    """The stream the decoder is held on holds I_4x4 and I_16x16 MBs, so the
    per-MB select of the reconstruction is exercised both ways."""
    from media_tpu_torch.core import nal as tnal
    from media_tpu_torch.core import syntax as tsyn
    from media_tpu_torch.core.bitstream import BitReader
    from media_tpu_torch.pipeline import slice_coder as tsc

    aus, _r0, _r1 = port_stream("cavlc")
    units = {nu.nal_type: nu for nu in tnal.iter_nal_units(aus[0])}
    sps = tsyn.SPS.parse(BitReader(units[7].rbsp))
    pps = tsyn.PPS.parse(BitReader(units[8].rbsp))
    br = BitReader(units[5].rbsp)
    tsyn.SliceHeader.parse(br, sps, pps, nal_type=5, nal_ref_idc=3)
    parsed = tsc.parse_islice_mbs(br, H // 16, W // 16, QP)
    assert 0 < parsed.is_i4.sum() < parsed.is_i4.size
    assert parsed.covered == (H // 16) * (W // 16)
