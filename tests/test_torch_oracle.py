"""The port's scalar oracle (media_tpu_torch/ref/) against media_tpu's.

ref/decoder.py: the port's ReferenceDecoder and the JAX package's decode
the port's own streams (device="cpu") to the same planes, and those are the
encoder's recon. The configurations are those of the port's session,
I_4x4, multi-slice and B-GOP tests at 64x48 and below (constant QP and CBR
with CAVLC, I_4x4, two and three slices with deblocking inside and across
slices, the IBPBP B-GOP, a cropped 44x30 picture) plus lossless I_PCM; the
oracle parses CAVLC only. ref/deblock.py: the port's deblock_frame_np and
bS grids against the original's on random strengths, QPs and per-MB QP
maps. Tolerance 0 (integer numpy on both sides).
"""

import numpy as np
import pytest

import chip_smoke as cs
from media_tpu.ref import deblock as jdb
from media_tpu.ref.decoder import ReferenceDecoder as JaxReferenceDecoder
from media_tpu_torch.pipeline.codec import EncoderConfig, EncoderSession
from media_tpu_torch.ref import deblock as tdb
from media_tpu_torch.ref.decoder import ReferenceDecoder

N = 3
CONFIGS = {
    "cq": dict(),
    "cbr": dict(rc_mode="cbr", bitrate=300_000, framerate=30),
    "i4x4": dict(i4x4=True),
    "i4x4_cbr": dict(i4x4=True, rc_mode="cbr", bitrate=300_000,
                     framerate=30),
    "slices2": dict(num_slices=2),
    "slices3_idc2": dict(num_slices=3, deblock_across_slices=False),
    "bgop": dict(b_frames=1),
    "lossless": dict(lossless=True),
    "cropped_44x30": dict(width=44, height=30),
}


def _planes(p):
    return np.asarray(p.cpu() if hasattr(p, "cpu") else p)


def encode(name):
    kw = dict(width=64, height=48, qp=28, gop_size=30)
    kw.update(CONFIGS[name])
    n = 5 if kw.get("b_frames") else N
    bufs = cs.clip_i420(kw["width"], kw["height"], n)[0]
    s = EncoderSession(EncoderConfig(**kw), device="cpu")
    if kw.get("b_frames"):
        return s.encode_frames(bufs), None
    aus = [s.encode_frame(bufs[0])] + s.encode_frames(bufs[1:])
    return aus, tuple(_planes(p) for p in s.recon)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_reference_decoder_equals_jax_and_recon(name):
    aus, recon = encode(name)
    got, want = ReferenceDecoder(), JaxReferenceDecoder()
    frames = [[f for au in aus for f in d.decode_annexb(au)]
              for d in (got, want)]
    assert len(frames[0]) == len(frames[1]) == len(aus)
    for i, (a, b) in enumerate(zip(*frames)):
        for p in "yuv":
            np.testing.assert_array_equal(np.asarray(getattr(a, p)),
                                          np.asarray(getattr(b, p)),
                                          f"picture {i} plane {p}")
    if recon is not None:  # the last picture is the encoder's last recon
        last = frames[0][-1]
        for p, r in zip("yuv", recon):
            plane = np.asarray(getattr(last, p))
            np.testing.assert_array_equal(plane, r[: plane.shape[0],
                                                   : plane.shape[1]], p)


@pytest.mark.parametrize("seed", range(3))
def test_deblock_frame_np_equals_original(seed):
    rng = np.random.default_rng(seed)
    R, C = 3, 4
    # Flat planes with a little noise, so that most edges pass the
    # alpha/beta tests and get filtered.
    y = (120 + rng.integers(-4, 5, (16 * R, 16 * C))).astype(np.uint8)
    u, v = ((90 + rng.integers(-3, 4, (8 * R, 8 * C))).astype(np.uint8)
            for _ in range(2))
    bs_v = rng.integers(0, 5, (4 * R, 4 * C)).astype(np.int32)
    bs_h = rng.integers(0, 5, (4 * R, 4 * C)).astype(np.int32)
    qp = int(rng.integers(28, 52))
    qp_map = rng.integers(20, 52, (R, C))
    for kw in ({}, {"qp_map": qp_map}):
        a = tdb.deblock_frame_np(y, u, v, qp, qp - 2, bs_v, bs_h, **kw)
        b = jdb.deblock_frame_np(y, u, v, qp, qp - 2, bs_v, bs_h, **kw)
        for pa, pb in zip(a, b):
            np.testing.assert_array_equal(pa, pb)
        assert not np.array_equal(a[0], y)  # something was filtered
    nnz = rng.integers(0, 2, (4 * R, 4 * C))
    mv = rng.integers(-8, 9, (R, C, 2))
    intra = rng.random((R, C)) < 0.3
    for fn, args in ((lambda m: m.inter_bs_grids_np, (nnz, mv, intra)),
                     (lambda m: m.intra_bs_grids_np, (R, C))):
        for ga, gb in zip(fn(tdb)(*args), fn(jdb)(*args)):
            np.testing.assert_array_equal(ga, gb)
