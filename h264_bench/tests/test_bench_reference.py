"""The plain reference against the program on the CPU: the same access
units byte for byte and the same planes after deblocking, at small sizes;
and its deblocking order against the control's."""

from __future__ import annotations

import numpy as np
import pytest

from h264_bench import gen
from h264_bench.reference import deblock as db
from h264_bench.reference.encoder import ReferenceEncoder
from h264_bench.tests.conftest import tiny_traffic


def encode_both(kind: str, w: int, h: int, n_p: int, seed: int):
    from media_tpu_torch.pipeline.codec import EncoderConfig, EncoderSession

    t = tiny_traffic(kind)
    fr = gen.to_host(gen.make_frames(t, w, h, seed, "cpu"))[:n_p + 1]
    enc = dict(width=w, height=h, qp=32, gop_size=300, level_idc=40,
               framerate=30, entropy_mode="device")
    s = EncoderSession(EncoderConfig(**enc), device="cpu")
    s.PIPELINE_CHUNK = 4
    aus = [s.encode_frame(gen.i420(fr[0]))]
    aus += s.encode_frames_staged(s.upload_frames([gen.i420(f)
                                                   for f in fr[1:]]))
    ref = ReferenceEncoder(enc)
    au_of, rec = ref.idr(*fr[0])
    want = [au_of(0)]
    for k in range(1, n_p + 1):
        au, rec = ref.p(*fr[k], rec, k)
        want.append(au)
    return aus, want, [p.numpy() for p in s.recon], rec


@pytest.mark.parametrize("kind, w, h", [("natural", 64, 48),
                                        ("natural", 176, 144),
                                        ("screen", 64, 48)])
def test_reference_equals_program(kind, w, h):
    aus, want, got_rec, want_rec = encode_both(kind, w, h, 5, 21)
    assert [len(a) for a in aus] == [len(a) for a in want]
    assert aus == want
    for a, b in zip(got_rec, want_rec):
        assert np.array_equal(a, b)


def test_reference_refuses_other_tools():
    with pytest.raises(ValueError):
        ReferenceEncoder(dict(width=64, height=48, qp=30, level_idc=40,
                              framerate=30, cabac=True))


def test_two_pass_differs_from_mb_order():
    """The control's filter order changes an I picture's samples."""
    rng = np.random.default_rng(0)
    R, C = 3, 4
    base = rng.integers(90, 110, (16 * R, 16 * C)).astype(np.uint8)
    u = base[::2, ::2].copy()
    meta = db.build_meta(36, 34, *db.intra_bs_grids(R, C), R, C)
    a = db.deblock_frame(base, u, u, meta, R, C)
    b = db.deblock_two_pass(base, u, u, meta, R, C)
    assert sum(int((x != y).sum()) for x, y in zip(a, b)) > 0
