"""The traffic generator: one seed gives the same frames; two seeds give
the same brightness, contrast and motion."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from h264_bench import gen
from h264_bench.tests.conftest import tiny_traffic

W, H = 64, 48


def frames(kind, seed, w=W, h=H):
    return gen.to_host(gen.make_frames(tiny_traffic(kind), w, h, seed, "cpu"))


@pytest.mark.parametrize("kind", ["natural", "screen"])
def test_one_seed_same_frames(kind):
    a, b = frames(kind, 2**31 + 11), frames(kind, 2**31 + 11)
    assert len(a) == len(b) == tiny_traffic(kind)["ring_frames"] + 1
    for fa, fb in zip(a, b):
        for pa, pb in zip(fa, fb):
            assert pa.dtype == np.uint8 and np.array_equal(pa, pb)


@pytest.mark.parametrize("kind", ["natural", "screen"])
def test_two_seeds_differ(kind):
    a, b = frames(kind, 1), frames(kind, 2)
    assert any(not np.array_equal(fa[0], fb[0]) for fa, fb in zip(a, b))


def test_natural_contrast_and_motion_fixed():
    # A larger picture, so that the statistics settle.
    a, b = frames("natural", 1, 256, 192), frames("natural", 2, 256, 192)
    for fa, fb in zip(a, b):
        ya, yb = fa[0].astype(float), fb[0].astype(float)
        assert abs(ya.mean() - yb.mean()) < 3
        assert abs(ya.std() - yb.std()) < 0.06 * ya.std()
    # Motion energy: frame-to-frame change alike on both seeds.
    da = [np.abs(a[i + 1][0].astype(int) - a[i][0]).mean() for i in range(8)]
    db = [np.abs(b[i + 1][0].astype(int) - b[i][0]).mean() for i in range(8)]
    assert np.allclose(da, db, rtol=0.15)


def test_pan_is_an_exact_seamless_shift():
    """The field alone: after 4 frames the pan has moved 10 and 5 whole
    pels, and the picture is the first rolled by that, wrapped at the
    edges with no seam."""
    t = tiny_traffic("natural")
    t["layers"] = t["layers"][:1]
    fr = gen.make_frames(t, W, H, 3, "cpu")
    y0, y4 = fr[0][0].to(torch.int32), fr[4][0].to(torch.int32)
    rolled = torch.roll(y0, shifts=(-5, -10), dims=(0, 1))
    assert int((y4 - rolled).abs().max()) <= 1
    # A half-pel frame lies between its neighbours, not on either.
    y1 = fr[1][0].to(torch.int32)
    assert int((y1 - y0).abs().max()) > 1


@pytest.mark.parametrize("seed", [1, 2])
def test_screen_text_scrolls_4px(seed):
    fr = frames("screen", seed)
    x, y0, w, h = 16, 10, 40, 32
    for f in range(len(fr) - 1):
        cur, nxt = fr[f][0], fr[f + 1][0]
        assert np.array_equal(nxt[y0:y0 + h - 4, x:x + w],
                              cur[y0 + 4:y0 + h, x:x + w])
        # Outside the text window nothing moves.
        mask = np.ones_like(cur, bool)
        mask[y0:y0 + h, x:x + w] = False
        assert np.array_equal(cur[mask], nxt[mask])


def test_screen_same_ink_on_every_seed():
    a, b = frames("screen", 1), frames("screen", 2)
    ink_a = sum(int((f[0] == 16).sum()) for f in a)
    ink_b = sum(int((f[0] == 16).sum()) for f in b)
    assert ink_a > 0 and abs(ink_a - ink_b) < 0.2 * ink_a


def test_chroma_rule():
    t = tiny_traffic("natural")
    y, u, v = gen.make_frames(t, W, H, 5, "cpu")[0]
    sub = y[::2, ::2].to(torch.int32)
    (a, b, c) = t["chroma"]["u"]
    assert torch.equal(u, (sub * a // b + c).clamp(0, 255).to(torch.uint8))
