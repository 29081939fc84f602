"""media_tpu_torch deblocking against media_tpu: exact equality.

The plain version of the whole-frame wavefront (the CPU path of
deblock_frame) must equal the JAX wave-major scan in both QP modes and the
numpy raster oracle ref/deblock.py, working on uint8 planes in place; the
bS grids must equal the JAX ones. The CUDA kernel is held to the plain
version in tests/test_torch_cuda.py.
"""

import jax
import numpy as np
import pytest
import torch

from media_tpu.ops import deblock as jdb
from media_tpu.pipeline import deblock_apply as jda
from media_tpu.ref.deblock import (
    deblock_frame_np, inter_bs_grids_np, intra_bs_grids_np)
from media_tpu_torch.ops import deblock as tdb
from media_tpu_torch.ops import deblock_wave as dw
from media_tpu_torch.pipeline import deblock_apply as tda


# Jitted once per mode (QP traced), so the JAX side compiles few programs.
_jax_wavemajor = jax.jit(jda._deblock_frame_wavemajor, static_argnums=(7, 8))
_jax_pframe = jax.jit(jda.deblock_pframe_from_symbols,
                      static_argnums=(6, 7, 8))
_jax_iframe = jax.jit(jda.deblock_iframe, static_argnums=(5, 6, 7))


@pytest.fixture(autouse=True)
def _small_jax_scan(monkeypatch):
    # One wave per scan step: the same result as the default 8-wave unroll,
    # and a much smaller program for XLA to compile.
    monkeypatch.setenv("MEDIA_TPU_DEBLOCK_UNROLL", "1")


def planes(R, C, seed, smooth):
    rng = np.random.default_rng(seed)
    out = [rng.integers(0, 256, (R * s, C * s)).astype(np.int32)
           for s in (16, 8, 8)]
    if smooth:  # |p0-q0| < alpha, so most edges filter
        out = [(p // 8 + 100).astype(np.int32) for p in out]
    return out


def random_bs(R, C, seed):
    rng = np.random.default_rng(seed + 100)
    bs_v = rng.integers(0, 5, (R * 4, C * 4)).astype(np.int32)
    bs_h = rng.integers(0, 5, (R * 4, C * 4)).astype(np.int32)
    bs_v[:, 0] = 0
    bs_h[0, :] = 0
    return bs_v, bs_h


def torch_deblock(y, u, v, qp, qp_c, bs_v, bs_h, R, C, qp_map=None):
    T = torch.as_tensor
    out = tda.deblock_frame(T(y), T(u), T(v), qp, qp_c, T(bs_v), T(bs_h), R,
                            C, qp_map=None if qp_map is None else T(qp_map))
    assert all(p.dtype == torch.uint8 for p in out)
    return [p.numpy() for p in out]


@pytest.mark.parametrize("per_mb", [False, True])
@pytest.mark.parametrize("qp,smooth", [(22, True), (30, True), (36, False)])
def test_plain_matches_jax_wavemajor(qp, smooth, per_mb):
    R, C = 3, 5
    y, u, v = planes(R, C, qp, smooth)
    bs_v, bs_h = random_bs(R, C, qp)
    qp_map = None
    if per_mb:
        rng = np.random.default_rng(qp + 7)
        qp_map = np.clip(qp + rng.integers(-6, 7, (R, C)), 0, 51).astype(
            np.int32)
    qp_c = min(qp, 39)
    want = _jax_wavemajor(y, u, v, qp, qp_c, bs_v, bs_h, R, C, qp_map=qp_map)
    got = torch_deblock(y, u, v, qp, qp_c, bs_v, bs_h, R, C, qp_map)
    for a, b, name in zip(want, got, "yuv"):
        np.testing.assert_array_equal(np.asarray(a), b, err_msg=name)
    assert any((b != p).any() for b, p in zip(got, (y, u, v)))


@pytest.mark.parametrize("inter", [False, True])
def test_plain_matches_numpy_oracle(inter):
    R, C = 4, 3
    y, u, v = planes(R, C, 5, smooth=True)
    if inter:
        rng = np.random.default_rng(1)
        nnz = rng.integers(0, 3, (R * 4, C * 4)).astype(np.int32)
        mv = rng.integers(-9, 10, (R, C, 2)).astype(np.int32)
        bs_v, bs_h = inter_bs_grids_np(nnz, mv)
        tv, th = tdb.inter_bs_grids(torch.as_tensor(nnz), torch.as_tensor(mv),
                                    R, C)
        jv, jh = jdb.inter_bs_grids(nnz, mv, R, C)
    else:
        bs_v, bs_h = intra_bs_grids_np(R, C)
        tv, th = tdb.intra_bs_grids(R, C)
        jv, jh = jdb.intra_bs_grids(R, C)
    for a, b, c in ((bs_v, tv, jv), (bs_h, th, jh)):
        np.testing.assert_array_equal(np.asarray(c), b.numpy())
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    want = deblock_frame_np(y, u, v, 30, 29, bs_v, bs_h)
    got = torch_deblock(y, u, v, 30, 29, bs_v, bs_h, R, C)
    for a, b, name in zip(want, got, "yuv"):
        np.testing.assert_array_equal(np.asarray(a), b, err_msg=name)


def test_pframe_and_iframe_drivers_match_jax():
    R, C = 2, 3
    rng = np.random.default_rng(11)
    y, u, v = (p.astype(np.uint8) for p in planes(R, C, 11, smooth=True))
    sym = np.zeros((R, C, 386), np.int16)
    sym[..., :2] = rng.integers(-20, 21, (R, C, 2))
    sym[..., 2:258] = (rng.integers(0, 5, (R, C, 256)) == 0) * rng.integers(
        -3, 4, (R, C, 256))
    T = torch.as_tensor
    want = _jax_pframe(y, u, v, sym, 30, 29, R, C, ())
    got = tda.deblock_pframe_from_symbols(T(y), T(u), T(v), T(sym), 30, 29,
                                          R, C)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    want = _jax_iframe(y, u, v, 36, 34, R, C, (1,))
    got = tda.deblock_iframe(T(y), T(u), T(v), 36, 34, R, C, slice_starts=(1,))
    for a, b in zip(want, got):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_wave_schedule_covers_every_mb_once():
    R, C = 4, 7
    seen = []
    for k in range(dw.n_waves(R, C)):
        r, c = dw.wave_mbs(k, R, C, "cpu")
        assert ((2 * r + c) == k).all() and (c >= 0).all() and (c < C).all()
        seen += list(zip(r.tolist(), c.tolist()))
    assert sorted(seen) == [(r, c) for r in range(R) for c in range(C)]


def test_deblock_wave_rejects_bad_inputs():
    R, C = 1, 2
    y = torch.zeros((16, 32), dtype=torch.uint8)
    u = torch.zeros((8, 16), dtype=torch.uint8)
    meta = torch.zeros((2, dw.META_COLS), dtype=torch.int32)
    with pytest.raises(ValueError):
        dw.deblock_wave(y.int(), u, u.clone(), meta, R, C)
    with pytest.raises(ValueError):
        dw.deblock_wave(y, u, u.clone(), meta[:1], R, C)

