"""media_tpu_torch's per-wave deblocking against media_tpu: exact equality.

The plain version of the wave-step kernel (the CPU path of
deblock_wave_step) must equal the JAX package's Pallas wave kernel run in
interpret mode on the same patches and strengths, and the per-wave route of
deblock_frame must equal the JAX deblock_frame under
MEDIA_TPU_DEBLOCK_KERNEL=pallas and the port's own whole-frame route. The
CUDA kernel is held to the plain version in tests/test_torch_cuda.py.
Everything is integer: tolerance 0.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from media_tpu.ops import deblock as jdb
from media_tpu.ops.deblock_pallas import deblock_wave_pallas
from media_tpu.pipeline import deblock_apply as jda
from media_tpu.ref.deblock import inter_bs_grids_np, intra_bs_grids_np
from media_tpu_torch.ops import deblock_pallas as tdp
from media_tpu_torch.ops.deblock import META_COLS
from media_tpu_torch.pipeline import deblock_apply as tda


def planes(R, C, seed=0, smooth=False):
    rng = np.random.default_rng(seed)
    out = [rng.integers(0, 256, (R * s, C * s)).astype(np.int32)
           for s in (16, 8, 8)]
    if smooth:  # |p0-q0| < alpha, so most edges filter
        out = [(p // 8 + off).astype(np.int32)
               for p, off in zip(out, (100, 80, 80))]
    return out


def torch_deblock(y, u, v, qp, qp_c, bs_v, bs_h, R, C, kernel, qp_map=None):
    T = torch.as_tensor
    out = tda.deblock_frame(T(y), T(u), T(v), qp, qp_c, T(bs_v), T(bs_h), R,
                            C, qp_map=qp_map, kernel=kernel)
    assert all(p.dtype == torch.uint8 for p in out)
    return [p.numpy() for p in out]


def _tc0(bs, qp):
    row = jdb.TC0_TABLE[qp]
    return np.where(bs == 1, row[0], np.where(bs == 2, row[1],
                                              np.where(bs == 3, row[2], 0)))


@pytest.mark.parametrize("n,qp,smooth", [(1, 30, True), (7, 22, True),
                                         (12, 36, False)])
def test_step_plain_matches_pallas_interpret(n, qp, smooth):
    """N patches with random bS (0..4) per edge and 4x4 block: the Pallas
    kernel takes eight strength arrays and four scalars, the port one meta
    row per MB carrying the same values."""
    rng = np.random.default_rng(n + qp)
    qp_c = min(qp, 39) - 1
    yp = rng.integers(0, 256, (n, 20, 20)).astype(np.int32)
    up = rng.integers(0, 256, (n, 12, 12)).astype(np.int32)
    vp = rng.integers(0, 256, (n, 12, 12)).astype(np.int32)
    if smooth:
        yp, up, vp = yp // 8 + 100, up // 8 + 80, vp // 8 + 80
    bsv = rng.integers(0, 5, (n, 4, 4)).astype(np.int32)  # [mb, edge, block]
    bsh = rng.integers(0, 5, (n, 4, 4)).astype(np.int32)
    bscv, bsch = bsv[:, (0, 2)], bsh[:, (0, 2)]

    # JAX side: edge index leading, one value per sample line.
    def lead(bs, rep, horizontal):
        x = np.repeat(bs, rep, axis=2).transpose(1, 0, 2)
        return x[:, :, None, :] if horizontal else x[..., None]

    a, b = int(jdb.ALPHA_TABLE[qp]), int(jdb.BETA_TABLE[qp])
    ac, bc = int(jdb.ALPHA_TABLE[qp_c]), int(jdb.BETA_TABLE[qp_c])
    jv, jh = lead(bsv, 4, False), lead(bsh, 4, True)
    jcv, jch = lead(bscv, 2, False), lead(bsch, 2, True)
    want = deblock_wave_pallas(
        jnp.asarray([a, b, ac, bc], jnp.int32), jv, _tc0(jv, qp), jh,
        _tc0(jh, qp), jcv, _tc0(jcv, qp_c), jch, _tc0(jch, qp_c),
        yp, up, vp, True)

    # Port side: the meta row of ops/deblock.py:META_COLS.
    meta = np.concatenate([
        bsv.reshape(n, 16), bsh.reshape(n, 16),
        _tc0(bsv, qp).reshape(n, 16), _tc0(bsh, qp).reshape(n, 16),
        bscv.reshape(n, 8), bsch.reshape(n, 8),
        _tc0(bscv, qp_c).reshape(n, 8), _tc0(bsch, qp_c).reshape(n, 8),
        np.tile([a, b], (n, 8)), np.tile([ac, bc], (n, 4))],
        axis=1).astype(np.int32)
    assert meta.shape == (n, META_COLS)
    T = torch.as_tensor
    before = tdp.deblock_wave_step.launches
    got = tdp.deblock_wave_step(
        T(yp.astype(np.uint8)), T(up.astype(np.uint8)),
        T(vp.astype(np.uint8)), T(meta))
    assert tdp.deblock_wave_step.launches == before  # the CPU path launches none
    for w, g, name, src in zip(want, got, "yuv", (yp, up, vp)):
        assert g.dtype == torch.uint8
        np.testing.assert_array_equal(np.asarray(w), g.numpy(), err_msg=name)
    if smooth:
        assert (got[0].numpy() != yp).any() and (got[1].numpy() != up).any()


@pytest.mark.parametrize("qp", [22, 30])
@pytest.mark.parametrize("smooth", [False, True])
def test_wave_route_matches_jax_pallas_intra(qp, smooth, monkeypatch):
    monkeypatch.setenv("MEDIA_TPU_DEBLOCK_KERNEL", "pallas")
    R, C = 4, 5
    y, u, v = planes(R, C, seed=qp, smooth=smooth)
    bs_v, bs_h = intra_bs_grids_np(R, C)
    qp_c = min(qp, 39)
    want = jda.deblock_frame(y, u, v, qp, qp_c, bs_v, bs_h, R, C)
    got = torch_deblock(y, u, v, qp, qp_c, bs_v, bs_h, R, C, "wave")
    for a, b, name in zip(want, got, "yuv"):
        np.testing.assert_array_equal(np.asarray(a).astype(np.uint8), b,
                                      err_msg=name)


@pytest.mark.parametrize("seed", range(2))
def test_wave_route_matches_jax_pallas_inter(seed, monkeypatch):
    monkeypatch.setenv("MEDIA_TPU_DEBLOCK_KERNEL", "pallas")
    R, C = 3, 6
    y, u, v = planes(R, C, seed=seed, smooth=True)
    rng = np.random.default_rng(100 + seed)
    nnz = (rng.random((R * 4, C * 4)) < 0.4).astype(np.int32)
    mv = rng.integers(-20, 21, (R, C, 2)).astype(np.int32)
    bs_v, bs_h = inter_bs_grids_np(nnz, mv)
    want = jda.deblock_frame(y, u, v, 32, 32, bs_v, bs_h, R, C)
    got = torch_deblock(y, u, v, 32, 32, bs_v, bs_h, R, C, "wave")
    for a, b, name in zip(want, got, "yuv"):
        np.testing.assert_array_equal(np.asarray(a).astype(np.uint8), b,
                                      err_msg=name)
    assert (got[0] != y).any()


@pytest.mark.parametrize("R,C,qp", [(1, 1, 30), (2, 7, 26), (5, 3, 38)])
def test_wave_route_matches_frame_route(R, C, qp):
    y, u, v = planes(R, C, seed=R * C, smooth=True)
    rng = np.random.default_rng(R + C)
    bs_v = rng.integers(0, 5, (R * 4, C * 4)).astype(np.int32)
    bs_h = rng.integers(0, 5, (R * 4, C * 4)).astype(np.int32)
    a = torch_deblock(y, u, v, qp, qp - 1, bs_v, bs_h, R, C, "frame")
    b = torch_deblock(y, u, v, qp, qp - 1, bs_v, bs_h, R, C, "wave")
    for p, q, name in zip(a, b, "yuv"):
        np.testing.assert_array_equal(p, q, err_msg=name)


def test_wave_route_rejects_qp_map_and_unknown_kernel():
    R, C = 2, 2
    y, u, v = planes(R, C)
    bs_v, bs_h = intra_bs_grids_np(R, C)
    with pytest.raises(NotImplementedError):
        torch_deblock(y, u, v, 30, 29, bs_v, bs_h, R, C, "wave",
                      qp_map=torch.full((R, C), 30))
    with pytest.raises(ValueError):
        torch_deblock(y, u, v, 30, 29, bs_v, bs_h, R, C, "pallas")


def test_wave_step_rejects_bad_inputs():
    yp = torch.zeros((2, 20, 20), dtype=torch.uint8)
    cp = torch.zeros((2, 12, 12), dtype=torch.uint8)
    meta = torch.zeros((2, META_COLS), dtype=torch.int32)
    with pytest.raises(ValueError):
        tdp.deblock_wave_step(yp.int(), cp, cp.clone(), meta)
    with pytest.raises(ValueError):
        tdp.deblock_wave_step(yp, cp, cp.clone(), meta[:1])
    with pytest.raises(ValueError):
        tdp.deblock_wave_step(yp, cp[:, :, :8], cp.clone(), meta)
    with pytest.raises(ValueError):
        tdp.deblock_wave_step(yp[:0], cp[:0], cp[:0], meta[:0])
