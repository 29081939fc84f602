"""media_tpu_torch's per-wave deblocking against media_tpu: exact equality.

The plain version of the wave-step kernel (the CPU path of
deblock_wave_step) must equal the JAX package's Pallas wave kernel run in
interpret mode on the same patches and strengths, and the per-wave route of
deblock_frame must equal the JAX deblock_frame under
MEDIA_TPU_DEBLOCK_KERNEL=pallas and the port's own whole-frame route. The
in-place wave step (patches read from and written to the raster planes, row
0 and column 0 guarded) must equal the same waves run on planes padded by 4
at the top and left. The CUDA kernel is held to the plain version in
tests/test_torch_cuda.py.
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
from media_tpu_torch.ops import deblock_wave as tdw
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


def _padded_waves(y, u, v, meta, R, C):
    """The waves of a picture on planes padded by 4 zeros at the top and
    left, so that every MB has a whole patch: gather, plain step, scatter."""
    padded = []
    for p in (y, u, v):
        q = torch.zeros((p.shape[0] + 4, p.shape[1] + 4), dtype=p.dtype)
        q[4:, 4:] = p
        padded.append(q)
    ar = {16: torch.arange(20), 8: torch.arange(12)}
    for k in range(tdp.n_waves(R, C)):
        r, c = tdp.wave_mbs(k, R, C, "cpu")
        idx = [((r[:, None] * s + ar[s])[:, :, None],
                (c[:, None] * s + ar[s])[:, None, :]) for s in (16, 8, 8)]
        out = tdp.deblock_wave_step_plain(
            *(q[i] for q, i in zip(padded, idx)), meta[r * C + c])
        for q, i, o in zip(padded, idx, out):
            q[i] = o
    return [q[4:, 4:] for q in padded]


def _inplace_case(R, C):
    T = torch.as_tensor
    src = [T(p.astype(np.uint8)) for p in planes(R, C, seed=R * C, smooth=True)]
    rng = np.random.default_rng(R + C)
    bs = [T(rng.integers(0, 5, (R * 4, C * 4)).astype(np.int32))
          for _ in range(2)]
    return src, tda.build_meta(30, 29, *bs, R, C)


@pytest.mark.parametrize("R,C", [(1, 1), (2, 7), (5, 3), (9, 5)])
def test_inplace_step_matches_padded_waves(R, C):
    src, meta = _inplace_case(R, C)
    want = _padded_waves(*src, meta, R, C)
    got = [p.clone() for p in src]
    before = tdp.deblock_wave_step.launches
    for k in range(tdp.n_waves(R, C)):
        tdp.deblock_wave_step_inplace(*got, meta, R, C, k)
    assert tdp.deblock_wave_step.launches == before  # the CPU path launches none
    routed = [p.clone() for p in src]
    tdw.run_waves(*routed, meta, R, C)
    for a, b, c, name in zip(want, got, routed, "yuv"):
        assert torch.equal(a, b) and torch.equal(a, c), name
    if R * C > 1:
        assert any(not torch.equal(a, p) for a, p in zip(got, src))


def test_inplace_step_rejects_bad_inputs():
    R, C = 2, 3
    (y, u, v), meta = _inplace_case(R, C)
    step = tdp.deblock_wave_step_inplace
    for k in (-1, tdp.n_waves(R, C)):
        with pytest.raises(ValueError):
            step(y, u, v, meta, R, C, k)
    with pytest.raises(ValueError):
        step(y.int(), u, v, meta, R, C, 0)
    with pytest.raises(ValueError):
        step(y, u, v, meta.long(), R, C, 0)
    with pytest.raises(ValueError):
        step(y.t().contiguous().t(), u, v, meta, R, C, 0)
    with pytest.raises(ValueError):
        step(y, u[:, :8], v, meta, R, C, 0)
    with pytest.raises(ValueError):
        tdw.run_waves(y, u, v, meta[:1], R, C)
