"""media_tpu_torch ops against media_tpu's JAX ops: exact equality.

Transform/quant, intra prediction and costs, full-pel search and half-pel
planes of the PyTorch port are fed the same seeded integers as the JAX
functions and must agree bit for bit; the JAX functions' results (on the
CPU) are read from tests/golden_torch/ (the recipes say what they were
asked; tests/jax_golden.py). The JAX-free copies of constant tables must
equal the originals, read live.
"""

import numpy as np
import pytest
import torch

from jax_golden import Golden
from media_tpu.entropy import device_cavlc as jdc
from media_tpu.ops import deblock as jdb
from media_tpu.ops import transform as jT
from media_tpu.pipeline import encoder as jenc
from media_tpu_torch.entropy import device_cavlc as tdc
from media_tpu_torch.ops import deblock as tdb
from media_tpu_torch.ops import interp as tinterp
from media_tpu_torch.ops import intra as tintra
from media_tpu_torch.ops import me as tme
from media_tpu_torch.ops import transform as tT
from media_tpu_torch.pipeline import encoder as tenc


GOLDEN = Golden(__file__)


def eq(a, b, msg=""):
    np.testing.assert_array_equal(np.asarray(a), b.numpy(), err_msg=msg)


def eq_all(want, got):
    assert len(want) == len(got)
    for i, (a, b) in enumerate(zip(want, got)):
        eq(a, b, str(i))


@GOLDEN.recipe
def jax_chroma_qp():
    """The JAX package's chroma_qp of QP 0..51."""
    return [int(jT.chroma_qp(qp)) for qp in range(52)]


def test_constant_tables_equal_originals():
    for name in ("MF_4x4", "V_4x4", "CHROMA_QP_TABLE", "ZIGZAG_FLAT",
                 "INV_ZIGZAG_FLAT"):
        np.testing.assert_array_equal(getattr(jT, name), getattr(tT, name),
                                      err_msg=name)
    for name in ("ALPHA_TABLE", "BETA_TABLE", "TC0_TABLE"):
        np.testing.assert_array_equal(getattr(jdb, name), getattr(tdb, name),
                                      err_msg=name)
    np.testing.assert_array_equal(jenc.ZSCAN_TO_RASTER, tenc.ZSCAN_TO_RASTER)
    for name in ("_LEN_CT", "_COD_CT", "_LEN_CDC", "_COD_CDC", "_LEN_TZ",
                 "_COD_TZ", "_LEN_TZC", "_COD_TZC", "_LEN_RB", "_COD_RB"):
        np.testing.assert_array_equal(getattr(jdc, name), getattr(tdc, name),
                                      err_msg=name)
    assert jdc.MAX_LEVEL == tT.MAX_LEVEL
    assert (jdc.BLOCK_WORDS, jdc.HDR_WORDS) == (tdc.BLOCK_WORDS, tdc.HDR_WORDS)
    assert GOLDEN.read(jax_chroma_qp) == [int(tT.chroma_qp(qp))
                                          for qp in range(52)]


def chain_inputs(qp):
    """Residuals and levels of 64 blocks."""
    rng = np.random.default_rng(qp)
    res = rng.integers(-255, 256, (64, 4, 4)).astype(np.int32)
    z = rng.integers(-40, 41, (64, 4, 4)).astype(np.int32)
    return res, z


def chain(m, qp, res, z, w, d, scans):
    """The chain's steps through transform module m (either package's):
    the forward transform of res, then each step on its own input; w, d
    and scans are the JAX package's forward, dequant and zigzag outputs."""
    out = [m.forward_4x4(res), m.hadamard_4x4(w), m.hadamard_2x2(w[:, :2, :2])]
    for intra in (True, False):
        out.append(m.quant_4x4(w, qp, intra=intra))
        out.append(m.quant_dc_2x2(w[:, :2, :2], qp, intra=intra))
    out += [m.quant_dc_4x4(w * 4, qp), m.dequant_4x4(z, qp),
            m.dequant_dc_4x4(z, qp), m.dequant_dc_2x2(z[:, :2, :2], qp),
            m.inverse_4x4(d), m.zigzag(z), m.inverse_zigzag(scans)]
    return out


CHAIN_QPS = [0, 17, 30, 44, 51]


@GOLDEN.recipe(cases=CHAIN_QPS)
def jax_transform_chain(qp):
    """chain() through the JAX transforms, and its w, d and scans."""
    res, z = chain_inputs(qp)
    w = np.array(jT.forward_4x4(res))
    d = np.array(jT.dequant_4x4(z, qp))
    scans = np.array(jT.zigzag(z))
    out = chain(jT, qp, res, z, w, d, scans)
    return {"w": w, "d": d, "scans": scans,
            "out": [np.asarray(a) for a in out]}


@pytest.mark.parametrize("qp", CHAIN_QPS)
def test_transform_quant_chain(qp):
    res, z = chain_inputs(qp)
    jax = GOLDEN.read(jax_transform_chain, qp)
    T_ = torch.as_tensor
    eq_all(jax["out"], chain(tT, qp, T_(res), T_(z), T_(jax["w"]),
                             T_(jax["d"]), T_(jax["scans"])))


CLAMP_W = np.array([[[30000, -30000, 5, 0]] * 4], np.int32)


@GOLDEN.recipe
def jax_quant_clamp():
    return np.asarray(jT.quant_4x4(CLAMP_W, 0, intra=True))


def test_quant_clamps_levels():
    eq(GOLDEN.read(jax_quant_clamp), tT.quant_4x4(torch.as_tensor(CLAMP_W), 0,
                                                  intra=True))


def intra_inputs(seed):
    rng = np.random.default_rng(seed)
    n = 24
    top = rng.integers(0, 256, (n, 16)).astype(np.int32)
    left = rng.integers(0, 256, (n, 16)).astype(np.int32)
    tl = rng.integers(0, 256, (n,)).astype(np.int32)
    at = rng.random(n) < 0.6
    al = rng.random(n) < 0.6
    orig = rng.integers(0, 256, (n, 16, 16)).astype(np.int32)
    return top, left, tl, at, al, orig


def intra_chain(m, top, left, tl, at, al, orig):
    """Intra predictions and costs through intra module m (either
    package's)."""
    ct, cl, corig = top[:, :8], left[:, :8], orig[:, :8, :8]
    p16 = m.pred_16x16_all(top, left, tl, at, al)
    pc = m.pred_chroma_all(ct, cl, tl, at, al)
    return [p16, m.mode_available_16x16(at, al), m.satd_cost(p16, orig),
            m.sad_cost(p16, orig), pc, m.mode_available_chroma(at, al),
            m.sad_cost(pc, corig)]


@GOLDEN.recipe(cases=[0, 1])
def jax_intra_chain(seed):
    from media_tpu.ops import intra as jintra

    return [np.asarray(a) for a in intra_chain(jintra, *intra_inputs(seed))]


@pytest.mark.parametrize("seed", [0, 1])
def test_intra_predictions_and_costs(seed):
    got = intra_chain(tintra, *map(torch.as_tensor, intra_inputs(seed)))
    eq_all(GOLDEN.read(jax_intra_chain, seed), got)


def search_inputs(flat):
    rng = np.random.default_rng(5)
    n, rs = 6, 8
    win = rng.integers(0, 256, (n, 16 + 2 * rs, 16 + 2 * rs)).astype(np.int32)
    if flat:  # many exact ties: the first minimum must win in both
        win = (win // 128) * 100
    cur = win[:, 5 : 5 + 16, 11 : 11 + 16].copy()
    cur[0] = rng.integers(0, 256, (16, 16))
    return cur, win, rs


@GOLDEN.recipe(cases=[False, True])
def jax_full_search(flat):
    import jax.numpy as jnp

    from media_tpu.ops import me as jme

    cur, win, rs = search_inputs(flat)
    mv, cost = jme.full_search(jnp.asarray(cur), jnp.asarray(win), rs)
    return np.asarray(mv), np.asarray(cost)


@pytest.mark.parametrize("flat", [False, True])
def test_full_search(flat):
    cur, win, rs = search_inputs(flat)
    mv, cost = GOLDEN.read(jax_full_search, flat)
    tmv, tcost = tme.full_search(torch.as_tensor(cur), torch.as_tensor(win), rs)
    eq(mv, tmv)
    eq(cost, tcost)


def half_pel_ref():
    rng = np.random.default_rng(9)
    return rng.integers(0, 256, (40, 56)).astype(np.int32)


@GOLDEN.recipe
def jax_half_pel_planes():
    from media_tpu.ops import interp as jinterp

    return [np.asarray(p) for p in jinterp.half_pel_planes(half_pel_ref())]


def test_half_pel_planes():
    want = GOLDEN.read(jax_half_pel_planes)
    eq_all(want, tinterp.half_pel_planes(torch.as_tensor(half_pel_ref())))
