"""media_tpu_torch ops against media_tpu's JAX ops: exact equality.

Transform/quant, intra prediction and costs, full-pel search and half-pel
planes of the PyTorch port are fed the same seeded integers as the JAX
functions (run on the CPU, as conftest pins them) and must agree bit for
bit. The JAX-free copies of constant tables must equal the originals.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from media_tpu.entropy import device_cavlc as jdc
from media_tpu.ops import deblock as jdb
from media_tpu.ops import interp as jinterp
from media_tpu.ops import intra as jintra
from media_tpu.ops import me as jme
from media_tpu.ops import transform as jT
from media_tpu.pipeline import encoder as jenc
from media_tpu_torch.entropy import device_cavlc as tdc
from media_tpu_torch.ops import deblock as tdb
from media_tpu_torch.ops import interp as tinterp
from media_tpu_torch.ops import intra as tintra
from media_tpu_torch.ops import me as tme
from media_tpu_torch.ops import transform as tT
from media_tpu_torch.pipeline import encoder as tenc


def eq(a, b, msg=""):
    np.testing.assert_array_equal(np.asarray(a), b.numpy(), err_msg=msg)


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
    for qp in range(52):
        assert int(jT.chroma_qp(qp)) == int(tT.chroma_qp(qp))


@pytest.mark.parametrize("qp", [0, 17, 30, 44, 51])
def test_transform_quant_chain(qp):
    rng = np.random.default_rng(qp)
    res = rng.integers(-255, 256, (64, 4, 4)).astype(np.int32)
    t = torch.as_tensor(res)
    eq(jT.forward_4x4(res), tT.forward_4x4(t))
    w = np.array(jT.forward_4x4(res))
    tw = torch.as_tensor(w)
    eq(jT.hadamard_4x4(w), tT.hadamard_4x4(tw))
    eq(jT.hadamard_2x2(w[:, :2, :2]), tT.hadamard_2x2(tw[:, :2, :2]))
    for intra in (True, False):
        eq(jT.quant_4x4(w, qp, intra=intra), tT.quant_4x4(tw, qp, intra=intra))
        eq(jT.quant_dc_2x2(w[:, :2, :2], qp, intra=intra),
           tT.quant_dc_2x2(tw[:, :2, :2], qp, intra=intra))
    eq(jT.quant_dc_4x4(w * 4, qp), tT.quant_dc_4x4(tw * 4, qp))
    z = rng.integers(-40, 41, (64, 4, 4)).astype(np.int32)
    tz = torch.as_tensor(z)
    eq(jT.dequant_4x4(z, qp), tT.dequant_4x4(tz, qp))
    eq(jT.dequant_dc_4x4(z, qp), tT.dequant_dc_4x4(tz, qp))
    eq(jT.dequant_dc_2x2(z[:, :2, :2], qp), tT.dequant_dc_2x2(tz[:, :2, :2], qp))
    d = np.array(jT.dequant_4x4(z, qp))
    eq(jT.inverse_4x4(d), tT.inverse_4x4(torch.as_tensor(d)))
    eq(jT.zigzag(z), tT.zigzag(tz))
    scans = np.array(jT.zigzag(z))
    eq(jT.inverse_zigzag(scans), tT.inverse_zigzag(torch.as_tensor(scans)))


def test_quant_clamps_levels():
    w = np.array([[[30000, -30000, 5, 0]] * 4], np.int32)
    eq(jT.quant_4x4(w, 0, intra=True), tT.quant_4x4(torch.as_tensor(w), 0,
                                                    intra=True))


@pytest.mark.parametrize("seed", [0, 1])
def test_intra_predictions_and_costs(seed):
    rng = np.random.default_rng(seed)
    n = 24
    top = rng.integers(0, 256, (n, 16)).astype(np.int32)
    left = rng.integers(0, 256, (n, 16)).astype(np.int32)
    tl = rng.integers(0, 256, (n,)).astype(np.int32)
    at = rng.random(n) < 0.6
    al = rng.random(n) < 0.6
    orig = rng.integers(0, 256, (n, 16, 16)).astype(np.int32)
    ct, cl, corig = top[:, :8], left[:, :8], orig[:, :8, :8]
    T_ = torch.as_tensor
    p16 = jintra.pred_16x16_all(top, left, tl, at, al)
    tp16 = tintra.pred_16x16_all(T_(top), T_(left), T_(tl), T_(at), T_(al))
    eq(p16, tp16)
    eq(jintra.mode_available_16x16(at, al),
       tintra.mode_available_16x16(T_(at), T_(al)))
    eq(jintra.satd_cost(p16, orig), tintra.satd_cost(tp16, T_(orig)))
    eq(jintra.sad_cost(p16, orig), tintra.sad_cost(tp16, T_(orig)))
    pc = jintra.pred_chroma_all(ct, cl, tl, at, al)
    tpc = tintra.pred_chroma_all(T_(ct), T_(cl), T_(tl), T_(at), T_(al))
    eq(pc, tpc)
    eq(jintra.mode_available_chroma(at, al),
       tintra.mode_available_chroma(T_(at), T_(al)))
    eq(jintra.sad_cost(pc, corig), tintra.sad_cost(tpc, T_(corig)))


@pytest.mark.parametrize("flat", [False, True])
def test_full_search(flat):
    rng = np.random.default_rng(5)
    n, rs = 6, 8
    win = rng.integers(0, 256, (n, 16 + 2 * rs, 16 + 2 * rs)).astype(np.int32)
    if flat:  # many exact ties: the first minimum must win in both
        win = (win // 128) * 100
    cur = win[:, 5 : 5 + 16, 11 : 11 + 16].copy()
    cur[0] = rng.integers(0, 256, (16, 16))
    mv, cost = jme.full_search(jnp.asarray(cur), jnp.asarray(win), rs)
    tmv, tcost = tme.full_search(torch.as_tensor(cur), torch.as_tensor(win), rs)
    eq(mv, tmv)
    eq(cost, tcost)


def test_half_pel_planes():
    rng = np.random.default_rng(9)
    ref = rng.integers(0, 256, (40, 56)).astype(np.int32)
    for a, b in zip(jinterp.half_pel_planes(ref),
                    tinterp.half_pel_planes(torch.as_tensor(ref))):
        eq(a, b)
