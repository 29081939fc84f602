"""media_tpu_torch's I_4x4 intra path against media_tpu's: exact equality.

The nine 4x4 prediction modes on random and on flat samples under every
availability combination; FrameEncoder.encode_iframe(i4x4=True) field by
field on a structured scene that holds I_4x4 macroblocks and a flat region
(where several modes tie and the first must win); EncoderSession byte for
byte for i4x4 x {CAVLC, CABAC} x {deblock on, off}; and the reference
operating point at a small size (i4x4 + CBR + CABAC) through encode_frames,
the staged entry and load_reference_state mid-GOP. Everything is integer:
tolerance 0, except the rate controller's float32 carry (1e-6 relative).
The JAX side is read from tests/golden_torch/ (the recipes say what the JAX
package was asked; tests/jax_golden.py); it deblocked one wave per scan step
(same bytes, smaller programs).
"""

import itertools

import numpy as np
import pytest
import torch

from jax_golden import Golden
from media_tpu_torch.ops import intra as tintra
from media_tpu_torch.pipeline import encoder as tenc
from media_tpu_torch.pipeline.codec import EncoderConfig, EncoderSession
from media_tpu_torch.utils import yuv

W, H, QP, K = 64, 48, 28, 2
GOLDEN = Golden(__file__, env={"MEDIA_TPU_DEBLOCK_UNROLL": "1"})


def structured_scene(w, h, seed=1, shift=0):
    """Strong directional edges (the content where I_4x4 wins) around a flat
    rectangle (where the 4x4 modes tie)."""
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
          for t in range(1 + 2 * K)]


# ------------------------------------------------------------ pred_4x4_all

AVAILS = list(itertools.product([False, True], repeat=3))
KINDS = ["random", "flat"]


def pred_inputs(kind, avail):
    """top, left, corner and the three availability flags of 96 blocks."""
    rng = np.random.default_rng(5)
    n = 96
    if kind == "random":
        top, left, corner = (rng.integers(0, 256, s).astype(np.int32)
                             for s in ((n, 8), (n, 4), (n,)))
    else:
        level = rng.integers(0, 256, n).astype(np.int32)
        top, left, corner = (np.repeat(level[:, None], 8, 1),
                             np.repeat(level[:, None], 4, 1), level)
    return (top, left, corner, *(np.full(n, a) for a in avail))


@GOLDEN.recipe(cases=[(k, a) for k in KINDS for a in AVAILS])
def jax_pred_4x4_all(kind, avail):
    """The jitted JAX pred_4x4_all: (predictions, mode availability)."""
    import jax
    import jax.numpy as jnp

    from media_tpu.ops import intra as jintra

    p, ok = jax.jit(jintra.pred_4x4_all)(
        *(jnp.asarray(x) for x in pred_inputs(kind, avail)))
    return np.asarray(p), np.asarray(ok)


@pytest.mark.parametrize("avail", AVAILS)
@pytest.mark.parametrize("kind", KINDS)
def test_pred_4x4_all_matches_jax(kind, avail):
    n = 96
    want_p, want_ok = GOLDEN.read(jax_pred_4x4_all, kind, avail)
    got_p, got_ok = tintra.pred_4x4_all(*(torch.tensor(x) for x in
                                          pred_inputs(kind, avail)))
    assert got_p.dtype == torch.int32 and got_p.shape == (n, 9, 4, 4)
    np.testing.assert_array_equal(got_p.numpy(), want_p)
    np.testing.assert_array_equal(got_ok.numpy(), want_ok)


def test_corner_is_not_a_wrapped_top_sample():
    """Index -1 of either neighbour run is p[-1, -1]: a diagonal-down-right
    block of a corner that differs from t[7] and l[3] shows it."""
    top = torch.full((1, 8), 10, dtype=torch.int32)
    top[0, 7] = 250
    left = torch.full((1, 4), 10, dtype=torch.int32)
    left[0, 3] = 250
    yes = torch.ones(1, dtype=torch.bool)
    preds, _ok = tintra.pred_4x4_all(top, left, torch.tensor([90],
                                                             dtype=torch.int32),
                                     yes, yes, yes)
    assert int(preds[0, tintra.I4_DDR, 0, 0]) == (10 + 2 * 90 + 10 + 2) >> 2


# ---------------------------------------------------------- encode_iframe

IFRAME_CASES = {"one-slice-deblock": ((), True), "two-slices": ((1,), False)}
FIELDS = ("is_i4", "modes4", "luma4_levels", "mode16", "chroma_mode",
          "dc_levels", "ac_levels", "cdc_levels", "cac_levels", "recon_y",
          "recon_u", "recon_v")


@GOLDEN.recipe(cases=list(IFRAME_CASES))
def jax_encode_iframe(name):
    """The JAX FrameEncoder's encode_iframe(i4x4=True), field by field."""
    from media_tpu.pipeline import encoder as jenc

    slice_rows, deblock = IFRAME_CASES[name]
    je = jenc.FrameEncoder(W, H, slice_rows=slice_rows)
    r = je.encode_iframe(*structured_scene(W, H), QP, deblock=deblock,
                         i4x4=True)
    return {f: np.asarray(getattr(r, f)) for f in FIELDS}


@pytest.fixture(scope="module")
def iframes():
    out = {}
    y, u, v = structured_scene(W, H)
    for name, (slice_rows, deblock) in IFRAME_CASES.items():
        te = tenc.FrameEncoder(W, H, "cpu", slice_rows=slice_rows)
        out[name] = (GOLDEN.read(jax_encode_iframe, name),
                     te.encode_iframe(y, u, v, QP, deblock=deblock, i4x4=True))
    return out


@pytest.mark.parametrize("field", FIELDS)
@pytest.mark.parametrize("case", list(IFRAME_CASES))
def test_encode_iframe_i4x4_field_matches_jax(iframes, case, field):
    want, got = iframes[case][0][field], getattr(iframes[case][1], field)
    if torch.is_tensor(got):
        got = got.numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want, err_msg=field)


@pytest.mark.parametrize("case", list(IFRAME_CASES))
def test_scene_holds_both_mb_types_and_ties(iframes, case):
    _want, got = iframes[case]
    n_i4 = int(got.is_i4.sum())
    assert 0 < n_i4 < got.is_i4.size
    # The side that lost carries no levels; mode16 is kept on I_4x4 MBs.
    assert not got.luma4_levels[~got.is_i4].any()
    assert not got.ac_levels[got.is_i4].any()
    assert not got.dc_levels[got.is_i4].any()


# ---------------------------------------------------------------- sessions


def cfg(cls, **kw):
    return cls(width=W, height=H, qp=QP, gop_size=30, i4x4=True, **kw)


@GOLDEN.recipe(cases=[(c, d) for c in (False, True) for d in (True, False)])
def jax_i4x4_session(cabac, deblock):
    """The JAX I_4x4 session's IDR + K P (host entropy) and its recon."""
    from media_tpu.pipeline.codec import EncoderConfig as JaxConfig
    from media_tpu.pipeline.codec import EncoderSession as JaxSession

    kw = dict(cabac=cabac, deblock=deblock, entropy_mode="host")
    js = JaxSession(cfg(JaxConfig, **kw))
    aus = [js.encode_frame(FRAMES[0])] + js.encode_frames(FRAMES[1 : 1 + K])
    return {"aus": aus, "recon": tuple(np.asarray(p) for p in js.recon)}


@pytest.mark.parametrize("deblock", [True, False])
@pytest.mark.parametrize("cabac", [False, True])
def test_i4x4_session_matches_jax(cabac, deblock):
    kw = dict(cabac=cabac, deblock=deblock, entropy_mode="host")
    js = GOLDEN.read(jax_i4x4_session, cabac, deblock)
    for coder in ("native", "python"):
        s = EncoderSession(cfg(EncoderConfig, **kw), device="cpu",
                           host_coder=coder)
        got = [s.encode_frame(FRAMES[0])] + s.encode_frames(FRAMES[1 : 1 + K])
        assert got == js["aus"], coder
    for a, b in zip(s.recon, js["recon"]):
        np.testing.assert_array_equal(a.numpy(), b)


OP_POINT = dict(cabac=True, cabac_init_idc=1, rc_mode="cbr", bitrate=150_000,
                framerate=30)


@GOLDEN.recipe
def jax_op_point_run():
    """The operating point at a small size from the JAX session: the AUs of
    IDR + K P, its state after them, the AUs of the next K P frames and the
    final rate state."""
    from media_tpu.pipeline.codec import EncoderConfig as JaxConfig
    from media_tpu.pipeline.codec import EncoderSession as JaxSession

    s = JaxSession(cfg(JaxConfig, **OP_POINT))
    s.PIPELINE_CHUNK = K
    aus = [s.encode_frame(FRAMES[0])] + s.encode_frames(FRAMES[1 : 1 + K])
    state = {
        "recon": tuple(np.asarray(p) for p in s.recon),
        "frame_idx": s.frame_idx, "frame_idx_of_idr": s.frame_idx_of_idr,
        "idr_pic_id": s.idr_pic_id, "_bits_hwm": s._bits_hwm,
        "rc_state": dict(s.rc_state), "_rc_corr": s._rc_corr,
        "_cabac_scale": s._cabac_scale,
        "_rc_dev": None if s._rc_dev is None else tuple(
            float(np.asarray(x)) for x in s._rc_dev),
    }
    more = s.encode_frames(FRAMES[1 + K :])
    return aus, state, more, dict(s.rc_state)


@pytest.fixture(scope="module")
def jax_op_point():
    return GOLDEN.read(jax_op_point_run)


def port_op_point():
    s = EncoderSession(cfg(EncoderConfig, **OP_POINT), device="cpu")
    s.PIPELINE_CHUNK = K
    return s


def _rc_close(got: dict, want: dict):
    for k in ("qp", "buf", "cplx"):
        assert got[k] == pytest.approx(want[k], rel=1e-6, abs=1e-3), k


def test_operating_point_with_i4x4_matches_jax(jax_op_point):
    aus, _state, more, rc = jax_op_point
    s = port_op_point()
    got = [s.encode_frame(FRAMES[0])] + s.encode_frames(FRAMES[1 : 1 + K])
    got += s.encode_frames(FRAMES[1 + K :])
    assert got == aus + more
    _rc_close(s.rc_state, rc)


def test_operating_point_with_i4x4_staged(jax_op_point):
    aus, _state, more, _rc = jax_op_point
    s = port_op_point()
    got = [s.encode_frame(FRAMES[0])] + s.encode_frames(FRAMES[1 : 1 + K])
    got += s.encode_frames_staged(s.upload_frames(FRAMES[1 + K :]))
    assert got == aus + more


def test_load_reference_state_continues_a_jax_i4x4_gop(jax_op_point):
    _aus, state, more, rc = jax_op_point
    s = port_op_point()
    s.load_reference_state(state)
    assert s.encode_frames(FRAMES[1 + K :]) == more
    _rc_close(s.rc_state, rc)
