"""The port's rate-controlled P path against media_tpu's, module by module.

Same inputs from a numpy seed through the JAX function (CPU) and its
counterpart in the port (device="cpu"): per-MB quantisation, the device
CAVLC packer with a per-MB QP map (mb_qp_delta, a delta that wraps mod 52
included), one chunk of the CBR loop with and without adaptive_qp and
deblocking, and the CBR + CAVLC session with its host fallback. Tolerance:
none for streams, bits, QPs, levels and planes; the rate controller's three
floats within 1e-6 relative (`buf` relative to the per-frame target), since
the float32 rate loop's last place differs between XLA and torch. The JAX
side is read from tests/golden_torch/ (the recipes say what the JAX package
was asked; tests/jax_golden.py).
"""

import types

import numpy as np
import pytest
import torch

import chip_smoke as cs
from jax_golden import Golden
from media_tpu_torch.core.bitstream import BitWriter
from media_tpu_torch.entropy import device_cavlc as tpack
from media_tpu_torch.ops import transform as T
from media_tpu_torch.pipeline import encoder as tenc
from media_tpu_torch.pipeline import pframe_core as tcore
from media_tpu_torch.pipeline import slice_coder
from media_tpu_torch.pipeline.codec import EncoderConfig, EncoderSession
from media_tpu_torch.pipeline.deblock_apply import build_meta

W, H = 64, 48
R, C = H // 16, W // 16
GOLDEN = Golden(__file__)


# ------------------------------------------------------------- ops/transform

QP_FORMS = [0, 11, 30, 51, "scalar", "map"]


def quant_inputs(qp):
    """Coefficients and the QP in the form named: an int, a 0-d int32 (37)
    or a per-MB map."""
    rng = np.random.default_rng(3)
    n = 7
    w = rng.integers(-4000, 4000, (n, 16, 4, 4)).astype(np.int32)
    w2 = rng.integers(-4000, 4000, (n, 2, 2)).astype(np.int32)
    qmap = rng.integers(0, 52, n).astype(np.int32)
    q = {"scalar": np.int32(37), "map": qmap}.get(qp, qp)
    return w, w2, q


@GOLDEN.recipe(cases=QP_FORMS)
def jax_quantisers(qp):
    """The JAX quantisers and dequantisers, intra and inter."""
    import jax.numpy as jnp

    from media_tpu.ops import transform as JT

    w, w2, q = quant_inputs(qp)
    jq = jnp.asarray(q) if isinstance(q, np.ndarray | np.generic) else q
    out = []
    for intra in (True, False):
        out.append(JT.quant_4x4(w, jq, intra=intra))
        out.append(JT.quant_dc_2x2(w2, jq, intra=intra))
    out.append(JT.dequant_4x4(w // 64, jq))
    out.append(JT.dequant_dc_2x2(w2 // 16, jq))
    return [np.asarray(a) for a in out]


@pytest.mark.parametrize("qp", QP_FORMS)
def test_quantisers_take_int_scalar_and_per_mb_qp(qp):
    w, w2, q = quant_inputs(qp)
    tq = torch.tensor(q) if isinstance(q, np.ndarray | np.generic) else q
    tw, tw2 = torch.tensor(w), torch.tensor(w2)
    got = []
    for intra in (True, False):
        got.append(T.quant_4x4(tw, tq, intra=intra))
        got.append(T.quant_dc_2x2(tw2, tq, intra=intra))
    got.append(T.dequant_4x4(tw // 64, tq))
    got.append(T.dequant_dc_2x2(tw2 // 16, tq))
    want = GOLDEN.read(jax_quantisers, qp)
    assert len(got) == len(want)
    for w_, g in zip(want, got):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(w_, g.numpy())


@GOLDEN.recipe
def jax_chroma_qp_device():
    """chroma_qp_device over QPs -3..55."""
    import jax.numpy as jnp

    from media_tpu.pipeline import pframe_core as jcore

    return np.asarray(jcore.chroma_qp_device(
        jnp.arange(-3, 56, dtype=jnp.int32)))


def test_chroma_qp_device_and_tensor_qp_meta():
    qp = torch.arange(-3, 56, dtype=torch.int32)
    np.testing.assert_array_equal(GOLDEN.read(jax_chroma_qp_device),
                                  tcore.chroma_qp_device(qp).numpy())
    # The deblocking meta from a QP held in a 0-d tensor, as the rate loop
    # hands it over, equals the meta from the same QP as a Python int.
    g = torch.Generator().manual_seed(0)
    bs = [torch.randint(0, 5, (4 * R, 4 * C), generator=g, dtype=torch.int32)
          for _ in range(2)]
    for q in (0, 27, 51):
        qc = int(T.chroma_qp(q))
        want = build_meta(q, qc, *bs, R, C)
        got = build_meta(torch.tensor(q, dtype=torch.int32),
                         torch.tensor(qc, dtype=torch.int32), *bs, R, C)
        assert torch.equal(want, got)


# ------------------------------------------------- entropy/device_cavlc.py


def _sparse(rng, shape, density, mag=30):
    a = rng.integers(-mag, mag, size=shape).astype(np.int32)
    return (a * (rng.random(shape) < density)).astype(np.int32)


PACK_CASES = [(0, 0.02), (1, 0.15), (2, 0.5)]


def pack_inputs(seed, density):
    """P symbols with skip candidates and uncoded MBs, and a QP map."""
    rng = np.random.default_rng(seed)
    mv = rng.integers(-6, 7, (R, C, 2)).astype(np.int32)
    luma = _sparse(rng, (R, C, 16, 16), density)
    cdc = _sparse(rng, (R, C, 2, 4), density)
    cac = _sparse(rng, (R, C, 2, 4, 15), density)
    for a in (mv, luma, cdc, cac):
        a[1:, :2] = 0  # skip candidates and uncoded MBs
    # 2 beside 50: a delta of +48 is coded as -4, one of -48 as +4.
    qp_map = rng.choice([2, 29, 30, 50], (R, C)).astype(np.int32)
    return mv, luma, cdc, cac, qp_map


@GOLDEN.recipe(cases=PACK_CASES)
def jax_pack(seed, density):
    """The JAX device packer at a cap of 4096 words, slice QP 30: (stream
    words, bits). Jitted: eagerly it dispatches thousands of small
    operations."""
    import jax
    import jax.numpy as jnp

    from media_tpu.entropy import device_cavlc as jpack

    mv, luma, cdc, cac, qp_map = pack_inputs(seed, density)
    s, b = jax.jit(lambda mv, luma, cdc, cac, qp_map, slice_qp:
                   jpack.pack_pslice_device(mv, luma, cdc, cac, 4096,
                                            qp_map=qp_map,
                                            slice_qp=slice_qp))(
        jnp.asarray(mv), jnp.asarray(luma), jnp.asarray(cdc),
        jnp.asarray(cac), jnp.asarray(qp_map), jnp.int32(30))
    return np.asarray(s), int(b)


@pytest.mark.parametrize("seed,density", PACK_CASES)
def test_pack_pslice_device_with_qp_map(seed, density):
    mv, luma, cdc, cac, qp_map = pack_inputs(seed, density)
    cap = 4096
    want_s, want_b = GOLDEN.read(jax_pack, seed, density)
    got_s, got_b = tpack.pack_pslice_device(
        *(torch.tensor(a) for a in (mv, luma, cdc, cac)), cap,
        qp_map=torch.tensor(qp_map),
        slice_qp=torch.tensor(30, dtype=torch.int32))
    assert int(got_b) == int(want_b) <= cap * 32
    np.testing.assert_array_equal(got_s.numpy().astype(np.uint32), want_s)
    # ... and equals the Python writer given the same map.
    bw = BitWriter()
    slice_coder.write_pslice_mbs(bw, mv=mv, luma_levels=luma, cdc_levels=cdc,
                                 cac_levels=cac, qp_map=qp_map, slice_qp=30)
    assert bw.bit_position == int(got_b)
    bw.rbsp_trailing_bits()
    merged = BitWriter()
    tpack.merge_slice_data(merged, got_s.numpy().astype(np.uint32), int(got_b))
    assert merged.get_bytes() == bw.get_bytes()


def test_last_coded_scan():
    vals = torch.tensor([5, 6, 7, 8, 9, 10])
    coded = torch.tensor([False, True, False, False, True, False])
    got = tpack._last_coded(vals, coded, torch.tensor(1))
    assert got.tolist() == [1, 6, 6, 6, 9, 9]
    none = tpack._last_coded(vals, torch.zeros(6, dtype=torch.bool),
                             torch.tensor(3))
    assert none.tolist() == [3] * 6


# ----------------------------------------------- pipeline/encoder.py: chunk


def planes(n, seed=0):
    rng = np.random.default_rng(seed)
    big = rng.integers(0, 256, (H + 40, W + 40)).astype(np.float64)
    for _ in range(2):
        big = (big + np.roll(big, 1, 0) + np.roll(big, 1, 1)) / 3
    out = []
    for t in range(n):
        y = (big[2 * t : 2 * t + H, 3 * t : 3 * t + W]
             + rng.normal(0, 1.5, (H, W))).round().clip(0, 255).astype(np.uint8)
        out.append((y, (y[::2, ::2] // 2 + 40).astype(np.uint8),
                    (y[::2, ::2] // 3 + 70).astype(np.uint8)))
    return out


PLANES = planes(4)
RC0 = {"qp": 27.3, "buf": 5000.0, "cplx": 9000 * 0.625 * 2 ** (27.3 / 6)}
TARGET = 9000


def _close(a, b, scale=0.0):
    return abs(a - b) <= 1e-6 * max(abs(a), abs(b), scale)


CHUNK_CASES = [(1, False, False), (3, False, True), (3, True, False),
               (3, True, True)]


def chunk_args(k, adaptive, deblock):
    ys, us, vs = (np.stack([f[i] for f in PLANES[1 : 1 + k]])
                  for i in range(3))
    return ((ys, us, vs, *PLANES[0], RC0, TARGET),
            dict(deblock=deblock, adaptive_qp=adaptive, cap=16384))


@GOLDEN.recipe(cases=CHUNK_CASES)
def jax_cbr_chunk(k, adaptive, deblock):
    """The JAX FrameEncoder's encode_pframes_cbr on chunk_args(): streams,
    bits, QPs, recon planes and the rate carry."""
    from media_tpu.pipeline import encoder as jenc

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MEDIA_TPU_DEBLOCK_UNROLL", "1")
        args, kw = chunk_args(k, adaptive, deblock)
        out = jenc.FrameEncoder(W, H).encode_pframes_cbr(*args, **kw)
    return ([np.asarray(a) for a in out[:3]],
            [np.asarray(a) for a in out[3]], dict(out[4]))


@pytest.mark.parametrize("k,adaptive,deblock", CHUNK_CASES, ids=[
    "step-frame_qp-plain", "chunk-frame_qp-deblock", "chunk-mb_qp-plain",
    "chunk-mb_qp-deblock"])
def test_cbr_chunk_equals_jax(k, adaptive, deblock):
    """One step and a chunk of three of the device rate loop (four cases,
    not eight: each compiled a JAX program of its own)."""
    args, kw = chunk_args(k, adaptive, deblock)
    arrays, recon, rc = GOLDEN.read(jax_cbr_chunk, k, adaptive, deblock)
    want = (*arrays, recon, rc)
    enc = tenc.FrameEncoder(W, H, "cpu")
    ref_before = [p.copy() for p in PLANES[0]]
    got = enc.encode_pframes_cbr(*args, **kw)
    np.testing.assert_array_equal(got[0], want[0])  # streams
    np.testing.assert_array_equal(got[1], want[1])  # bits
    np.testing.assert_array_equal(got[2], want[2])  # qps
    assert got[2].dtype == np.int32
    assert len(got[3]) == len(want[3])
    for a, b in zip(got[3], want[3]):
        np.testing.assert_array_equal(a.numpy(), b)
    assert _close(got[4]["qp"], want[4]["qp"])
    assert _close(got[4]["cplx"], want[4]["cplx"])
    assert _close(got[4]["buf"], want[4]["buf"], TARGET)
    # The loop writes to none of its inputs: a second run is the same run.
    for a, b in zip(PLANES[0], ref_before):
        np.testing.assert_array_equal(a, b)
    again = enc.encode_pframes_cbr(*args, **kw)
    np.testing.assert_array_equal(again[0], got[0])
    assert again[4] == got[4]


def test_cbr_dev_entry_scales_the_feedback_and_keeps_tensors():
    """encode_pframes_cbr_dev: device tensors in and out, the carry as 0-d
    float32 tensors, and a bits_scale that moves buf and cplx but not this
    chunk's first QP."""
    enc = tenc.FrameEncoder(W, H, "cpu")
    dev = [torch.tensor(np.stack([f[i] for f in PLANES[1:3]]))
           for i in range(3)]
    ref = tuple(torch.tensor(p) for p in PLANES[0])
    outs = [enc.encode_pframes_cbr_dev(*dev, ref, RC0, TARGET, bits_scale=s,
                                       deblock=True, cap=16384)
            for s in (1.0, 0.8)]
    for streams, bits, qps, recon, rc in outs:
        assert streams.shape == (2, 16384) and bits.shape == (2,)
        assert qps.dtype == torch.int32 and recon[0].dtype == torch.uint8
        assert all(x.dtype == torch.float32 and x.dim() == 0 for x in rc)
    assert int(outs[0][2][0]) == int(outs[1][2][0])
    assert torch.equal(outs[0][0][0], outs[1][0][0])
    assert float(outs[1][4][1]) < float(outs[0][4][1])  # buf
    # A carry handed back in as tensors continues the loop.
    rc = dict(zip(("qp", "buf", "cplx"), outs[0][4]))
    more = enc.encode_pframes_cbr_dev(*dev, outs[0][3], rc, TARGET, cap=16384)
    assert int(more[1].max()) <= 16384 * 32


# --------------------------------------------- pipeline/codec.py: CBR + CAVLC


def clip(n):
    return [y.tobytes() + u.tobytes() + v.tobytes() for y, u, v in planes(n, 5)]


FRAMES = clip(8)
CBR = dict(width=W, height=H, qp=30, gop_size=30, rc_mode="cbr",
           bitrate=150_000, framerate=30)


def drive(s):
    log = cs.tap_rate_loop(s)
    aus = [s.encode_frame(FRAMES[0])] + s.encode_frames(FRAMES[1:5])
    aus += [s.encode_frame(f) for f in FRAMES[5:7]]
    return aus, cs.rate_record(s, aus, log)


@GOLDEN.recipe
def jax_cbr_run():
    """The JAX session's CBR + CAVLC run, and the same run with a stream
    budget of 8 words, which sends every P run down the host fallback."""
    from media_tpu.pipeline import encoder as jenc
    from media_tpu.pipeline.codec import EncoderConfig as JaxConfig
    from media_tpu.pipeline.codec import EncoderSession as JaxSession

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MEDIA_TPU_DEBLOCK_UNROLL", "1")
        s = JaxSession(JaxConfig(**CBR))
        s.PIPELINE_CHUNK = 2
        aus, rec = drive(s)
        mp.setattr(jenc.FrameEncoder, "cap_words", property(lambda _: 8))
        f = JaxSession(JaxConfig(**CBR))
        fallback = [f.encode_frame(FRAMES[0])] + f.encode_frames(FRAMES[1:4])
    return dict(aus=aus, rec=rec, fallback=fallback,
                fallback_rc=dict(f.rc_state))


@pytest.fixture(scope="module")
def jax_cbr():
    return types.SimpleNamespace(**GOLDEN.read(jax_cbr_run))


def port(**kw):
    s = EncoderSession(EncoderConfig(**CBR), device="cpu", **kw)
    s.PIPELINE_CHUNK = 2
    return s


def test_cbr_cavlc_session_equals_jax(jax_cbr):
    s = port()
    aus, rec = drive(s)
    first = next((i for i, (a, b) in enumerate(zip(aus, jax_cbr.aus))
                  if a != b), None)
    assert first is None, (first, rec["qps"], jax_cbr.rec["qps"],
                           rec["bits"], jax_cbr.rec["bits"])
    assert rec["qps"] == jax_cbr.rec["qps"] and len(rec["qps"]) == 6
    assert rec["bits"] == jax_cbr.rec["bits"]
    for g, w in zip(rec["rc_chunks"] + [list(rec["rc_final"].values())[:3]],
                    jax_cbr.rec["rc_chunks"]
                    + [list(jax_cbr.rec["rc_final"].values())[:3]]):
        assert _close(g[0], w[0]) and _close(g[2], w[2])
        assert _close(g[1], w[1], s._rc_target)
    assert s.sps.profile_idc == 66 and s.pps.entropy_coding_mode == 0


def test_cbr_cavlc_staged_entry_raises_as_in_jax(jax_cbr):
    s = port()
    s.encode_frame(FRAMES[0])
    with pytest.raises(RuntimeError, match="staged path requires "
                                           "single-slice CAVLC-CQ or "
                                           "CABAC-CBR"):
        s.encode_frames_staged(s.upload_frames(FRAMES[1:3]))


@pytest.mark.parametrize("coder", ["native", "python"])
def test_cbr_host_fallback_at_the_mean_qp(jax_cbr, coder, monkeypatch):
    """Bits above the full device budget: the run is coded again on the
    host at the mean of the QPs the loop chose, and each AU is charged to
    the buffer in host floats."""
    monkeypatch.setattr(tenc.FrameEncoder, "cap_words", property(lambda _: 8))
    s = port(host_coder=coder)
    got = [s.encode_frame(FRAMES[0])] + s.encode_frames(FRAMES[1:4])
    assert got == jax_cbr.fallback
    for key in ("qp", "buf", "cplx"):
        assert _close(s.rc_state[key], jax_cbr.fallback_rc[key],
                      s._rc_target), key


def test_reset_gop_state_restores_the_rate_controller():
    s = port()
    first = [s.encode_frame(FRAMES[0])] + s.encode_frames(FRAMES[1:4])
    assert s.rc_state != s._rc_init
    s.reset_gop_state()
    assert s.rc_state == s._rc_init and s._rc_dev is None
    assert s._rc_corr == 0.0 and s._cabac_scale == 0.92
    assert [s.encode_frame(FRAMES[0])] + s.encode_frames(FRAMES[1:4]) == first
    with pytest.raises(ValueError, match="rc_mode"):
        EncoderSession(EncoderConfig(width=W, height=H, rc_mode="vbr"),
                       device="cpu")
