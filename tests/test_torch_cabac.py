"""The port's CABAC: entropy/cabac_*.py against media_tpu's, and the session
and decoder paths that emit and read CABAC.

Same inputs, made from a numpy seed, through the JAX package (on the CPU)
and the port (device="cpu"). The JAX package's host coders run live; its
sessions and decoder are read from tests/golden_torch/ (run_jax says what
they were asked; tests/jax_golden.py). Tolerance: none for bytes, integer
arrays, planes, per-frame QPs and bit counts; the rate controller's three
floats within 1e-6 relative (`buf` relative to the per-frame target, of
whose order its terms are), because the float32 rate loop's last place
differs between XLA and torch.

One JAX session per configuration encoded an IDR through
encode_frame, 4 P through encode_frames, 4 P staged and 1 P through
encode_frame, PIPELINE_CHUNK 2 on both sides: the port must repeat it byte
for byte, continue it from the JAX session's state after the first run, and
survive a forced overflow of the stream cap; its TpuDecoder must decode the
stream to the JAX TpuDecoder's planes and to the encoder's recon.
"""

import types

import numpy as np
import pytest
import torch

import chip_smoke as cs
from jax_golden import Golden
from media_tpu.entropy import cabac_contexts as jctx
from media_tpu.entropy import cabac_engine as jeng
from media_tpu.entropy import cabac_init_tables as jinit
from media_tpu.entropy import cabac_slice as jslice
from media_tpu_torch import native
from media_tpu_torch.entropy import cabac_contexts as tctx
from media_tpu_torch.entropy import cabac_engine as teng
from media_tpu_torch.entropy import cabac_init_tables as tinit
from media_tpu_torch.entropy import cabac_slice as tslice
from media_tpu_torch.pipeline.codec import EncoderConfig, EncoderSession
from media_tpu_torch.pipeline.decoder_tpu import TpuDecoder

W, H, CHUNK = 64, 48, 2
R, C = 3, 4
P_KEYS = ("mv", "luma_levels", "cdc_levels", "cac_levels")
I_KEYS = ("mode16", "chroma_mode", "dc_levels", "ac_levels", "cdc_levels",
          "cac_levels")


# ------------------------------------------------------- the copied modules


@pytest.mark.parametrize("orig,copy", [(jinit, tinit), (jeng, teng),
                                       (jctx, tctx)],
                         ids=["init_tables", "engine", "contexts"])
def test_copied_tables_equal(orig, copy):
    names = [k for k, v in vars(orig).items()
             if not k.startswith("_") and isinstance(
                 v, (np.ndarray, int, tuple, list, dict))]
    assert names
    for k in names:
        a, b = getattr(orig, k), getattr(copy, k)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b, k)
        else:
            assert np.all(np.asarray(a) == np.asarray(b)), k


@pytest.mark.parametrize("seed", range(3))
def test_engine_bins_equal_and_round_trip(seed):
    rng = np.random.default_rng(seed)
    n = 4000
    ctxs = rng.integers(0, 20, n)
    bins = (rng.random(n) < rng.choice([0.1, 0.5, 0.9], n)).astype(int)
    kinds = rng.choice(3, n, p=[0.8, 0.15, 0.05])
    outs = []
    for eng, ctx_mod in ((jeng, jctx), (teng, tctx)):
        models = ctx_mod.ContextModels(27, seed, slice_type="P")
        enc = eng.CabacEncoder()
        for c, b, k in zip(ctxs, bins, kinds):
            if k == 0:
                enc.encode_bin(models, int(c), int(b))
            elif k == 1:
                enc.encode_bypass(int(b))
            else:
                enc.encode_terminate(0)
        enc.encode_terminate(1)
        outs.append(enc.get_bytes())
    assert outs[0] == outs[1] and len(outs[0]) > 100
    models = tctx.ContextModels(27, seed, slice_type="P")
    dec = teng.CabacDecoder(outs[1], 0)
    for c, b, k in zip(ctxs, bins, kinds):
        if k == 0:
            assert dec.decode_bin(models, int(c)) == b
        elif k == 1:
            assert dec.decode_bypass() == b
        else:
            assert dec.decode_terminate() == 0
    assert dec.decode_terminate() == 1


def _sparse(rng, shape, density, mag=40):
    a = rng.integers(-mag, mag, size=shape).astype(np.int32)
    return (a * (rng.random(shape) < density)).astype(np.int32)


def _same(a: dict, b: dict, keys):
    for k in keys:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), k)


@pytest.mark.parametrize("with_map", [False, True], ids=["qp", "qp_map"])
@pytest.mark.parametrize("seed,density", [(0, 0.0), (1, 0.1), (2, 0.5)])
def test_pslice_cabac_equals_jax_and_round_trips(seed, density, with_map):
    rng = np.random.default_rng(seed)
    sym = {"mv": rng.integers(-8, 9, (R, C, 2)).astype(np.int32),
           "luma_levels": _sparse(rng, (R, C, 16, 16), density),
           "cdc_levels": _sparse(rng, (R, C, 2, 4), density),
           "cac_levels": _sparse(rng, (R, C, 2, 4, 15), density)}
    for a in sym.values():
        a[1:, :2] = 0  # skip candidates
    qp_map = (rng.choice([1, 27, 28, 51], (R, C)).astype(np.int32)
              if with_map else None)  # 1 <-> 51: the delta wraps mod 52
    args = (*(sym[k] for k in P_KEYS), 28)
    kw = dict(cabac_init_idc=seed, qp_map=qp_map)
    data = tslice.write_pslice_cabac(*args, **kw)
    assert data == jslice.write_pslice_cabac(*args, **kw)
    got = tslice.parse_pslice_cabac(b"\xff" + data, 8, R, C, 28, seed)
    want = jslice.parse_pslice_cabac(b"\xff" + data, 8, R, C, 28, seed)
    _same(got, want, P_KEYS + ("qp_map", "covered"))
    _same(got, sym, P_KEYS)
    assert got["covered"] == R * C


@pytest.mark.parametrize("seed,density", [(0, 0.0), (1, 0.15), (2, 0.6)])
def test_islice_cabac_equals_jax_and_round_trips(seed, density):
    rng = np.random.default_rng(seed)
    sym = {"mode16": rng.integers(0, 4, (R, C)).astype(np.int32),
           "chroma_mode": rng.integers(0, 4, (R, C)).astype(np.int32),
           "dc_levels": _sparse(rng, (R, C, 16), density, 60),
           "ac_levels": _sparse(rng, (R, C, 16, 15), density, 60),
           "cdc_levels": _sparse(rng, (R, C, 2, 4), density, 60),
           "cac_levels": _sparse(rng, (R, C, 2, 4, 15), density, 60)}
    args = (*(sym[k] for k in I_KEYS), 26)
    data = tslice.write_islice_cabac(*args)
    assert data == jslice.write_islice_cabac(*args)
    got = tslice.parse_islice_cabac(data, 0, R, C, 26)
    want = jslice.parse_islice_cabac(data, 0, R, C, 26)
    _same(got, want, I_KEYS + ("is_i4", "covered"))
    _same(got, sym, I_KEYS)


# ------------------------------------------------- sessions and the decoder


def clip(n, seed=0, w=W, h=H):
    """Textured pan with a moving bright block (I420 buffers)."""
    rng = np.random.default_rng(seed)
    big = rng.integers(0, 256, (h + 48, w + 48)).astype(np.float64)
    for _ in range(2):
        big = (big + np.roll(big, 1, 0) + np.roll(big, 1, 1)) / 3
    out = []
    for t in range(n):
        y = big[2 * t : 2 * t + h, 3 * t : 3 * t + w].copy()
        y[10 : 22, 5 + 5 * t : 17 + 5 * t] = 235
        y = (y + rng.normal(0, 1.5, y.shape)).round().clip(0, 255).astype(
            np.uint8)
        out.append(y.tobytes() + (y[::2, ::2] // 2 + 40).astype(
            np.uint8).tobytes() + (y[::2, ::2] // 3 + 70).astype(
                np.uint8).tobytes())
    return out


FRAMES = clip(10)
CONFIGS = {
    "cbr_cabac": dict(rc_mode="cbr", bitrate=150_000, cabac=True,
                      cabac_init_idc=1),
    "cbr_cabac_aq": dict(rc_mode="cbr", bitrate=150_000, cabac=True,
                         cabac_init_idc=1, adaptive_qp=True),
    "cq_cabac": dict(cabac=True, cabac_init_idc=2, insert_aud=True),
}


def make(cls, name, cfg_cls=EncoderConfig, **kw):
    s = cls(cfg_cls(width=W, height=H, qp=30, gop_size=30, framerate=30,
                    **CONFIGS[name]), **kw)
    s.PIPELINE_CHUNK = CHUNK
    return s


def drive(s, name):
    """The four entry points in turn. Returns (AUs by phase, the rate
    loop's record, the state after the first run as numpy values, the
    session)."""
    log = cs.tap_rate_loop(s)
    staged_ok = name != "cq_cabac"  # the staged entry refuses CABAC at CQ
    a0 = [s.encode_frame(FRAMES[0])]
    a1 = s.encode_frames(FRAMES[1:5])
    state = snapshot(s)
    if staged_ok:
        a2 = s.encode_frames_staged(s.upload_frames(FRAMES[5:9]))
    else:
        a2 = s.encode_frames(FRAMES[5:9])
    a3 = [s.encode_frame(FRAMES[9])]
    return (a0, a1, a2, a3), cs.rate_record(s, a0 + a1 + a2 + a3, log), state


def snapshot(s) -> dict:
    rc_dev = s._rc_dev
    return {
        "recon": tuple(cs._host(p) for p in s.recon),
        "frame_idx": s.frame_idx, "frame_idx_of_idr": s.frame_idx_of_idr,
        "idr_pic_id": s.idr_pic_id, "_bits_hwm": s._bits_hwm,
        "rc_state": dict(s.rc_state), "_rc_corr": s._rc_corr,
        "_cabac_scale": s._cabac_scale,
        "_rc_dev": None if rc_dev is None else [
            np.float32(cs._host(x)) for x in rc_dev],
    }


# One deblocking wave per scan step: same bytes, smaller programs.
GOLDEN = Golden(__file__, env={"MEDIA_TPU_DEBLOCK_UNROLL": "1"})


@GOLDEN.recipe(cases=list(CONFIGS))
def run_jax(name):
    """The JAX session's run of a configuration along drive(), and the JAX
    TpuDecoder's pictures of its AUs."""
    from media_tpu.pipeline.codec import EncoderConfig as JaxConfig
    from media_tpu.pipeline.codec import EncoderSession as JaxSession
    from media_tpu.pipeline.decoder_tpu import TpuDecoder as JaxDecoder

    s = make(JaxSession, name, JaxConfig)
    phases, rec, state = drive(s, name)
    dec = JaxDecoder()
    decoded = [f for au in sum(phases, []) for f in dec.decode_annexb(au)]
    planes = [tuple(np.asarray(getattr(f, p)) for p in "yuv")
              for f in decoded]
    return {"phases": phases, "rec": rec, "state": state, "planes": planes}


@pytest.fixture(scope="module", params=list(CONFIGS))
def jax_run(request):
    return types.SimpleNamespace(name=request.param,
                                 **GOLDEN.read(run_jax, request.param))


def assert_rate_records_close(got: dict, want: dict, target: float):
    """Exact AUs, bits and QPs; the controller's floats within 1e-6."""
    first = next((i for i, (a, b) in enumerate(
        zip(got["au_sha256"], want["au_sha256"])) if a != b), None)
    assert first is None, (
        f"AU {first} differs: {got['au_bytes'][first]} against "
        f"{want['au_bytes'][first]} bytes; qps {got['qps']} against "
        f"{want['qps']}; bits {got['bits']} against {want['bits']}")
    assert got["au_bytes"] == want["au_bytes"]
    assert got["qps"] == want["qps"] and got["bits"] == want["bits"]
    assert len(got["rc_chunks"]) == len(want["rc_chunks"])
    scale = {"buf": target}

    def close(a, b, key):
        tol = 1e-6 * max(abs(a), abs(b), scale.get(key, 0.0))
        assert abs(a - b) <= tol, (key, a, b)

    for g, w in zip(got["rc_chunks"], want["rc_chunks"]):
        for key, a, b in zip(("qp", "buf", "cplx"), g, w):
            close(a, b, key)
    for key in ("qp", "buf", "cplx"):
        close(got["rc_final"][key], want["rc_final"][key], key)
    close(got["rc_final"]["cabac_scale"], want["rc_final"]["cabac_scale"],
          "cabac_scale")
    close(got["rc_final"]["rc_corr"], want["rc_final"]["rc_corr"], "buf")


def test_session_equals_jax_along_every_entry_point(jax_run):
    before = sum(native.fallbacks.values())
    s = make(EncoderSession, jax_run.name, device="cpu")
    phases, rec, _state = drive(s, jax_run.name)
    assert phases == jax_run.phases
    assert_rate_records_close(rec, jax_run.rec, s._rc_target)
    if jax_run.name != "cq_cabac":
        # IDR, 2 + 2 chunks of the device loop, none for the host loop.
        assert len(rec["qps"]) == 8 and len(rec["rc_chunks"]) == 4
        assert len(set(rec["qps"])) > 1
    assert sum(native.fallbacks.values()) == before
    assert s.sps.profile_idc >= 77 and s.pps.entropy_coding_mode == 1


def test_session_continues_from_the_jax_sessions_state(jax_run):
    """The rate controller handed over mid-GOP: recon, counters, rc_state,
    the device carry, the pending correction and the CABAC/CAVLC ratio."""
    s = make(EncoderSession, jax_run.name, device="cpu")
    s.load_reference_state(jax_run.state)
    if jax_run.name == "cq_cabac":
        got = s.encode_frames(FRAMES[5:9])
    else:
        got = s.encode_frames_staged(s.upload_frames(FRAMES[5:9]))
    got.append(s.encode_frame(FRAMES[9]))
    assert got == jax_run.phases[2] + jax_run.phases[3]
    for key in ("qp", "buf", "cplx"):
        a, b = s.rc_state[key], jax_run.rec["rc_final"][key]
        assert abs(a - b) <= 1e-6 * max(abs(a), abs(b), s._rc_target), key


def test_forced_cap_overflow_retries_to_the_same_bytes(jax_run, monkeypatch):
    """A 1-word adaptive stream cap overflows: the chunk is run again at the
    full budget from the same rate-controller inputs and gives the bytes of
    the run that never overflowed. One chunk only: as in the JAX package, a
    chunk dispatched before the overflowed one's finisher ran starts from
    the overflowed run's rate state."""
    s = make(EncoderSession, jax_run.name, device="cpu")
    if jax_run.name == "cq_cabac":
        # Constant-QP CABAC packs on the host: it never sizes a stream cap.
        monkeypatch.setattr(s, "_device_cap", None)
        got = [s.encode_frame(FRAMES[0])] + s.encode_frames(FRAMES[1:5])
        assert got == jax_run.phases[0] + jax_run.phases[1]
        return
    monkeypatch.setattr(s, "_device_cap", lambda: 1)
    calls = cs.tap_rate_loop(s)
    got = [s.encode_frame(FRAMES[0])] + s.encode_frames(FRAMES[1 : 1 + CHUNK])
    assert got == jax_run.phases[0] + jax_run.phases[1][:CHUNK]
    assert len(calls) == 2  # the chunk ran twice
    want = jax_run.rec["rc_chunks"][0]
    for a, b in zip((float(x) for x in s._rc_dev), want):
        assert abs(a - b) <= 1e-6 * max(abs(a), abs(b), s._rc_target)


def test_decoder_equals_jax_decoder_and_encoder_recon(jax_run):
    before = sum(native.fallbacks.values())
    aus = sum(jax_run.phases, [])
    dec = TpuDecoder(device="cpu")
    frames = [f for au in aus for f in dec.decode_annexb(au)]
    assert len(frames) == len(jax_run.planes) == 10
    for i, (f, want) in enumerate(zip(frames, jax_run.planes)):
        for got, w, p in zip((f.y, f.u, f.v), want, "yuv"):
            np.testing.assert_array_equal(got, w, f"picture {i} plane {p}")
    s = make(EncoderSession, jax_run.name, device="cpu")
    s.encode_frame(FRAMES[0])
    s.encode_frames(FRAMES[1:5])
    for got, rec in zip((frames[4].y, frames[4].u, frames[4].v), s.recon):
        np.testing.assert_array_equal(got, rec.numpy())
    assert sum(native.fallbacks.values()) == before
    # The Python CABAC parsers behind the same dispatch: same planes.
    slow = TpuDecoder(device="cpu", host_parser="python")
    for au, f in zip(aus[:3], frames):
        (g,) = slow.decode_annexb(au)
        np.testing.assert_array_equal(g.y, f.y)
        np.testing.assert_array_equal(g.v, f.v)


def cq_device(slices=1, w=W, h=H, **kw):
    """The cq_cabac configuration with P-slice entropy on the device: the
    device's CAVLC pack, transcoded to CABAC on the host."""
    s = EncoderSession(EncoderConfig(
        width=w, height=h, qp=30, gop_size=30, framerate=30,
        num_slices=slices, entropy_mode="device", **CONFIGS["cq_cabac"]),
        device="cpu", **kw)
    s.PIPELINE_CHUNK = CHUNK
    return s


@pytest.mark.parametrize("slices", [1, 4],
                         ids=["one_slice_equals_jax", "four_slices_refused"])
def test_staged_entry_refuses_cabac_at_constant_qp(slices):
    """One slice: the staged entry codes CABAC at constant QP through the
    device pack and the transcode, as do the fed entry's device route and
    the per-frame entry, to the JAX session's AUs (whose encode_frames codes
    these frames on the host). Four slices: still refused."""
    s = cq_device(slices)
    got = [s.encode_frame(FRAMES[0])]
    if slices > 1:
        with pytest.raises(RuntimeError, match="staged path requires"):
            s.encode_frames_staged(s.upload_frames(FRAMES[1:3]))
        return
    before = sum(native.fallbacks.values())
    got += s.encode_frames(FRAMES[1:5])
    got += s.encode_frames_staged(s.upload_frames(FRAMES[5:9]))
    got.append(s.encode_frame(FRAMES[9]))
    assert got == sum(GOLDEN.read(run_jax, "cq_cabac")["phases"], [])
    assert sum(native.fallbacks.values()) == before
    host = make(EncoderSession, "cq_cabac", device="cpu")
    host.encode_frame(FRAMES[0])
    host.encode_frames(FRAMES[1:10])
    for a, b in zip(s.recon, host.recon):
        assert torch.equal(a, b)


def _refuse_transcode(*a, **kw):
    native.fallbacks["transcode_pslice_native"] += 1


@pytest.mark.parametrize("w,h,case", [
    (W, H, "packed"), (176, 144, "packed"), (W, H, "cap_overflow"),
    (W, H, "transcoder_refuses")])
def test_cabac_cq_device_routes_equal_encode_frame_and_host(w, h, case,
                                                           monkeypatch):
    """The fed and staged device routes of single-slice CABAC at constant
    QP against per-frame encode_frame and the host route: the same AUs and
    planes; the device routes also where a 1-word stream cap overflows
    (the chunk is packed again at the full budget) and where the C++
    transcoder refuses every slice (the Python parse and recode, each
    refusal counted). At 176x144, whose plain deblocking is dear on the
    CPU, the staged route alone against encode_frame."""
    small = w == W
    frames = clip(5 if small else 4, seed=3, w=w, h=h)
    one = cq_device(w=w, h=h)
    want = [one.encode_frame(f) for f in frames]
    routes = {"staged": cq_device(w=w, h=h)}
    if small:
        routes["fed"] = cq_device(w=w, h=h)
    if small and case == "packed":
        routes["host"] = cq_device(w=w, h=h)
        routes["host"].cfg.entropy_mode = "host"
    if case == "cap_overflow":
        for s in routes.values():
            monkeypatch.setattr(s, "_device_cap", lambda: 1)
    if case == "transcoder_refuses":
        monkeypatch.setattr(native, "transcode_pslice_native",
                            _refuse_transcode)
    before = native.fallbacks["transcode_pslice_native"]
    for name, s in routes.items():
        got = [s.encode_frame(frames[0])]
        if name == "staged":
            got += s.encode_frames_staged(s.upload_frames(frames[1:]))
        else:
            got += s.encode_frames(frames[1:])
        assert got == want, name
        for a, b in zip(s.recon, one.recon):
            assert torch.equal(a, b), name
    refused = native.fallbacks["transcode_pslice_native"] - before
    assert refused == (2 * 4 if case == "transcoder_refuses" else 0)
