"""media_tpu_torch/parallel/sharding.py against media_tpu/parallel/sharding.py.

The port's tiles run on a list of torch devices (here ["cpu"] * n), the
JAX package's on the conftest's virtual CPU devices. Held with tolerance 0:
make_sharded_pframe_step's symbols, recon and SAD sum (n = 2 at 64x32);
ShardedEncoderSession under CBR with adaptive_qp, deblocking and an I_4x4
IDR over two tiles at 64x32 (every AU digest, QP and tile bit count; the
final rate state within 1e-6), against the JAX ShardedEncoderSession's run
read from tests/golden_torch/ (the recipes say what the JAX package was
asked; tests/jax_golden.py), which the slow twin recomputes live (about a
minute of XLA on a CPU), and the same run through the doubled-cap route. The
constant-QP session is held to the JAX multi-slice session in
tests/test_torch_multislice.py, which already runs it. Then the port's
deliberate differences, each beside the JAX behaviour it avoids: a CABAC or
lossless configuration raises (the JAX streams pinned by a slow test), and
the session has the encode_frame the API calls (the JAX API's sharded
session fails every frame). Then the mesh and halo helpers, and the API's
placement on a pool of CPU devices.
"""

import numpy as np
import pytest
import torch

import chip_smoke as cs
from jax_golden import Golden
from media_tpu.parallel import sharding as jsharding
from media_tpu.pipeline.codec import EncoderConfig as JaxConfig
from media_tpu_torch.api import encoder_api as tenc
from media_tpu_torch.api.errors import EncoderRetCode
from media_tpu_torch.core import log as tlog
from media_tpu_torch.core import params as P
from media_tpu_torch.ops.transform import chroma_qp
from media_tpu_torch.parallel import sharding
from media_tpu_torch.parallel.sharding import (
    DevicePool, ShardedEncoderSession, make_sharded_pframe_step,
    make_tile_mesh)
from media_tpu_torch.pipeline.codec import EncoderConfig, EncoderSession
from media_tpu_torch.pipeline.decoder_tpu import TpuDecoder

W, H, N = 64, 32, 5
FRAMES = cs.clip_i420(W, H, N, seed=2)[0]
CBR_KW = dict(width=W, height=H, qp=30, gop_size=30, rc_mode="cbr",
              bitrate=100_000, framerate=30, adaptive_qp=True, deblock=True,
              i4x4=True)
# chip_smoke.sharded_record of the JAX ShardedEncoderSession(CBR_KW) over
# two devices on FRAMES (IDR, then 4 P in one encode_frames call);
# test_cbr_constants_equal_a_live_jax_run recomputes it.
GOLDEN = Golden(__file__, env={"MEDIA_TPU_DEBLOCK_UNROLL": "1"})


def drive(sess) -> dict:
    run = cs.drive_sharded_run(sess, FRAMES, N)
    return {"aus": run["aus"],
            **cs.sharded_record(sess, run["aus"], run["log"])}


def check_cbr_record(got: dict, want: dict) -> None:
    assert got["au_sha256"] == want["au_sha256"]
    assert got["au_bytes"] == want["au_bytes"]
    assert got["qps"] == want["qps"]
    assert got["bits"] == want["bits"]
    for k, b in want["rc_final"].items():
        assert got["rc_final"][k] == pytest.approx(b, rel=1e-6, abs=1e-6), k


STEP_H, STEP_W, STEP_N, STEP_QP = 32, 64, 2, 28


def step_planes():
    """(current, reference) planes of a 64x32 picture."""
    h, w = STEP_H, STEP_W
    rng = np.random.default_rng(3)
    big = rng.integers(0, 256, (h + 32, w + 32)).astype(np.int32)
    big = ((big + np.roll(big, 1, 0) + np.roll(big, 1, 1)) // 3).astype(
        np.uint8)
    ref = (big[:h, :w], big[: h // 2, : w // 2] // 2 + 60,
           big[: h // 2, : w // 2] // 3 + 80)
    cur = (big[3 : h + 3, 5 : w + 5], ref[1].copy(), ref[2].copy())
    return cur, ref


@GOLDEN.recipe
def jax_sharded_pframe_step():
    """The JAX make_sharded_pframe_step over two virtual CPU devices."""
    cur, ref = step_planes()
    qp_c = int(chroma_qp(STEP_QP))
    out = jsharding.make_sharded_pframe_step(
        jsharding.make_tile_mesh(STEP_N), STEP_H, STEP_W)(
            *cur, *ref, STEP_QP, qp_c)
    return {k: np.asarray(out[k]) for k in ("symbols", "recon_y", "recon_u",
                                            "recon_v", "sad_total")}


def test_sharded_pframe_step_equals_jax():
    n, qp = STEP_N, STEP_QP
    cur, ref = step_planes()
    qp_c = int(chroma_qp(qp))
    want = GOLDEN.read(jax_sharded_pframe_step)
    got = make_sharded_pframe_step(make_tile_mesh(devices=["cpu"] * n),
                                   STEP_H, STEP_W)(*cur, *ref, qp, qp_c)
    np.testing.assert_array_equal(got["symbols"].numpy(), want["symbols"])
    for k in ("recon_y", "recon_u", "recon_v"):
        assert len(got[k]) == n
        np.testing.assert_array_equal(torch.cat(got[k]).numpy(), want[k])
    assert got["sad_total"].dtype == torch.int32
    assert int(got["sad_total"]) == want["sad_total"].item()


def jax_cbr_drive() -> dict:
    """drive() of the JAX ShardedEncoderSession(CBR_KW) over two devices,
    without its AUs."""
    js = jsharding.ShardedEncoderSession(JaxConfig(**CBR_KW), n_devices=2)
    run = drive(js)
    run.pop("aus")
    return run


@GOLDEN.recipe
def jax_cbr_run():
    """chip_smoke.sharded_record of jax_cbr_drive: IDR, then 4 P in one
    encode_frames call."""
    return jax_cbr_drive()


def test_cbr_aq_i4x4_session_equals_the_recorded_jax_run():
    s = ShardedEncoderSession(EncoderConfig(**CBR_KW), devices=["cpu"] * 2)
    got = drive(s)
    check_cbr_record(got, GOLDEN.read(jax_cbr_run))
    assert len(s._cbr_fns) == 1  # no retry at a doubled cap
    # The stream decodes to the session's reconstruction.
    dec = TpuDecoder(device="cpu")
    frames = [f for au in got["aus"] for f in dec.decode_annexb(au)]
    assert len(frames) == N
    for plane, rec in zip((frames[-1].y, frames[-1].u, frames[-1].v),
                          s.recon):
        np.testing.assert_array_equal(plane, rec.numpy())


def test_cbr_doubled_cap_route_gives_the_same_run():
    """A per-tile cap below every P slice's size: the run repeats from the
    same state at 2x, 4x, ... the cap until it fits, with the same output."""
    s = ShardedEncoderSession(EncoderConfig(**CBR_KW), devices=["cpu"] * 2)
    s.cap_local = 32
    check_cbr_record(drive(s), GOLDEN.read(jax_cbr_run))
    caps = sorted(s._cbr_fns)
    assert caps[0] == 32 and len(caps) >= 3
    assert caps == [32 * 2 ** i for i in range(len(caps))]


@pytest.mark.slow
def test_cbr_constants_equal_a_live_jax_run():
    recorded = GOLDEN.read(jax_cbr_run)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MEDIA_TPU_DEBLOCK_UNROLL", "1")
        want = jax_cbr_drive()
    assert want == {**recorded, "rc_final": want["rc_final"]}
    check_cbr_record(want, recorded)


@pytest.mark.parametrize("field", ["cabac", "lossless"])
def test_cabac_and_lossless_are_refused(field):
    cfg = EncoderConfig(width=W, height=H, **{field: True})
    with pytest.raises(ValueError, match=f"{field}=True is not supported"):
        ShardedEncoderSession(cfg, devices=["cpu"] * 2)


@pytest.mark.slow
def test_jax_sharded_cabac_and_lossless_streams_break(monkeypatch):
    """What the port refuses: the JAX ShardedEncoderSession with
    cabac=True writes CAVLC P slice data under a CABAC PPS (its IDR equals
    the single-device slice-local session's, its P AUs do not, and the JAX
    TpuDecoder refuses the stream); with lossless=True it codes a lossy
    IDR + P stream."""
    from media_tpu.pipeline.codec import EncoderSession as JaxSession
    from media_tpu.pipeline.decoder_tpu import TpuDecoder as JaxDecoder
    from media_tpu.ref.decoder import ReferenceDecoder

    monkeypatch.setenv("MEDIA_TPU_DEBLOCK_UNROLL", "1")
    kw = dict(width=W, height=H, qp=30, gop_size=30)
    bufs = FRAMES[:3]
    sharded = jsharding.ShardedEncoderSession(JaxConfig(cabac=True, **kw),
                                              n_devices=2)
    got = sharded.encode_frames(bufs)
    single = JaxSession(JaxConfig(cabac=True, num_slices=2,
                                  deblock_across_slices=False,
                                  entropy_mode="host", **kw))
    want = single.encode_frames(bufs)
    assert got[0] == want[0]
    assert got[1] != want[1] and got[2] != want[2]
    assert len(JaxDecoder().decode_annexb(b"".join(want))) == 3
    with pytest.raises(Exception):
        JaxDecoder().decode_annexb(b"".join(got))

    lossless = jsharding.ShardedEncoderSession(
        JaxConfig(lossless=True, **kw), n_devices=2)
    frames = ReferenceDecoder().decode_annexb(
        b"".join(lossless.encode_frames(bufs)))
    y_in = np.frombuffer(bufs[-1][: W * H], np.uint8).reshape(H, W)
    assert len(frames) == 3 and not np.array_equal(frames[-1].y, y_in)


def test_tile_mesh_is_the_callers_list_or_the_cuda_devices():
    assert make_tile_mesh(devices=["cpu"] * 3) == (torch.device("cpu"),) * 3
    with pytest.raises(ValueError, match="not divisible"):
        ShardedEncoderSession(EncoderConfig(width=W, height=48),
                              devices=["cpu"] * 2)
    if not torch.cuda.is_available():
        for call in (make_tile_mesh, lambda: make_tile_mesh(2),
                     lambda: ShardedEncoderSession(EncoderConfig(W, H))):
            with pytest.raises(RuntimeError, match="cuda"):
                call()


@pytest.mark.parametrize("n", [2, 3])
def test_halo_rows_are_the_neighbours_and_the_edge_padding(n):
    """Each tile gets `halo` rows of its neighbours above and below; the
    edge tiles repeat their own border row: together, the tile's window of
    the edge-padded plane."""
    halo = 5
    plane = torch.arange(8 * n * 3, dtype=torch.int32).reshape(8 * n, 3)
    tiles = sharding.split_tiles(plane, ("cpu",) * n)
    padded = torch.cat([plane[:1].expand(halo, -1), plane,
                        plane[-1:].expand(halo, -1)])
    for t, ext in enumerate(sharding._halo_exchange_rows(tiles, halo)):
        assert torch.equal(ext, padded[8 * t : 8 * t + 8 + 2 * halo])


def capture_log(monkeypatch) -> list:
    lines = []
    monkeypatch.setattr(tlog._manager, "_callback",
                        lambda lvl, tag, msg: lines.append((lvl, tag, msg)))
    monkeypatch.setattr(tlog._manager, "_level", tlog.LOG_DEBUG)
    return lines


def test_forced_multichip_places_a_sharded_session_from_the_pool(
        monkeypatch):
    """tests/test_api.py:287-302 on the port, over a pool of two CPU
    devices installed as the process pool: a baseline session lands on two
    tiles, encodes through the API, and returns its load on destroy."""
    pool = DevicePool(["cpu"] * 2)
    monkeypatch.setattr(sharding, "_POOL", pool)
    lines = capture_log(monkeypatch)
    store = P.ParamStore({P.KEY_HW_WIDTH: W, P.KEY_HW_HEIGHT: H,
                          P.KEY_MULTICHIP: "1"})
    enc = tenc.create_video_encoder(store, device="cpu")
    assert enc.init_encoder() == EncoderRetCode.VIDEO_ENCODER_SUCCESS
    sess = enc.session
    assert isinstance(sess, ShardedEncoderSession)
    assert len(sess.mesh) == 2 and sess.cfg.num_slices == 2
    assert all(v > 0 for v in pool.loads())
    assert enc.start_encoder() == EncoderRetCode.VIDEO_ENCODER_SUCCESS
    aus = []
    for buf in FRAMES[:3]:
        code, au = enc.encode_one_frame(buf)
        assert code == EncoderRetCode.VIDEO_ENCODER_SUCCESS
        aus.append(bytes(au))
    # The API's session is the sharded session of the policy's config.
    ref = ShardedEncoderSession(
        tenc.VideoEncoder._reference_policy_config(enc._params, sess.cfg.qp),
        devices=["cpu"] * 2)
    assert aus == [ref.encode_frame(b) for b in FRAMES[:3]]
    assert enc.destroy_encoder() == EncoderRetCode.VIDEO_ENCODER_SUCCESS
    assert pool.loads() == [0, 0]
    assert not [m for lvl, _t, m in lines if lvl >= tlog.LOG_WARN]


def test_forced_multichip_on_main_keeps_one_session_and_the_pool(
        monkeypatch):
    """On main the policy asks for CABAC, which the sharded session
    refuses: the API logs the original's warning and keeps the
    single-device session (whose stream decodes), and the pool keeps no
    load."""
    pool = DevicePool(["cpu"] * 2)
    monkeypatch.setattr(sharding, "_POOL", pool)
    lines = capture_log(monkeypatch)
    store = P.ParamStore({P.KEY_HW_WIDTH: W, P.KEY_HW_HEIGHT: H,
                          P.KEY_MULTICHIP: "1", P.KEY_PROFILE: "main"})
    enc = tenc.create_video_encoder(store, device="cpu")
    assert enc.init_encoder() == EncoderRetCode.VIDEO_ENCODER_SUCCESS
    assert type(enc.session) is EncoderSession and enc.session.cfg.cabac
    assert pool.loads() == [0, 0]
    warns = [m for lvl, tag, m in lines
             if lvl == tlog.LOG_WARN and tag == "VideoEncoder"]
    assert warns == ["multi-chip placement failed (sharded sessions write "
                     "CAVLC slice data; cabac=True is not supported); "
                     "single chip"]


def test_the_jax_api_cannot_encode_on_its_sharded_session():
    """Why the port's ShardedEncoderSession has encode_frame: the JAX one
    has none, so every encode_one_frame of a JAX API session placed on the
    mesh (tests/test_api.py:287-302) fails."""
    from media_tpu import api as japi
    from media_tpu.core import params as jP

    n = len(jsharding.get_pool().loads())
    store = jP.ParamStore({jP.KEY_HW_WIDTH: 64, jP.KEY_HW_HEIGHT: 16 * n,
                           jP.KEY_MULTICHIP: "1"})
    enc = japi.create_video_encoder(store)
    assert enc.init_encoder() == 0 and enc.start_encoder() == 0
    assert isinstance(enc.session, jsharding.ShardedEncoderSession)
    assert not hasattr(enc.session, "encode_frame")
    code, au = enc.encode_one_frame(bytes(64 * 16 * n * 3 // 2))
    assert (int(code), au) == (int(EncoderRetCode.VIDEO_ENCODER_ENCODE_FAIL),
                               b"")
    enc.destroy_encoder()
