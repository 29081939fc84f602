"""media_tpu_torch on a CUDA device: the two deblocking kernels against their
plain versions, and whole encoder and decoder sessions on CUDA against the
CPU path (which the other tests/test_torch_*.py hold to the JAX package).

This file imports neither JAX nor media_tpu, so it runs on a CUDA host that
has none:

    python -m pytest tests/test_torch_cuda.py -m cuda

Every test skips where torch.cuda is unavailable.
"""

import numpy as np
import pytest
import torch

from chip_smoke import PACK_SHAPES, PCORE_RANGES
from media_tpu_torch.ops import deblock_pallas as dp
from media_tpu_torch.ops import deblock_wave as dw
from media_tpu_torch.pipeline import deblock_apply as tda
from media_tpu_torch.pipeline.codec import EncoderConfig, EncoderSession
from media_tpu_torch.pipeline.decoder_tpu import TpuDecoder
from media_tpu_torch.utils import yuv

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (and nvcc to build the kernel)")
    return torch.device("cuda")


# One MB, one row, one column, a small picture, a large one, and 4K, which
# has more MB rows (135) than an H100 has SMs.
@pytest.mark.parametrize("R,C", [(1, 1), (1, 5), (5, 1), (6, 9), (34, 80),
                                 (135, 240)])
@pytest.mark.parametrize("per_mb", [False, True])
def test_kernel_matches_plain(cuda_device, per_mb, R, C):
    rng = np.random.default_rng(R * C)
    planes = [torch.as_tensor(rng.integers(0, 256, (R * s, C * s)) // 8 + 100,
                              dtype=torch.uint8) for s in (16, 8, 8)]
    bs_v = torch.as_tensor(rng.integers(0, 5, (R * 4, C * 4)), dtype=torch.int32)
    bs_h = torch.as_tensor(rng.integers(0, 5, (R * 4, C * 4)), dtype=torch.int32)
    qp_map = torch.as_tensor(
        np.clip(30 + rng.integers(-6, 7, (R, C)), 0, 51)) if per_mb else None
    meta = tda.build_meta(30, 29, bs_v, bs_h, R, C, qp_map=qp_map)
    dev = [p.clone().to(cuda_device) for p in planes]
    cpu = [p.clone() for p in planes]
    before = dw.deblock_wave.launches
    dw.deblock_wave(*dev, meta.to(cuda_device), R, C)
    torch.cuda.synchronize()
    assert dw.deblock_wave.launches == before + 1
    dw.deblock_wave(*cpu, meta, R, C)
    assert dw.deblock_wave.launches == before + 1  # the CPU path launches none
    for a, b in zip(dev, cpu):
        assert torch.equal(a.cpu(), b)
    if R * C > 1:
        assert any(not torch.equal(b, p) for b, p in zip(cpu, planes))
    # Rows shared out among 3 persistent blocks, as on a device that cannot
    # hold a block per row: the same planes.
    few = [p.clone().to(cuda_device) for p in planes]
    dw.launch_deblock_wave(*few, meta.to(cuda_device), R, C, max_blocks=3)
    for a, b in zip(few, cpu):
        assert torch.equal(a.cpu(), b)


# One MB, a short wave, and the widest wave of a 1080p picture.
@pytest.mark.parametrize("n", [1, 7, 60])
def test_wave_step_kernel_matches_plain(cuda_device, n):
    rng = np.random.default_rng(n)
    R, C = 1, n  # any grid with n MBs gives n meta rows
    patches = [torch.as_tensor(rng.integers(0, 256, (n, s, s)) // 8 + 100,
                               dtype=torch.uint8) for s in (20, 12, 12)]
    bs_v = torch.as_tensor(rng.integers(0, 5, (R * 4, C * 4)), dtype=torch.int32)
    bs_h = torch.as_tensor(rng.integers(0, 5, (R * 4, C * 4)), dtype=torch.int32)
    meta = tda.build_meta(30, 29, bs_v, bs_h, R, C)
    meta[:, 16:20] = torch.as_tensor(rng.integers(0, 5, (n, 4)))  # top edges
    before = dp.deblock_wave_step.launches
    got = dp.deblock_wave_step(*(p.to(cuda_device) for p in patches),
                               meta.to(cuda_device))
    torch.cuda.synchronize()
    assert dp.deblock_wave_step.launches == before + 1
    want = dp.deblock_wave_step(*patches, meta)
    assert dp.deblock_wave_step.launches == before + 1  # the CPU path launches none
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)
    assert any(not torch.equal(b, p) for b, p in zip(want, patches))


# The in-place entry on a wave of one MB, a short wave and the widest wave of
# a 1080p picture, against gather -> plain step -> scatter on the CPU.
@pytest.mark.parametrize("R,C,k,n", [(3, 4, 0, 1), (9, 20, 12, 7),
                                     (68, 120, 134, 60)])
def test_wave_step_inplace_kernel_matches_plain(cuda_device, R, C, k, n):
    assert len(dp.wave_rows(k, R, C)) == n
    rng = np.random.default_rng(n)
    planes = [torch.as_tensor(rng.integers(0, 256, (R * s, C * s)) // 8 + 100,
                              dtype=torch.uint8) for s in (16, 8, 8)]
    bs = [torch.as_tensor(rng.integers(0, 5, (R * 4, C * 4)), dtype=torch.int32)
          for _ in range(2)]
    meta = tda.build_meta(30, 29, *bs, R, C)
    dev = [p.clone().to(cuda_device) for p in planes]
    cpu = [p.clone() for p in planes]
    before = dp.deblock_wave_step.launches
    dp.deblock_wave_step_inplace(*dev, meta.to(cuda_device), R, C, k)
    torch.cuda.synchronize()
    assert dp.deblock_wave_step.launches == before + 1
    dp.deblock_wave_step_inplace(*cpu, meta, R, C, k)
    assert dp.deblock_wave_step.launches == before + 1  # the CPU path launches none
    for a, b in zip(dev, cpu):
        assert torch.equal(a.cpu(), b)
    assert any(not torch.equal(b, p) for b, p in zip(cpu, planes))


@pytest.mark.parametrize("R,C", [(3, 4), (9, 5)])
def test_wave_route_on_cuda_matches_frame_route(cuda_device, R, C):
    rng = np.random.default_rng(R + C)
    planes = [torch.as_tensor(rng.integers(0, 256, (R * s, C * s)) // 8 + 100,
                              dtype=torch.uint8, device=cuda_device)
              for s in (16, 8, 8)]
    bs = [torch.as_tensor(rng.integers(0, 5, (R * 4, C * 4)), dtype=torch.int32,
                          device=cuda_device) for _ in range(2)]
    before = dp.deblock_wave_step.launches
    a = tda.deblock_frame(*planes, 30, 29, *bs, R, C, kernel="wave")
    assert dp.deblock_wave_step.launches == before + dw.n_waves(R, C)
    b = tda.deblock_frame(*planes, 30, 29, *bs, R, C, kernel="frame")
    # The same waves launch by launch instead of as a CUDA graph.
    c = [p.clone() for p in planes]
    meta = tda.build_meta(30, 29, *bs, R, C)
    for k in range(dw.n_waves(R, C)):
        dp.deblock_wave_step_inplace(*c, meta, R, C, k)
    assert dp.deblock_wave_step.launches == before + 2 * dw.n_waves(R, C)
    for p, q, w in zip(a, b, c):
        assert torch.equal(p, q) and torch.equal(p, w)


def test_argmin_keeps_first_minimum(cuda_device):
    # MVs and intra modes are the first minimum of tied int32 costs.
    costs = np.random.default_rng(1).integers(0, 4, (4096, 289)).astype(np.int32)
    got = torch.argmin(torch.as_tensor(costs, device=cuda_device), dim=1)
    np.testing.assert_array_equal(got.cpu().numpy(), np.argmin(costs, axis=1))


def _clip(w, h, n, seed=0):
    rng = np.random.default_rng(seed)
    big = rng.integers(0, 256, (h + 48, w + 48)).astype(np.float64)
    for _ in range(2):
        big = (big + np.roll(big, 1, 0) + np.roll(big, 1, 1)) / 3
    out = []
    for t in range(n):
        y = big[2 * t : 2 * t + h, 3 * t : 3 * t + w].copy()
        y[10:22, 5 + 7 * t : 17 + 7 * t] = 235
        y = (y + rng.normal(0, 1.5, y.shape)).round().clip(0, 255).astype(
            np.uint8)
        out.append(yuv.pack_i420(y, (y[::2, ::2] // 2 + 40).astype(np.uint8),
                                 (y[::2, ::2] // 3 + 70).astype(np.uint8)))
    return out


@pytest.mark.parametrize("entropy", ["device", "host"])
def test_session_on_cuda_matches_cpu(cuda_device, entropy):
    frames = _clip(72, 40, 7)
    out, recon = [], []
    for device in (cuda_device, "cpu"):
        s = EncoderSession(EncoderConfig(width=72, height=40, qp=28,
                                         gop_size=30, entropy_mode=entropy),
                           device=device)
        s.PIPELINE_CHUNK = 3
        aus = [s.encode_frame(frames[0])] + s.encode_frames(frames[1:4])
        aus += s.encode_frames_staged(s.upload_frames(frames[4:]))
        out.append(aus)
        recon.append([p.cpu() for p in s.recon])
    assert out[0] == out[1]
    for a, b in zip(*recon):
        assert torch.equal(a, b)


def test_staged_download_waits_for_its_own_chunk(cuda_device):
    # A chunk's finisher returns its AUs while the work enqueued after the
    # next chunk's dispatch (a 200 ms sleep) still runs: its download waits
    # for its own chunk only. Before that, four chunks through
    # encode_frames_staged take each pinned ring slot twice.
    from media_tpu_torch.pipeline import codec

    frames = _clip(72, 40, 13, seed=2)
    kw = dict(width=72, height=40, qp=28, gop_size=30)
    cpu = EncoderSession(EncoderConfig(**kw), device="cpu")
    want = [cpu.encode_frame(f) for f in frames]
    s = EncoderSession(EncoderConfig(**kw), device=cuda_device)
    s.PIPELINE_CHUNK = 2
    got = [s.encode_frame(frames[0])]
    chunks = s.upload_frames(frames[1:])
    counts = codec.wait_for_chunk
    before = counts.ready + counts.waited
    got += s.encode_frames_staged(chunks[:4])
    first = s._dispatch_packed(*chunks[4])
    second = s._dispatch_packed(*chunks[5])
    torch.cuda._sleep(400_000_000)  # about 200 ms at the highest SM clock
    slept = torch.cuda.Event()
    slept.record()
    got += first()
    assert not slept.query()
    got += second()
    assert got == want
    assert counts.ready + counts.waited - before == 6


def test_staged_cabac_cq_1080p_on_cuda_matches_host_route(cuda_device):
    """1080p Main-profile CABAC at constant QP with I_4x4 IDRs, one slice:
    the staged route on the card (the device's CAVLC pack transcoded to
    CABAC on the host) gives the AUs and planes of per-frame encode_frame,
    which codes each P frame's downloaded symbols with the host's CABAC
    writer, and of the same route on the CPU at 176x144."""
    kw = dict(qp=32, gop_size=300, level_idc=41, profile="main", cabac=True,
              i4x4=True, entropy_mode="device")
    for (w, h), devices in (((1920, 1080), (cuda_device,)),
                            ((176, 144), (cuda_device, "cpu"))):
        frames = _clip(w, h, 5, seed=5)
        out, recon = [], []
        for device in devices:
            one = EncoderSession(EncoderConfig(width=w, height=h, **kw),
                                 device=device)
            out.append([one.encode_frame(f) for f in frames])
            recon.append([p.cpu() for p in one.recon])
        s = EncoderSession(EncoderConfig(width=w, height=h, **kw),
                           device=cuda_device)
        s.PIPELINE_CHUNK = 2
        out.append([s.encode_frame(frames[0])] + s.encode_frames_staged(
            s.upload_frames(frames[1:])))
        recon.append([p.cpu() for p in s.recon])
        for aus, planes in zip(out[1:], recon[1:]):
            assert aus == out[0]
            for a, b in zip(planes, recon[0]):
                assert torch.equal(a, b)


@pytest.mark.parametrize("kernel", ["frame", "wave"])
def test_decode_on_cuda_matches_cpu(cuda_device, kernel):
    frames = _clip(72, 40, 4)
    s = EncoderSession(EncoderConfig(width=72, height=40, qp=28, gop_size=30),
                       device=cuda_device)
    aus = [s.encode_frame(frames[0])] + s.encode_frames(frames[1:])
    out = []
    for device in (cuda_device, "cpu"):
        dec = TpuDecoder(device=device, deblock_kernel=kernel)
        out.append([f for au in aus for f in dec.decode_annexb(au)])
    assert len(out[0]) == len(out[1]) == 4
    for a, b in zip(*out):
        for p in "yuv":
            np.testing.assert_array_equal(getattr(a, p), getattr(b, p))
    for got, want in zip((out[0][-1].y, out[0][-1].u, out[0][-1].v), s.recon):
        np.testing.assert_array_equal(got, want.cpu().numpy())


@pytest.mark.parametrize("adaptive", [False, True], ids=["frame_qp", "mb_qp"])
def test_cbr_cabac_session_and_decode_on_cuda_match_cpu(cuda_device, adaptive):
    """The reference operating point at 64x48: the CBR loop's QPs, the
    transcoded CABAC AUs and the recon on the card equal the CPU's (which
    the CPU tests hold to the JAX package), and the CABAC stream decodes on
    the card to the same planes as on the CPU and to the encoder's recon."""
    frames = _clip(64, 48, 9)
    out, recon = [], []
    for device in (cuda_device, "cpu"):
        s = EncoderSession(EncoderConfig(
            width=64, height=48, qp=30, gop_size=30, rc_mode="cbr",
            bitrate=150_000, framerate=30, cabac=True, cabac_init_idc=1,
            adaptive_qp=adaptive), device=device)
        s.PIPELINE_CHUNK = 2
        aus = [s.encode_frame(frames[0])] + s.encode_frames(frames[1:5])
        aus += s.encode_frames_staged(s.upload_frames(frames[5:]))
        out.append(aus)
        recon.append([p.cpu() for p in s.recon])
    assert out[0] == out[1]
    for a, b in zip(*recon):
        assert torch.equal(a, b)
    decoded = []
    for device in (cuda_device, "cpu"):
        dec = TpuDecoder(device=device)
        decoded.append([f for au in out[0] for f in dec.decode_annexb(au)])
    assert len(decoded[0]) == len(decoded[1]) == 9
    for a, b in zip(*decoded):
        for p in "yuv":
            np.testing.assert_array_equal(getattr(a, p), getattr(b, p))
    for got, want in zip((decoded[0][-1].y, decoded[0][-1].u,
                          decoded[0][-1].v), recon[0]):
        np.testing.assert_array_equal(got, want.numpy())


def _structured(w, h, n):
    """Directional edges around a flat rectangle: I_4x4 and I_16x16 MBs."""
    rng = np.random.default_rng(1)
    yy, xx = np.mgrid[0:h, 0:w]
    out = []
    for t in range(n):
        x = xx + 2 * t
        y = (128 + 60 * np.sin(x / 3.0) * (yy % 17 < 9)
             + 50 * ((x + 2 * yy) % 23 < 7)).clip(0, 255).astype(np.uint8)
        y += rng.integers(0, 6, (h, w)).astype(np.uint8)
        y[16:32, 16:48] = 100
        out.append(yuv.pack_i420(y, np.full((h // 2, w // 2), 90, np.uint8),
                                 np.full((h // 2, w // 2), 150, np.uint8)))
    return out


NEW_CONFIGS = {
    "i4x4-cavlc": dict(i4x4=True),
    "i4x4-cabac": dict(i4x4=True, cabac=True),
    "i4x4-cbr-cabac": dict(i4x4=True, cabac=True, cabac_init_idc=1,
                           rc_mode="cbr", bitrate=150_000, framerate=30),
    "3slices-idc0": dict(num_slices=3),
    "3slices-idc2": dict(num_slices=3, deblock_across_slices=False),
    "2slices-i4x4-cabac-idc2": dict(num_slices=2, i4x4=True, cabac=True,
                                    deblock_across_slices=False),
    "2slices-cabac-cbr": dict(num_slices=2, cabac=True, rc_mode="cbr",
                              bitrate=150_000, framerate=30),
}


@pytest.mark.parametrize("name", list(NEW_CONFIGS))
def test_new_configs_encode_and_decode_on_cuda_match_cpu(cuda_device, name):
    """I_4x4 and multi-slice sessions (both idc values) on the card against
    the CPU (which the CPU tests hold to the JAX package): same AUs, same
    recon; their streams decoded on the card through both deblock routes
    against the CPU's planes and the encoder's recon."""
    frames = _structured(64, 48, 4)
    out, recon, n_i4 = [], [], []
    for device in (cuda_device, "cpu"):
        s = EncoderSession(EncoderConfig(width=64, height=48, qp=28,
                                         gop_size=30, **NEW_CONFIGS[name]),
                           device=device)
        s.PIPELINE_CHUNK = 2
        inner = s._frame_encoder.encode_iframe

        def tapped(*a, _inner=inner, **kw):
            res = _inner(*a, **kw)
            n_i4.append(0 if res.is_i4 is None else int(res.is_i4.sum()))
            return res

        s._frame_encoder.encode_iframe = tapped
        out.append([s.encode_frame(frames[0])] + s.encode_frames(frames[1:]))
        recon.append([p.cpu() for p in s.recon])
    assert out[0] == out[1]
    assert n_i4[0] == n_i4[1] and (n_i4[0] > 0) == ("i4x4" in name)
    for a, b in zip(*recon):
        assert torch.equal(a, b)
    for kernel in ("frame", "wave"):
        decoded = []
        for device in (cuda_device, "cpu"):
            dec = TpuDecoder(device=device, deblock_kernel=kernel)
            decoded.append([f for au in out[0] for f in dec.decode_annexb(au)])
        assert len(decoded[0]) == len(decoded[1]) == 4
        for a, b in zip(*decoded):
            for p in "yuv":
                np.testing.assert_array_equal(getattr(a, p), getattr(b, p))
        last = decoded[0][-1]
        for got, want in zip((last.y, last.u, last.v), recon[0]):
            np.testing.assert_array_equal(got, want.numpy())


@pytest.mark.parametrize("n", [5, 6])
def test_bgop_on_cuda_matches_cpu(cuda_device, n):
    frames = _clip(64, 48, n)
    out = []
    for device in (cuda_device, "cpu"):
        s = EncoderSession(EncoderConfig(width=64, height=48, qp=28,
                                         gop_size=4, b_frames=1),
                           device=device)
        out.append(s.encode_frames(frames))
    assert out[0] == out[1] and len(out[0]) == n


def test_lossless_touches_no_device(cuda_device):
    """Constructing the session places its frame encoder's tables on the
    device like any session; encoding lossless frames allocates nothing
    there."""
    frames = _clip(64, 48, 2)
    s = EncoderSession(EncoderConfig(width=64, height=48, lossless=True,
                                     num_slices=2), device=cuda_device)
    before = torch.cuda.memory_allocated(cuda_device)
    aus = s.encode_frames(frames)
    cpu = EncoderSession(EncoderConfig(width=64, height=48, lossless=True,
                                       num_slices=2), device="cpu")
    assert aus == cpu.encode_frames(frames)
    assert all(isinstance(p, np.ndarray) for p in s.recon)
    assert torch.cuda.memory_allocated(cuda_device) == before


# ------------------------------------------------ the launch-device repairs


def _random_picture(R, C, seed, device):
    rng = np.random.default_rng(seed)
    planes = [torch.as_tensor(rng.integers(0, 256, (R * s, C * s)) // 8 + 100,
                              dtype=torch.uint8, device=device)
              for s in (16, 8, 8)]
    bs = [torch.as_tensor(rng.integers(0, 5, (R * 4, C * 4)), dtype=torch.int32,
                          device=device) for _ in range(2)]
    return planes, bs


def _launch_devices():
    """cuda:0 given explicitly; with more than one card also the last one
    while cuda:0 is current."""
    n = torch.cuda.device_count()
    return [torch.device("cuda", 0)] + (
        [torch.device("cuda", n - 1)] if n > 1 else [])


def test_kernels_launch_on_their_tensors_device(cuda_device):
    """Every wrapper launches on its tensors' device, whatever device is
    current. On a host with one card that device is the current one too,
    so there this checks only that an explicit cuda:0 works; the repair
    itself is checked on the last card where there is more than one (and
    on the CPU by tests/test_torch_kernel_launch.py)."""
    torch.cuda.set_device(0)
    R, C = 5, 7
    for dev in _launch_devices():
        planes, bs = _random_picture(R, C, 3, "cpu")
        want = tda.deblock_frame(*planes, 30, 29, *bs, R, C, kernel="frame")
        meta = tda.build_meta(30, 29, *bs, R, C)
        for kernel in ("frame", "wave"):
            got = tda.deblock_frame(*(p.to(dev) for p in planes), 30, 29,
                                    *(b.to(dev) for b in bs), R, C,
                                    kernel=kernel)
            assert torch.cuda.current_device() == 0
            for a, b in zip(got, want):
                assert a.device == dev and torch.equal(a.cpu(), b), kernel
        c = [p.to(dev) for p in planes]
        for k in range(dw.n_waves(R, C)):
            dp.deblock_wave_step_inplace(*c, meta.to(dev), R, C, k)
        for a, b in zip(c, want):
            assert torch.equal(a.cpu(), b)
        n = 3
        patches = [torch.randint(90, 130, (n, s, s), dtype=torch.uint8)
                   for s in (20, 12, 12)]
        got = dp.deblock_wave_step(*(p.to(dev) for p in patches),
                                   meta[:n].to(dev))
        torch.cuda.synchronize(dev)
        for a, b in zip(got, dp.deblock_wave_step_plain(*patches, meta[:n])):
            assert a.device == dev and torch.equal(a.cpu(), b)
        assert torch.cuda.current_device() == 0


def test_wave_route_in_two_threads(cuda_device):
    """Two threads run route `wave` on two pictures of one geometry 20 times
    each, through the one CUDA graph of that geometry: every result equals
    its own plain version."""
    import threading

    R, C = 9, 11
    pics = [_random_picture(R, C, seed, cuda_device) for seed in (1, 2)]
    want = [[p.cpu() for p in tda.deblock_frame(
        *(q.cpu() for q in planes), 30, 29, *(b.cpu() for b in bs), R, C,
        kernel="wave")] for planes, bs in pics]
    errors = []

    def work(i):
        try:
            planes, bs = pics[i]
            for _ in range(20):
                got = tda.deblock_frame(*planes, 30, 29, *bs, R, C,
                                        kernel="wave")
                torch.cuda.current_stream().synchronize()
                if not all(torch.equal(a.cpu(), b)
                           for a, b in zip(got, want[i])):
                    errors.append(i)
        except Exception as e:  # reported below
            errors.append(repr(e))

    threads = [threading.Thread(target=work, args=(i,)) for i in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert errors == []


# ------------------------------------------------------- the public API


def _api_run(store_kw, frames, device, events=None):
    from media_tpu_torch import api
    from media_tpu_torch.core import params as P

    store = P.ParamStore({getattr(P, k): v for k, v in store_kw.items()})
    enc = api.create_video_encoder(store, device=device)
    assert enc.init_encoder() == 0 and enc.start_encoder() == 0
    aus, qps = [], []
    for i, buf in enumerate(frames):
        for k, v in (events or {}).get(i, {}).items():
            store.set(getattr(P, k), v)
        code, au = enc.encode_one_frame(buf)
        assert code == 0
        aus.append(bytes(au))
        qps.append(enc._current_qp())
    dec = api.create_video_decoder(device=device)
    assert [dec.create_decoder(0), dec.init_decoder(),
            dec.start_decoder()] == [0, 0, 0]
    payloads = []
    for au in aus + [b""]:
        assert dec.send_stream_data(au) == 0
        while True:
            code, payload, _info = dec.retrieve_frame_data()
            if code == 0:
                payloads.append(payload)
            elif code not in (13,):  # BAD_PIC_SIZE: the new geometry
                break
    assert type(dec._decoder).__name__ == "TpuDecoder"
    return aus, qps, payloads


@pytest.mark.parametrize("profile", ["baseline", "main"])
def test_api_lifecycle_on_cuda_matches_cpu(cuda_device, profile):
    frames = _clip(64, 48, 6)
    kw = {"KEY_HW_WIDTH": "64", "KEY_HW_HEIGHT": "48", "KEY_PROFILE": profile}
    events = {3: {"KEY_FORCE_KEYFRAME": "1"},
              5: {"KEY_BITRATE": "2000000", "KEY_PARAM_ADJUSTING": "1"}}
    (a, qa, pa), (b, qb, pb) = (_api_run(kw, frames, d, events)
                                for d in (cuda_device, "cpu"))
    assert a == b and pa == pb and len(pa) == 6
    for x, y in zip(qa, qb):  # the rate loop's float carry
        assert abs(x - y) <= 1e-5 * max(abs(x), abs(y))


def test_api_default_properties_on_cuda_match_the_golden(cuda_device):
    """The shipped property defaults (720x1280 baseline, CBR, I_4x4): the
    first three AUs are those the JAX package recorded."""
    import json
    import os

    import chip_smoke as cs

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "media_tpu_torch", "golden_1080p.json")) as f:
        want = json.load(f)["api_default"]
    aus, _qps, payloads = _api_run({}, cs.api_clip("api_default")[:3],
                                   cuda_device)
    assert [cs.hashlib.sha256(a).hexdigest() for a in aus] == \
        want["au_sha256"][:3]
    assert [cs.hashlib.sha256(p).hexdigest() for p in payloads] == \
        want["decoded_sha256"][:3]


@pytest.mark.parametrize("rc", ["cq", "cbr"])
def test_two_tiles_on_cuda_match_cpu(cuda_device, rc):
    """Two row tiles on the one card (["cuda:0"] * 2) against the same
    session on ["cpu"] * 2 (tests/test_torch_sharding.py and
    test_torch_multislice.py hold that one to the JAX package): AUs,
    recon, rate state; one whole-frame launch per tile per picture."""
    from media_tpu_torch.parallel.sharding import ShardedEncoderSession

    bufs = _clip(64, 64, 4, seed=11)
    kw = dict(width=64, height=64, qp=30, gop_size=30)
    if rc == "cbr":
        kw.update(rc_mode="cbr", bitrate=150_000, framerate=30,
                  adaptive_qp=True, i4x4=True)
    out = {}
    for devs in (["cuda:0"] * 2, ["cpu"] * 2):
        s = ShardedEncoderSession(EncoderConfig(**kw), devices=devs)
        before = dw.deblock_wave.launches
        aus = s.encode_frames(bufs[:1]) + s.encode_frames(bufs[1:])
        out[devs[0]] = (aus, [p.cpu() for p in s.recon], s.base.rc_state,
                        dw.deblock_wave.launches - before)
    gpu, cpu = out["cuda:0"], out["cpu"]
    assert gpu[0] == cpu[0]
    assert all(torch.equal(a, b) for a, b in zip(gpu[1], cpu[1]))
    assert gpu[3] == 2 * len(bufs) and cpu[3] == 0
    for k in ("qp", "buf", "cplx"):
        assert gpu[2][k] == pytest.approx(cpu[2][k], rel=1e-5)


def test_process_dispatch_on_cuda_matches_a_session(cuda_device):
    """dispatch_multiprocess over two spawned workers on the card: the AUs
    of one session on the card that applies the same GOP resets, and one
    whole-frame launch per picture in the workers."""
    from media_tpu_torch.parallel.gop_dispatch_mp import dispatch_multiprocess

    w, h, gop, ngops = 64, 48, 3, 2
    bufs = _clip(w, h, gop * ngops, seed=12)
    cfg = dict(width=w, height=h, qp=30, gop_size=gop)
    aus, rep = dispatch_multiprocess(cfg, bufs, gop, n_procs=2,
                                     use_distributed=False, device="cuda")
    sess = EncoderSession(EncoderConfig(**cfg), device=cuda_device)
    want = []
    for g in range(ngops):
        sess.reset_gop_state(g)
        want += sess.encode_frames(bufs[g * gop : (g + 1) * gop])
    assert aus == want
    assert rep.kernel_launches == len(bufs) and rep.n_procs == 2


def test_capi_void_factories_run_on_cuda(cuda_device):
    """The port's C ABI on the card: CreateVideoEncoder() and
    CreateVideoDecoder() (void, so "cuda") give the AUs and payloads of the
    same run through CreateVideoEncoderOn(b"cpu") /
    CreateVideoDecoderOn(b"cpu"), with two whole-frame launches a picture
    on the card and none on the CPU."""
    import chip_smoke as cs
    from media_tpu_torch import native
    from media_tpu_torch.core import params as P

    lib = native.bind_capi(native.build_capi()[0])
    frames = _clip(64, 48, 5)
    run = ({"KEY_HW_WIDTH": 64, "KEY_HW_HEIGHT": 48, "KEY_PROFILE": "main"},
           5, {3: {"KEY_FORCE_KEYFRAME": "1"}}, (64, 48))
    out = {}
    for name, enc, dec in (
            ("cuda", lib.CreateVideoEncoder, lib.CreateVideoDecoder),
            ("cpu", lambda: lib.CreateVideoEncoderOn(b"cpu"),
             lambda: lib.CreateVideoDecoderOn(b"cpu"))):
        before = dw.deblock_wave.launches
        e = cs.drive_capi_encode(lib, enc(), P, run, frames,
                                 torch.cuda.synchronize)
        d = cs.drive_capi_decode(lib, dec(), e["aus"], (64, 48))
        out[name] = (e["codes"], e["aus"], d["codes"], d["payloads"],
                     dw.deblock_wave.launches - before)
    gpu, cpu = out["cuda"], out["cpu"]
    assert gpu[:4] == cpu[:4] and not any(gpu[0] + gpu[2])
    assert len(gpu[3]) == 5 and gpu[4] == 10 and cpu[4] == 0


# ------------------------------------------- the CAVLC P-slice packer kernel


# One MB, one row, one column, a small slice, a 17-row tile, 1080p and 4K,
# each with chip_smoke.PACK_CASES: sparse, dense 28-bit escapes at ratio 1.0,
# a cap that overflows, groups of the bitcat tree over their level's cap,
# all skipped, a QP map with the slice QP as a 0-d device tensor.
@pytest.mark.parametrize("R,C", PACK_SHAPES)
def test_device_cavlc_kernel_matches_plain(cuda_device, R, C):
    """Every case's stream words (all of them, overflow included) and bit
    count equal the plain version's on the same device tensors; the calls
    read nothing back from the device."""
    from chip_smoke import PACK_CASES, slice_symbols
    from media_tpu_torch.entropy import device_cavlc as dc
    from media_tpu_torch.pipeline.pframe_core import unpack_symbols_device

    runs = []
    for i, (name, (opts, out_words, ratio, per_mb)) in enumerate(
            PACK_CASES.items()):
        sym = unpack_symbols_device(
            slice_symbols(R, C, R * C + i, **opts).to(cuda_device))
        kw = {}
        if per_mb:
            rng = np.random.default_rng(i)
            kw = {"qp_map": torch.as_tensor(rng.integers(20, 45, (R, C)),
                                            dtype=torch.int32,
                                            device=cuda_device),
                  "slice_qp": torch.tensor(31, dtype=torch.int32,
                                           device=cuda_device)}
        runs.append((name, sym, out_words(R * C), ratio, kw))
    dc.pack_pslice_device(*runs[0][1], runs[0][2])  # build, tables cached
    before = dc.pack_pslice_device.launches
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = [dc.pack_pslice_device(*sym, out_words, ratio=ratio, **kw)
               for _, sym, out_words, ratio, kw in runs]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert dc.pack_pslice_device.launches == before + len(runs)
    for (name, sym, out_words, ratio, kw), (stream, bits) in zip(runs, got):
        want_s, want_b = dc.pack_pslice_plain(*sym, out_words, ratio=ratio,
                                              **kw)
        assert stream.device == bits.device == sym[0].device
        assert int(bits) == int(want_b), name
        assert torch.equal(stream, want_s), name
        if name == "level_cap" or (name == "overflow" and R * C > 1):
            assert int(bits) == out_words * 32 + 1, name
        elif name == "all_skip":
            assert int(bits) == 2 * len(f"{R * C + 1:b}") - 1
        else:
            assert 0 < int(bits) <= out_words * 32, name


def test_device_cavlc_kernel_on_its_tensors_device(cuda_device):
    from chip_smoke import slice_symbols
    from media_tpu_torch.entropy import device_cavlc as dc
    from media_tpu_torch.pipeline.pframe_core import unpack_symbols_device

    torch.cuda.set_device(0)
    packed = slice_symbols(3, 4, 5)
    want = dc.pack_pslice_device(*unpack_symbols_device(packed), 4096)
    for dev in _launch_devices():
        got = dc.pack_pslice_device(*unpack_symbols_device(packed.to(dev)),
                                    4096)
        assert torch.cuda.current_device() == 0
        assert all(g.device == dev for g in got)
        assert torch.equal(got[0].cpu(), want[0])
        assert int(got[1]) == int(want[1])


def test_device_cavlc_kernel_in_two_threads(cuda_device):
    """Two threads, each on a stream of its own, pack their own slices 20
    times: every result equals its slice's plain version."""
    import threading

    from chip_smoke import slice_symbols
    from media_tpu_torch.entropy import device_cavlc as dc
    from media_tpu_torch.pipeline.pframe_core import unpack_symbols_device

    R, C = 17, 30
    syms = [unpack_symbols_device(slice_symbols(R, C, s).to(cuda_device))
            for s in (1, 2)]
    want = [dc.pack_pslice_plain(*sym, 1 << 14) for sym in syms]
    errors = []

    def work(i):
        try:
            with torch.cuda.stream(torch.cuda.Stream()):
                for _ in range(20):
                    stream, bits = dc.pack_pslice_device(*syms[i], 1 << 14)
                    torch.cuda.current_stream().synchronize()
                    if not (torch.equal(stream, want[i][0])
                            and int(bits) == int(want[i][1])):
                        errors.append(i)
        except Exception as e:  # reported below
            errors.append(repr(e))

    threads = [threading.Thread(target=work, args=(i,)) for i in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert errors == []


# ------------------------------------------------------ the P-frame core kernel


# One MB, one row, one column, a small grid, 1080p and 4K (more MBs than
# the card has SMs, many times over).
@pytest.mark.parametrize("R,C", [(1, 1), (1, 5), (5, 1), (6, 9), (68, 120),
                                 (135, 240)])
def test_pframe_core_kernel_matches_plain(cuda_device, R, C):
    """Every output of local_pframe_core and search_refine_luma through the
    kernel equals the plain version's on the same device tensors; the
    kernel calls read nothing back from the device."""
    from chip_smoke import pcore_runs
    from media_tpu_torch.pipeline import pframe_core as pc

    runs = pcore_runs(R, C, cuda_device)
    label, planes, rs, qp, qp_c = runs[0]
    pc.local_pframe_core(*planes, qp, qp_c, rs, R, C)  # build, tables cached
    before = (pc.local_pframe_core.launches, pc.search_refine_luma.launches)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = [(pc.local_pframe_core(*planes, qp, qp_c, rs, R, C),
                pc.search_refine_luma(pc.to_mbs(planes[0], R, C, 16),
                                      planes[3], rs, R, C))
               for _, planes, rs, qp, qp_c in runs]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert (pc.local_pframe_core.launches, pc.search_refine_luma.launches) == (
        before[0] + len(runs), before[1] + len(runs))
    for (label, planes, rs, qp, qp_c), (core, search) in zip(runs, got):
        want = pc.local_pframe_core_plain(*planes, qp, qp_c, rs, R, C)
        for k, v in want.items():
            assert core[k].device == planes[0].device, (label, k)
            assert core[k].dtype == v.dtype, (label, k)
            assert torch.equal(core[k], v), (label, k)
        want = pc.search_refine_luma_plain(pc.to_mbs(planes[0], R, C, 16),
                                           planes[3], rs, R, C)
        for name, a, b in zip(("qmv", "pred", "cost"), search, want):
            assert a.dtype == b.dtype and torch.equal(a, b), (label, name)


# The search ranges beyond the session's 8 and 4 (none, one sample, 16 and
# the widest the wrapper takes, 32) on small grids.
@pytest.mark.parametrize("R,C", [(1, 1), (2, 3), (5, 1), (6, 9)])
@pytest.mark.parametrize("rs", PCORE_RANGES)
def test_pframe_core_kernel_at_every_search_range(cuda_device, R, C, rs):
    """Every picture kind at the range, the QP in each form: the int32 and
    uint8 entries (extended planes, and the whole picture whose rows the
    kernel clamps) and the search alone equal their plain versions."""
    from chip_smoke import pcore_runs, pcore_whole_u8
    from media_tpu_torch.pipeline import pframe_core as pc

    for label, planes, rs, qp, qp_c in pcore_runs(R, C, cuda_device, (rs,)):
        want = pc.local_pframe_core_plain(*planes, qp, qp_c, rs, R, C)
        for entry, got in (
                ("int32", pc.local_pframe_core(*planes, qp, qp_c, rs, R, C)),
                ("uint8", pc.local_pframe_core(
                    *(p.to(torch.uint8) for p in planes), qp, qp_c, rs, R,
                    C)),
                ("whole", pc.pframe_core_whole(
                    *pcore_whole_u8(planes, rs), qp, qp_c, rs, R, C))):
            for k, v in want.items():
                assert got[k].dtype == v.dtype, (label, entry, k)
                assert torch.equal(got[k], v), (label, entry, k)
        cur = pc.to_mbs(planes[0], R, C, 16)
        got = pc.search_refine_luma(cur, planes[3], rs, R, C)
        want = pc.search_refine_luma_plain(cur, planes[3], rs, R, C)
        for name, a, b in zip(("qmv", "pred", "cost"), got, want):
            assert a.dtype == b.dtype and torch.equal(a, b), (label, name)


def test_pframe_core_kernel_resources(cuda_device):
    """Both instances keep everything in registers (no stack, no spill) and
    keep at least 8 blocks of 128 threads resident an SM at every range,
    the uint8 one (the encoder's) 12 at rs 8."""
    from media_tpu_torch.pipeline import pframe_core as pc

    for rs in (0, 8, 32):
        for uint8 in (True, False):
            r = pc.kernel_resources(rs, uint8)
            assert r["threads"] == 128 and r["blocks_per_sm"] >= 8, r
            assert r["local_bytes"] == 0, r
    assert pc.kernel_resources(8)["blocks_per_sm"] == 12


def test_pframe_core_kernel_on_a_row_tile(cuda_device):
    """A 17-row tile of a 1080p picture cut in four, whose extension rows
    are its neighbours' rows (parallel/sharding.py's halo exchange)."""
    from chip_smoke import pcore_planes
    from media_tpu_torch.pipeline import pframe_core as pc

    R, C = 17, 120
    for rs, tile in ((8, 1), (4, 2)):
        planes = [p.to(cuda_device) for p in pcore_planes(
            R, C, rs, tile, "moving", tiles=4, tile=tile)]
        qp = torch.full((R * C,), 31, dtype=torch.int32, device=cuda_device)
        got = pc.local_pframe_core(*planes, qp, 30, rs, R, C)
        want = pc.local_pframe_core_plain(*planes, qp, 30, rs, R, C)
        for k, v in want.items():
            assert torch.equal(got[k], v), (rs, k)


def test_pframe_core_kernel_on_its_tensors_device(cuda_device):
    from chip_smoke import pcore_planes
    from media_tpu_torch.pipeline import pframe_core as pc

    torch.cuda.set_device(0)
    R, C, rs = 3, 4, 8
    planes = pcore_planes(R, C, rs, 5)
    want = pc.local_pframe_core_plain(*planes, 30, 29, rs, R, C)
    for dev in _launch_devices():
        got = pc.local_pframe_core(*(p.to(dev) for p in planes), 30,
                                   torch.tensor(29, device=dev), rs, R, C)
        assert torch.cuda.current_device() == 0
        for k, v in want.items():
            assert got[k].device == dev and torch.equal(got[k].cpu(), v), k


def test_pframe_core_kernel_in_two_threads(cuda_device):
    """Two threads, each on a stream of its own, run the P core on their
    own pictures 20 times: every result equals its picture's plain
    version."""
    import threading

    from chip_smoke import pcore_planes
    from media_tpu_torch.pipeline import pframe_core as pc

    R, C, rs = 17, 30, 8
    inputs = [[p.to(cuda_device) for p in pcore_planes(R, C, rs, s)]
              for s in (1, 2)]
    want = [pc.local_pframe_core_plain(*planes, 28, 27, rs, R, C)
            for planes in inputs]
    errors = []

    def work(i):
        try:
            with torch.cuda.stream(torch.cuda.Stream()):
                for _ in range(20):
                    got = pc.local_pframe_core(*inputs[i], 28, 27, rs, R, C)
                    torch.cuda.current_stream().synchronize()
                    if not all(torch.equal(got[k], v)
                               for k, v in want[i].items()):
                        errors.append(i)
        except Exception as e:  # reported below
            errors.append(repr(e))

    threads = [threading.Thread(target=work, args=(i,)) for i in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert errors == []


# ----------------------------------------------- the intra wavefront kernels


def _intra_kernels(planes, qp, starts, i4x4):
    """Both counted wrappers on one picture: (the encode's dict, the
    reconstruction of its symbols)."""
    from chip_smoke import intra_recon_args
    from media_tpu_torch.ops.transform import chroma_qp
    from media_tpu_torch.pipeline import decoder_tpu as dt
    from media_tpu_torch.pipeline import encoder as en

    R, C = planes[0].shape[0] // 16, planes[0].shape[1] // 16
    has_top = dt.row_has_top(R, starts, planes[0].device)
    enc = en.intra_encode(*planes, qp, int(chroma_qp(qp)), has_top, i4x4)
    return enc, dt.intra_recon(*intra_recon_args(R, C, enc, qp, starts))


def _intra_plain(planes, qp, starts, i4x4):
    from chip_smoke import intra_recon_args
    from media_tpu_torch.ops.transform import chroma_qp
    from media_tpu_torch.pipeline import decoder_tpu as dt
    from media_tpu_torch.pipeline import encoder as en

    R, C = planes[0].shape[0] // 16, planes[0].shape[1] // 16
    has_top = dt.row_has_top(R, starts, planes[0].device)
    enc = en.intra_encode_plain(*planes, qp, int(chroma_qp(qp)), has_top,
                                i4x4)
    return enc, dt.intra_recon_plain(*intra_recon_args(R, C, enc, qp, starts))


def _assert_intra_equal(got, want, what):
    from chip_smoke import _intra_err

    assert _intra_err(got[0], want[0]) == 0, (what, "encode")
    assert all(p.dtype == torch.uint8 for p in got[1]), what
    assert _intra_err(got[1], want[1]) == 0, (what, "recon")


# One MB, one row, one column, a small grid and 1080p: flat planes (ties
# everywhere) and the structured picture with a slice start, with and
# without the I_4x4 decision; noise at QP 0 and QP 51 below 1080p.
@pytest.mark.parametrize("R,C", [(1, 1), (1, 5), (5, 1), (6, 9), (68, 120)])
def test_intra_kernels_match_plain(cuda_device, R, C):
    """Every output of intra_encode and intra_recon through the kernels
    equals the plain loops' on the same device tensors; the kernel calls
    read nothing back from the device."""
    from chip_smoke import intra_runs
    from media_tpu_torch.pipeline import decoder_tpu as dt
    from media_tpu_torch.pipeline import encoder as en

    runs = [(label, [p.to(cuda_device) for p in planes], qp, starts)
            for label, planes, qp, starts in intra_runs(R, C)]
    from media_tpu_torch.pipeline.intra_wave import kernel_launches

    _intra_kernels(runs[0][1], 28, (), True)  # build, tables cached
    before = (en.intra_encode.launches, dt.intra_recon.launches)
    before_k = en.intra_encode.kernel_launches
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = [_intra_kernels(planes, qp, starts, i4x4)
               for _, planes, qp, starts in runs for i4x4 in (False, True)]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    n = 2 * len(runs)
    assert (en.intra_encode.launches, dt.intra_recon.launches) == (
        before[0] + n, before[1] + n)
    assert en.intra_encode.kernel_launches - before_k == len(runs) * (
        kernel_launches(R, C, False) + kernel_launches(R, C, True))
    k = 0
    for label, planes, qp, starts in runs:
        for i4x4 in (False, True):
            want = _intra_plain(planes, qp, starts, i4x4)
            assert got[k][0]["recon_y"].device == planes[0].device
            _assert_intra_equal(got[k], want, (label, i4x4))
            k += 1


def test_intra_kernels_match_plain_at_4k(cuda_device):
    """(135, 240) without the I_4x4 decision: more MB rows and wider waves
    than a 1080p picture."""
    from chip_smoke import intra_runs

    for label, planes, qp, starts in intra_runs(135, 240):
        planes = [p.to(cuda_device) for p in planes]
        _assert_intra_equal(_intra_kernels(planes, qp, starts, False),
                            _intra_plain(planes, qp, starts, False), label)


def test_intra_kernels_on_their_tensors_device(cuda_device):
    from chip_smoke import intra_picture

    torch.cuda.set_device(0)
    planes = intra_picture(3, 4, 5, "structured")
    want = _intra_plain(planes, 28, (1,), True)
    for dev in _launch_devices():
        got = _intra_kernels([p.to(dev) for p in planes], 28, (1,), True)
        assert torch.cuda.current_device() == 0
        assert got[0]["mode16"].device == dev and got[1][0].device == dev
        _assert_intra_equal(
            ({k: v.cpu() for k, v in got[0].items()},
             [p.cpu() for p in got[1]]), want, str(dev))


def test_intra_kernels_in_two_threads(cuda_device):
    """Two threads, each on a stream of its own, encode and decode IDRs of
    their own pictures (one with the I_4x4 decision, one without) 10 times:
    every result equals its picture's plain version."""
    import threading

    from chip_smoke import intra_picture

    inputs = [([p.to(cuda_device) for p in intra_picture(17, 30, s,
                                                         "structured")],
               i4x4) for s, i4x4 in ((1, True), (2, False))]
    want = [_intra_plain(planes, 28, (), i4x4) for planes, i4x4 in inputs]
    errors = []

    def work(i):
        try:
            with torch.cuda.stream(torch.cuda.Stream()):
                planes, i4x4 = inputs[i]
                for _ in range(10):
                    got = _intra_kernels(planes, 28, (), i4x4)
                    torch.cuda.current_stream().synchronize()
                    _assert_intra_equal(got, want[i], i)
        except Exception as e:  # reported below
            errors.append(repr(e))

    threads = [threading.Thread(target=work, args=(i,)) for i in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert errors == []


# ----------------------------- the P core's uint8 entry and its row clamp


@pytest.mark.parametrize("R,C", [(1, 1), (1, 5), (5, 1), (6, 9), (68, 120)])
def test_pframe_core_whole_picture_uint8_matches_plain(cuda_device, R, C):
    """pframe_core_whole on the encoder's uint8 planes, the reference with
    no halo rows (the kernel clamps them), equals the plain version on the
    int32 edge-padded planes, every run of chip_smoke.pcore_runs."""
    from chip_smoke import pcore_runs, pcore_whole_u8
    from media_tpu_torch.pipeline import pframe_core as pc

    before = pc.local_pframe_core.launches
    runs = pcore_runs(R, C, cuda_device)
    for label, planes, rs, qp, qp_c in runs:
        got = pc.pframe_core_whole(*pcore_whole_u8(planes, rs), qp, qp_c, rs,
                                   R, C)
        want = pc.local_pframe_core_plain(*planes, qp, qp_c, rs, R, C)
        for k, v in want.items():
            assert got[k].dtype == v.dtype, (label, k)
            assert torch.equal(got[k], v), (label, k)
    assert pc.local_pframe_core.launches == before + len(runs)


def test_pframe_core_uint8_row_tile_reads_its_halo_rows(cuda_device):
    """The 17-row tiles of a 1080p picture cut in four, as uint8 with their
    neighbours' rows as halos (parallel/sharding.py): read as given."""
    from chip_smoke import pcore_planes
    from media_tpu_torch.pipeline import pframe_core as pc

    R, C = 17, 120
    for rs, tile in ((8, 0), (8, 1), (4, 3)):
        planes = [p.to(cuda_device) for p in pcore_planes(
            R, C, rs, tile, "moving", tiles=4, tile=tile)]
        got = pc.local_pframe_core(*(p.to(torch.uint8) for p in planes), 31,
                                   30, rs, R, C)
        want = pc.local_pframe_core_plain(*planes, 31, 30, rs, R, C)
        for k, v in want.items():
            assert torch.equal(got[k], v), (rs, tile, k)


# ------------------------------------------------ the deblocking meta kernel


@pytest.mark.parametrize("R,C", [(1, 1), (1, 4), (3, 1), (2, 3), (3, 4),
                                 (68, 120), (135, 240)])
def test_deblock_meta_kernel_matches_plain(cuda_device, R, C):
    """Every meta column of deblock_meta through the kernel equals the plain
    version's on the same device tensors, for every case of
    chip_smoke.meta_runs (P and I pictures, every QP form, slice starts);
    the kernel calls read nothing back from the device."""
    from chip_smoke import meta_runs

    runs = meta_runs(R, C, cuda_device)
    for _, kw in runs:  # build; the tables and slice rows cached
        tda.deblock_meta(**kw, R=R, C=C)
    before = tda.deblock_meta.launches
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = [tda.deblock_meta(**kw, R=R, C=C) for _, kw in runs]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert tda.deblock_meta.launches == before + len(runs)
    for (label, kw), meta in zip(runs, got):
        want = tda.deblock_meta_plain(**kw, R=R, C=C)
        assert meta.device == want.device, label
        assert torch.equal(meta, want), label


def test_deblock_meta_kernel_on_its_tensors_device(cuda_device):
    from chip_smoke import meta_qps, meta_symbols

    torch.cuda.set_device(0)
    R, C = 3, 4
    sym = meta_symbols(R, C, 5, "dense")
    qmap = meta_qps("map", R, C, 5)[2]
    want = tda.deblock_meta_plain(sym, 30, 29, R, C, (1,), qmap)
    for dev in _launch_devices():
        got = tda.deblock_meta(sym.to(dev), 30, 29, R, C, (1,), qmap.to(dev))
        assert torch.cuda.current_device() == 0
        assert got.device == dev and torch.equal(got.cpu(), want)
