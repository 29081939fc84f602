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
