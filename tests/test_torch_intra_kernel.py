"""The CUDA intra wavefront (media_tpu_torch/csrc/intra_wave.cu) on the CPU.

No card here, so three things stand in for it:

- the wrappers, with a stand-in for the kernel library: CPU tensors run the
  plain loops and launch nothing; other tensors go to the kernels inside
  their device's context, on its current stream;
- the kernels' arithmetic, compiled with g++ from the same header the
  kernels use (csrc/intra_wave.cuh, driven MB by MB in raster order by
  csrc/intra_wave_emu.cpp, which has the kernel library's C ABI) and called
  through the launchers: every symbol array, is_i4, modes4 and recon sample
  equal to encoder.intra_encode_plain's, with and without the I_4x4
  decision, and every decoded sample equal to decoder_tpu.intra_recon_plain's
  on the symbols those encodes give, on one MB, one row, one column and
  small grids, at QP 0, 28, 36 (the other branch of dequant_dc_4x4) and 51,
  on flat planes (every mode ties), a structured scene (both MB types),
  noise and slice-start rows; whole sessions and decoders through them give
  the plain path's bytes and planes;
- the same arithmetic against the JAX package's FrameEncoder.encode_iframe
  and its decoder's I reconstructions, once with I_4x4 and once without.

The plain loops are held to the JAX package by tests/test_torch_i4x4.py,
test_torch_i4x4_decode.py, test_torch_session.py and test_torch_decoder.py;
the kernels to the plain loops on the card by tests/test_torch_cuda.py and
chip_smoke.py. Tolerance 0: everything is integer.
"""

import contextlib
import ctypes
import hashlib
import os
import subprocess
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from media_tpu.pipeline import decoder_tpu as jdec
from media_tpu.pipeline import encoder as jenc
from media_tpu_torch import kernels
from media_tpu_torch.ops import transform as T
from media_tpu_torch.pipeline import decoder_tpu as tdec
from media_tpu_torch.pipeline import encoder as tenc
from media_tpu_torch.pipeline import intra_wave as iw
from media_tpu_torch.pipeline.codec import EncoderConfig, EncoderSession
from media_tpu_torch.utils import yuv

ENC_KEYS = ("mode16", "chroma_mode", "dc_levels", "ac_levels", "cdc_levels",
            "cac_levels", "recon_y", "recon_u", "recon_v")
I4_KEYS = ("is_i4", "modes4", "luma4_levels")


def structured_scene(w, h, seed=1, shift=0):
    """Strong directional edges (the content where I_4x4 wins) around a flat
    rectangle (where I_16x16 wins), as in tests/test_torch_i4x4.py."""
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


def picture(R, C, kind, seed=0):
    """int32 (y, u, v) planes of an (R, C) MB grid: "flat" (one level a
    plane: every mode ties), "scene" (structured_scene, chroma in four
    levels) or "noise"."""
    rng = np.random.default_rng(seed)
    h, w = 16 * R, 16 * C
    if kind == "flat":
        planes = (np.full((h, w), 77), np.full((h // 2, w // 2), 90),
                  np.full((h // 2, w // 2), 150))
    elif kind == "noise":
        planes = [rng.integers(0, 256, s) for s in ((h, w),) + ((h // 2,
                                                                 w // 2),) * 2]
    else:
        y, _u, v = structured_scene(w, h, seed=seed + 1)
        u = (rng.integers(0, 256, (h // 2, w // 2)) // 64) * 40 + 40
        planes = (y, u, v)
    return [torch.as_tensor(np.asarray(p), dtype=torch.int32) for p in planes]


# ----------------------------------------------------------------- wrappers


def test_cpu_tensors_run_the_plain_versions(monkeypatch):
    monkeypatch.setattr(kernels, "load", lambda: pytest.fail("launched"))
    monkeypatch.setattr(tenc.intra_encode, "launches", 0)
    monkeypatch.setattr(tdec.intra_recon, "launches", 0)
    R, C = 2, 3
    y, u, v = picture(R, C, "scene")
    has_top = tdec.row_has_top(R, (), "cpu")
    for i4x4 in (False, True):
        got = tenc.intra_encode(y, u, v, 28, 28, has_top, i4x4)
        want = tenc.intra_encode_plain(y, u, v, 28, 28, has_top, i4x4)
        assert set(got) == set(want)
        for k in want:
            assert torch.equal(got[k], want[k]), k
        # The kernels' dtypes: int32 symbols, uint8 recon planes.
        assert got["recon_y"].dtype == torch.uint8
        assert got["ac_levels"].dtype == torch.int32
        i4 = tuple(got[k] for k in I4_KEYS) if i4x4 else None
        args = (R, C, got["mode16"], got["chroma_mode"],
                (got["dc_levels"], got["ac_levels"]),
                (got["cdc_levels"], got["cac_levels"]), 28, (), i4)
        for a, b in zip(tdec.intra_recon(*args),
                        tdec.intra_recon_plain(*args)):
            assert a.dtype == torch.uint8
            assert torch.equal(a, b)
    # The public paths: a session's IDR and its decode.
    frame = yuv.pack_i420(*(p.numpy().astype(np.uint8) for p in (y, u, v)))
    s = EncoderSession(EncoderConfig(width=16 * C, height=16 * R, qp=28,
                                     i4x4=True), device="cpu")
    au = s.encode_frame(frame)
    (pic,) = tdec.TpuDecoder(device="cpu").decode_annexb(au)
    assert np.array_equal(pic.y, s.recon[0].numpy())
    assert tenc.intra_encode.launches == 0
    assert tdec.intra_recon.launches == 0


@pytest.fixture
def stub(monkeypatch):
    """A stand-in for the kernel library that records each launch: the
    entry point, the device current at the call and its arguments."""
    current = [torch.device("cuda", 7)]  # what the caller had made current
    log = []

    @contextlib.contextmanager
    def device(dev):
        prev, current[0] = current[0], torch.device(dev)
        try:
            yield
        finally:
            current[0] = prev

    err = [0]  # what each launch returns

    def entry(name):
        def launch(*args):
            log.append((name, current[0], args))
            return err[0]
        return launch

    lib = types.SimpleNamespace(
        intra_encode_launch=entry("encode"), intra_recon_launch=entry("recon"),
        media_cuda_error_string=lambda err: b"stub error")
    streams = {}
    monkeypatch.setattr(torch.cuda, "device", device)
    monkeypatch.setattr(
        torch.cuda, "current_stream",
        lambda dev=None: types.SimpleNamespace(
            cuda_stream=streams.setdefault(str(dev), 1000 + len(streams))))
    monkeypatch.setattr(kernels, "load", lambda: lib)
    for wrapper in (tenc.intra_encode, tdec.intra_recon):
        monkeypatch.setattr(wrapper, "launches", 0)
        monkeypatch.setattr(wrapper, "kernel_launches", 0)
    return log, streams, err


def _meta_encode_args(R, C):
    meta = torch.device("meta")
    planes = [torch.empty(s, dtype=torch.int32, device=meta)
              for s in ((16 * R, 16 * C), (8 * R, 8 * C), (8 * R, 8 * C))]
    return planes, torch.empty((R,), dtype=torch.bool, device=meta)


def _meta_recon_args(R, C, i4=True):
    meta = torch.device("meta")

    def e(*shape, dtype=torch.int32):
        return torch.empty(shape, dtype=dtype, device=meta)

    i4_sym = (e(R, C, dtype=torch.bool), e(R, C, 16), e(R, C, 16, 16))
    return (R, C, e(R, C), e(R, C), (e(R, C, 16), e(R, C, 16, 15)),
            (e(R, C, 2, 4), e(R, C, 2, 4, 15)), 30, (), i4_sym if i4 else None)


def test_wrappers_launch_on_their_tensors_device_and_stream(stub):
    log, streams, _ = stub
    R, C = 2, 3
    planes, has_top = _meta_encode_args(R, C)
    meta = planes[0].device
    out = tenc.intra_encode(*planes, 30, 29, has_top, True)
    assert out["recon_y"].shape == (16 * R, 16 * C)
    assert out["recon_y"].dtype == torch.uint8
    assert out["ac_levels"].shape == (R, C, 16, 15)
    assert out["is_i4"].dtype == torch.bool
    assert out["luma4_levels"].shape == (R, C, 16, 16)
    out = tenc.intra_encode(*planes, 30, 29, has_top, False)
    assert "is_i4" not in out
    iw.launch_intra_encode(*planes, 30, 29, has_top, False)  # raw: no count
    planes_r = tdec.intra_recon(*_meta_recon_args(R, C))
    assert [p.shape for p in planes_r] == [(16 * R, 16 * C), (8 * R, 8 * C),
                                           (8 * R, 8 * C)]
    assert all(p.dtype == torch.uint8 for p in planes_r)
    tdec.intra_recon(*_meta_recon_args(R, C, i4=False))
    assert [(name, dev) for name, dev, _ in log] == [("encode", meta)] * 3 + [
        ("recon", meta)] * 2
    assert tenc.intra_encode.launches == 2
    assert tdec.intra_recon.launches == 2
    # One kernel a wave: 2 (R - 1) + C waves with I_4x4, R + C - 1 without.
    assert tenc.intra_encode.kernel_launches == 5 + 4
    assert tdec.intra_recon.kernel_launches == 5 + 4
    for _, _, args in log:  # the current stream of the tensors' device
        assert args[-1].value == streams[str(meta)]
    assert [args[-4:-1] for _, _, args in log[:3]] == [(R, C, 1), (R, C, 0),
                                                       (R, C, 0)]
    assert [args[-3:-1] for _, _, args in log[3:]] == [(R, C)] * 2
    # QP and chroma QP by value.
    assert log[0][2][5:7] == (30, 29)
    assert log[3][2][10:12] == (30, int(T.chroma_qp(30)))
    strides = ctypes.cast(log[0][2][3], ctypes.POINTER(ctypes.c_int64))
    assert [strides[i] for i in range(3)] == [16 * C, 8 * C, 8 * C]


def test_wrappers_refuse_bad_arguments_and_raise_on_a_failed_launch(stub):
    log, _, err = stub
    R, C = 2, 3
    planes, has_top = _meta_encode_args(R, C)
    with pytest.raises(ValueError, match="QP"):
        tenc.intra_encode(*planes, 52, 29, has_top)
    with pytest.raises(ValueError, match="row_has_top"):
        tenc.intra_encode(*planes, 30, 29, has_top[:1])
    with pytest.raises(ValueError, match="u of shape"):
        tenc.intra_encode(planes[0], planes[1][1:], planes[2], 30, 29, has_top)
    args = list(_meta_recon_args(R, C))
    args[4] = (args[4][0], args[4][1][:, :, :, 1:])
    with pytest.raises(ValueError, match="ac_levels"):
        tdec.intra_recon(*args)
    assert log == []
    err[0] = 700
    with pytest.raises(RuntimeError, match="intra_encode kernel launch failed"):
        tenc.intra_encode(*planes, 30, 29, has_top)
    with pytest.raises(RuntimeError, match="intra_recon kernel launch failed"):
        tdec.intra_recon(*_meta_recon_args(R, C))
    assert tenc.intra_encode.launches == 0
    assert tdec.intra_recon.launches == 0
    assert tenc.intra_encode.kernel_launches == 0
    assert tdec.intra_recon.kernel_launches == 0


def test_kernel_launches_count_the_waves_that_hold_an_mb():
    """kernel_launches against the plain schedule: the waves of
    encoder.wave_lanes that hold at least one MB."""
    for R, C in ((1, 1), (1, 5), (5, 1), (3, 4), (68, 120)):
        for i4x4 in (False, True):
            skew = 2 if i4x4 else 1
            want = sum(
                len(tenc.wave_lanes(k, R, C, skew, "cpu")[0]) > 0
                for k in range(skew * (R - 1) + C))
            assert iw.kernel_launches(R, C, i4x4) == want, (R, C, i4x4)


# ------------------------------------------- the kernels' arithmetic, on g++


@pytest.fixture(scope="module")
def emu_lib():
    """csrc/intra_wave_emu.cpp built with g++ into csrc/build/emu_<hash>/."""
    srcs = [os.path.join(kernels.CSRC, f) for f in
            ("intra_wave_emu.cpp", "intra_wave.cuh", "pframe_core.cuh")]
    flags = ["-O1", "-shared", "-fPIC", "-std=c++17"]
    h = hashlib.sha256(" ".join(flags).encode())
    for s in srcs:
        with open(s, "rb") as f:
            h.update(f.read())
    out_dir = os.path.join(kernels.CSRC, "build", f"emu_{h.hexdigest()[:16]}")
    lib = os.path.join(out_dir, "libintra_wave_emu.so")
    if not os.path.exists(lib):
        os.makedirs(out_dir, exist_ok=True)
        tmp = f"{lib}.{os.getpid()}.tmp"
        subprocess.run(["g++", *flags, "-o", tmp, srcs[0]], check=True,
                       capture_output=True, timeout=300)
        os.replace(tmp, lib)
    return kernels.bind_intra_wave(ctypes.CDLL(lib))


@pytest.fixture
def emulate(emu_lib, monkeypatch):
    """The raw launches on CPU tensors, the host build of the kernel
    library in place of the card's; counts of the routed wrappers."""
    monkeypatch.setattr(kernels, "load", lambda: emu_lib)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    return types.SimpleNamespace(encode=iw.launch_intra_encode,
                                 recon=iw.launch_intra_recon)


def _route_wrappers_to_the_emulation(monkeypatch):
    """encoder.intra_encode and decoder_tpu.intra_recon launch (the g++
    build) on CPU tensors too, as they do on CUDA ones; returns the count
    of routed calls."""
    calls = []

    def encode(y, u, v, qp, qp_c, row_has_top, i4x4=False):
        calls.append("encode")
        return iw.launch_intra_encode(y, u, v, qp, qp_c, row_has_top, i4x4)

    def recon(R, C, mode16, chroma_mode, luma_sym, chroma_sym, qp,
              slice_starts=(), i4_sym=None):
        calls.append("recon")
        return iw.launch_intra_recon(
            R, C, mode16, chroma_mode, luma_sym, chroma_sym, qp,
            int(T.chroma_qp(qp)),
            tdec.row_has_top(R, slice_starts, mode16.device), i4_sym)

    monkeypatch.setattr(tenc, "intra_encode", encode)
    monkeypatch.setattr(tdec, "intra_recon", recon)
    return calls


def _assert_encode_equal(got, want, what):
    assert set(got) == set(want), what
    for k, v in want.items():
        assert got[k].dtype == v.dtype, (what, k)
        assert torch.equal(got[k], v), (what, k)


def _recon_args(R, C, sym, qp, starts):
    """intra_recon's arguments for the symbols of an encode; the I_4x4
    fields only where the picture holds an I_4x4 MB (decoder_tpu's schedule
    choice)."""
    i4 = (tuple(sym[k] for k in I4_KEYS)
          if "is_i4" in sym and bool(sym["is_i4"].any()) else None)
    return (R, C, sym["mode16"], sym["chroma_mode"],
            (sym["dc_levels"], sym["ac_levels"]),
            (sym["cdc_levels"], sym["cac_levels"]), qp, starts, i4)


def _check_encode_and_recon(emulate, R, C, planes, qp, starts, what):
    """Both kernels against both plain loops, with and without I_4x4;
    returns the plain encodes."""
    qp_c = int(T.chroma_qp(qp))
    has_top = tdec.row_has_top(R, starts, "cpu")
    out = {}
    for i4x4 in (False, True):
        want = tenc.intra_encode_plain(*planes, qp, qp_c, has_top, i4x4)
        got = emulate.encode(*planes, qp, qp_c, has_top, i4x4)
        _assert_encode_equal(got, want, (what, i4x4))
        args = _recon_args(R, C, want, qp, starts)
        got_r = emulate.recon(*args[:7], qp_c, has_top, args[8])
        for a, b, name in zip(got_r, tdec.intra_recon_plain(*args), "yuv"):
            assert a.dtype == b.dtype == torch.uint8, (what, i4x4, name)
            assert torch.equal(a, b), (what, i4x4, name)
        # The encoder's recon is the decoder's.
        assert torch.equal(got_r[0], got["recon_y"]), (what, i4x4)
        out[i4x4] = want
    return out


# One MB, one row, one column, two small grids; the QPs of both branches of
# dequant_dc_4x4 and the ends of the range; the picture kinds in turn; a
# slice start on every grid of 3 rows or more.
SHAPES = ((1, 1), (1, 5), (5, 1), (3, 4), (4, 6))
QPS = (0, 28, 36, 51)
KINDS = ("flat", "scene", "noise")
CASES = [(R, C, qp, KINDS[(i + j) % 3], (1,) if R >= 3 and j % 2 else ())
         for i, (R, C) in enumerate(SHAPES) for j, qp in enumerate(QPS)]


@pytest.mark.parametrize("R,C,qp,kind,starts", CASES)
def test_kernel_arithmetic_matches_plain(emulate, R, C, qp, kind, starts):
    planes = picture(R, C, kind, seed=R * C + qp)
    out = _check_encode_and_recon(emulate, R, C, planes, qp, starts,
                                  (R, C, qp, kind, starts))
    if kind == "flat" and R > 1 and C > 1:
        # Ties everywhere: at an MB with both neighbours all four modes tie
        # and V, the first, wins.
        assert int((out[False]["mode16"] == 0).sum()) > 0


@pytest.mark.parametrize("slice_rows", [(), (1, 2), (2,)])
def test_scene_holds_both_mb_types_and_ties(emulate, slice_rows):
    """The structured scene at 64x64: I_4x4 and I_16x16 MBs, the flat
    rectangle where the 4x4 modes tie, the availability of FrameEncoder's
    slice rows; the losing side's levels zero and mode16 kept."""
    R, C = 4, 4
    planes = [torch.as_tensor(p, dtype=torch.int32)
              for p in structured_scene(16 * C, 16 * R)]
    enc = tenc.FrameEncoder(16 * C, 16 * R, "cpu", slice_rows=slice_rows)
    assert enc._row_has_top.tolist() == [
        r > 0 and r not in slice_rows for r in range(R)]
    out = _check_encode_and_recon(emulate, R, C, planes, 28, slice_rows,
                                  slice_rows)[True]
    got = emulate.encode(*planes, 28, 28, enc._row_has_top, True)
    is_i4 = got["is_i4"]
    assert 0 < int(is_i4.sum()) < R * C
    assert not got["luma4_levels"][~is_i4].any()
    assert not got["modes4"][~is_i4].any()
    assert not got["ac_levels"][is_i4].any()
    assert not got["dc_levels"][is_i4].any()
    assert torch.equal(got["mode16"], out["mode16"])


@pytest.mark.parametrize("name,cfg", [
    ("cavlc-i16", dict()),
    ("cabac-i4x4-2slices", dict(cabac=True, i4x4=True, num_slices=2)),
    ("cavlc-i4x4-deblock", dict(i4x4=True, deblock=True)),
])
def test_sessions_and_decoders_through_the_kernels(emulate, monkeypatch, name,
                                                   cfg):
    """An EncoderSession and a TpuDecoder whose intra wavefronts run the
    g++ build give the bytes and planes of the plain path: every IDR of the
    session through the encoder kernel, every I picture of the decoder
    through the recon kernel."""
    W, H = 64, 48
    frames = [yuv.pack_i420(*structured_scene(W, H, shift=2 * t))
              for t in range(2)]

    def run():
        s = EncoderSession(EncoderConfig(width=W, height=H, qp=28,
                                         gop_size=1, **cfg), device="cpu")
        aus = s.encode_frames(frames)
        dec = tdec.TpuDecoder(device="cpu")
        pics = [tuple(np.array(getattr(f, c)) for c in "yuv")
                for au in aus for f in dec.decode_annexb(au)]
        return aus, pics, s.recon[0].numpy()

    want = run()
    calls = _route_wrappers_to_the_emulation(monkeypatch)
    got = run()
    assert calls.count("encode") == 2 and calls.count("recon") == 2
    assert got[0] == want[0]
    for a, b in zip(got[1], want[1]):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(got[1][-1][0], got[2])


# ------------------------------------------------ against the JAX package

JAX_W, JAX_H, JAX_QP = 64, 48, 28


@pytest.fixture(scope="module")
def jax_intra():
    """The JAX package's encode_iframe (no deblocking) of the structured
    scene, with and without I_4x4, and its decoder's I reconstruction of
    each result: {i4x4: (planes, fields as numpy, decoded planes)}."""
    y, u, v = structured_scene(JAX_W, JAX_H)
    R, C = JAX_H // 16, JAX_W // 16
    out = {}
    for i4x4 in (False, True):
        res = jenc.FrameEncoder(JAX_W, JAX_H).encode_iframe(
            y, u, v, JAX_QP, deblock=False, i4x4=i4x4)
        fields = {k: np.array(getattr(res, k))
                  for k in ENC_KEYS + (I4_KEYS if i4x4 else ())}
        sym = [jnp.asarray(fields[k]) for k in ENC_KEYS[:6]]
        luma, chroma = (sym[2], sym[3]), (sym[4], sym[5])
        if i4x4:
            dec = jdec._recon_iframe_mixed_device(
                R, C, sym[0], sym[1], luma, chroma,
                tuple(jnp.asarray(fields[k]) for k in I4_KEYS), JAX_QP, False)
        else:
            dec = jdec._recon_iframe_device(R, C, sym[0], sym[1], luma,
                                            chroma, JAX_QP, False)
        out[i4x4] = ((y, u, v), fields, [np.asarray(p) for p in dec])
    return out


@pytest.mark.parametrize("i4x4", [False, True], ids=["i16x16", "i4x4"])
def test_kernel_arithmetic_matches_jax(emulate, jax_intra, i4x4):
    planes, want, want_dec = jax_intra[i4x4]
    R, C = JAX_H // 16, JAX_W // 16
    planes = [torch.as_tensor(p, dtype=torch.int32) for p in planes]
    has_top = tdec.row_has_top(R, (), "cpu")
    got = emulate.encode(*planes, JAX_QP, int(T.chroma_qp(JAX_QP)), has_top,
                         i4x4)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    if i4x4:
        assert 0 < want["is_i4"].sum() < R * C
    sym = {k: torch.as_tensor(v) for k, v in want.items()}
    args = _recon_args(R, C, sym, JAX_QP, ())
    got_dec = emulate.recon(*args[:7], int(T.chroma_qp(JAX_QP)), has_top,
                            args[8])
    for a, b, name in zip(got_dec, want_dec, "yuv"):
        np.testing.assert_array_equal(a.numpy(), b, err_msg=name)
