"""The CUDA deblocking meta kernel (media_tpu_torch/csrc/deblock_meta.cu) on
the CPU.

No card here, so three things stand in for it:

- the kernel's arithmetic, compiled with g++ from the same header the
  kernel uses (csrc/deblock_meta.cuh, driven MB by MB by
  csrc/deblock_meta_emu.cpp, which has the kernel library's C ABI) and
  called through the wrapper: every meta column equal to build_meta's over
  pframe_bs_grids or intra_bs_grids, for P and I pictures, the QP as an int,
  a 0-d tensor and a per-MB map, QP 0 and 51, slice starts, one-row and
  one-column pictures, and MVs 3 and 4 quarter-pels apart;
- the wrapper, with a stand-in for the kernel library: CPU tensors run the
  plain version and launch nothing; other tensors go to the kernel inside
  their device's context, on its current stream, counted under a lock; a
  failed launch raises;
- the deblocking entry points that call the wrapper, on CPU tensors,
  against the JAX package's deblock_pframe_from_symbols and deblock_iframe
  planes.

Everything is integer: tolerance 0. The kernel is held to the plain version
on the card by tests/test_torch_cuda.py and chip_smoke.py.
"""

import contextlib
import ctypes
import hashlib
import os
import subprocess
import threading
import types

import jax
import numpy as np
import pytest
import torch

from chip_smoke import META_SHAPES, meta_qps, meta_runs, meta_symbols
from media_tpu.pipeline import deblock_apply as jda
from media_tpu_torch import kernels
from media_tpu_torch.ops.deblock import META_COLS
from media_tpu_torch.pipeline import deblock_apply as tda

CPU = torch.device("cpu")


# ------------------------------------------- the kernel's arithmetic, on g++


@pytest.fixture(scope="module")
def emu_lib():
    """csrc/deblock_meta_emu.cpp built with g++ into csrc/build/emu_<hash>/."""
    srcs = [os.path.join(kernels.CSRC, f) for f in
            ("deblock_meta_emu.cpp", "deblock_meta.cuh")]
    flags = ["-O1", "-shared", "-fPIC", "-std=c++17"]
    h = hashlib.sha256(" ".join(flags).encode())
    for s in srcs:
        with open(s, "rb") as f:
            h.update(f.read())
    out_dir = os.path.join(kernels.CSRC, "build", f"emu_{h.hexdigest()[:16]}")
    lib = os.path.join(out_dir, "libdeblock_meta_emu.so")
    if not os.path.exists(lib):
        os.makedirs(out_dir, exist_ok=True)
        tmp = f"{lib}.{os.getpid()}.tmp"
        subprocess.run(["g++", *flags, "-o", tmp, srcs[0]], check=True,
                       capture_output=True, timeout=300)
        os.replace(tmp, lib)
    return kernels.bind_deblock_meta(ctypes.CDLL(lib))


@pytest.fixture
def emulate(emu_lib, monkeypatch):
    """The raw launch on CPU tensors, the host build of the kernel library
    in place of the card's."""
    monkeypatch.setattr(kernels, "load", lambda: emu_lib)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    return tda.launch_deblock_meta


CASES = [(R, C, i) for R, C in META_SHAPES for i in range(9)]


@pytest.mark.parametrize("R,C,i", CASES)
def test_kernel_arithmetic_matches_plain(emulate, R, C, i):
    label, kw = meta_runs(R, C, CPU)[i]
    want = tda.deblock_meta_plain(**kw, R=R, C=C)
    got = emulate(**kw, R=R, C=C)
    assert got.dtype == want.dtype == torch.int32, label
    assert got.shape == (R * C, META_COLS), label
    bad = (got != want).any(dim=0).nonzero().flatten().tolist()
    assert not bad, f"{label}: columns {bad} differ"


def test_mv_threshold_is_four_quarter_pels(emulate):
    """MVs 3 apart along a row and 4 down a column, no level: bS 0 on every
    vertical MB edge, 1 on every horizontal one below row 0, at QP 51 a
    nonzero tc0 there."""
    R, C = 3, 4
    sym = meta_symbols(R, C, 0, "steps")
    meta = emulate(sym, 51, 51, R, C).reshape(R, C, META_COLS)
    assert torch.equal(meta, tda.deblock_meta_plain(sym, 51, 51, R, C)
                       .reshape(R, C, META_COLS))
    assert int(meta[..., 0:16].abs().max()) == 0
    assert (meta[1:, :, 16:20] == 1).all() and (meta[0, :, 16:20] == 0).all()
    assert int(meta[..., 20:32].abs().max()) == 0  # inner edges, same MV
    assert (meta[1:, :, 48:52] > 0).all()


def test_levels_anywhere_in_a_block_count(emulate):
    """One nonzero level at each zig-zag position of one block in turn: bS 2
    on the block's four edges each time."""
    R, C = 2, 2
    for pos in range(16):
        sym = torch.zeros((R, C, 386), dtype=torch.int16)
        sym[1, 1, 2 + 16 * 5 + pos] = -1  # block 5: row 1, column 1
        meta = emulate(sym, 30, 29, R, C)
        assert torch.equal(meta, tda.deblock_meta_plain(sym, 30, 29, R, C))
        mb = meta[3]
        assert int(mb[1 * 4 + 1]) == 2 and int(mb[2 * 4 + 1]) == 2  # v1, v2
        assert int(mb[16 + 1 * 4 + 1]) == 2 and int(mb[16 + 2 * 4 + 1]) == 2


# --------------------------------------------------------------- the wrapper


def test_cpu_tensors_run_the_plain_version(monkeypatch):
    monkeypatch.setattr(kernels, "load", lambda: pytest.fail("launched"))
    monkeypatch.setattr(tda.deblock_meta, "launches", 0)
    R, C = 3, 4
    for label, kw in meta_runs(R, C, CPU):
        got = tda.deblock_meta(**kw, R=R, C=C)
        assert torch.equal(got, tda.deblock_meta_plain(**kw, R=R, C=C)), label
    assert tda.deblock_meta.launches == 0


@pytest.fixture
def stub(monkeypatch):
    """A stand-in for the kernel library that records each launch: the
    device current at the call and its arguments."""
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

    def launch(*args):
        log.append((current[0], args))
        return err[0]

    lib = types.SimpleNamespace(deblock_meta_launch=launch,
                                media_cuda_error_string=lambda e: b"stub")
    streams = {}
    monkeypatch.setattr(torch.cuda, "device", device)
    monkeypatch.setattr(
        torch.cuda, "current_stream",
        lambda dev=None: types.SimpleNamespace(
            cuda_stream=streams.setdefault(str(dev), 1000 + len(streams))))
    monkeypatch.setattr(kernels, "load", lambda: lib)
    monkeypatch.setattr(tda.deblock_meta, "launches", 0)
    return log, streams, err


def test_wrapper_launches_on_its_tensors_device_and_stream(stub,
                                                          monkeypatch):
    log, streams, _ = stub
    monkeypatch.setattr(tda, "_ptr", lambda t: t)  # the tensors, as passed
    meta_dev = torch.device("meta")
    R, C = 2, 3
    sym = torch.empty((R, C, 386), dtype=torch.int16, device=meta_dev)
    qp = torch.empty((), dtype=torch.int32, device=meta_dev)
    qmap = torch.empty((R, C), dtype=torch.int64, device=meta_dev)
    out = tda.deblock_meta(sym, 30, 29, R, C)
    assert out.shape == (R * C, META_COLS) and out.dtype == torch.int32
    assert out.device == meta_dev
    tda.deblock_meta(sym, qp, qp, R, C, slice_starts=(1,))
    tda.deblock_meta(sym, 30, 29, R, C, qp_map=qmap)
    tda.deblock_meta(None, 36, 34, R, C, intra=True, device=meta_dev)
    tda.launch_deblock_meta(sym, 30, 29, R, C)  # the raw launch: no count
    assert [dev for dev, _ in log] == [meta_dev] * 5
    assert tda.deblock_meta.launches == 4
    for _, args in log:  # the current stream of the tensors' device
        assert args[-1].value == streams[str(meta_dev)]
        assert tuple(args[-4:-2]) == (R, C)
        assert args[7].shape == (52, 6) and args[8].shape == (R * C, META_COLS)
    # (symbols, qp tensor, qp value, qp_c tensor, qp_c value, map, slice
    # rows, ...): a QP by value, read on the device, or a map.
    by_value, on_device, mapped, intra = (a for _, a in log[:4])
    assert by_value[0] is sym and by_value[1:7] == (None, 30, None, 29, None,
                                                    None)
    for q in (on_device[1], on_device[3]):
        assert q.dtype == torch.int32 and q.shape == (1,)
    assert on_device[6].dtype == torch.uint8 and on_device[6].shape == (R,)
    assert mapped[1] is None and mapped[3] is None
    assert mapped[5].dtype == torch.int32 and mapped[5].shape == (R * C,)
    assert intra[0] is None and intra[-2] == 1 and by_value[-2] == 0


def test_wrapper_refuses_bad_arguments_and_raises_on_a_failed_launch(stub):
    log, _, err = stub
    meta_dev = torch.device("meta")
    R, C = 2, 3
    sym = torch.empty((R, C, 386), dtype=torch.int16, device=meta_dev)
    with pytest.raises(ValueError, match="symbols"):
        tda.deblock_meta(sym.to(torch.int32), 30, 29, R, C)
    with pytest.raises(ValueError, match="symbols"):
        tda.deblock_meta(sym[:1], 30, 29, R, C)
    with pytest.raises(ValueError, match="qp_map"):
        tda.deblock_meta(sym, 30, 29, R, C, qp_map=torch.empty(
            (R, C + 1), dtype=torch.int32, device=meta_dev))
    with pytest.raises(ValueError, match="qp"):
        tda.deblock_meta(sym, torch.empty((R * C,), dtype=torch.int32,
                                          device=meta_dev), 29, R, C)
    assert log == []
    err[0] = 700
    with pytest.raises(RuntimeError, match="deblock_meta kernel launch"):
        tda.deblock_meta(sym, 30, 29, R, C)
    assert tda.deblock_meta.launches == 0


def test_count_is_exact_from_several_threads(stub):
    sym = torch.empty((1, 1, 386), dtype=torch.int16,
                      device=torch.device("meta"))

    def work():
        for _ in range(200):
            tda.deblock_meta(sym, 30, 29, 1, 1)

    threads = [threading.Thread(target=work) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert tda.deblock_meta.launches == 800


def test_deblocking_entries_route_through_the_wrapper(monkeypatch):
    """deblock_pframe_from_symbols and deblock_iframe take their meta from
    deblock_meta, with the slice starts, the QP map and intra as given."""
    calls = []
    real = tda.deblock_meta

    def spy(*a, **kw):
        calls.append((a, kw))
        return real(*a, **kw)

    monkeypatch.setattr(tda, "deblock_meta", spy)
    R, C = 2, 3
    planes = [torch.full((s * R, s * C), 100, dtype=torch.uint8)
              for s in (16, 8, 8)]
    sym = meta_symbols(R, C, 1)
    qmap = meta_qps("map", R, C, 1)[2]
    tda.deblock_pframe_from_symbols(*planes, sym, 30, 29, R, C, (1,), qmap)
    tda.deblock_iframe(*planes, 36, 34, R, C, (1,), kernel="wave")
    (a0, kw0), (a1, kw1) = calls
    assert a0[0] is sym and a0[5] == (1,) and a0[6] is qmap
    assert a1[0] is None and a1[5] == (1,) and kw1["intra"]
    assert kw1["device"] == planes[0].device


# ------------------------------------------------ against the JAX package


_jax_pframe = jax.jit(jda.deblock_pframe_from_symbols,
                      static_argnums=(6, 7, 8))
_jax_iframe = jax.jit(jda.deblock_iframe, static_argnums=(5, 6, 7))
JAX_R, JAX_C = 3, 4


def _jax_planes(seed):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 256, (s * JAX_R, s * JAX_C)) // 8 + 100)
            .astype(np.uint8) for s in (16, 8, 8)]


@pytest.fixture(scope="module")
def jax_pframe_uniform():
    """The JAX deblock_pframe_from_symbols at QP 30 with a slice start:
    (planes, symbols, planes out)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MEDIA_TPU_DEBLOCK_UNROLL", "1")
        planes, sym = _jax_planes(1), meta_symbols(JAX_R, JAX_C, 1)
        out = _jax_pframe(*planes, sym.numpy(), 30, 29, JAX_R, JAX_C, (1,))
        return planes, sym, [np.asarray(p) for p in out]


@pytest.fixture(scope="module")
def jax_pframe_map():
    """The JAX deblock_pframe_from_symbols with a per-MB QP map: (planes,
    symbols, map, planes out)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MEDIA_TPU_DEBLOCK_UNROLL", "1")
        planes, sym = _jax_planes(2), meta_symbols(JAX_R, JAX_C, 2, "dense")
        qmap = meta_qps("map", JAX_R, JAX_C, 2)[2]
        out = _jax_pframe(*planes, sym.numpy(), 30, 29, JAX_R, JAX_C, (),
                          qmap.numpy())
        return planes, sym, qmap, [np.asarray(p) for p in out]


@pytest.fixture(scope="module")
def jax_iframe():
    """The JAX deblock_iframe at QP 36 with a slice start: (planes, planes
    out)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MEDIA_TPU_DEBLOCK_UNROLL", "1")
        planes = _jax_planes(3)
        out = _jax_iframe(*planes, 36, 34, JAX_R, JAX_C, (2,))
        return planes, [np.asarray(p) for p in out]


def _assert_planes(got, want):
    for a, b, name in zip(got, want, "yuv"):
        assert a.dtype == torch.uint8
        np.testing.assert_array_equal(a.numpy(), b, err_msg=name)


@pytest.mark.parametrize("qp_form", ["int", "0d"])
def test_pframe_deblock_matches_jax(jax_pframe_uniform, qp_form):
    planes, sym, want = jax_pframe_uniform
    qp, qp_c = (30, 29) if qp_form == "int" else (
        torch.tensor(30, dtype=torch.int32), torch.tensor(29))
    got = tda.deblock_pframe_from_symbols(
        *(torch.as_tensor(p) for p in planes), sym, qp, qp_c, JAX_R, JAX_C,
        (1,))
    _assert_planes(got, want)


def test_pframe_deblock_with_a_qp_map_matches_jax(jax_pframe_map):
    planes, sym, qmap, want = jax_pframe_map
    got = tda.deblock_pframe_from_symbols(
        *(torch.as_tensor(p) for p in planes), sym, 30, 29, JAX_R, JAX_C,
        qp_map=qmap)
    _assert_planes(got, want)


@pytest.mark.parametrize("kernel", ["frame", "wave"])
def test_iframe_deblock_matches_jax(jax_iframe, kernel):
    planes, want = jax_iframe
    got = tda.deblock_iframe(*(torch.as_tensor(p) for p in planes), 36, 34,
                             JAX_R, JAX_C, (2,), kernel=kernel)
    _assert_planes(got, want)


def test_kernel_arithmetic_feeds_the_jax_planes(emulate, jax_pframe_map,
                                                jax_iframe):
    """The emulated kernel's meta through the plain filter gives the JAX
    package's planes."""
    from media_tpu_torch.ops.deblock_wave import deblock_wave

    planes, sym, qmap, want = jax_pframe_map
    meta = emulate(sym, 30, 29, JAX_R, JAX_C, qp_map=qmap)
    got = [torch.as_tensor(p).clone() for p in planes]
    deblock_wave(*got, meta, JAX_R, JAX_C)
    _assert_planes(got, want)
    planes, want = jax_iframe
    meta = emulate(None, 36, 34, JAX_R, JAX_C, (2,), intra=True, device=CPU)
    got = [torch.as_tensor(p).clone() for p in planes]
    deblock_wave(*got, meta, JAX_R, JAX_C)
    _assert_planes(got, want)
