"""The CUDA P-slice packer (media_tpu_torch/csrc/device_cavlc.cu) on the CPU.

No card here, so three things stand in for it:

- the wrapper, with a stand-in for the kernel library: CPU tensors run the
  plain version and launch nothing; other tensors go to the kernel inside
  their device's context, on its current stream;
- the kernel's arithmetic, compiled with g++ from the same header the
  kernels use (csrc/device_cavlc.cuh, driven serially by
  csrc/device_cavlc_emu.cpp, which has the kernel library's C ABI) and
  called through the wrapper: stream words and bit count equal to
  pack_pslice_plain's, overflow included;
- the placement and overflow rule as chunk_write_kernel evaluates it, tile
  by tile, written once here in Python from chunk bit counts: equal to
  bitcat_reduce's words and `ok`.

The plain version is held to the JAX package by tests/test_torch_pframe.py
and tests/test_torch_cbr.py; the kernel to the plain version on the card by
tests/test_torch_cuda.py and chip_smoke.py.
"""

import contextlib
import ctypes
import hashlib
import os
import subprocess
import types

import numpy as np
import pytest
import torch

from chip_smoke import slice_symbols as symbols
from media_tpu_torch import kernels
from media_tpu_torch.entropy import device_cavlc as tdc
from media_tpu_torch.pipeline.pframe_core import unpack_symbols_device

TILE = 512  # chunks a block of chunk_write_kernel (a level-3 node)


# ------------------------------------------------------------------ wrapper


def test_cpu_tensors_run_the_plain_version(monkeypatch):
    monkeypatch.setattr(kernels, "load", lambda: pytest.fail("launched"))
    monkeypatch.setattr(tdc.pack_pslice_device, "launches", 0)
    sym = unpack_symbols_device(symbols(2, 3, 0))
    qp_map = torch.full((2, 3), 30, dtype=torch.int32)
    for kw in ({}, {"qp_map": qp_map, "slice_qp": 28}):
        got = tdc.pack_pslice_device(*sym, 512, **kw)
        want = tdc.pack_pslice_plain(*sym, 512, **kw)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert tdc.pack_pslice_device.launches == 0


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

    def launch(*args):
        log.append((current[0], args))
        return 0

    lib = types.SimpleNamespace(device_cavlc_launch=launch,
                                device_cavlc_scratch_bytes=lambda R, C: 64)
    streams = {}
    monkeypatch.setattr(torch.cuda, "device", device)
    monkeypatch.setattr(
        torch.cuda, "current_stream",
        lambda dev=None: types.SimpleNamespace(
            cuda_stream=streams.setdefault(str(dev), 1000 + len(streams))))
    monkeypatch.setattr(kernels, "load", lambda: lib)
    monkeypatch.setattr(tdc.pack_pslice_device, "launches", 0)
    return log, streams


def test_wrapper_launches_on_its_tensors_device_and_stream(stub):
    log, streams = stub
    R, C = 2, 3
    meta = torch.device("meta")
    packed = torch.empty((R, C, 386), dtype=torch.int16, device=meta)
    sym = unpack_symbols_device(packed)
    stream, bits = tdc.pack_pslice_device(*sym, 4096)
    assert stream.shape == (4096,) and stream.dtype == torch.int64
    assert bits.shape == () and bits.dtype == torch.int64
    qp = torch.empty((R, C), dtype=torch.int32, device=meta)
    seed = torch.empty((), dtype=torch.int32, device=meta)
    tdc.pack_pslice_device(*sym, 4096, qp_map=qp, slice_qp=seed)
    tdc.pack_pslice_device(*sym, 4096, qp_map=qp, slice_qp=26)
    tdc.launch_pack_pslice(*sym, 4096)  # the raw launch is not counted
    assert [dev for dev, _ in log] == [meta] * 4
    assert tdc.pack_pslice_device.launches == 3
    # The stream is the current stream of the tensors' device; the slice QP
    # goes by value unless it lies on the device.
    for _, args in log:
        assert args[-1].value == streams[str(meta)]
        assert (args[-3].value, args[-2].value) == (R, C)
    assert log[0][1][7].value == 0 and log[2][1][7].value == 26
    # The views of one (R, C, 386) tensor pass as they are: their MB
    # strides are the packed tensor's.
    strides = ctypes.cast(log[0][1][4], ctypes.POINTER(ctypes.c_int64))
    assert [strides[i] for i in range(8)] == [C * 386, 386] * 4


def test_wrapper_refuses_a_bad_shape(stub):
    meta = torch.device("meta")
    sym = list(unpack_symbols_device(
        torch.empty((2, 3, 386), dtype=torch.int16, device=meta)))
    sym[1] = sym[1][:, :, :8]
    with pytest.raises(ValueError, match="shape"):
        tdc.pack_pslice_device(*sym, 4096)
    assert tdc.pack_pslice_device.launches == 0


# ------------------------------------------- the kernel's arithmetic, on g++


@pytest.fixture(scope="module")
def emu_lib():
    """csrc/device_cavlc_emu.cpp built with g++ into csrc/build/emu_<hash>/."""
    srcs = [os.path.join(kernels.CSRC, f) for f in
            ("device_cavlc_emu.cpp", "device_cavlc.cuh")]
    flags = ["-O1", "-shared", "-fPIC", "-std=c++17"]
    h = hashlib.sha256(" ".join(flags).encode())
    for s in srcs:
        with open(s, "rb") as f:
            h.update(f.read())
    out_dir = os.path.join(kernels.CSRC, "build", f"emu_{h.hexdigest()[:16]}")
    lib = os.path.join(out_dir, "libdevice_cavlc_emu.so")
    if not os.path.exists(lib):
        os.makedirs(out_dir, exist_ok=True)
        tmp = f"{lib}.{os.getpid()}.tmp"
        subprocess.run(["g++", *flags, "-o", tmp, srcs[0]], check=True,
                       capture_output=True, timeout=300)
        os.replace(tmp, lib)
    return kernels.bind_device_cavlc(ctypes.CDLL(lib))


@pytest.fixture
def emulate(emu_lib, monkeypatch):
    """launch_pack_pslice on CPU tensors, the host build of the kernel
    library in place of the card's."""
    monkeypatch.setattr(kernels, "load", lambda: emu_lib)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    return tdc.launch_pack_pslice


def _cases():
    # (R, C, seed, symbol options, out_words, ratio, per-MB QP)
    return [
        (1, 1, 0, {}, 2048, 0.25, False),
        (1, 5, 1, {}, 2048, 0.25, False),
        (5, 1, 2, {}, 2048, 0.25, True),
        (4, 6, 3, {}, 2048, 0.25, False),
        (4, 6, 4, {"big": True, "density": 2}, 8192, 1.0, False),  # escapes
        (4, 6, 5, {}, 8, 0.25, False),      # the stream overflows out_words
        (4, 6, 6, {"big": True, "density": 1}, 16384, 0.25, False),  # a level
        (4, 6, 7, {"skip_share": 1.0}, 2048, 0.25, True),   # all skipped
        (4, 6, 8, {"skip_share": 0.0, "density": 3}, 4096, 0.25, True),
        (17, 3, 9, {}, 16384, 0.25, True),  # a 17-row tile, 1378 chunks
    ]


@pytest.mark.parametrize("R,C,seed,opts,out_words,ratio,per_mb", _cases())
def test_kernel_arithmetic_matches_plain(emulate, R, C, seed, opts,
                                         out_words, ratio, per_mb):
    sym = unpack_symbols_device(symbols(R, C, seed, **opts))
    kw = {}
    if per_mb:
        rng = np.random.default_rng(seed + 100)
        kw = {"qp_map": torch.as_tensor(rng.integers(20, 45, (R, C)),
                                        dtype=torch.int32),
              "slice_qp": torch.tensor(31, dtype=torch.int32)}
    want_s, want_b = tdc.pack_pslice_plain(*sym, out_words, ratio=ratio, **kw)
    got_s, got_b = emulate(*sym, out_words, ratio=ratio, **kw)
    assert int(got_b) == int(want_b)
    # Every word, also where the stream overflowed: the placement
    # reproduces the reference tree's truncations.
    assert torch.equal(got_s, want_s)
    if kw:  # the slice QP as an int gives the same stream
        by_value = emulate(*sym, out_words, ratio=ratio, qp_map=kw["qp_map"],
                           slice_qp=31)
        assert torch.equal(by_value[0], want_s)
    if opts.get("skip_share") == 1.0:
        assert int(want_b) == len(f"{R * C + 1:b}") * 2 - 1  # ue(R*C) alone
    if out_words == 8 or opts.get("density") == 1:
        assert int(want_b) == out_words * 32 + 1  # the cases that overflow
    else:
        assert 0 < int(want_b) <= out_words * 32


# ----------------------------------------------- slots of the plain version


def test_worst_case_block_and_header_fit_their_slots():
    # Dense blocks at the quantiser's largest level, every sign pattern of
    # the first coefficients, every nC context; and sparse ones with long
    # runs. The 28-bit escape bounds a 16-coefficient block at 464 bits.
    rng = np.random.default_rng(0)
    lv = np.full((64, 16), 2063)
    lv[:, :6] *= np.where((np.arange(64)[:, None] >> np.arange(6)) & 1, -1, 1)
    lv = np.concatenate([lv, rng.integers(-2063, 2064, (64, 16)),
                         np.where(rng.random((64, 16)) < 0.5, 0,
                                  rng.integers(-2063, 2064, (64, 16)))])
    worst = 0
    for nc in (0, 2, 4, 8):
        _, nbits = tdc.encode_blocks(torch.as_tensor(lv),
                                     torch.full((len(lv),), nc),
                                     max_coeff=16, chroma_dc=False)
        worst = max(worst, int(nbits.max()))
    assert worst == 464 <= tdc.BLOCK_WORDS * 32
    # The longest header: a skip run across a 4K picture, MV differences
    # of twice the search range's reach, the largest cbp code and dQP.
    n = 3
    meta = {"is_skip": torch.zeros(n, dtype=torch.bool),
            "skip_run": torch.tensor([135 * 240 - 1, 0, 5]),
            "qmv": torch.tensor([[-72, 72], [72, -72], [0, 0]]),
            "pred_mv": torch.zeros((n, 2), dtype=torch.int64),
            "cbp": torch.tensor([47, 15, 1])}
    _, hb = tdc._encode_headers(meta, 1, n, qp_map=torch.tensor([[25, 51, 25]]),
                                slice_qp=51)
    assert int(hb.max()) <= tdc.HDR_WORDS * 32


# ------------------------------- the tree's placement, as the kernel takes it


def kernel_placement(bits, slot_bits, out_words, ratio):
    """(shift, keep, total_bits) of every chunk as chunk_write_kernel
    computes them: the exclusive scan inside a tile of 512 chunks for levels
    1-3, prefixes of the tile sums for the levels above; each group checked
    against its level's capacity by the tile that holds it or starts it."""
    n = len(bits)
    caps, wraps = tdc.bitcat_schedule(n, out_words, ratio)
    levels = len(caps)
    n_tiles = -(-n // TILE)
    padded = np.zeros(n_tiles * TILE, np.int64)
    padded[:n] = bits
    tiles = padded.reshape(n_tiles, TILE)
    tile_sum = tiles.sum(axis=1)
    tile_pre = np.concatenate([[0], np.cumsum(tile_sum)])
    slot = np.zeros(n_tiles * TILE, np.int64)
    slot[:n] = slot_bits
    shift = np.zeros(n, np.int64)
    keep = np.zeros(n, np.int64)
    fail = False
    lane = np.arange(TILE)
    for t in range(n_tiles):
        eloc = np.concatenate([[0], np.cumsum(tiles[t])])
        first = {L: (t >> 3 * (L - 3)) << 3 * (L - 3)
                 for L in range(4, levels + 1)}
        end = {L: min(first[L] + (1 << 3 * (L - 3)), n_tiles) for L in first}
        at = np.zeros(TILE, np.int64)
        k = np.minimum(slot[t * TILE:(t + 1) * TILE], tiles[t])
        for L in range(1, levels + 1):
            if L <= 3:
                a0 = (lane >> 3 * (L - 1)) << 3 * (L - 1)
                g0 = (lane >> 3 * L) << 3 * L
                p = eloc[a0] - eloc[g0]
            else:
                a0 = t if L == 4 else first[L - 1]
                p = np.full(TILE, tile_pre[a0] - tile_pre[first[L]])
            at = at + (p & 31) + 32 * ((p >> 5) & wraps[L - 1])
            k = np.minimum(k, 32 * caps[L - 1] - at)
        k = np.minimum(k, 32 * out_words - at)
        m = min(TILE, n - t * TILE)
        shift[t * TILE:t * TILE + m] = at[:m]
        keep[t * TILE:t * TILE + m] = k[:m]
        for L in range(1, min(3, levels) + 1):
            g = 8 ** L
            for l0 in range(0, TILE, g):
                if eloc[min(l0 + g, TILE)] - eloc[l0] > 32 * caps[L - 1]:
                    fail = True
        for L in first:
            if first[L] == t and (tile_pre[end[L]] - tile_pre[t]
                                  > 32 * caps[L - 1]):
                fail = True
    total = out_words * 32 + 1 if fail else int(padded.sum())
    return shift, keep, total


def _placed(contents, shift, keep, out_words):
    """The stream of 32-bit words that ORs bit i < keep of each chunk in at
    shift + i."""
    out = np.zeros(32 * out_words, np.uint8)
    for c in np.flatnonzero(keep > 0):
        k = int(keep[c])
        out[shift[c]:shift[c] + k] |= contents[c, :k]
    words = np.packbits(out).view(">u4").astype(np.int64)
    return torch.as_tensor(words)


# (chunks, bit counts (low, high), out_words, ratio): one MB; counts not a
# multiple of 8; tiles of level 4 and 5 groups; loose and tight schedules
# (a level's groups overflow while the slice fits; a stream beyond
# out_words; slot-sized chunks whose prefixes wrap the word shift).
@pytest.mark.parametrize("n,lo,hi,out_words,ratio", [
    (28, 0, 120, 16384, 0.25),
    (28, 0, 600, 16384, 0.25),
    (29, 0, 40, 8, 0.25),
    (517, 0, 100, 16384, 0.25),
    (517, 0, 600, 16384, 1.0),
    (4103, 0, 60, 1 << 14, 0.25),
    (4103, 100, 600, 1 << 14, 0.25),
    (4103, 0, 200, 2000, 0.25),
    (36001, 0, 20, 1 << 16, 0.25),
    (36001, 0, 200, 1 << 17, 0.25),
])
def test_kernel_placement_matches_bitcat_reduce(n, lo, hi, out_words, ratio):
    rng = np.random.default_rng(n + hi + out_words)
    bits = rng.integers(lo, hi + 1, n) * (rng.random(n) < 0.6)
    slot = np.where(np.arange(n) % 27 == 0, 128, 512)
    held = np.minimum(bits, slot)
    contents = (rng.integers(0, 2, (n, 512), dtype=np.uint8)
                * (np.arange(512)[None, :] < held[:, None]))
    words = torch.as_tensor(
        np.packbits(contents, axis=1).view(">u4").astype(np.int64))
    stream, total, ok = tdc.bitcat_reduce(words, torch.as_tensor(bits),
                                          out_words, ratio=ratio)
    want_total = int(total) if bool(ok) else out_words * 32 + 1
    width = stream.shape[-1]
    want = torch.zeros(out_words, dtype=torch.int64)
    want[:min(width, out_words)] = stream[:out_words]
    shift, keep, got_total = kernel_placement(bits, slot, out_words, ratio)
    assert got_total == want_total
    assert torch.equal(_placed(contents, shift, keep, out_words), want)
    if want_total > out_words * 32:
        return
    # Without overflow a chunk lands at its exclusive prefix, whole up to
    # its slot.
    before = np.concatenate([[0], np.cumsum(bits)[:-1]])
    live = bits > 0
    assert np.array_equal(shift[live], before[live])
    assert np.array_equal(keep[live], held[live])
