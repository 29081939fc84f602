"""media_tpu_torch.native: the port's build of the C++ slice writers, parsers
and the CAVLC->CABAC transcoder, from its own sources and its own generated
tables.

Seeded symbol arrays go through each wrapper of the port, through the same
wrapper of media_tpu.native and through the port's Python coder; bytes and
integer arrays must be equal (tolerance: none). The generated table file
equals the one csrc/gen_tables.py writes, a failed build raises with the
compiler's output, a refusal of a C++ routine is counted, and the session
and the decoder give the same bytes and planes through the Python coders
(host_coder / host_parser = "python") as through the C++ ones.
"""

import ctypes
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest

from media_tpu import native as jnative
from media_tpu.core import bitstream as jbs
from media_tpu.core import nal as jnal
from media_tpu_torch import native
from media_tpu_torch.core.bitstream import BitReader, BitWriter
from media_tpu_torch.entropy import cabac_slice
from media_tpu_torch.entropy.cabac_contexts import ContextModels
from media_tpu_torch.entropy.cabac_engine import CabacEncoder
from media_tpu_torch.entropy.cabac_init_tables import INIT_MN_P
from media_tpu_torch.native import gen_tables
from media_tpu_torch.pipeline import slice_coder
from media_tpu_torch.pipeline.codec import EncoderConfig, EncoderSession
from media_tpu_torch.pipeline.decoder_tpu import (
    TpuDecoder, parse_pslice_symbols)

ROOT = Path(__file__).resolve().parent.parent
R, C = 4, 5
P_KEYS = ("mv", "luma_levels", "cdc_levels", "cac_levels")
I_KEYS = ("mode16", "chroma_mode", "dc_levels", "ac_levels", "cdc_levels",
          "cac_levels")

def _sparse(rng, shape, density, mag=40):
    a = rng.integers(-mag, mag, size=shape).astype(np.int32)
    return (a * (rng.random(shape) < density)).astype(np.int32)


def p_symbols(seed, density):
    """P-slice symbols with a block of skip candidates, and a per-MB QP map
    whose deltas wrap mod 52 (QPs 2 and 50 side by side)."""
    rng = np.random.default_rng(100 + seed)
    sym = {"mv": rng.integers(-8, 9, (R, C, 2)).astype(np.int32),
           "luma_levels": _sparse(rng, (R, C, 16, 16), density),
           "cdc_levels": _sparse(rng, (R, C, 2, 4), density),
           "cac_levels": _sparse(rng, (R, C, 2, 4, 15), density)}
    for a in sym.values():
        a[R // 2 :, : C // 2] = 0
    qp_map = rng.choice([2, 26, 30, 31, 50], (R, C)).astype(np.int32)
    return sym, qp_map


def i_symbols(seed, density):
    rng = np.random.default_rng(seed)
    return {"mode16": rng.integers(0, 4, (R, C)).astype(np.int32),
            "chroma_mode": rng.integers(0, 4, (R, C)).astype(np.int32),
            "dc_levels": _sparse(rng, (R, C, 16), density, 60),
            "ac_levels": _sparse(rng, (R, C, 16, 15), density, 60),
            "cdc_levels": _sparse(rng, (R, C, 2, 4), density, 60),
            "cac_levels": _sparse(rng, (R, C, 2, 4, 15), density, 60)}


def _same_arrays(a: dict, b: dict, keys):
    for k in keys:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), k)


CASES = [(s, d) for s in range(2) for d in (0.0, 0.1, 0.5)]


def test_generated_tables_equal_the_jax_packages(tmp_path):
    """All but the first line, which names the generating script."""
    out = tmp_path / "cavlc_tables.inc"
    subprocess.run([sys.executable, str(ROOT / "csrc" / "gen_tables.py"),
                    str(out)], check=True, capture_output=True, timeout=300,
                   env={**os.environ, "JAX_PLATFORMS": "cpu",
                        "PYTHONPATH": ""})
    want = out.read_text().splitlines()
    got = gen_tables.render().splitlines()
    assert got[0].startswith("// GENERATED by media_tpu_torch/native/")
    assert got[1:] == want[1:] and len(got) == 17


def test_library_builds_once_under_the_ports_tree():
    lib, _secs = native.build()
    assert Path(lib).is_relative_to(ROOT / "media_tpu_torch" / "csrc"
                                    / "build")
    assert native.build() == (lib, 0.0)
    handle = native.load()
    assert all(hasattr(handle, s) for s in native.SYMBOLS)


@pytest.mark.parametrize("compiler,what", [
    ("no-such-c++-compiler", "cannot run the C\\+\\+ compiler"),
    ("false", "build failed \\(1\\)"),
])
def test_failed_build_raises_with_the_command(compiler, what):
    with pytest.raises(RuntimeError, match=what) as err:
        native.build(compiler=compiler)
    assert "cavlc_pack.cpp" in str(err.value)


def test_compile_error_raises_with_the_compilers_output(tmp_path, monkeypatch):
    """A source that does not compile: the message carries g++'s own."""
    for name in native.SOURCES:
        (tmp_path / name).write_text("int broken( {\n")
    monkeypatch.setattr(native, "CSRC", str(tmp_path))
    with pytest.raises(RuntimeError, match="error") as err:
        native.build()
    assert "broken" in str(err.value) or "expected" in str(err.value)


@pytest.mark.parametrize("seed,density", CASES)
def test_cavlc_pslice_writer(seed, density):
    sym, _ = p_symbols(seed, density)
    outs = []
    for mod, bw_cls in ((native, BitWriter), (jnative, jbs.BitWriter)):
        bw = bw_cls()
        bw.u(3, 0x5)  # a slice header that ends off a byte boundary
        mod.write_pslice_native(bw, *(sym[k] for k in P_KEYS))
        outs.append(bw.get_bytes())
    bw = BitWriter()
    bw.u(3, 0x5)
    slice_coder.write_pslice_mbs(bw, **sym)
    bw.rbsp_trailing_bits()
    assert outs[0] == outs[1] == bw.get_bytes()


@pytest.mark.parametrize("seed,density", CASES)
def test_cavlc_islice_writer(seed, density):
    sym = i_symbols(seed, density)
    outs = []
    for mod, bw_cls in ((native, BitWriter), (jnative, jbs.BitWriter)):
        bw = bw_cls()
        bw.u(7, 0x55)
        mod.write_islice_native(bw, *(sym[k] for k in I_KEYS))
        outs.append(bw.get_bytes())
    bw = BitWriter()
    bw.u(7, 0x55)
    slice_coder.write_islice_mbs(bw, **sym)
    bw.rbsp_trailing_bits()
    assert outs[0] == outs[1] == bw.get_bytes()


@pytest.mark.parametrize("with_map", [False, True], ids=["qp", "qp_map"])
@pytest.mark.parametrize("seed,density", CASES)
def test_cabac_pslice_writer_and_parser(seed, density, with_map):
    sym, qp_map = p_symbols(seed, density)
    qm = qp_map if with_map else None
    args = (*(sym[k] for k in P_KEYS), 30)
    got = native.cabac_write_pslice_native(*args, cabac_init_idc=seed,
                                           qp_map=qm)
    assert got == jnative.cabac_write_pslice_native(
        *args, cabac_init_idc=seed, qp_map=qm)
    assert got == cabac_slice.write_pslice_cabac(
        *args, cabac_init_idc=seed, qp_map=qm)
    back = native.cabac_parse_pslice_native(got, 0, R, C, 30, seed)
    _same_arrays(back, jnative.cabac_parse_pslice_native(got, 0, R, C, 30,
                                                         seed),
                 P_KEYS + ("qp_map", "covered"))
    oracle = cabac_slice.parse_pslice_cabac(got, 0, R, C, 30, seed)
    _same_arrays(back, oracle, P_KEYS)
    _same_arrays(back, sym, P_KEYS)
    assert back["covered"] == oracle["covered"] == R * C
    if with_map:
        coded = np.array([[any(sym[k][r, c].any() for k in P_KEYS[1:])
                           for c in range(C)] for r in range(R)])
        np.testing.assert_array_equal(back["qp_map"][coded], qp_map[coded])
        np.testing.assert_array_equal(back["qp_map"], oracle["qp_map"])


@pytest.mark.parametrize("seed,density", CASES)
def test_cabac_islice_writer_and_parser(seed, density):
    sym = i_symbols(seed, density)
    args = (*(sym[k] for k in I_KEYS), 28)
    got = native.cabac_write_islice_native(*args)
    assert got == jnative.cabac_write_islice_native(*args)
    assert got == cabac_slice.write_islice_cabac(*args)
    back = native.cabac_parse_islice_native(got, 0, R, C, 28)
    keys = I_KEYS + ("is_i4", "modes4", "luma4_levels", "covered")
    _same_arrays(back, jnative.cabac_parse_islice_native(got, 0, R, C, 28),
                 keys)
    _same_arrays(back, cabac_slice.parse_islice_cabac(got, 0, R, C, 28),
                 I_KEYS + ("covered",))
    _same_arrays(back, sym, I_KEYS)
    assert not back["is_i4"].any()


@pytest.mark.parametrize("with_map", [False, True], ids=["qp", "qp_map"])
@pytest.mark.parametrize("seed,density", CASES)
def test_cavlc_pslice_parser_and_transcoder(seed, density, with_map):
    sym, qp_map = p_symbols(seed, density)
    bw = BitWriter()
    bw.u(5, 0x11)  # the parse starts at bit 5
    slice_coder.write_pslice_mbs(
        bw, **sym, **(dict(qp_map=qp_map, slice_qp=30) if with_map else {}))
    nbits = bw.bit_position
    bw.rbsp_trailing_bits()
    data = bw.get_bytes()
    back = native.parse_pslice_native(data, len(data) * 8, 5, R, C, 30)
    _same_arrays(back, jnative.parse_pslice_native(data, len(data) * 8, 5, R,
                                                   C, 30),
                 P_KEYS + ("qp_map", "covered"))
    br = BitReader(data)
    br.u(5)
    oracle = parse_pslice_symbols(br, R, C, slice_qp=30)
    _same_arrays(back, oracle, P_KEYS + ("covered",))
    _same_arrays(back, sym, P_KEYS)
    # On a skipped MB the C++ parser carries the running QP (spec 7.4.5) and
    # the Python one, as in the JAX package, leaves the slice QP; everywhere
    # else the two maps are equal.
    differs = back["qp_map"] != oracle["qp_map"]
    coded = np.array([[any(sym[k][r, c].any() for k in P_KEYS[1:])
                       for c in range(C)] for r in range(R)])
    assert not (differs & coded).any()
    assert (oracle["qp_map"][differs] == 30).all()
    assert with_map or not differs.any()
    # The transcoder: that parse re-emitted as CABAC.
    cabac = native.transcode_pslice_native(data, nbits, 5, R, C, 30,
                                           cabac_init_idc=1)
    assert cabac == jnative.transcode_pslice_native(data, nbits, 5, R, C, 30,
                                                    cabac_init_idc=1)
    assert cabac == cabac_slice.write_pslice_cabac(
        *(oracle[k] for k in P_KEYS), 30, cabac_init_idc=1,
        qp_map=oracle["qp_map"])


def _engine_bins(ctx_idx, bins, kinds, qp, idc, cap=None):
    """The C++ engine alone (mtpu_cabac_engine_bins): the bins, then the
    end-of-slice terminate bin. Bytes, or the routine's negative code."""
    arrs = [np.ascontiguousarray(a, np.int32) for a in (ctx_idx, bins, kinds)]
    init = np.ascontiguousarray(INIT_MN_P[idc], np.int32)
    cap = len(arrs[1]) + 16 if cap is None else cap  # under a byte a bin
    out = np.zeros(max(cap, 1), np.uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    n = native.load().mtpu_cabac_engine_bins(
        *(a.ctypes.data_as(i32p) for a in arrs), len(arrs[1]), qp,
        init.ctypes.data_as(i32p),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), cap)
    return out[:n].tobytes() if n >= 0 else n


def _engine_bins_python(ctx_idx, bins, kinds, qp, idc):
    ctx = ContextModels(qp, idc, "P")
    enc = CabacEncoder()
    for c, b, k in zip(ctx_idx, bins, kinds):
        if k == 0:
            enc.encode_bin(ctx, int(c), int(b))
        elif k == 1:
            enc.encode_bypass(int(b))
        else:
            enc.encode_terminate(0)
    enc.encode_terminate(1)
    return enc.get_bytes()


def _held_carry_stream(rng, runs=30, length=40):
    """Bypass bins chosen against the spec encoder's state so that its
    interval keeps straddling the output boundary, each bin one more
    outstanding bit (in the byte engine, 0xFF bytes held back), and then,
    after `length` of them, the bin that carries through them all; a few
    regular bins between the runs."""
    enc, models = CabacEncoder(), ContextModels(30, 1, "P")
    bins, kinds, carried = [], [], 0

    def code(kind, b):
        bins.append(b)
        kinds.append(kind)
        enc.encode_bypass(b) if kind else enc.encode_bin(models, 105, b)

    for _ in range(runs):
        for _ in range(int(rng.integers(1, 20))):
            code(0, int(rng.random() < 0.3))
        for _ in range(4 * length):
            low, r = 2 * enc.low, enc.range
            if enc.bits_outstanding >= length and low + r >= 1024:
                code(1, 1)
                carried += 1
                break
            keep = [b for b in (0, 1) if 512 <= low + b * r < 1024]
            code(1, min(keep, key=lambda b: abs(low + b * r - 768))
                 if keep else int(rng.integers(2)))
    assert carried >= 5
    return (np.full(len(bins), 105), np.array(bins, np.int32),
            np.array(kinds, np.int32))


def _bin_stream(case, rng):
    """(ctx_idx, bins, kinds) of one engine case at QP 30 and
    cabac_init_idc 1; kinds 0 regular, 1 bypass, 2 terminate of value 0."""
    n = 4000
    ctx = rng.integers(0, 8, n) + 105  # significant_coeff_flag contexts
    kinds = np.zeros(n, np.int32)
    if case in ("p01", "p99"):
        bins = rng.random(n) < (0.01 if case == "p01" else 0.99)
    elif case == "all_mps":
        bins = ContextModels(30, 1, "P").mps[ctx]
    elif case == "bypass_ones":
        kinds[8:] = 1
        bins = np.ones(n, bool)
        bins[:8] = rng.random(8) < 0.5
    elif case == "held_carry":
        return _held_carry_stream(rng)
    else:  # mixed: every kind, terminate bins of value 0 among them
        kinds = rng.choice([0, 1, 2], n, p=[0.6, 0.3, 0.1]).astype(np.int32)
        bins = (rng.random(n) < 0.5) & (kinds != 2)
    return ctx, bins.astype(np.int32), kinds


@pytest.mark.parametrize("case", ["p01", "p99", "all_mps", "bypass_ones",
                                  "held_carry", "mixed", "short"])
def test_cabac_engine_equals_the_python_encoder(case):
    """The byte-wise engine against the spec's bit-at-a-time one
    (entropy/cabac_engine.py) on extreme probabilities, MPS runs, a run of
    4000 bypass 1s (0xFF bytes held to the end), runs of held 0xFF bytes
    that a carry turns to 0x00, every kind of bin mixed, and streams of 0 to
    20 bins that end before or just after the first byte."""
    rng = np.random.default_rng(sum(map(ord, case)))
    if case == "short":
        streams = []
        for n in range(21):
            for i in range(12):
                kinds = rng.choice([0, 1, 2], n, p=[0.6, 0.3, 0.1])
                bins = (rng.random(n) < 0.5) & (kinds != 2)
                streams.append((rng.integers(0, 460, n), bins, kinds,
                                4 * i + n % 4, i % 3))
    else:
        streams = [(*_bin_stream(case, rng), 30, 1)]
    for i, (ctx, bins, kinds, qp, idc) in enumerate(streams):
        want = _engine_bins_python(ctx, bins, kinds, qp, idc)
        assert _engine_bins(ctx, bins, kinds, qp, idc) == want, (case, i)


def test_cabac_engine_refuses_a_small_buffer_and_bad_bins():
    """-1 where the payload and the slack byte before it do not fit; -2
    for a kind it does not know, a context outside the table, or a
    terminate bin of value 1 before the end."""
    ctx, bins, kinds = _bin_stream("mixed", np.random.default_rng(5))
    want = _engine_bins_python(ctx, bins, kinds, 30, 0)
    assert _engine_bins(ctx, bins, kinds, 30, 0, cap=len(want) + 1) == want
    for cap in (len(want), len(want) // 2, 1, 0):
        assert _engine_bins(ctx, bins, kinds, 30, 0, cap=cap) == -1

    def with_bin7(kind, c, b):
        k2, c2, b2 = kinds.copy(), ctx.copy(), bins.copy()
        k2[7], c2[7], b2[7] = kind, c, b
        return _engine_bins(c2, b2, k2, 30, 0)

    assert with_bin7(3, 105, 0) == -2  # no such kind
    assert with_bin7(0, 460, 0) == -2  # no such context
    assert with_bin7(2, 105, 1) == -2  # the slice ends before the end


@pytest.mark.parametrize("with_map", [False, True], ids=["qp", "qp_map"])
@pytest.mark.parametrize("density", [0.02, 0.1])
def test_cabac_writers_at_1080p_equal_the_jax_packages(density, with_map):
    """The benchmark's picture size (68 x 120 MBs): the P writer, the
    transcode and the I writer with I_4x4 MBs byte for byte the JAX
    package's C++ library (the bit-at-a-time engine), and the P slice
    parsed back to its symbols."""
    R8, C8, qp, idc = 68, 120, 32, int(with_map)
    rng = np.random.default_rng(int(density * 100) + 10 * with_map)
    sym = {"mv": rng.integers(-24, 25, (R8, C8, 2)).astype(np.int32),
           "luma_levels": _sparse(rng, (R8, C8, 16, 16), density, 12),
           "cdc_levels": _sparse(rng, (R8, C8, 2, 4), density, 12),
           "cac_levels": _sparse(rng, (R8, C8, 2, 4, 15), density, 12)}
    still = rng.random((R8, C8)) < 0.3  # skip candidates
    for a in sym.values():
        a[still] = 0
    qp_map = (rng.choice([24, 28, 32, 36, 40], (R8, C8)).astype(np.int32)
              if with_map else None)
    args = (*(sym[k] for k in P_KEYS), qp)
    got = native.cabac_write_pslice_native(*args, cabac_init_idc=idc,
                                           qp_map=qp_map)
    assert got == jnative.cabac_write_pslice_native(
        *args, cabac_init_idc=idc, qp_map=qp_map)
    back = native.cabac_parse_pslice_native(got, 0, R8, C8, qp, idc)
    _same_arrays(back, sym, P_KEYS)
    assert back["covered"] == R8 * C8
    coded = np.any([sym[k].reshape(R8, C8, -1).any(-1) for k in P_KEYS[1:]],
                   axis=0)
    if with_map:
        np.testing.assert_array_equal(back["qp_map"][coded], qp_map[coded])

    bw = BitWriter()
    if with_map:
        slice_coder.write_pslice_mbs(bw, **sym, qp_map=qp_map, slice_qp=qp)
        bw.rbsp_trailing_bits()
    else:
        native.write_pslice_native(bw, *args[:4])
    data = bw.get_bytes()
    cabac = native.transcode_pslice_native(data, len(data) * 8, 0, R8, C8,
                                           qp, cabac_init_idc=idc)
    assert cabac == jnative.transcode_pslice_native(
        data, len(data) * 8, 0, R8, C8, qp, cabac_init_idc=idc)
    assert with_map or cabac == got

    isym = i_symbols(int(density * 100), density)
    isym = {k: np.resize(v, (R8, C8, *v.shape[2:])) for k, v in isym.items()}
    is_i4 = rng.random((R8, C8)) < 0.6
    modes4 = rng.integers(0, 9, (R8, C8, 16)).astype(np.int32)
    luma4 = _sparse(rng, (R8, C8, 16, 16), density, 20)
    iargs = (*(isym[k] for k in I_KEYS), 28)
    i4 = dict(is_i4=is_i4, modes4=modes4, luma4_levels=luma4)
    igot = native.cabac_write_islice_native(*iargs, **i4)
    assert igot == jnative.cabac_write_islice_native(*iargs, **i4)
    iback = native.cabac_parse_islice_native(igot, 0, R8, C8, 28)
    np.testing.assert_array_equal(iback["is_i4"], is_i4)
    np.testing.assert_array_equal(iback["luma4_levels"][is_i4], luma4[is_i4])


@pytest.mark.parametrize("seed", range(3))
def test_escape_rbsp(seed):
    rng = np.random.default_rng(seed)
    rbsp = bytes(rng.choice([0, 0, 0, 1, 2, 3, 4, 200], 5000).astype(np.uint8))
    got = native.escape_rbsp_native(rbsp)
    assert got == jnative.escape_rbsp_native(rbsp) == jnal.escape_rbsp(rbsp)
    assert native.escape_rbsp_native(b"") == b""


def test_refusal_is_counted_and_returns_none():
    """A P macroblock type outside the C++ parser's envelope: None, one
    count under the wrapper's name, and the Python parser says what it is."""
    bw = BitWriter()
    bw.ue(0)  # mb_skip_run
    bw.ue(3)  # mb_type P_8x8
    bw.rbsp_trailing_bits()
    data = bw.get_bytes()
    before = native.fallbacks["parse_pslice_native"]
    assert native.parse_pslice_native(data, len(data) * 8, 0, 2, 2, 30) is None
    assert native.fallbacks["parse_pslice_native"] == before + 1
    with pytest.raises(slice_coder.UnsupportedStream, match="mb_type 3"):
        parse_pslice_symbols(BitReader(data), 2, 2, slice_qp=30)


def test_refusals_from_many_threads_are_each_counted():
    """The wrappers run on a pool's threads (a chunk's P transcodes): 16
    threads, more than this host's cores, each refused 40 times with a short
    switch interval, count 640 refusals, none lost."""
    bw = BitWriter()
    bw.ue(0)  # mb_skip_run
    bw.ue(3)  # mb_type P_8x8, outside the C++ parser's envelope
    bw.rbsp_trailing_bits()
    data = bw.get_bytes()
    before = native.fallbacks["parse_pslice_native"]

    def refuse():
        for _ in range(40):
            assert native.parse_pslice_native(data, len(data) * 8, 0, 2, 2,
                                              30) is None

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=refuse) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert native.fallbacks["parse_pslice_native"] == before + 16 * 40


def _clip(w, h, n, seed=0):
    rng = np.random.default_rng(seed)
    big = rng.integers(0, 256, (h + 32, w + 32)).astype(np.float64)
    for _ in range(2):
        big = (big + np.roll(big, 1, 0) + np.roll(big, 1, 1)) / 3
    out = []
    for t in range(n):
        y = (big[t : t + h, 2 * t : 2 * t + w]
             + rng.normal(0, 1.5, (h, w))).round().clip(0, 255).astype(np.uint8)
        out.append(y.tobytes() + (y[::2, ::2] // 2 + 40).astype(
            np.uint8).tobytes() + (y[::2, ::2] // 3 + 70).astype(
                np.uint8).tobytes())
    return out


@pytest.mark.parametrize("fields", [
    dict(entropy_mode="host"), dict(cabac=True, cabac_init_idc=2),
    dict(rc_mode="cbr", bitrate=120_000, cabac=True),
], ids=["cavlc_cq_host", "cabac_cq", "cabac_cbr"])
def test_python_coders_equal_the_native_ones_end_to_end(fields):
    """The session's host_coder and the decoder's host_parser: same AUs and
    same planes through the Python coders as through the C++ ones, with no
    refusal counted on the way."""
    frames = _clip(48, 32, 4)
    before = sum(native.fallbacks.values())
    aus = []
    for coder in ("native", "python"):
        s = EncoderSession(EncoderConfig(width=48, height=32, qp=30, **fields),
                           device="cpu", host_coder=coder)
        s.PIPELINE_CHUNK = 2
        aus.append([s.encode_frame(frames[0])] + s.encode_frames(frames[1:]))
    assert aus[0] == aus[1]
    planes = []
    for parser in ("native", "python"):
        d = TpuDecoder(device="cpu", host_parser=parser)
        planes.append([f for au in aus[0] for f in d.decode_annexb(au)])
    assert len(planes[0]) == 4
    for a, b in zip(*planes):
        for p in "yuv":
            np.testing.assert_array_equal(getattr(a, p), getattr(b, p))
    np.testing.assert_array_equal(planes[0][-1].y, s.recon[0].numpy())
    assert sum(native.fallbacks.values()) == before
    with pytest.raises(ValueError, match="host_coder"):
        EncoderSession(EncoderConfig(width=48, height=32), device="cpu",
                       host_coder="c++")
    with pytest.raises(ValueError, match="host_parser"):
        TpuDecoder(device="cpu", host_parser="c++")
