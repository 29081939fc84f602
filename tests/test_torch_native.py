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

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from media_tpu import native as jnative
from media_tpu.core import bitstream as jbs
from media_tpu.core import nal as jnal
from media_tpu_torch import native
from media_tpu_torch.core.bitstream import BitReader, BitWriter
from media_tpu_torch.entropy import cabac_slice
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
