"""media_tpu_torch imports torch and nothing of JAX or of media_tpu, and its
copies of media_tpu's host modules (core.bitstream / nal / syntax,
utils.yuv, entropy.cavlc / cavlc_tables, pipeline.mv_pred) behave exactly as
the originals: same tables, same bytes, same values on seeded inputs.
"""

import dataclasses
import re
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest

from media_tpu.core import bitstream as jbs
from media_tpu.core import nal as jnal
from media_tpu.core import syntax as jsyn
from media_tpu.entropy import cavlc as jcavlc
from media_tpu.entropy import cavlc_tables as jtab
from media_tpu.pipeline import mv_pred as jmv
from media_tpu.utils import yuv as jyuv
from media_tpu_torch.core import bitstream as tbs
from media_tpu_torch.core import nal as tnal
from media_tpu_torch.core import syntax as tsyn
from media_tpu_torch.entropy import cavlc as tcavlc
from media_tpu_torch.entropy import cavlc_tables as ttab
from media_tpu_torch.pipeline import mv_pred as tmv
from media_tpu_torch.utils import yuv as tyuv

ROOT = Path(__file__).resolve().parent.parent

_WALK = """
import importlib, pkgutil, sys
import media_tpu_torch
names = ["media_tpu_torch"] + [m.name for m in pkgutil.walk_packages(
    media_tpu_torch.__path__, "media_tpu_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "media_tpu"))
print(len(names), "modules;", "foreign:", bad)
sys.exit(1 if bad or len(names) < 20 else 0)
"""


def test_port_imports_neither_jax_nor_media_tpu():
    """Every module of the package, imported in a fresh interpreter."""
    proc = subprocess.run([sys.executable, "-c", _WALK], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_chip_smoke_source_names_no_jax_import():
    src = (ROOT / "chip_smoke.py").read_text()
    for line in src.splitlines():
        words = line.split()
        if words[:1] in (["import"], ["from"]):
            assert words[1].split(".")[0] not in ("jax", "media_tpu"), line


def _public(mod):
    return {k: v for k, v in vars(mod).items()
            if not k.startswith("__") and not isinstance(
                v, (types.ModuleType, types.FunctionType, type, re.Pattern))}


def _same(a, b):
    if isinstance(a, np.ndarray):
        return (isinstance(b, np.ndarray) and a.dtype == b.dtype
                and np.array_equal(a, b))
    return a == b


@pytest.mark.parametrize("orig,copy", [(jtab, ttab), (jsyn, tsyn),
                                       (jnal, tnal)],
                         ids=["cavlc_tables", "syntax", "nal"])
def test_copied_constants_equal(orig, copy):
    a, b = _public(orig), _public(copy)
    a.pop("annotations", None), b.pop("annotations", None)
    shared = set(a) & set(b)
    assert set(a) - shared == set(), "constants missing from the copy"
    assert shared
    for k in sorted(shared):
        assert _same(a[k], b[k]), k
    ttab.validate_tables()


def _write_random(bw, rng, n=300):
    for _ in range(n):
        kind = rng.integers(0, 5)
        if kind == 0:
            nb = int(rng.integers(1, 33))
            bw.u(nb, int(rng.integers(0, 1 << nb)))
        elif kind == 1:
            bw.ue(int(rng.integers(0, 70000)))
        elif kind == 2:
            bw.se(int(rng.integers(-40000, 40000)))
        elif kind == 3:
            bw.flag(bool(rng.integers(0, 2)))
        else:
            mx = int(rng.integers(1, 5))
            bw.te(int(rng.integers(0, mx + 1)), mx)
    bw.rbsp_trailing_bits()
    return bw.get_bytes()


def _read_random(br, rng, n=300):
    out = []
    for _ in range(n):
        kind = rng.integers(0, 5)
        if kind == 0:
            nb = int(rng.integers(1, 33))
            rng.integers(0, 1 << nb)
            out.append(br.u(nb))
        elif kind == 1:
            rng.integers(0, 70000)
            out.append(br.ue())
        elif kind == 2:
            rng.integers(-40000, 40000)
            out.append(br.se())
        elif kind == 3:
            rng.integers(0, 2)
            out.append(br.flag())
        else:
            mx = int(rng.integers(1, 5))
            rng.integers(0, mx + 1)
            out.append(br.te(mx))
    out.append((br.bit_position, br.more_rbsp_data(), br.bits_remaining()))
    return out


@pytest.mark.parametrize("seed", range(3))
def test_bitwriter_bitreader_copies(seed):
    data = [_write_random(m.BitWriter(), np.random.default_rng(seed))
            for m in (jbs, tbs)]
    assert data[0] == data[1] and len(data[0]) > 100
    vals = [_read_random(m.BitReader(data[0]), np.random.default_rng(seed))
            for m in (jbs, tbs)]
    assert vals[0] == vals[1]
    with pytest.raises(EOFError):
        tbs.BitReader(b"\x80").u(16)


@pytest.mark.parametrize("seed", range(3))
def test_nal_copies(seed):
    rng = np.random.default_rng(seed)
    stream_j, stream_t = b"", b""
    for i in range(12):
        n = int(rng.integers(1, 6000 if i % 4 == 0 else 80))
        rbsp = bytes(rng.choice([0, 0, 0, 1, 2, 3, 4, 200], n).astype(np.uint8))
        assert jnal.escape_rbsp(rbsp) == tnal.escape_rbsp(rbsp)
        assert jnal.unescape_rbsp(rbsp) == tnal.unescape_rbsp(rbsp)
        assert tnal.unescape_rbsp(tnal.escape_rbsp(rbsp)) == rbsp
        kw = dict(nal_ref_idc=int(rng.integers(0, 4)),
                  long_start_code=bool(rng.integers(0, 2)))
        nal_type = int(rng.integers(1, 13))
        # The original may escape large payloads with its C++ helper: the
        # bytes must be the same either way.
        stream_j += jnal.wrap_nal(nal_type, rbsp + b"\x80", **kw)
        stream_t += tnal.wrap_nal(nal_type, rbsp + b"\x80", **kw)
    assert stream_j == stream_t
    units = [[dataclasses.astuple(u) for u in m.iter_nal_units(stream_t)]
             for m in (jnal, tnal)]
    assert units[0] == units[1] and len(units[0]) == 12
    assert (jnal.split_parameter_sets(stream_t)
            == tnal.split_parameter_sets(stream_t))
    assert list(tnal.iter_nal_units(b"\x12\x34garbage")) == []


def _headers(syn, bs):
    """SPS, PPS and a set of slice headers written and parsed back."""
    out = []
    for (w, h), kw in (((64, 48), {}), ((1920, 1080), {"level_idc": 40}),
                       ((40, 24), {"pic_order_cnt_type": 0})):
        sps = syn.SPS.for_size(w, h, **kw)
        sps.vui_timing = (1, 60)
        for cabac in (0, 1):
            pps = syn.PPS(pic_init_qp=30, entropy_coding_mode=cabac)
            bw = bs.BitWriter()
            sps.write(bw)
            bw.rbsp_trailing_bits()
            sps_b = bw.get_bytes()
            bw = bs.BitWriter()
            pps.write(bw)
            bw.rbsp_trailing_bits()
            pps_b = bw.get_bytes()
            out += [sps_b, pps_b,
                    dataclasses.asdict(syn.SPS.parse(bs.BitReader(sps_b))),
                    dataclasses.asdict(syn.PPS.parse(bs.BitReader(pps_b)))]
            for st, idr, first, idc in ((7, True, 0, 0), (5, False, 0, 1),
                                        (5, False, sps.pic_width_in_mbs, 2),
                                        (0, False, 0, 0)):
                hdr = syn.SliceHeader(
                    slice_type=st, idr=idr, idr_pic_id=3 if idr else 0,
                    frame_num=0 if idr else 5, first_mb_in_slice=first,
                    slice_qp_delta=-2, disable_deblocking_filter_idc=idc,
                    cabac_init_idc=1, pic_order_cnt_lsb=0 if idr else 10)
                bw = bs.BitWriter()
                hdr.write(bw, sps, pps)
                pos = bw.bit_position
                bw.rbsp_trailing_bits()
                raw = bw.get_bytes()
                br = bs.BitReader(raw)
                back = syn.SliceHeader.parse(
                    br, sps, pps, nal_type=5 if idr else 1, nal_ref_idc=3)
                out += [raw, pos, br.bit_position, dataclasses.asdict(back)]
    sei = syn.write_sei_rbsp([syn.sei_recovery_point(0),
                              syn.sei_user_data(b"hello")])
    out += [sei, syn.parse_sei_rbsp(sei), syn.write_aud_rbsp(1)]
    return out


def test_syntax_copies():
    a, b = _headers(jsyn, jbs), _headers(tsyn, tbs)
    assert len(a) == len(b) > 50
    for i, (x, y) in enumerate(zip(a, b)):
        assert x == y, i


@pytest.mark.parametrize("seed", range(3))
def test_cavlc_block_copies(seed):
    rng = np.random.default_rng(seed)
    blocks = []
    for _ in range(200):
        n = int(rng.choice([4, 15, 16]))
        density = rng.choice([0.0, 0.1, 0.5, 1.0])
        mag = int(rng.choice([2, 20, 3000]))
        c = (rng.random(n) < density) * rng.integers(-mag, mag + 1, n)
        n_c = -1 if n == 4 else int(rng.integers(0, 17))
        blocks.append((c.astype(int).tolist(), n_c, n))
    out = []
    for bs, cv in ((jbs, jcavlc), (tbs, tcavlc)):
        bw = bs.BitWriter()
        tcs = [cv.encode_block(bw, c, n_c) for c, n_c, _ in blocks]
        bw.rbsp_trailing_bits()
        data = bw.get_bytes()
        br = bs.BitReader(data)
        dec = []
        for c, n_c, n in blocks:
            coeffs, tc = cv.decode_block(br, n_c, n)
            assert list(coeffs) == c
            dec.append((list(coeffs), tc))
        out.append((data, tcs, dec))
    assert out[0] == out[1]


@pytest.mark.parametrize("seed", range(3))
def test_mv_pred_copies(seed):
    rng = np.random.default_rng(seed)
    R, C = 5, 6
    maps = {}, {}
    for r in range(R):
        for c in range(C):
            got = [(m.predict_mv(mp, r, c, C), m.skip_mv(mp, r, c, C))
                   for m, mp in zip((jmv, tmv), maps)]
            assert got[0] == got[1], (r, c)
            if rng.random() < 0.85:  # some MBs stay unknown to the map
                mv = (int(rng.integers(-40, 41)), int(rng.integers(-40, 41)))
                if rng.random() < 0.2:
                    mv = (0, 0)
                for mp in maps:
                    mp[(r, c)] = mv
    assert jmv.median3(3, -1, 2) == tmv.median3(3, -1, 2)


def test_yuv_copies():
    rng = np.random.default_rng(0)
    w, h = 40, 24
    buf = bytes(rng.integers(0, 256, w * h * 3 // 2, dtype=np.uint8))
    a, b = jyuv.split_i420(buf, w, h), tyuv.split_i420(buf, w, h)
    for p, q in zip(a, b):
        np.testing.assert_array_equal(p, q)
        for size in (16, 8):
            np.testing.assert_array_equal(jyuv.pad_to_mb_grid(p, size),
                                          tyuv.pad_to_mb_grid(q, size))
    assert jyuv.pack_i420(*a) == tyuv.pack_i420(*b) == buf
    assert jyuv.psnr(a[0], a[0][::-1]) == tyuv.psnr(b[0], b[0][::-1])
