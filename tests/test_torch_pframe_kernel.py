"""The CUDA P-frame core (media_tpu_torch/csrc/pframe_core.cu) on the CPU.

No card here, so three things stand in for it:

- the wrapper, with a stand-in for the kernel library: CPU tensors run the
  plain versions and launch nothing; other tensors go to the kernel inside
  their device's context, on its current stream;
- the kernel's arithmetic, compiled with g++ from the same header the
  kernel uses (csrc/pframe_core.cuh, driven MB by MB by
  csrc/pframe_core_emu.cpp, which has the kernel library's C ABI) and
  called through the wrapper: every symbol, recon sample, MV, prediction
  and cost equal to local_pframe_core_plain's and search_refine_luma_plain's,
  with the QP as an int, a 0-d tensor and a per-MB map, on pictures full of
  ties, MVs past every edge and a row tile whose halo rows are real rows;
  the uint8 entry too, on a whole-picture reference whose rows the kernel
  clamps (against the int32 edge-padded one) and on a row tile's real halo
  rows;
- the same arithmetic against the JAX package's local_pframe_core, once per
  QP form.

The plain versions are held to the JAX package by tests/test_torch_pframe.py
and tests/test_torch_ops.py; the kernel to the plain versions on the card by
tests/test_torch_cuda.py and chip_smoke.py.
"""

import contextlib
import ctypes
import functools
import hashlib
import os
import subprocess
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import PCORE_KINDS, pcore_planes, pcore_qps, pcore_whole_u8
from media_tpu.pipeline import pframe_core as jpc
from media_tpu_torch import kernels
from media_tpu_torch.pipeline import pframe_core as tpc

KEYS = ("symbols", "recon_y", "recon_u", "recon_v", "sad_total")


# ------------------------------------------------------------------ wrapper


def test_cpu_tensors_run_the_plain_versions(monkeypatch):
    monkeypatch.setattr(kernels, "load", lambda: pytest.fail("launched"))
    monkeypatch.setattr(tpc.local_pframe_core, "launches", 0)
    monkeypatch.setattr(tpc.search_refine_luma, "launches", 0)
    R, C, rs = 2, 3, 8
    planes = pcore_planes(R, C, rs, 1)
    for form in ("int", "0d", "map"):
        qp, qp_c = pcore_qps(form, R * C, 2)
        got = tpc.local_pframe_core(*planes, qp, qp_c, rs, R, C)
        want = tpc.local_pframe_core_plain(*planes, qp, qp_c, rs, R, C)
        for k in KEYS:
            assert torch.equal(got[k], want[k]), k
    cur = tpc.to_mbs(planes[0], R, C, 16)
    for a, b in zip(tpc.search_refine_luma(cur, planes[3], rs, R, C),
                    tpc.search_refine_luma_plain(cur, planes[3], rs, R, C)):
        assert torch.equal(a, b)
    assert tpc.local_pframe_core.launches == 0
    assert tpc.search_refine_luma.launches == 0


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
        pframe_core_launch=entry("core"), pframe_search_launch=entry("search"),
        pframe_core_u8_launch=entry("core_u8"),
        media_cuda_error_string=lambda err: b"stub error")
    streams = {}
    monkeypatch.setattr(torch.cuda, "device", device)
    monkeypatch.setattr(
        torch.cuda, "current_stream",
        lambda dev=None: types.SimpleNamespace(
            cuda_stream=streams.setdefault(str(dev), 1000 + len(streams))))
    monkeypatch.setattr(kernels, "load", lambda: lib)
    monkeypatch.setattr(tpc.local_pframe_core, "launches", 0)
    monkeypatch.setattr(tpc.search_refine_luma, "launches", 0)
    return log, streams, err


def _meta_planes(R, C, rs):
    meta = torch.device("meta")
    hy, hc = rs + tpc.INTERP_HALO, rs // 2 + 2
    return [torch.empty(s, dtype=torch.int32, device=meta) for s in (
        (16 * R, 16 * C), (8 * R, 8 * C), (8 * R, 8 * C),
        (16 * R + 2 * hy, 16 * C), (8 * R + 2 * hc, 8 * C),
        (8 * R + 2 * hc, 8 * C))]


def test_wrapper_launches_on_its_tensors_device_and_stream(stub):
    log, streams, _ = stub
    R, C, rs = 2, 3, 8
    planes = _meta_planes(R, C, rs)
    meta = planes[0].device
    out = tpc.local_pframe_core(*planes, 30, 29, rs, R, C)
    assert out["symbols"].shape == (R, C, tpc.SYMBOLS_PER_MB)
    assert out["symbols"].dtype == torch.int16
    assert out["recon_y"].shape == (16 * R, 16 * C)
    assert out["recon_u"].dtype == torch.uint8
    assert out["sad_total"].shape == () and out["sad_total"].dtype == torch.int32
    qp = torch.empty((), dtype=torch.int32, device=meta)
    qmap = torch.empty((R * C,), dtype=torch.int32, device=meta)
    tpc.local_pframe_core(*planes, qp, qp, rs, R, C)
    tpc.local_pframe_core(*planes, qmap, qp, rs, R, C)
    tpc.launch_pframe_core(*planes, 30, 29, rs, R, C)  # the raw launch: no count
    cur = torch.empty((R * C, 16, 16), dtype=torch.int32, device=meta)
    qmv, pred, cost = tpc.search_refine_luma(cur, planes[3], rs, R, C)
    assert (qmv.shape, pred.shape, cost.shape) == ((R * C, 2),
                                                   (R * C, 16, 16), (R * C,))
    assert [(name, dev) for name, dev, _ in log] == [("core", meta)] * 4 + [
        ("search", meta)]
    assert tpc.local_pframe_core.launches == 3
    assert tpc.search_refine_luma.launches == 1
    for _, _, args in log:  # the current stream of the tensors' device
        assert args[-1].value == streams[str(meta)]
        assert tuple(args[-4:-1]) == (R, C, rs)
    # A QP by value, as a 0-d device tensor (stride 0), as a map (stride 1).
    q = [args[7:13] for _, _, args in log[:3]]
    assert q[0][0].value is None and q[0][1:3] == (0, 30)
    assert q[0][3].value is None and q[0][4:6] == (0, 29)
    assert q[1][1] == 0 and q[1][4] == 0
    assert q[2][1] == 1 and q[2][4] == 0
    strides = ctypes.cast(log[0][2][6], ctypes.POINTER(ctypes.c_int64))
    assert [strides[i] for i in range(6)] == [16 * C, 8 * C, 8 * C, 16 * C,
                                              8 * C, 8 * C]


def test_wrapper_refuses_bad_arguments_and_raises_on_a_failed_launch(stub):
    log, _, err = stub
    R, C, rs = 2, 3, 8
    planes = _meta_planes(R, C, rs)
    with pytest.raises(ValueError, match="ref_y_ext"):
        tpc.local_pframe_core(*planes[:3], planes[3][1:], *planes[4:], 30, 29,
                              rs, R, C)
    with pytest.raises(ValueError, match="qp"):
        tpc.local_pframe_core(*planes, torch.empty(
            (5,), dtype=torch.int32, device=planes[0].device), 29, rs, R, C)
    with pytest.raises(ValueError, match="search range"):
        big = _meta_planes(R, C, 40)
        tpc.local_pframe_core(*big, 30, 29, 40, R, C)
    assert log == []
    err[0] = 700
    with pytest.raises(RuntimeError, match="pframe_core kernel launch failed"):
        tpc.local_pframe_core(*planes, 30, 29, rs, R, C)
    cur = torch.empty((R * C, 16, 16), dtype=torch.int32,
                      device=planes[0].device)
    with pytest.raises(RuntimeError, match="search launch failed"):
        tpc.search_refine_luma(cur, planes[3], rs, R, C)
    assert tpc.local_pframe_core.launches == 0
    assert tpc.search_refine_luma.launches == 0


def test_uint8_planes_take_the_uint8_entry(stub):
    """Six uint8 planes go to the uint8 entry as they are (no int32 copy):
    with extended references (whole 0) from local_pframe_core, with the
    picture alone (whole 1) from pframe_core_whole; int32 planes to the
    int32 entry, whole-picture ones with their halos padded first."""
    log, _, _ = stub
    R, C, rs = 2, 3, 8
    planes = _meta_planes(R, C, rs)
    u8 = [p.to(torch.uint8) for p in planes]
    whole = u8[:3] + [torch.empty(p.shape, dtype=torch.uint8,
                                  device=p.device) for p in u8[:3]]
    tpc.local_pframe_core(*u8, 30, 29, rs, R, C)
    tpc.pframe_core_whole(*whole, 30, 29, rs, R, C)
    tpc.pframe_core_whole(*(p.to(torch.int32) for p in whole), 30, 29, rs,
                          R, C)
    assert [name for name, _, _ in log] == ["core_u8", "core_u8", "core"]
    assert [args[-2] for _, _, args in log[:2]] == [0, 1]
    assert tuple(log[1][2][-5:-2]) == (R, C, rs)
    strides = ctypes.cast(log[1][2][6], ctypes.POINTER(ctypes.c_int64))
    assert [strides[i] for i in range(6)] == [16 * C, 8 * C, 8 * C] * 2
    assert tpc.local_pframe_core.launches == 3
    with pytest.raises(ValueError, match="ref_y_ext"):  # halo rows missing
        tpc.local_pframe_core(*whole, 30, 29, rs, R, C)
    with pytest.raises(ValueError, match="uint8"):
        tpc.launch_pframe_core(*(p.to(torch.int32) for p in whole), 30, 29,
                               rs, R, C, whole=True)


def test_whole_picture_entry_on_cpu_pads_and_runs_the_plain_version(
        monkeypatch):
    monkeypatch.setattr(kernels, "load", lambda: pytest.fail("launched"))
    monkeypatch.setattr(tpc.local_pframe_core, "launches", 0)
    R, C, rs = 2, 3, 8
    planes = pcore_planes(R, C, rs, 4)
    want = tpc.local_pframe_core_plain(*planes, 30, 29, rs, R, C)
    got = tpc.pframe_core_whole(*pcore_whole_u8(planes, rs), 30, 29, rs, R, C)
    _assert_core_equal(got, want, "cpu")
    assert tpc.local_pframe_core.launches == 0


# ------------------------------------------- the kernel's arithmetic, on g++


@pytest.fixture(scope="module")
def emu_lib():
    """csrc/pframe_core_emu.cpp built with g++ into csrc/build/emu_<hash>/."""
    srcs = [os.path.join(kernels.CSRC, f) for f in
            ("pframe_core_emu.cpp", "pframe_core.cuh")]
    flags = ["-O1", "-shared", "-fPIC", "-std=c++17"]
    h = hashlib.sha256(" ".join(flags).encode())
    for s in srcs:
        with open(s, "rb") as f:
            h.update(f.read())
    out_dir = os.path.join(kernels.CSRC, "build", f"emu_{h.hexdigest()[:16]}")
    lib = os.path.join(out_dir, "libpframe_core_emu.so")
    if not os.path.exists(lib):
        os.makedirs(out_dir, exist_ok=True)
        tmp = f"{lib}.{os.getpid()}.tmp"
        subprocess.run(["g++", *flags, "-o", tmp, srcs[0]], check=True,
                       capture_output=True, timeout=300)
        os.replace(tmp, lib)
    return kernels.bind_pframe_core(ctypes.CDLL(lib))


@pytest.fixture
def emulate(emu_lib, monkeypatch):
    """The raw launches on CPU tensors, the host build of the kernel
    library in place of the card's."""
    monkeypatch.setattr(kernels, "load", lambda: emu_lib)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    return types.SimpleNamespace(core=tpc.launch_pframe_core,
                                 search=tpc.launch_search_refine_luma)


def _assert_core_equal(got, want, what):
    for k in KEYS:
        assert got[k].dtype == want[k].dtype, (what, k)
        assert torch.equal(got[k], want[k]), (what, k)


def _assert_search_equal(emulate, planes, rs, R, C, what):
    cur = tpc.to_mbs(planes[0], R, C, 16)
    want = tpc.search_refine_luma_plain(cur, planes[3], rs, R, C)
    got = emulate.search(cur, planes[3], rs, R, C)
    for name, a, b in zip(("qmv", "pred", "cost"), got, want):
        assert a.dtype == b.dtype and torch.equal(a, b), (what, name)
    return want


# Shapes: one MB, one row, one column, small grids; both search ranges;
# the three QP forms; every picture kind of chip_smoke.PCORE_KINDS.
SHAPES = ((1, 1), (1, 5), (5, 1), (3, 4), (4, 6))
CASES = [(R, C, rs, form, kind)
         for i, (R, C) in enumerate(SHAPES)
         for rs in (8, 4)
         for form, kind in (
             [("int", "moving"), ("0d", "edge_far"), ("map", "edge_near")]
             + ([("int", "flat"), ("0d", "periodic")] if rs == 8 else
                [("map", "constant"), ("low", "noise")]))]


@pytest.mark.parametrize("R,C,rs,form,kind", CASES)
def test_kernel_arithmetic_matches_plain(emulate, R, C, rs, form, kind):
    seed = 100 * R + 10 * C + rs
    planes = pcore_planes(R, C, rs, seed, kind)
    qp, qp_c = pcore_qps(form, R * C, seed)
    want = tpc.local_pframe_core_plain(*planes, qp, qp_c, rs, R, C)
    _assert_core_equal(emulate.core(*planes, qp, qp_c, rs, R, C), want,
                       (R, C, rs, form, kind))
    qmv = _assert_search_equal(emulate, planes, rs, R, C, kind)[0]
    if kind in ("edge_far", "edge_near"):
        # MVs of the MBs on the named edges point past them, along each
        # axis that has room for the pan (3 MBs or more).
        far = kind == "edge_far"
        mv = qmv.reshape(R, C, 2) * (1 if far else -1)
        if C >= 3:
            assert int(mv[:, -1 if far else 0, 0].max()) > 0
        if R >= 3:
            assert int(mv[-1 if far else 0, :, 1].max()) > 0
    if form == "low":
        levels = want["symbols"][..., 2:].abs()
        assert int(levels.max()) == 2063  # the clamp is reached


def test_ties_keep_the_first_minimum(emulate):
    """Stripes of period 4 shifted by 2 match at (-2, -2), (2, -2), ...
    with one cost: the first in (dy, dx) raster order wins, in the kernel
    as in the plain version."""
    R, C, rs = 3, 4, 8
    planes = pcore_planes(R, C, rs, 0, "periodic")
    qmv = _assert_search_equal(emulate, planes, rs, R, C, "periodic")[0]
    interior = qmv.reshape(R, C, 2)[1, 1]
    assert interior.tolist() == [-8, -8]  # full-pel (-2, -2), refined in place
    flat = pcore_planes(R, C, rs, 3, "constant")
    qmv = _assert_search_equal(emulate, flat, rs, R, C, "constant")[0]
    assert int(qmv.abs().max()) == 0


@pytest.mark.parametrize("rs,form", [(8, "map"), (4, "0d")])
def test_row_tile_with_real_halo_rows(emulate, rs, form):
    """The middle tile of three: its extension rows above and below are
    the neighbour tiles' rows, not edge copies; the kernel reads them."""
    R, C = 2, 4
    planes = pcore_planes(R, C, rs, 7, "moving", tiles=3, tile=1)
    hy = rs + tpc.INTERP_HALO
    assert not torch.equal(planes[3][:hy], planes[3][hy:hy + 1].expand(hy, -1))
    qp, qp_c = pcore_qps(form, R * C, 7)
    want = tpc.local_pframe_core_plain(*planes, qp, qp_c, rs, R, C)
    _assert_core_equal(emulate.core(*planes, qp, qp_c, rs, R, C), want, "tile")
    _assert_search_equal(emulate, planes, rs, R, C, "tile")


def test_strided_planes(emulate):
    """Planes that are views with a row stride wider than their width, and
    uint8 planes, give what contiguous int32 planes give."""
    R, C, rs = 2, 3, 4
    planes = pcore_planes(R, C, rs, 5, "moving")
    wide = [torch.zeros((p.shape[0], p.shape[1] + 8), dtype=torch.int32)
            for p in planes]
    views = []
    for w, p in zip(wide, planes):
        w[:, 3 : 3 + p.shape[1]] = p
        views.append(w[:, 3 : 3 + p.shape[1]])
    want = tpc.local_pframe_core_plain(*planes, 28, 27, rs, R, C)
    _assert_core_equal(emulate.core(*views, 28, 27, rs, R, C), want, "views")
    u8 = [p.to(torch.uint8) for p in planes]
    _assert_core_equal(emulate.core(*u8, 28, 27, rs, R, C), want, "uint8")


# ------------------------------------------------ against the JAX package


@functools.partial(jax.jit, static_argnums=(8, 9, 10))
def _jax_core(y, u, v, ry, ru, rv, qp, qp_c, rs, R, C):
    return jpc.local_pframe_core(y, u, v, ry, ru, rv, qp, qp_c, rs, R, C)


JAX_R, JAX_C, JAX_RS = 3, 4, 8
JAX_FORMS = ("int", "0d", "map")


@pytest.fixture(scope="module")
def jax_cores():
    """The JAX package's local_pframe_core on one moving picture with the
    QP in each form: {form: (planes, qps, result as numpy)}."""
    R, C, rs = JAX_R, JAX_C, JAX_RS
    planes = pcore_planes(R, C, rs, 11, "moving")
    out = {}
    for form in JAX_FORMS:
        qp, qp_c = pcore_qps(form, R * C, 11)
        jq = [q if isinstance(q, int) else jnp.asarray(q.numpy())
              for q in (qp, qp_c)]
        res = _jax_core(*(jnp.asarray(p.numpy()) for p in planes), *jq, rs, R,
                        C)
        out[form] = (planes, (qp, qp_c),
                     {k: np.asarray(res[k]) for k in KEYS})
    return out


@pytest.mark.parametrize("form", JAX_FORMS)
def test_kernel_arithmetic_matches_jax(emulate, jax_cores, form):
    planes, (qp, qp_c), want = jax_cores[form]
    got = emulate.core(*planes, qp, qp_c, JAX_RS, JAX_R, JAX_C)
    for k in KEYS:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    assert np.abs(want["symbols"][..., :2]).max() > 0  # real MVs


# ------------------------------------- the uint8 entry and the row clamp


# Every picture kind of chip_smoke.PCORE_KINDS, at one MB, one row, one
# column and a small grid, the QP in each form: MVs past the top and bottom
# read the clamped rows.
U8_CASES = [(R, C, rs, form, kind)
            for (R, C), rs in (((1, 1), 8), ((1, 4), 4), ((3, 1), 8),
                               ((3, 4), 8))
            for form, kind in zip(("int", "0d", "map", "int", "0d", "map",
                                   "low"), PCORE_KINDS)]


@pytest.mark.parametrize("R,C,rs,form,kind", U8_CASES)
def test_whole_picture_uint8_matches_padded_int32(emulate, R, C, rs, form,
                                                  kind):
    seed = 200 + 100 * R + 10 * C + rs
    planes = pcore_planes(R, C, rs, seed, kind)
    qp, qp_c = pcore_qps(form, R * C, seed)
    want = tpc.local_pframe_core_plain(*planes, qp, qp_c, rs, R, C)
    got = emulate.core(*pcore_whole_u8(planes, rs), qp, qp_c, rs, R, C,
                       whole=True)
    _assert_core_equal(got, want, (R, C, rs, form, kind))
    _assert_core_equal(emulate.core(*planes, qp, qp_c, rs, R, C), got,
                       "int32 extended")


@pytest.mark.parametrize("rs,tile", [(8, 0), (4, 1), (8, 2)])
def test_uint8_row_tile_reads_its_halo_rows_as_given(emulate, rs, tile):
    """The tiles of three, their extension rows the neighbours' rows (edge
    copies only at the picture's top and bottom), as uint8: the kernel does
    not clamp them."""
    R, C = 2, 4
    planes = pcore_planes(R, C, rs, 9, "moving", tiles=3, tile=tile)
    hy = rs + tpc.INTERP_HALO
    if tile == 1:
        assert not torch.equal(planes[3][:hy],
                               planes[3][hy:hy + 1].expand(hy, -1))
    qp, qp_c = pcore_qps("map", R * C, 9)
    want = tpc.local_pframe_core_plain(*planes, qp, qp_c, rs, R, C)
    u8 = [p.to(torch.uint8) for p in planes]
    _assert_core_equal(emulate.core(*u8, qp, qp_c, rs, R, C), want, "tile")
