"""Host (C++) entropy runtime of the port: CAVLC and CABAC slice writers,
CAVLC and CABAC slice parsers, the CAVLC->CABAC transcoder, RBSP escaping;
and the build of the port's C ABI (libVideoCodec, build_capi) and of the
standalone C caller of it (build_capi_drive).

Counterpart of media_tpu/native/__init__.py. The sources are the port's own
copies under media_tpu_torch/csrc/*.cpp; their tables come from
native/gen_tables.py (this package's Python tables). At first use the
generated cavlc_tables.inc and the shared library are built with the system
C++ compiler into media_tpu_torch/csrc/build/host_<hash>/ and loaded with
ctypes. This is host code: it runs on the CPU beside either torch device.

A build or load failure raises RuntimeError with the compiler's output; no
caller falls back to Python because the library is missing. The one `None`
a wrapper returns is the C++ routine's own refusal (`n < 0`: the slice is
outside its envelope, e.g. I_PCM or an MB type it does not code); the caller
then runs the Python coder, and `fallbacks[<function name>]` counts it. The
Python coders in entropy/ and pipeline/slice_coder.py stay the tested oracle.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import subprocess
import sys
import sysconfig
import time

import numpy as np

from ..entropy.cabac_init_tables import INIT_MN_I, INIT_MN_P
from . import gen_tables

CSRC = os.path.normpath(os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "..", "csrc"))
SOURCES = ("cavlc_pack.cpp", "cabac_pack.cpp", "cavlc_parse.cpp",
           "cabac_parse.cpp")
CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")
SYMBOLS = ("mtpu_write_slice_i", "mtpu_write_slice_p", "mtpu_escape_rbsp",
           "mtpu_parse_slice_p", "mtpu_transcode_pslice",
           "mtpu_cabac_parse_slice_p", "mtpu_cabac_parse_slice_i",
           "mtpu_cabac_write_slice_p", "mtpu_cabac_write_slice_i")

# How often a C++ routine refused a slice (returned n < 0) and its caller
# went on with the Python coder, by wrapper name.
fallbacks: collections.Counter = collections.Counter()


def build(compiler: str = "g++") -> tuple[str, float]:
    """Generate the tables and compile the library unless a build of these
    exact sources, tables, flags and compiler exists. Returns (library path,
    seconds spent building; 0.0 when cached). Raises RuntimeError with the
    compiler's output when the build fails."""
    srcs = [os.path.join(CSRC, s) for s in SOURCES]
    inc_text = gen_tables.render()
    h = hashlib.sha256(" ".join((compiler, *CXX_FLAGS)).encode())
    h.update(inc_text.encode())
    for s in srcs:
        with open(s, "rb") as f:
            h.update(f.read())
    out_dir = os.path.join(CSRC, "build", f"host_{h.hexdigest()[:16]}")
    lib = os.path.join(out_dir, "libmedia_tpu_torch_host.so")
    if os.path.exists(lib):
        return lib, 0.0
    os.makedirs(out_dir, exist_ok=True)
    t0 = time.perf_counter()
    tag = f"{os.getpid()}.tmp"
    inc = os.path.join(out_dir, "cavlc_tables.inc")
    with open(f"{inc}.{tag}", "w") as f:
        f.write(inc_text)
    os.replace(f"{inc}.{tag}", inc)
    _compile([compiler, *CXX_FLAGS, f"-I{out_dir}", *srcs], lib)
    return lib, time.perf_counter() - t0


def _compile(cmd: list, out: str) -> None:
    """Run `cmd -o <out>.<pid>.tmp` and move the result to `out`, so that
    processes building at once never see a partial file. Raises
    RuntimeError with the command line and the compiler's output."""
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [*cmd, "-o", tmp]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, cwd=CSRC)
    except OSError as e:
        raise RuntimeError(f"media_tpu_torch.native: cannot run the C++ "
                           f"compiler: {' '.join(cmd)}\n{e}") from e
    if proc.returncode != 0:
        raise RuntimeError(f"media_tpu_torch.native: build failed "
                           f"({proc.returncode}):\n{' '.join(cmd)}\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)


# The C ABI bridge (csrc/api) and its standalone caller. The bridge embeds
# this interpreter's Python: it is compiled against its headers and linked
# to its shared libpython, found in LIBDIR (also the library's run path).
CAPI_DIR = os.path.join(CSRC, "api")
CAPI_SOURCES = ("video_codec_api.cpp", "video_codec_api.h", "capi_drive.c")


def _python_link() -> list:
    ver = f"{sys.version_info.major}.{sys.version_info.minor}"
    libdir = sysconfig.get_config_var("LIBDIR")
    return [f"-L{libdir}", f"-Wl,-rpath,{libdir}", f"-lpython{ver}"]


def _capi_dir(compiler: str) -> str:
    """csrc/build/capi_<hash>/: the hash covers the sources, the header, the
    flags, the compiler and the Python version."""
    h = hashlib.sha256(" ".join((compiler, *CXX_FLAGS, *_python_link(),
                                 sysconfig.get_path("include"),
                                 sys.version)).encode())
    for name in CAPI_SOURCES:
        with open(os.path.join(CAPI_DIR, name), "rb") as f:
            h.update(f.read())
    return os.path.join(CSRC, "build", f"capi_{h.hexdigest()[:16]}")


def build_capi(compiler: str = "g++") -> tuple[str, float]:
    """Compile the port's C ABI, libVideoCodec.so, unless a build of these
    exact sources exists. Returns (library path, seconds spent building; 0.0
    when cached). Raises RuntimeError with the compiler's output when the
    build fails."""
    out_dir = _capi_dir(compiler)
    lib = os.path.join(out_dir, "libVideoCodec.so")
    if os.path.exists(lib):
        return lib, 0.0
    os.makedirs(out_dir, exist_ok=True)
    t0 = time.perf_counter()
    _compile([compiler, *CXX_FLAGS, f"-I{sysconfig.get_path('include')}",
              os.path.join(CAPI_DIR, "video_codec_api.cpp"),
              *_python_link()], lib)
    return lib, time.perf_counter() - t0


class PicInfo(ctypes.Structure):
    """MtpuPicInfo of video_codec_api.h."""
    _fields_ = [("width", ctypes.c_uint32), ("height", ctypes.c_uint32)]


# MtpuDecoderEventCallback and MtpuCopyFrameFunc of video_codec_api.h.
EVENT_CB = ctypes.CFUNCTYPE(None, ctypes.c_uint32, ctypes.POINTER(PicInfo),
                            ctypes.c_void_p)
COPY_CB = ctypes.CFUNCTYPE(ctypes.c_int64, ctypes.POINTER(ctypes.c_uint8),
                           ctypes.c_uint32, ctypes.POINTER(ctypes.c_uint8),
                           ctypes.c_uint32, ctypes.POINTER(PicInfo),
                           ctypes.c_void_p)


def bind_capi(path: str) -> ctypes.CDLL:
    """Load a libVideoCodec with ctypes.CDLL (RTLD_LOCAL: two bridges that
    export the same names can live in one process) and declare the
    signatures of video_codec_api.h. The JAX package's library has every
    function but the two *On factories. A call releases the interpreter
    lock; the bridge takes it again itself."""
    lib = ctypes.CDLL(path)
    vp, u32, u32p = ctypes.c_void_p, ctypes.c_uint32, ctypes.POINTER(
        ctypes.c_uint32)
    u8pp = ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8))
    sigs = {
        "CreateVideoEncoder": (vp, []),
        "CreateVideoEncoderOn": (vp, [ctypes.c_char_p]),
        "DestroyVideoEncoder": (ctypes.c_int, [vp]),
        "MtpuEncoderSetParam": (ctypes.c_int, [vp, ctypes.c_char_p,
                                               ctypes.c_char_p]),
        "InitEncoder": (ctypes.c_int, [vp]),
        "StartEncoder": (ctypes.c_int, [vp]),
        "EncodeOneFrame": (ctypes.c_int, [vp, ctypes.c_char_p, u32, u8pp,
                                          u32p]),
        "StopEncoder": (ctypes.c_int, [vp]),
        "ResetEncoder": (ctypes.c_int, [vp]),
        "CreateVideoDecoder": (vp, []),
        "CreateVideoDecoderOn": (vp, [ctypes.c_char_p]),
        "DestroyVideoDecoder": (ctypes.c_int, [vp]),
        "MtpuCreateDecoder": (ctypes.c_int, [vp, u32]),
        "InitDecoder": (ctypes.c_int, [vp]),
        "SetDecodeParams": (ctypes.c_int, [vp, u32, u32, u32]),
        "StartDecoder": (ctypes.c_int, [vp]),
        "SendStreamData": (ctypes.c_int, [vp, ctypes.c_char_p, u32]),
        "RetrieveFrameData": (ctypes.c_int, [vp, ctypes.c_char_p, u32, u32p,
                                             u32p, u32p]),
        "FlushDecoder": (ctypes.c_int, [vp]),
        "StopDecoder": (ctypes.c_int, [vp]),
        "ResetDecoder": (ctypes.c_int, [vp]),
        "GetDecodeParams": (ctypes.c_int, [vp, u32p, u32p, u32p, u32p]),
        "SetDecoderCallbacks": (ctypes.c_int, [vp, EVENT_CB, vp]),
        "SetCopyFrameFunc": (ctypes.c_int, [vp, COPY_CB, vp]),
    }
    for name, (restype, argtypes) in sigs.items():
        if hasattr(lib, name):
            fn = getattr(lib, name)
            fn.restype, fn.argtypes = restype, argtypes
    return lib


def build_capi_drive() -> tuple[str, float]:
    """Compile csrc/api/capi_drive.c, a C program that encodes a raw I420
    file through libVideoCodec, into the library's build directory, linked
    to the library with a run path to it. Returns (program path, seconds
    spent building both; 0.0 when cached)."""
    lib, secs = build_capi()
    out_dir = os.path.dirname(lib)
    prog = os.path.join(out_dir, "capi_drive")
    if os.path.exists(prog):
        return prog, secs
    t0 = time.perf_counter()
    _compile(["gcc", "-O2", "-std=c11", f"-I{CAPI_DIR}",
              os.path.join(CAPI_DIR, "capi_drive.c"), f"-L{out_dir}",
              f"-Wl,-rpath,{out_dir}", "-lVideoCodec"], prog)
    return prog, secs + time.perf_counter() - t0


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """The host library, built on first use, with its C signatures."""
    path = build()[0]
    try:
        lib = ctypes.CDLL(path)
    except OSError as e:
        raise RuntimeError(f"media_tpu_torch.native: cannot load {path}: "
                           f"{e}") from e
    missing = [s for s in SYMBOLS if not hasattr(lib, s)]
    if missing:
        raise RuntimeError(f"media_tpu_torch.native: {path} lacks {missing}")
    i32p = ctypes.POINTER(ctypes.c_int32)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    ci, i64, u64 = ctypes.c_int, ctypes.c_int64, ctypes.c_uint64
    sigs = {
        "mtpu_write_slice_i": [u64, ci] + [i32p] * 6 + [ci, ci, i32p, i32p,
                                                       u8p, i64],
        "mtpu_write_slice_p": [u64, ci] + [i32p] * 4 + [ci, ci, i32p, i32p,
                                                       i32p, u8p, i64],
        "mtpu_escape_rbsp": [u8p, i64, u8p, i64],
        "mtpu_parse_slice_p": [u8p, i64, i64, ci, ci, ci] + [i32p] * 5,
        "mtpu_transcode_pslice": [u8p, i64, i64, ci, ci, ci, i32p, u8p, i64],
        "mtpu_cabac_parse_slice_p": [u8p, i64, i64, ci, ci, ci] + [i32p] * 6,
        "mtpu_cabac_parse_slice_i": [u8p, i64, i64, ci, ci, ci] + [i32p] * 10,
        "mtpu_cabac_write_slice_p": [i32p] * 4 + [ci, ci, ci, i32p, i32p,
                                                  u8p, i64],
        "mtpu_cabac_write_slice_i": [i32p] * 9 + [ci, ci, ci, i32p, u8p, i64],
    }
    for name, argtypes in sigs.items():
        fn = getattr(lib, name)
        fn.restype = i64
        fn.argtypes = argtypes
    return lib


_I32P = ctypes.POINTER(ctypes.c_int32)
_U8P = ctypes.POINTER(ctypes.c_uint8)


def _i32(a):
    """A contiguous int32 copy or view of `a`, and its pointer. The caller
    keeps the array alive for the duration of the call."""
    arr = np.ascontiguousarray(a, dtype=np.int32)
    return arr, arr.ctypes.data_as(_I32P)


def _i32_all(*arrays):
    pairs = [_i32(a) for a in arrays]
    return [a for a, _ in pairs], [p for _, p in pairs]


def _out_bytes(R: int, C: int):
    cap = R * C * 4096 + 65536
    out = np.empty(cap, np.uint8)
    return out, out.ctypes.data_as(_U8P), cap


def _src(data: bytes):
    src = np.frombuffer(data, np.uint8)
    return src, src.ctypes.data_as(_U8P)


def _init_p(cabac_init_idc: int):
    return _i32(INIT_MN_P[int(np.clip(cabac_init_idc, 0, 2))])


def _refused(name: str) -> None:
    fallbacks[name] += 1


def write_islice_native(bw, mode16, chroma_mode, dc, ac, cdc, cac) -> None:
    """Append all I_16x16 MBs of an I slice and the RBSP trailing bits to
    BitWriter `bw` (CAVLC)."""
    lib = load()
    R, C = mode16.shape
    out, out_p, cap = _out_bytes(R, C)
    l_nnz = np.empty(R * 4 * C * 4, np.int32)
    c_nnz = np.empty(2 * R * 2 * C * 2, np.int32)
    _keep, ptrs = _i32_all(mode16, chroma_mode, dc, ac, cdc, cac)
    n = lib.mtpu_write_slice_i(
        bw._acc, bw._nbits, *ptrs, R, C, l_nnz.ctypes.data_as(_I32P),
        c_nnz.ctypes.data_as(_I32P), out_p, cap)
    if n < 0:
        raise RuntimeError("native I-slice packer overflow")
    bw._buf.extend(out[:n].tobytes())
    bw._acc = 0
    bw._nbits = 0


def write_pslice_native(bw, mv, luma, cdc, cac) -> None:
    """Append all MBs of a uniform-QP P slice and the RBSP trailing bits to
    BitWriter `bw` (CAVLC)."""
    lib = load()
    R, C = mv.shape[:2]
    out, out_p, cap = _out_bytes(R, C)
    l_nnz = np.empty(R * 4 * C * 4, np.int32)
    c_nnz = np.empty(2 * R * 2 * C * 2, np.int32)
    mv_scratch = np.empty(R * C * 2, np.int32)
    _keep, ptrs = _i32_all(mv, luma, cdc, cac)
    n = lib.mtpu_write_slice_p(
        bw._acc, bw._nbits, *ptrs, R, C, l_nnz.ctypes.data_as(_I32P),
        c_nnz.ctypes.data_as(_I32P), mv_scratch.ctypes.data_as(_I32P),
        out_p, cap)
    if n < 0:
        raise RuntimeError("native P-slice packer overflow")
    bw._buf.extend(out[:n].tobytes())
    bw._acc = 0
    bw._nbits = 0


def escape_rbsp_native(data: bytes) -> bytes:
    """Emulation-prevention escaping (spec 7.4.1) of an RBSP."""
    lib = load()
    n = len(data)
    cap = n + n // 2 + 64
    out = np.empty(cap, np.uint8)
    _keep, src_p = _src(data)
    m = lib.mtpu_escape_rbsp(src_p, n, out.ctypes.data_as(_U8P), cap)
    if m < 0:
        raise RuntimeError("native RBSP escape overflow")
    return out[:m].tobytes()


def cabac_write_pslice_native(mv, luma, cdc, cac, qp: int,
                              cabac_init_idc: int = 0,
                              qp_map=None) -> bytes | None:
    """CABAC P-slice payload via the C++ packer, byte-identical to
    entropy.cabac_slice.write_pslice_cabac. qp_map: optional (R, C) per-MB
    QP (mb_qp_delta coding on cbp != 0 MBs). None: the routine refused."""
    lib = load()
    R, C = mv.shape[:2]
    out, out_p, cap = _out_bytes(R, C)
    _keep, ptrs = _i32_all(mv, luma, cdc, cac)
    _init, init_p = _init_p(cabac_init_idc)
    _qarr, q_p = (None, None) if qp_map is None else _i32(qp_map)
    n = lib.mtpu_cabac_write_slice_p(*ptrs, R, C, int(qp), init_p, q_p,
                                     out_p, cap)
    if n < 0:
        return _refused("cabac_write_pslice_native")
    return out[:n].tobytes()


def cabac_write_islice_native(mode16, chroma_mode, dc, ac, cdc, cac,
                              qp: int, is_i4=None, modes4=None,
                              luma4_levels=None) -> bytes | None:
    """CABAC I-slice payload via the C++ packer, byte-identical to
    entropy.cabac_slice.write_islice_cabac. is_i4 (R, C) bool, modes4
    (R, C, 16) and luma4_levels (R, C, 16, 16) mark and carry the I_4x4
    MBs; without them every MB is I_16x16. None: the routine refused."""
    lib = load()
    R, C = mode16.shape
    out, out_p, cap = _out_bytes(R, C)
    _keep, ptrs = _i32_all(mode16, chroma_mode, dc, ac, cdc, cac)
    _init, init_p = _i32(INIT_MN_I)
    i4_ptrs = [None, None, None]  # null: every MB is I_16x16
    if is_i4 is not None:
        _keep4, i4_ptrs = _i32_all(is_i4, modes4, luma4_levels)
    n = lib.mtpu_cabac_write_slice_i(*ptrs, *i4_ptrs, R, C, int(qp), init_p,
                                     out_p, cap)
    if n < 0:
        return _refused("cabac_write_islice_native")
    return out[:n].tobytes()


def _p_arrays(R: int, C: int, qp_fill: int):
    return {"mv": np.zeros((R, C, 2), np.int32),
            "luma_levels": np.zeros((R, C, 16, 16), np.int32),
            "cdc_levels": np.zeros((R, C, 2, 4), np.int32),
            "cac_levels": np.zeros((R, C, 2, 4, 15), np.int32),
            "qp_map": np.full((R, C), qp_fill, np.int32)}


def parse_pslice_native(data: bytes, nbits: int, bitpos: int,
                        R: int, C: int, slice_qp: int):
    """Parse a CAVLC P slice's slice_data via the C++ parser. Returns
    {"mv", "luma_levels", "cdc_levels", "cac_levels", "qp_map", "covered"},
    or None when the slice uses tools beyond the P_L0_16x16 envelope."""
    lib = load()
    sym = _p_arrays(R, C, 0)
    _keep, src_p = _src(data)
    n = lib.mtpu_parse_slice_p(
        src_p, nbits, bitpos, R, C, int(slice_qp),
        *(a.ctypes.data_as(_I32P) for a in sym.values()))
    if n < 0:
        return _refused("parse_pslice_native")
    sym["covered"] = int(n)
    return sym


def transcode_pslice_native(data: bytes, nbits: int, bitpos: int,
                            R: int, C: int, qp: int,
                            cabac_init_idc: int = 0) -> bytes | None:
    """CAVLC -> CABAC transcode of one P slice's slice_data (C++): parse the
    device CAVLC pack and re-emit the slice as a CABAC payload. None: the
    routine refused."""
    lib = load()
    _init, init_p = _init_p(cabac_init_idc)
    _keep, src_p = _src(data)
    out, out_p, cap = _out_bytes(R, C)
    n = lib.mtpu_transcode_pslice(src_p, nbits, bitpos, R, C, int(qp), init_p,
                                  out_p, cap)
    if n < 0:
        return _refused("transcode_pslice_native")
    return out[:n].tobytes()


def cabac_parse_islice_native(data: bytes, bitpos: int, R: int, C: int,
                              qp: int):
    """Parse a CABAC I slice's slice_data via the C++ decoder. Returns the
    symbol dict (parse_islice_cabac layout) or None (I_PCM, per-MB QP)."""
    lib = load()
    _init, init_p = _i32(INIT_MN_I)
    sym = {"mode16": np.zeros((R, C), np.int32),
           "chroma_mode": np.zeros((R, C), np.int32),
           "dc_levels": np.zeros((R, C, 16), np.int32),
           "ac_levels": np.zeros((R, C, 16, 15), np.int32),
           "cdc_levels": np.zeros((R, C, 2, 4), np.int32),
           "cac_levels": np.zeros((R, C, 2, 4, 15), np.int32),
           "is_i4": np.zeros((R, C), np.int32),
           "modes4": np.zeros((R, C, 16), np.int32),
           "luma4_levels": np.zeros((R, C, 16, 16), np.int32)}
    _keep, src_p = _src(data)
    n = lib.mtpu_cabac_parse_slice_i(
        src_p, len(data), bitpos, R, C, int(qp), init_p,
        *(a.ctypes.data_as(_I32P) for a in sym.values()))
    if n < 0:
        return _refused("cabac_parse_islice_native")
    sym["is_i4"] = sym["is_i4"].astype(bool)
    sym["covered"] = int(n)
    return sym


def cabac_parse_pslice_native(data: bytes, bitpos: int, R: int, C: int,
                              qp: int, cabac_init_idc: int = 0):
    """Parse a CABAC P slice's slice_data via the C++ decoder (decode twin
    of the native packer). Returns the symbol dict or None (tools beyond the
    P_L0_16x16 envelope)."""
    lib = load()
    _init, init_p = _init_p(cabac_init_idc)
    sym = _p_arrays(R, C, int(qp))
    _keep, src_p = _src(data)
    n = lib.mtpu_cabac_parse_slice_p(
        src_p, len(data), bitpos, R, C, int(qp), init_p,
        *(a.ctypes.data_as(_I32P) for a in sym.values()))
    if n < 0:
        return _refused("cabac_parse_pslice_native")
    sym["covered"] = int(n)
    return sym
