"""Build and bind the port's hand-written CUDA kernels.

Every `csrc/*.cu` file is compiled by nvcc for sm_90a (Hopper), one nvcc
process per source, all started together, and the objects are linked into
one shared library with a plain C interface, at first use, into
`csrc/build/<hash of sources and flags>/`, and loaded with ctypes. A build
failure raises; there is no fallback. nvcc is taken from $CUDA_HOME/bin,
else from PATH, else from /usr/local/cuda/bin.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import time

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC"]


def _sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME")
    candidates = ([os.path.join(home, "bin", "nvcc")] if home else []) + [
        shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for path in candidates:
        if path and os.access(path, os.X_OK):
            return path
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _run_all(cmds: list[list[str]]) -> str:
    """Run the commands concurrently; raise on the first that fails."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, proc, out in zip(cmds, procs, outs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{out}")
    return "".join(outs)


def build(verbose: bool = False) -> tuple[str, float]:
    """Compile the kernels unless a build of these exact sources exists.
    Returns (library path, seconds spent building; 0.0 when cached)."""
    srcs = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs + sorted(glob.glob(os.path.join(CSRC, "*.cuh"))):
        with open(s, "rb") as f:
            h.update(f.read())
    out_dir = os.path.join(CSRC, "build", h.hexdigest()[:16])
    lib = os.path.join(out_dir, "libmedia_tpu_torch_kernels.so")
    if os.path.exists(lib):
        return lib, 0.0
    os.makedirs(out_dir, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{os.getpid()}.tmp"
    objs = [os.path.join(out_dir, f"{os.path.basename(s)}.{tag}.o")
            for s in srcs]
    t0 = time.perf_counter()
    log = _run_all([[nvcc, *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
                     "-c", "-o", o, s] for s, o in zip(srcs, objs)])
    tmp = f"{lib}.{tag}"
    log += _run_all([[nvcc, "-shared", "-o", tmp, *objs]])
    if verbose:
        print(log, end="")
    for o in objs:
        os.remove(o)
    os.replace(tmp, lib)
    return lib, time.perf_counter() - t0


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """The kernel library, built on first use, with its C signatures."""
    lib = ctypes.CDLL(build()[0])
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.deblock_wave_launch.argtypes = [vp] * 5 + [ci] * 4 + [vp]
    lib.deblock_wave_launch.restype = ci
    lib.deblock_wave_step_launch.argtypes = [vp] * 7 + [ci, vp]
    lib.deblock_wave_step_launch.restype = ci
    lib.deblock_wave_step_inplace_launch.argtypes = [vp] * 4 + [ci] * 3 + [vp]
    lib.deblock_wave_step_inplace_launch.restype = ci
    lib.media_cuda_error_string.argtypes = [ci]
    lib.media_cuda_error_string.restype = ctypes.c_char_p
    return bind_deblock_meta(
        bind_intra_wave(bind_pframe_core(bind_device_cavlc(lib))))


def bind_deblock_meta(lib: ctypes.CDLL) -> ctypes.CDLL:
    """The C signature of the deblocking meta kernel's entry point
    (csrc/deblock_meta.cu; its host build for the tests,
    csrc/deblock_meta_emu.cpp, has the same)."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.deblock_meta_launch.argtypes = (
        [vp, vp, ci, vp, ci] + [vp] * 4 + [ci] * 3 + [vp])
    lib.deblock_meta_launch.restype = ci
    return lib


def bind_intra_wave(lib: ctypes.CDLL) -> ctypes.CDLL:
    """The C signatures of the intra wavefront's entry points
    (csrc/intra_wave.cu; its host build for the tests,
    csrc/intra_wave_emu.cpp, has the same)."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.intra_encode_launch.argtypes = (
        [vp] * 5 + [ci, ci] + [vp] * 4 + [vp] * 12 + [ci, ci, ci, vp])
    lib.intra_encode_launch.restype = ci
    lib.intra_recon_launch.argtypes = (
        [vp] * 10 + [ci, ci] + [vp] * 4 + [vp] * 3 + [ci, ci, vp])
    lib.intra_recon_launch.restype = ci
    return lib


def bind_pframe_core(lib: ctypes.CDLL) -> ctypes.CDLL:
    """The C signatures of the P core's entry points (csrc/pframe_core.cu;
    its host build for the tests, csrc/pframe_core_emu.cpp, has the
    same)."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.pframe_core_launch.argtypes = (
        [vp] * 7 + [vp, ci, ci, vp, ci, ci] + [vp] * 8 + [ci, ci, ci, vp])
    lib.pframe_core_launch.restype = ci
    lib.pframe_core_u8_launch.argtypes = (
        [vp] * 7 + [vp, ci, ci, vp, ci, ci] + [vp] * 8 + [ci] * 4 + [vp])
    lib.pframe_core_u8_launch.restype = ci
    lib.pframe_search_launch.argtypes = (
        [vp, vp, ctypes.c_longlong] + [vp] * 3 + [ci, ci, ci, vp])
    lib.pframe_search_launch.restype = ci
    return lib


def bind_device_cavlc(lib: ctypes.CDLL) -> ctypes.CDLL:
    """The C signatures of the P-slice packer's entry points
    (csrc/device_cavlc.cu; its host build for the tests,
    csrc/device_cavlc_emu.cpp, has the same)."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.device_cavlc_scratch_bytes.argtypes = [ci, ci]
    lib.device_cavlc_scratch_bytes.restype = ctypes.c_longlong
    lib.device_cavlc_launch.argtypes = (
        [vp] * 7 + [ci, vp, ci, vp, vp, vp, ctypes.c_longlong, vp, vp, ci, ci,
                    vp])
    lib.device_cavlc_launch.restype = ci
    return lib


def error_string(err: int) -> str:
    return f"{err} ({load().media_cuda_error_string(err).decode()})"
