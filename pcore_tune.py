"""Time the P-core kernel (media_tpu_torch/csrc/pframe_core.cu) in other
builds, on one CUDA card (an H100: the sources are for sm_90a):

    python3 pcore_tune.py [--variants 128:0,128:12,128:0:126]

A variant `t:b` is a copy of pframe_core.cu and pframe_core.cuh with the
block's threads set to t and the blocks an SM that __launch_bounds__ asks
registers for set to b (0 keeps the source's: 12 for the uint8 instance, 8
for the int32 one), compiled by nvcc into a library of its own under
csrc/build/tune_<hash>/, all compiles started together; `t:b:m` also leaves
out the work of the stages whose bits m sets (1 << k for stage k of
pframe_core.cuh's mb_pframe: 1 the plane loads, 2 the full-pel SADs, 3 the
half-pel windows, 4 the quarter-pel SADs, 5 the chroma MC, 6 the residual
coding, 7 the SAD total's atomic add), so that the time saved is those
stages' share; such a build's results are wrong. The copies are patched
here (PATCHES); the repo's sources hold no switch for them. Each variant
without skips is held to the plain version on chip_smoke's small grids at
every search range, and every variant is timed at 1080p (R 68, C 120,
rs 8, QP 30/29, chip_smoke's moving picture): the uint8 whole-picture entry
(the encoder's) and the search alone, each a CUDA graph of one call
(memset and kernel) replayed between one event pair, so that the time is
the device's alone, the inputs warm in L2; every variant twice, in turns
(first to last, then last to first). One line a variant: the uint8
instance's registers and resident blocks an SM, each instance's stack and
spills by ptxas, both times.

    python3 pcore_tune.py --sass

compiles small kernels of the packed-byte operations the kernel could use
(a SAD of 4 words by __vsadu4, by __vabsdiffu4 + __dp4a, by PTX
vabsdiff4.add; __vavgu4; a funnel shift; __reduce_min_sync) for sm_90a and
prints each one's SASS instructions by cuobjdump, loads and stores left out.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import os
import re
import subprocess

ROOT = os.path.dirname(os.path.abspath(__file__))

# (file, text, its replacement, the times the text occurs in the file).
THREADS = ("pframe_core.cu", "constexpr int kThreads = 128;",
           "constexpr int kThreads = {};", 1)
MIN_BLOCKS = ("pframe_core.cu", "return sizeof(Pix) == 1 ? 12 : 8;",
              "return {};", 1)


def _off(cond: str, n: int = 1):
    """A loop of mb_pframe whose condition is `cond`, run no times."""
    return ("pframe_core.cuh", cond, "false && " + cond, n)


# Stage k of mb_pframe -> the patches that leave its work out.
PATCHES = {
    1: [_off("p < 64; p += nt)\n    row_word"),
        _off("p < gm.rows * gm.words;"), _off("p < 32;")],
    2: [_off("p < K * gm.nq;"),
        ("pframe_core.cuh", "int best = kNoKey;", "int best = rs * K + rs;",
         1)],
    3: [_off("p < kB1Rows * kHp;"), _off("p < kHpPlane;")],
    4: [_off("it < 4 * 49;")],
    5: [_off("p < 128;")],
    6: [_off("it < 96;", 4), _off("comp < 2;")],
    7: [("pframe_core.cuh", "global_add(a.sad_total, cost);", ";", 1)],
}


def patched_sources(csrc: str, threads: int, min_blocks: int,
                    skip: int) -> dict:
    """{file name: text} of pframe_core.cu and .cuh for one variant."""
    texts = {}
    for name in ("pframe_core.cu", "pframe_core.cuh"):
        with open(os.path.join(csrc, name)) as f:
            texts[name] = f.read()
    patches = [(*THREADS[:2], THREADS[2].format(threads), THREADS[3])]
    if min_blocks:
        patches.append((*MIN_BLOCKS[:2], MIN_BLOCKS[2].format(min_blocks),
                        MIN_BLOCKS[3]))
    patches += [p for k, ps in PATCHES.items() if skip >> k & 1 for p in ps]
    for name, old, new, n in patches:
        if texts[name].count(old) != n:
            raise RuntimeError(f"{name}: {old!r} occurs "
                               f"{texts[name].count(old)} times, not {n}")
        texts[name] = texts[name].replace(old, new)
    return texts


def build_variants(variants) -> dict:
    """{(threads, min_blocks, skip): (library path, ptxas log)}."""
    from media_tpu_torch import kernels

    h = hashlib.sha256(" ".join(kernels.NVCC_FLAGS).encode())
    for name in ("pframe_core.cu", "pframe_core.cuh"):
        with open(os.path.join(kernels.CSRC, name), "rb") as f:
            h.update(f.read())
    out_dir = os.path.join(kernels.CSRC, "build", f"tune_{h.hexdigest()[:16]}")
    cmds, libs = [], {}
    for v in variants:
        vdir = os.path.join(out_dir, "{}_{}_{}".format(*v))
        os.makedirs(vdir, exist_ok=True)
        for name, text in patched_sources(kernels.CSRC, *v).items():
            with open(os.path.join(vdir, name), "w") as f:
                f.write(text)
        libs[v] = os.path.join(vdir, "libpcore.so")
        cmds.append([kernels._nvcc(), *kernels.NVCC_FLAGS, "-Xptxas", "-v",
                     "-shared", "-o", libs[v],
                     os.path.join(vdir, "pframe_core.cu")])
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    logs = [p.communicate()[0] for p in procs]
    for cmd, p, log in zip(cmds, procs, logs):
        if p.returncode:
            raise RuntimeError(f"nvcc failed:\n{' '.join(cmd)}\n{log}")
    return {v: (libs[v], log) for v, log in zip(variants, logs)}


SASS_PROBE = r"""
#define K(name, expr)                                                   \
  extern "C" __global__ void name(const unsigned* a, const unsigned* b, \
                                  const unsigned* c, unsigned* o) {     \
    const int i = threadIdx.x;                                          \
    o[i] = (expr);                                                      \
  }
K(sad16_vsadu4, c[i] + __vsadu4(a[i], b[i]) + __vsadu4(a[i + 1], b[i + 1])
  + __vsadu4(a[i + 2], b[i + 2]) + __vsadu4(a[i + 3], b[i + 3]))
K(sad16_dp4a, __dp4a(__vabsdiffu4(a[i + 3], b[i + 3]), 0x01010101u,
  __dp4a(__vabsdiffu4(a[i + 2], b[i + 2]), 0x01010101u,
  __dp4a(__vabsdiffu4(a[i + 1], b[i + 1]), 0x01010101u,
  __dp4a(__vabsdiffu4(a[i], b[i]), 0x01010101u, c[i])))))
K(avg4_vavgu4, __vavgu4(a[i], b[i]))
K(align4_funnel, __funnelshift_r(a[i], b[i], c[i]))
K(warp_min, (unsigned)__reduce_min_sync(0xffffffffu, (int)a[i]))
extern "C" __global__ void sad16_ptx(const unsigned* a, const unsigned* b,
                                     const unsigned* c, unsigned* o) {
  const int i = threadIdx.x;
  unsigned acc = c[i];
  for (int j = 0; j < 4; ++j)
    asm("vabsdiff4.u32.u32.u32.add %0, %1, %2, %0;"
        : "+r"(acc) : "r"(a[i + j]), "r"(b[i + j]));
  o[i] = acc;
}
"""


def sass_probe() -> None:
    """Print the SASS of SASS_PROBE's kernels, one line each."""
    from media_tpu_torch import kernels

    out_dir = os.path.join(kernels.CSRC, "build", "sass_probe")
    os.makedirs(out_dir, exist_ok=True)
    src, cubin = (os.path.join(out_dir, f) for f in ("probe.cu", "probe.cubin"))
    with open(src, "w") as f:
        f.write(SASS_PROBE)
    nvcc = kernels._nvcc()
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-O3",
                    "-cubin", "-o", cubin, src], check=True)
    sass = subprocess.run(
        [os.path.join(os.path.dirname(nvcc), "cuobjdump"), "-sass", cubin],
        check=True, capture_output=True, text=True).stdout
    skip = ("NOP", "BRA", "EXIT", "S2R", "LDC", "ULDC", "LDG", "STG", "MOV",
            "IMAD.WIDE", "IMAD.MOV", "IMAD.SHL", "LEA", "UMOV", "CS2R")
    for block in sass.split("Function : ")[1:]:
        name = block.split("\n")[0].strip()
        ops = [m.group(1).strip() for m in re.finditer(
            r"/\*[0-9a-f]{4}\*/\s+([^;]*);", block)]
        ops = [o for o in ops if not o.startswith(skip)]
        print(f"[pcore_tune] sass {name}: {len(ops)} instructions: "
              + " | ".join(ops))


def bind(path: str):
    """A variant's library with the C signatures of the package's."""
    from media_tpu_torch import kernels

    lib = kernels.bind_pframe_core(ctypes.CDLL(path))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.pframe_core_occupancy.argtypes = [ci, ci, vp]
    lib.pframe_core_occupancy.restype = ci
    return lib


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--variants", default="128:0,128:12,128:0:126")
    ap.add_argument("--sass", action="store_true")
    args = ap.parse_args()
    if args.sass:
        sass_probe()
        return
    import torch

    from chip_smoke import (PCORE_RANGES, _ptxas_spills, graph_ms,
                            pcore_planes, pcore_runs, pcore_whole_u8)
    from media_tpu_torch.pipeline import pframe_core as pc

    variants = [tuple(int(x) for x in (v + ":0").split(":")[:3])
                for v in args.variants.split(",")]
    dev = torch.device("cuda")
    built = build_variants(variants)
    libs = {v: bind(built[v][0]) for v in variants}
    R, C, rs, qp, qp_c = 68, 120, 8, 30, 29
    planes = [p.to(dev) for p in pcore_planes(R, C, rs, 21, "moving")]
    whole = pcore_whole_u8(planes, rs)
    cur = pc.to_mbs(planes[0], R, C, 16)
    runs = [(R_, C_, run) for R_, C_ in ((1, 1), (2, 3), (6, 9))
            for run in pcore_runs(R_, C_, dev, (8, 4) + PCORE_RANGES)]
    runs.append((R, C, ("1080p", planes, rs, qp, qp_c)))
    for v in variants:  # each held to the plain version first
        if v[2]:
            continue
        for R_, C_, (label, pl, rs_, q, qc) in runs:
            want = pc.local_pframe_core_plain(*pl, q, qc, rs_, R_, C_)
            got = pc.launch_pframe_core(*pl, q, qc, rs_, R_, C_, lib=libs[v])
            if not all(torch.equal(got[k], want[k]) for k in want):
                raise AssertionError(f"variant {v}: {label} differs")
    times = {v: [] for v in variants}
    for order in (variants, variants[::-1]):
        for v in order:
            times[v].append((
                graph_ms(lambda: pc.launch_pframe_core(
                    *whole, qp, qp_c, rs, R, C, whole=True, lib=libs[v])),
                graph_ms(lambda: pc.launch_search_refine_luma(
                    cur, planes[3], rs, R, C, lib=libs[v]))))
    for v in variants:
        res = pc.kernel_resources(rs, lib=libs[v])
        spill = [f"{'uint8' if 'IhE' in name else 'int32'} stack {st}, "
                 f"spill stores {ss}, loads {sl}" for name, (st, ss, sl)
                 in sorted(_ptxas_spills(built[v][1]).items())]
        core = ", ".join(f"{a:.4f}" for a, _ in times[v])
        search = ", ".join(f"{b:.4f}" for _, b in times[v])
        print(f"[pcore_tune] threads {v[0]} min_blocks "
              + (str(v[1]) if v[1] else "of the source")
              + (f" skip {v[2]:#x}" if v[2] else "") + ": "
              f"{res['registers']} registers, {res['blocks_per_sm']} "
              f"blocks an SM; ptxas bytes: {'; '.join(spill)}; uint8 "
              f"whole entry ms {core}; search alone ms "
              f"{search} (graph replays, 1080p rs 8)")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"[pcore_tune] {torch.cuda.get_device_name(0)} | {smi}")


if __name__ == "__main__":
    main()
