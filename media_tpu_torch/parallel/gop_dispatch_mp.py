"""Multi-PROCESS GOP dispatch: the cross-host embodiment of gop_dispatch.py.

The port of media_tpu/parallel/gop_dispatch_mp.py. The thread dispatcher
proves GOP independence inside one process; this module runs the same
scheduling across OS processes, each with its own interpreter and its own
CUDA context — the shape of a real multi-host fleet (one process per host,
no shared interpreter):

  * worker processes are spawned (never forked: CUDA cannot be forked),
  * when asked, they join a `torch.distributed` gloo process group over a
    127.0.0.1 coordinator — the control plane of a real deployment (rank 0
    holds the rendezvous; reference analog: the host-wide shared-memory
    resource pool, vendor/netint/ni_rsrc_api.h:92-96); nothing is sent over
    it,
  * the parent builds the CUDA kernels and the host C++ library once
    before spawning (the original pre-warmed a shared XLA compilation
    cache), so that the workers load them instead of each running the
    compilers,
  * every worker encodes one throwaway GOP before it reports ready (the
    CUDA graphs, caches and first-launch costs fall outside the measured
    window), and no work is enqueued before every worker is ready,
  * GOPs are claimed from a shared queue (least-load by arrival), encoded
    with a per-process EncoderSession, stitched in presentation order with
    idr_pic_id seeded by GOP index (spec 7.4.3),
  * the result is byte-identical to a sequential session (tests), and the
    report carries warm per-GOP walls so scaling efficiency is measured on
    compute, not start-up.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import time
from dataclasses import dataclass, field


@dataclass
class MpGopStats:
    gop_index: int
    n_frames: int
    worker: int
    compute_s: float
    bytes_out: int


@dataclass
class MpDispatchReport:
    wall_s: float
    warm_wall_s: float
    prewarm_s: float
    n_procs: int
    distributed: bool
    gops: list = field(default_factory=list)
    # Whole-frame deblocking kernel launches of the workers' measured GOPs
    # (ops/deblock_wave.py:deblock_wave.launches; 0 on the CPU).
    kernel_launches: int = 0
    # CAVLC packer kernel launches of the same GOPs
    # (entropy/device_cavlc.py:pack_pslice_device.launches; 0 on the CPU).
    pack_launches: int = 0
    # P-core kernel launches of the same GOPs
    # (pipeline/pframe_core.py:local_pframe_core.launches; 0 on the CPU).
    core_launches: int = 0
    # Intra wavefront calls (one an IDR) of the same GOPs, and the kernels
    # they enqueued, one a wave (pipeline/encoder.py:intra_encode.launches
    # and .kernel_launches; 0 on the CPU).
    intra_launches: int = 0
    intra_kernel_launches: int = 0
    # Deblocking meta kernel launches of the same GOPs, one a picture
    # (pipeline/deblock_apply.py:deblock_meta.launches; 0 on the CPU).
    meta_launches: int = 0

    @property
    def compute_s_total(self) -> float:
        return sum(g.compute_s for g in self.gops)

    @property
    def scaling_efficiency(self) -> float:
        """Warm compute spread over workers vs measured warm wall."""
        if not self.gops or self.warm_wall_s <= 0:
            return 0.0
        ideal = self.compute_s_total / self.n_procs
        return ideal / self.warm_wall_s


def _get_checked(q, procs, what: str, poll_s: float = 5.0):
    """q.get() that raises instead of hanging when a worker process dies
    without posting its 'done' sentinel (OOM kill, CUDA fault, exception
    before the queue write)."""
    import queue as _queue

    while True:
        try:
            return q.get(timeout=poll_s)
        except _queue.Empty:
            dead = [p for p in procs if not p.is_alive() and p.exitcode != 0]
            if dead:
                codes = [p.exitcode for p in dead]
                raise RuntimeError(
                    f"{what} process(es) died with exit codes {codes} "
                    "before completing")


def _worker_main(widx: int, n_procs: int, coord: str | None,
                 cfg_kwargs: dict, gop_queue, result_queue, device: str,
                 pin_cpus: bool = False):
    if pin_cpus:
        # Give each worker a disjoint core slice so N workers measure real
        # N-way parallelism instead of thrashing one threadpool's cores.
        try:
            ncpu = os.cpu_count() or 1
            per = max(1, ncpu // n_procs)
            cpus = set(range(widx * per, min(ncpu, (widx + 1) * per)))
            os.sched_setaffinity(0, cpus or {widx % ncpu})
        except OSError:
            pass
    import torch

    if torch.device(device).type == "cpu":
        # n processes each with a full intra-op pool would oversubscribe
        # the cores.
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // (2 * n_procs)))
    distributed = False
    if coord is not None:
        import datetime

        import torch.distributed as dist

        try:
            dist.init_process_group(
                "gloo", init_method=f"tcp://{coord}", world_size=n_procs,
                rank=widx, timeout=datetime.timedelta(seconds=120))
            distributed = True
        except Exception as e:  # run degrades to uncoordinated processes
            result_queue.put(("log", widx,
                              f"torch.distributed init failed: {e}"))

    import numpy as np

    from ..entropy.device_cavlc import pack_pslice_device
    from ..ops.deblock_wave import deblock_wave
    from ..pipeline.codec import EncoderConfig, EncoderSession
    from ..pipeline.deblock_apply import deblock_meta
    from ..pipeline.encoder import intra_encode
    from ..pipeline.pframe_core import local_pframe_core
    from ..utils import yuv

    session = EncoderSession(EncoderConfig(**cfg_kwargs), device=device)
    # Per-worker warmup BEFORE signalling ready: the first GOP of a process
    # builds the kernels' library handle, the CUDA graphs and the device
    # caches, and pays the first launches. A throwaway zero-frame GOP moves
    # that cost ahead of the measured window.
    cfg = session.cfg
    warm = yuv.pack_i420(
        np.zeros((cfg.height, cfg.width), np.uint8),
        np.zeros((cfg.height // 2, cfg.width // 2), np.uint8),
        np.zeros((cfg.height // 2, cfg.width // 2), np.uint8))
    # A full zero GOP runs the exact shapes real GOPs use (IDR + the
    # P-chunk sizes of this gop_size).
    session.encode_frames([warm] * max(2, min(cfg.gop_size, 64)))
    session.reset_gop_state(0)
    # Measured GOPs only.
    deblock_wave.launches = pack_pslice_device.launches = 0
    local_pframe_core.launches = intra_encode.launches = 0
    intra_encode.kernel_launches = deblock_meta.launches = 0
    result_queue.put(("ready", widx, distributed))
    while True:
        item = gop_queue.get()
        if item is None:
            break
        g, frames = item
        session.reset_gop_state(g)
        t0 = time.perf_counter()
        aus = session.encode_frames(frames)
        dt = time.perf_counter() - t0
        result_queue.put(("gop", widx, g, aus, dt))
    if distributed:
        dist.destroy_process_group()
    result_queue.put(("done", widx, deblock_wave.launches,
                      pack_pslice_device.launches, local_pframe_core.launches,
                      intra_encode.launches, intra_encode.kernel_launches,
                      deblock_meta.launches))


def dispatch_multiprocess(cfg_kwargs: dict, frames: list, gop_size: int,
                          n_procs: int = 2, use_distributed: bool = True,
                          prewarm: bool = True, pin_cpus: bool = False,
                          device: str = "cuda"):
    """Encode `frames` as GOP-parallel work across `n_procs` OS processes,
    each with an EncoderSession on `device` ("cuda" unless the caller
    passes another; raises without CUDA).

    Returns (aus in presentation order, MpDispatchReport). Every GOP is
    encoded from pristine session state (reset_gop_state), so CBR configs
    dispatch too: each GOP budgets its bitrate independently — the same
    semantics as the reference's per-stream sessions — and the result is
    byte-identical to a sequential session applying the same resets. A
    worker that dies makes this raise.
    """
    from ..device import resolve_device

    dev = resolve_device(device)
    gops = [frames[i : i + gop_size] for i in range(0, len(frames), gop_size)]

    prewarm_s = 0.0
    if prewarm and gops:
        # Build once here; every worker then loads the libraries instead of
        # running nvcc and g++ itself.
        from .. import kernels, native

        t0 = time.perf_counter()
        if dev.type == "cuda":
            kernels.build()
        native.build()
        prewarm_s = time.perf_counter() - t0

    ctx = mp.get_context("spawn")
    q_in = ctx.Queue()
    q_out = ctx.Queue()
    coord = None
    if use_distributed:
        import socket

        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        coord = f"127.0.0.1:{s.getsockname()[1]}"
        s.close()

    t_wall = time.perf_counter()
    procs = [
        ctx.Process(target=_worker_main,
                    args=(i, n_procs, coord, cfg_kwargs, q_in, q_out,
                          str(dev), pin_cpus))
        for i in range(n_procs)
    ]
    for p in procs:
        p.start()

    results: dict[int, list] = {}
    stats: list[MpGopStats] = []
    distributed = False
    launches = packs = cores = intras = intra_kernels = metas = 0
    ready = done = 0
    try:
        # Wait for EVERY worker's ready (post-warmup) before enqueueing any
        # work: otherwise the first-ready worker drains the whole queue while
        # the others are still warming, and "scaling" measures one process.
        while ready < n_procs:
            msg = _get_checked(q_out, procs, what="worker")
            if msg[0] == "ready":
                ready += 1
                distributed = distributed or bool(msg[2])
        t_warm0 = time.perf_counter()
        for g, gf in enumerate(gops):
            q_in.put((g, gf))
        for _ in procs:
            q_in.put(None)
        while done < n_procs:
            msg = _get_checked(q_out, procs, what="worker")
            if msg[0] == "gop":
                _, widx, g, aus, dt = msg
                results[g] = aus
                stats.append(MpGopStats(gop_index=g, n_frames=len(gops[g]),
                                        worker=widx, compute_s=dt,
                                        bytes_out=sum(len(a) for a in aus)))
            elif msg[0] == "done":
                done += 1
                launches += msg[2]
                packs += msg[3]
                cores += msg[4]
                intras += msg[5]
                intra_kernels += msg[6]
                metas += msg[7]
            elif msg[0] == "log":
                pass
        for p in procs:
            p.join()
    finally:
        for p in procs:  # alive here only when a wait above raised
            if p.is_alive():
                p.terminate()
    wall = time.perf_counter() - t_wall
    warm_wall = (time.perf_counter() - t_warm0) if t_warm0 else wall

    missing = [g for g in range(len(gops)) if g not in results]
    if missing:
        raise RuntimeError(f"GOPs not encoded: {missing}")
    out: list[bytes] = []
    for g in range(len(gops)):
        out.extend(results[g])
    report = MpDispatchReport(wall_s=wall, warm_wall_s=warm_wall,
                              prewarm_s=prewarm_s, n_procs=n_procs,
                              distributed=distributed,
                              gops=sorted(stats, key=lambda s: s.gop_index),
                              kernel_launches=launches, pack_launches=packs,
                              core_launches=cores, intra_launches=intras,
                              intra_kernel_launches=intra_kernels,
                              meta_launches=metas)
    return out, report
