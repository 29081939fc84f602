"""GOP-parallel encoding over threads: the host-level scheduler.

The port of media_tpu/parallel/gop_dispatch.py. GOPs are independent by
construction — every GOP starts with an IDR that resets prediction state
and frame_num — so workers need share NOTHING to encode different GOPs
(SURVEY.md §2.3: "GOPs are distributed across hosts, embarrassingly
parallel at IDR boundaries"). This module is that claim as code: a
dispatcher that

  * splits the input into GOPs of cfg.gop_size frames,
  * assigns each GOP to a worker (its own EncoderSession on the device
    that the least-load DevicePool granted it — the ni_rsrc_allocate_auto
    analog, reference vendor/netint/ni_rsrc_api.h:343-348),
  * runs workers concurrently (a thread per worker; across processes the
    same scheduling is gop_dispatch_mp.py — nothing in the per-GOP work
    changes, because no data crosses GOP boundaries),
  * stitches AUs back in presentation order, seeding idr_pic_id with the
    GOP index so consecutive IDRs stay distinguishable (spec 7.4.3), and
  * accounts per-GOP compute seconds and bytes moved (frames in, AUs out)
    to make the scaling story quantitative.

With CQ rate control a dispatched encode is byte-identical to one
sequential session over the same frames (tests): per-GOP state is the only
state there is. Threads share one interpreter, so on a GPU they overlap
only where one waits on the device or in native code.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field

from ..device import resolve_device
from ..pipeline.codec import EncoderSession
from .sharding import DevicePool


@dataclass
class GopStats:
    gop_index: int
    n_frames: int
    worker: int
    compute_s: float
    bytes_in: int
    bytes_out: int


@dataclass
class DispatchReport:
    wall_s: float
    n_workers: int
    gops: list = field(default_factory=list)

    @property
    def compute_s_total(self) -> float:
        return sum(g.compute_s for g in self.gops)

    @property
    def bytes_in(self) -> int:
        return sum(g.bytes_in for g in self.gops)

    @property
    def bytes_out(self) -> int:
        return sum(g.bytes_out for g in self.gops)

    @property
    def busiest_worker_s(self) -> float:
        per = {}
        for g in self.gops:
            per[g.worker] = per.get(g.worker, 0.0) + g.compute_s
        return max(per.values()) if per else 0.0

    @property
    def dispatch_overhead(self) -> float:
        """Wall time beyond the busiest worker's compute, as a fraction —
        the scheduler/stitch cost the >=80% scaling target budgets for."""
        busy = self.busiest_worker_s
        return (self.wall_s - busy) / self.wall_s if self.wall_s > 0 else 0.0

    def to_json(self) -> dict:
        return {
            "wall_s": self.wall_s,
            "n_workers": self.n_workers,
            "n_gops": len(self.gops),
            "compute_s_total": self.compute_s_total,
            "busiest_worker_s": self.busiest_worker_s,
            "dispatch_overhead": self.dispatch_overhead,
            "bytes_in": self.bytes_in,
            "bytes_out": self.bytes_out,
            "per_gop": [
                {"gop": g.gop_index, "frames": g.n_frames,
                 "worker": g.worker, "compute_s": g.compute_s,
                 "bytes_out": g.bytes_out}
                for g in self.gops
            ],
        }


class GopDispatcher:
    """Schedule GOPs over `n_workers` encoder sessions.

    session_factory(cfg) -> session with encode_frames(frames) -> [AU] and
    an `idr_pic_id` attribute (EncoderSession or ShardedEncoderSession);
    without one, each worker builds EncoderSession(cfg, device=<the first
    device the pool granted it>). Each worker allocates its devices from
    the DevicePool at construction and releases them on close(): `pool`,
    else a pool of `device` repeated once per worker device ("cuda" unless
    the caller passes another; raises without CUDA).
    """

    def __init__(self, cfg, n_workers: int, session_factory=None,
                 pool: DevicePool | None = None,
                 devices_per_worker: int = 1, device="cuda"):
        self.cfg = cfg
        self.n_workers = n_workers
        if pool is None:
            pool = DevicePool([resolve_device(device)]
                              * (n_workers * devices_per_worker))
        self.pool = pool
        self._alloc = [
            self.pool.allocate(cfg.width, cfg.height, cfg.framerate,
                               devices_per_worker)
            for _ in range(n_workers)
        ]
        self._factory = session_factory
        self._report: DispatchReport | None = None

    def close(self) -> None:
        for sid, _devs in self._alloc:
            self.pool.release(sid)
        self._alloc = []

    @property
    def report(self) -> DispatchReport | None:
        return self._report

    def encode(self, frames) -> list[bytes]:
        """Encode frames GOP-parallel; returns AUs in presentation order."""
        cfg = self.cfg
        gops = [frames[i : i + cfg.gop_size]
                for i in range(0, len(frames), cfg.gop_size)]
        results: list = [None] * len(gops)
        stats: list = [None] * len(gops)
        next_gop = [0]
        lock = threading.Lock()
        t0 = time.perf_counter()

        def worker(widx: int) -> None:
            if self._factory is not None:
                session = self._factory(self.cfg)
            else:
                session = EncoderSession(self.cfg,
                                         device=self._alloc[widx][1][0])
            while True:
                with lock:
                    g = next_gop[0]
                    if g >= len(gops):
                        return
                    next_gop[0] += 1
                gop_frames = gops[g]
                # Consecutive IDRs must carry distinct idr_pic_id (7.4.3);
                # the GOP index provides a global, coordination-free seed.
                # Full pristine reset so CBR GOPs budget independently and
                # deterministically (codec.reset_gop_state).
                base = session.base if hasattr(session, "base") else session
                if hasattr(base, "reset_gop_state"):
                    base.reset_gop_state(g)
                else:
                    base.idr_pic_id = g & 0xFFFF
                    base.recon = None
                    base.frame_idx = 0
                t1 = time.perf_counter()
                aus = session.encode_frames(gop_frames)
                dt = time.perf_counter() - t1
                results[g] = aus
                stats[g] = GopStats(
                    gop_index=g, n_frames=len(gop_frames), worker=widx,
                    compute_s=dt,
                    bytes_in=sum(len(f) for f in gop_frames),
                    bytes_out=sum(len(a) for a in aus))

        errors: list = []

        def guarded(widx: int) -> None:
            try:
                worker(widx)
            except BaseException as e:  # surface, don't mask as a None slot
                with lock:
                    errors.append(e)

        threads = [threading.Thread(target=guarded, args=(i,))
                   for i in range(min(self.n_workers, len(gops)))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]
        wall = time.perf_counter() - t0
        self._report = DispatchReport(wall_s=wall, n_workers=self.n_workers,
                                      gops=[s for s in stats if s])
        out: list[bytes] = []
        for aus in results:
            out.extend(aus)
        return out
