"""Top-level encoder session: I420 frames in, Annex-B H.264 access units out.

PyTorch twin of media_tpu/pipeline/codec.py:EncoderSession, for every
EncoderConfig that one accepts: IDR (I_16x16, or the per-MB I_4x4 / I_16x16
decision) + P frames, one or several slices per picture, in-loop deblocking
across or within slices; CAVLC or CABAC; constant QP or the CBR rate loop on
the device (with per-MB QP under adaptive_qp); the IBPBP B-GOP; lossless
I_PCM. CBR + CABAC, the operating point of the reference, runs the device
loop on CAVLC bit counts and transcodes each slice to CABAC on the host
(native/); single-slice CABAC at constant QP takes the device pack and the
same transcode. The AU bytes equal the JAX package's for the same input.
The session runs on the GPU unless the caller passes device="cpu".
"""

from __future__ import annotations

import math
import os
import threading
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np
import torch

from .. import native
from ..core.bitstream import BitReader, BitWriter
from ..core.nal import H264NalType, wrap_nal
from ..core.syntax import (
    PPS, PROFILE_BY_NAME, SPS, SliceHeader, sei_recovery_point, sei_user_data,
    write_aud_rbsp, write_sei_rbsp)
from ..core.trace import span
from ..device import resolve_device
from ..entropy import cabac_slice
from ..entropy.device_cavlc import merge_slice_data
from ..utils import yuv
from . import slice_coder
from .encoder import FrameEncoder, stream_prefix_words
from .pframe_core import unpack_symbols


@dataclass
class EncoderConfig:
    """The JAX package's EncoderConfig fields and defaults (see
    media_tpu/pipeline/codec.py for their meaning)."""

    width: int = 1280
    height: int = 720
    qp: int = 28
    gop_size: int = 30
    level_idc: int = 40
    profile: str = "baseline"
    # Where P-slice entropy packing runs: "device", "host", or "auto"
    # (device on CUDA, host on CPU).
    entropy_mode: str = "auto"
    # "cq": constant QP (cfg.qp); "cbr": the on-device rate loop targeting
    # cfg.bitrate at cfg.framerate.
    rc_mode: str = "cq"
    bitrate: int = 5_000_000
    framerate: int = 30
    deblock: bool = True
    num_slices: int = 1
    deblock_across_slices: bool = True
    signal_timing: bool = True
    insert_aud: bool = False
    insert_sei: bool = False
    # CABAC entropy coding (forces main profile); composes with
    # rc_mode="cbr" and adaptive_qp.
    cabac: bool = False
    i4x4: bool = False
    cabac_init_idc: int = 0
    # Per-MB QP modulation (mb_qp_delta) under CBR.
    adaptive_qp: bool = False
    b_frames: int = 0
    lossless: bool = False


class _PinnedRing:
    """Two pinned host buffers of one dtype, handed out in turn, each grown
    only when a request is larger than what it holds."""

    def __init__(self, dtype):
        self._dtype = dtype
        self._bufs = [None, None]
        self._next = 0

    def take(self, n: int) -> torch.Tensor:
        i = self._next
        self._next ^= 1
        buf = self._bufs[i]
        if buf is None or buf.numel() < n:
            buf = self._bufs[i] = torch.empty(n, dtype=self._dtype,
                                              pin_memory=True)
        return buf


def wait_for_chunk(done) -> None:
    """Wait for a staged P chunk's completion event. Counts the chunk in
    `wait_for_chunk.ready` where the event had fired when its finisher
    began (the host set the pace), else in `wait_for_chunk.waited` (the
    device did)."""
    ready = done.query()
    with _COUNT_LOCK:  # sessions in several threads call it
        if ready:
            wait_for_chunk.ready += 1
        else:
            wait_for_chunk.waited += 1
    if not ready:
        done.synchronize()


wait_for_chunk.ready = 0
wait_for_chunk.waited = 0
_COUNT_LOCK = threading.Lock()


def _slice_bytes(stream_words) -> bytes:
    """A device CAVLC pack's 32-bit words as the slice's bytes."""
    return np.asarray(stream_words, dtype=np.uint32).byteswap().tobytes()


def _transcode_workers(k: int) -> int:
    """Host threads for the C++ transcodes of a chunk of k slices: one a
    slice, at most one a CPU this process may run on."""
    return min(k, len(os.sched_getaffinity(0)))


_POOL = None
_POOL_LOCK = threading.Lock()


def _transcode_pool() -> ThreadPoolExecutor:
    """The process's pool of transcode threads, made at its first use with
    one thread a CPU the process may run on; sessions in several threads
    share it."""
    global _POOL
    with _POOL_LOCK:
        if _POOL is None:
            _POOL = ThreadPoolExecutor(len(os.sched_getaffinity(0)),
                                       thread_name_prefix="transcode")
        return _POOL


def transcode_chunk(slices, R: int, C: int, cabac_init_idc: int):
    """Start the C++ CAVLC -> CABAC transcodes of a chunk's P slices, each
    (stream_words, total_bits, qp), on the process's pool of host threads:
    every slice is handed over before any is awaited, and the routine
    releases the GIL. Returns one Future a slice, in order, whose result is
    the payload or None (the routine refused the slice); where the chunk
    gets one worker (`_transcode_workers`), None a slice instead, and the
    caller transcodes each on its own thread. Counts the slices in
    `transcode_chunk.pooled` or `transcode_chunk.inline`."""
    k = len(slices)
    pooled = _transcode_workers(k) > 1
    with _COUNT_LOCK:
        if pooled:
            transcode_chunk.pooled += k
        else:
            transcode_chunk.inline += k
    if not pooled:
        return [None] * k
    native.load()  # built and bound here, not by k threads at once
    pool = _transcode_pool()
    return [pool.submit(native.transcode_pslice_native, _slice_bytes(w),
                        int(nbits), 0, R, C, int(qp),
                        cabac_init_idc=cabac_init_idc)
            for w, nbits, qp in slices]


transcode_chunk.pooled = 0
transcode_chunk.inline = 0


def _check_supported(cfg: EncoderConfig) -> None:
    if cfg.entropy_mode not in ("auto", "device", "host"):
        raise ValueError(f"entropy_mode {cfg.entropy_mode!r}")
    if cfg.rc_mode not in ("cq", "cbr"):
        raise ValueError(f"rc_mode {cfg.rc_mode!r}")


class EncoderSession:
    """Stateful H.264 encoder on one torch device: IDR + P-frame GOPs at a
    constant QP or under CBR rate control, IBPBP GOPs with b_frames=1, or
    all-I_PCM pictures with lossless (those are assembled on the host and
    touch no device).

    host_coder: "native" (the C++ slice writers and the transcoder of
    native/, the default) or "python" (the Python coders that are their
    oracle; for tests)."""

    # P-run pipeline chunk size (frames per device batch).
    PIPELINE_CHUNK = 4

    def __init__(self, cfg: EncoderConfig, device="cuda",
                 host_coder: str = "native"):
        _check_supported(cfg)
        if host_coder not in ("native", "python"):
            raise ValueError(f"host_coder {host_coder!r} (expected 'native' "
                             "or 'python')")
        self._native = host_coder == "native"
        self.device = resolve_device(device)
        self.cfg = cfg
        if cfg.lossless:
            cfg.deblock = False
            cfg.cabac = False
            cfg.rc_mode = "cq"
        if cfg.b_frames:
            if cfg.cabac or cfg.rc_mode != "cq" or cfg.num_slices != 1:
                raise ValueError(
                    "b_frames requires CAVLC, rc_mode='cq', single slice")
            # Display order != coding order: POC type 2 is forbidden with
            # reordering (spec 8.2.1); carry display order as POC type 0.
            self.sps = SPS.for_size(cfg.width, cfg.height,
                                    level_idc=cfg.level_idc,
                                    pic_order_cnt_type=0,
                                    log2_max_pic_order_cnt_lsb=16,
                                    max_num_ref_frames=2)
        else:
            self.sps = SPS.for_size(cfg.width, cfg.height,
                                    level_idc=cfg.level_idc)
        if cfg.signal_timing and cfg.framerate > 0:
            self.sps.vui_timing = (1, 2 * cfg.framerate)
        self.pps = PPS(pic_init_qp=cfg.qp, deblocking_filter_control_present=True)
        if cfg.cabac:
            # CABAC needs >= main profile; the baseline constraint flag off.
            self.sps.profile_idc = max(self.sps.profile_idc,
                                       PROFILE_BY_NAME["main"])
            self.pps.entropy_coding_mode = 1
        self._pad_w = self.sps.pic_width_in_mbs * 16
        self._pad_h = self.sps.pic_height_in_mbs * 16
        n_rows = self.sps.pic_height_in_mbs
        ns = max(1, min(cfg.num_slices, n_rows))
        bounds = [round(i * n_rows / ns) for i in range(ns + 1)]
        # (first MB row, end MB row) of each slice
        self.slice_rows = [(bounds[i], bounds[i + 1]) for i in range(ns)
                           if bounds[i] < bounds[i + 1]]
        starts = tuple(r0 for r0, _ in self.slice_rows[1:])
        self._frame_encoder = FrameEncoder(self._pad_w, self._pad_h,
                                           self.device, slice_rows=starts)
        across = cfg.deblock_across_slices or len(self.slice_rows) == 1
        if not across:
            self._frame_encoder.deblock_slice_starts = starts
        # disable_deblocking_filter_idc: 0 filters every edge, 1 none, 2
        # none across slice boundaries.
        self._deblock_idc = (0 if across else 2) if cfg.deblock else 1
        self.frame_idx = 0
        self.frame_idx_of_idr = 0
        self.idr_pic_id = 0
        self._force_idr = False
        self.recon = None  # (y, u, v) uint8 reference planes on the device
        # High-water-mark of per-frame slice_data bits, for right-sizing the
        # device stream buffer.
        self._bits_hwm: int | None = None
        # The packed P path's downloads on CUDA (_dispatch_packed): pinned
        # rings for the bit counts and the int64 stream words, and a side
        # stream for the words, made at the first chunk.
        self._pinned_bits = _PinnedRing(torch.int64)
        self._pinned_words = _PinnedRing(torch.int64)
        self._copy_stream = None
        # CBR state: virtual buffer + complexity model (bits*qstep EWMA).
        target = cfg.bitrate / max(cfg.framerate, 1)
        self._rc_target = target
        self.rc_state = {
            "qp": float(cfg.qp),
            "buf": 0.0,
            "cplx": target * 0.625 * 2 ** (cfg.qp / 6.0),
        }
        # CABAC-CBR batch state: the device rate loop runs on CAVLC bit
        # counts scaled by the running CABAC/CAVLC ratio; the host corrects
        # the virtual buffer with exact AU sizes one chunk later.
        self._rc_dev = None   # (qp_f, buf, cplx) 0-d tensors on the device
        self._rc_corr = 0.0   # pending actual-minus-estimated bits
        self._cabac_scale = 0.92
        # B-GOP state: display index since the IDR and the next reference
        # picture's frame_num (B pictures are non-reference; their
        # frame_num is PrevRefFrameNum + 1, spec 7.4.3).
        self._display_since_idr: int | None = None
        self._ref_frame_num = 1
        self._rc_init = dict(self.rc_state)

    def reset_gop_state(self, idr_pic_id: int = 0) -> None:
        """Return to a pristine GOP boundary: the next frame is an IDR and
        the reference planes, the rate control and the stream-cap
        high-water-mark return to their initial values."""
        self.recon = None
        self.frame_idx = 0
        self.idr_pic_id = idr_pic_id & 0xFFFF
        self._force_idr = False
        self._bits_hwm = None
        self.rc_state = dict(self._rc_init)
        self._rc_dev = None
        self._rc_corr = 0.0
        self._cabac_scale = 0.92
        self._display_since_idr = None
        self._ref_frame_num = 1

    def force_keyframe(self) -> None:
        self._force_idr = True

    def load_reference_state(self, state: dict) -> None:
        """Continue a GOP that another session (e.g. the JAX package's)
        started: state holds numpy "recon" (y, u, v) planes and the
        counters "frame_idx", "frame_idx_of_idr", "idr_pic_id" and
        "_bits_hwm"; for a CBR session also the rate controller: "rc_state"
        ({"qp", "buf", "cplx"} floats), "_rc_corr", "_cabac_scale" and
        "_rc_dev" (None, or the three float32 values of the device carry);
        for a B-GOP session also "_display_since_idr" and "_ref_frame_num"."""
        self.recon = tuple(
            torch.tensor(np.asarray(p, dtype=np.uint8), device=self.device)
            for p in state["recon"])
        self.frame_idx = int(state["frame_idx"])
        self.frame_idx_of_idr = int(state["frame_idx_of_idr"])
        self.idr_pic_id = int(state["idr_pic_id"])
        hwm = state["_bits_hwm"]
        self._bits_hwm = None if hwm is None else int(hwm)
        self._force_idr = False
        if "rc_state" in state:
            self.rc_state = {k: float(state["rc_state"][k])
                             for k in ("qp", "buf", "cplx")}
        self._rc_corr = float(state.get("_rc_corr", 0.0))
        self._cabac_scale = float(state.get("_cabac_scale", 0.92))
        rc_dev = state.get("_rc_dev")
        self._rc_dev = None if rc_dev is None else tuple(
            torch.tensor(np.float32(x), device=self.device) for x in rc_dev)
        if "_display_since_idr" in state:
            d = state["_display_since_idr"]
            self._display_since_idr = None if d is None else int(d)
            self._ref_frame_num = int(state["_ref_frame_num"])

    def _device_cap(self) -> int:
        """Per-frame device stream buffer size in words: a power of two at
        >= 4x the recent high-water-mark of frame bits (min 64 KiB), capped
        at the worst-case budget; overflow retries at the full budget."""
        full = self._frame_encoder.cap_words
        if self._bits_hwm is None:
            return full
        want = (self._bits_hwm * 4) // 32
        cap = 16384
        while cap < want:
            cap *= 2
        return min(cap, full)

    def _note_bits(self, max_bits: int) -> None:
        """Track the per-frame bits high-water-mark (10% decay)."""
        hwm = self._bits_hwm
        self._bits_hwm = (max_bits if hwm is None
                          else max(max_bits, int(hwm * 0.9)))

    def _planes(self, i420):
        cfg = self.cfg
        y, u, v = yuv.split_i420(i420, cfg.width, cfg.height)
        return (yuv.pad_to_mb_grid(y, 16), yuv.pad_to_mb_grid(u, 8),
                yuv.pad_to_mb_grid(v, 8))

    def _idr_due(self) -> bool:
        return (self.frame_idx % self.cfg.gop_size == 0 or self._force_idr
                or self.recon is None)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def encode_frame(self, i420) -> bytes:
        """Encode one I420 frame; returns the Annex-B bytes of its AU."""
        y, u, v = self._planes(i420)
        if self.cfg.lossless:
            data = self._encode_ipcm(y, u, v)
            self.frame_idx += 1
            return data
        if self.cfg.b_frames:
            # Single-frame call in B mode: encode as an anchor (no B can be
            # inserted without lookahead); counters stay consistent.
            return self._encode_frames_bgop([(y, u, v)])[0]
        is_idr = self._idr_due()
        self._force_idr = False
        if is_idr:
            data = self._encode_idr(y, u, v)
        else:
            data = self._encode_p(y, u, v)
        self.frame_idx += 1
        return data

    def upload_frames(self, i420_frames) -> list:
        """Pre-stage a run of P frames on the device as PIPELINE_CHUNK-sized
        batches and wait until the copies land. Returns an opaque chunk
        list for encode_frames_staged."""
        planes = [self._planes(buf) for buf in i420_frames]
        chunks = []
        for i in range(0, len(planes), self.PIPELINE_CHUNK):
            chunks.append(self._stack(planes[i : i + self.PIPELINE_CHUNK]))
        self._sync()
        return chunks

    @staticmethod
    def _stack_host(run):
        """A run of (y, u, v) planes as three (K, H, W) host stacks."""
        return [np.stack([p[j] for p in run]) for j in range(3)]

    def _stack(self, run):
        """A run of planes as one chunk: the three stacks on the device,
        the same three on the host, and the frame count."""
        host = self._stack_host(run)
        dev = [torch.as_tensor(h).to(self.device) for h in host]
        return (*dev, *host, len(run))

    def encode_frames_staged(self, chunks) -> list[bytes]:
        """Encode P-frame chunks pre-staged by upload_frames. The bitstream
        equals encode_frames' on the same frames. The session must be
        mid-GOP (a reference exists and no IDR falls inside the run), and
        its configuration single-slice, at constant QP (CAVLC, or CABAC
        transcoded from the device's CAVLC pack) or CABAC under CBR."""
        cfg = self.cfg
        if self.recon is None:
            raise RuntimeError("encode_frames_staged needs a reference frame "
                               "(encode an IDR first)")
        n_frames = sum(ch[6] for ch in chunks)
        until_idr = cfg.gop_size - (self.frame_idx % cfg.gop_size)
        if self._force_idr or n_frames > until_idr:
            raise RuntimeError("IDR due inside a staged run; use encode_frames")
        cbr_cabac = cfg.cabac and cfg.rc_mode == "cbr"
        if not (len(self.slice_rows) == 1
                and (cfg.rc_mode == "cq" or cbr_cabac)):
            raise RuntimeError(
                "staged path requires single-slice CAVLC-CQ or CABAC-CBR "
                "or CABAC-CQ")
        out: list[bytes] = []
        pending: list = []
        for ys_d, us_d, vs_d, ys, us, vs, k in chunks:
            if cbr_cabac:
                pending.append(self._dispatch_cbr_cabac_chunk(
                    ys_d, us_d, vs_d, k))
            else:
                pending.append(self._dispatch_packed(ys_d, us_d, vs_d, ys,
                                                     us, vs, k))
            while len(pending) > 1:  # depth-2 pipeline
                out.extend(pending.pop(0)())
        while pending:
            out.extend(pending.pop(0)())
        return out

    def encode_frames(self, i420_frames) -> list[bytes]:
        """Encode a sequence of frames, batching runs of P frames into
        chunked device dispatches; the host assembles chunk i-1's AUs after
        chunk i is dispatched. Same bitstream as repeated encode_frame
        calls at constant QP (under CBR the rate feedback follows the
        batching, as in the JAX package). Returns one Annex-B AU per input
        frame."""
        cfg = self.cfg
        if cfg.lossless:
            return [self.encode_frame(b) for b in i420_frames]
        planes = [self._planes(buf) for buf in i420_frames]
        if cfg.b_frames:
            return self._encode_frames_bgop(planes)
        out: list[bytes] = []
        pending: list = []  # deferred AU builders, in output order

        def drain(n: int) -> None:
            while len(pending) > n:
                out.extend(pending.pop(0)())

        i = 0
        while i < len(planes):
            if self._idr_due():
                drain(0)  # preserve AU order around the IDR
                self._force_idr = False
                out.append(self._encode_idr(*planes[i]))
                self.frame_idx += 1
                i += 1
                continue
            until_idr = cfg.gop_size - (self.frame_idx % cfg.gop_size)
            k = min(len(planes) - i, until_idr)
            if (cfg.rc_mode == "cbr" and cfg.cabac
                    and len(self.slice_rows) != 1):
                # Multi-slice CABAC CBR: the per-frame exact host loop.
                drain(0)
                for j in range(k):
                    out.append(self._encode_p_cbr_cabac(*planes[i + j]))
                    self.frame_idx += 1
                i += k
                continue
            if cfg.rc_mode == "cbr" and cfg.cabac:
                # CABAC CBR, pipelined: the device loop runs rate control
                # on its own CAVLC pack's bit counts x the running
                # CABAC/CAVLC ratio (no host read per frame) and only the
                # packed CAVLC streams are downloaded; the C++ transcoder
                # re-emits each slice as CABAC on the host while the next
                # chunk computes. Exact AU sizes correct the virtual buffer
                # one chunk later.
                k = min(k, self.PIPELINE_CHUNK)
                ys_d, us_d, vs_d = self._stack(planes[i : i + k])[:3]
                pending.append(self._dispatch_cbr_cabac_chunk(
                    ys_d, us_d, vs_d, k))
                drain(1)
                i += k
                continue
            if cfg.rc_mode == "cbr":
                drain(0)
                ys, us, vs = self._stack_host(planes[i : i + k])
                out.extend(self._encode_p_run_cbr(ys, us, vs, k))
                i += k
                continue
            use_device = (cfg.entropy_mode == "device"
                          or (cfg.entropy_mode == "auto"
                              and self.device.type != "cpu")) and (
                                  len(self.slice_rows) == 1)
            # (the device packer codes one CAVLC slice per frame; with
            # CABAC the finisher transcodes it)
            if not use_device:
                drain(0)
                host = self._stack_host(planes[i : i + k])
                symbols, self.recon = self._frame_encoder.encode_pframes_batch(
                    *host, *self.recon, cfg.qp, deblock=cfg.deblock)
                for j in range(k):
                    out.append(self._pslice_au(unpack_symbols(symbols[j])))
                    self.frame_idx += 1
                i += k
                continue
            k = min(k, self.PIPELINE_CHUNK)
            pending.append(self._dispatch_packed(
                *self._stack(planes[i : i + k])))
            drain(1)  # depth-2 pipeline: keep one chunk in flight
            i += k
        drain(0)
        return out

    def _dispatch_packed(self, ys_d, us_d, vs_d, ys, us, vs, k: int):
        """Dispatch one P chunk with on-device packing; returns the deferred
        finisher that downloads the streams and assembles the AUs (with
        CABAC, each transcoded from its CAVLC pack).

        On CUDA the chunk's bit counts are copied to pinned memory behind
        its launches and an event recorded after them, so the finisher,
        which runs after the next chunk's dispatch, waits for this chunk
        alone, and its stream words come down on a side stream while the
        device runs the next chunk."""
        cfg = self.cfg
        enc = self._frame_encoder
        prev_recon = self.recon
        cap = self._device_cap()
        cuda = self.device.type == "cuda"
        with span("enc.p.dispatch"):
            streams_d, bits_d, recon = enc.encode_pframes_packed_dev(
                ys_d, us_d, vs_d, prev_recon, cfg.qp, deblock=cfg.deblock,
                cap=cap)
            if cuda:
                if self._copy_stream is None:
                    self._copy_stream = torch.cuda.Stream(self.device)
                # Chunk i's slots come back to chunk i+2, whose dispatch
                # follows chunk i's finisher (depth-2 pipeline).
                bits_h = self._pinned_bits.take(k)[:k]
                words_h = self._pinned_words.take(k * cap)
                bits_h.copy_(bits_d, non_blocking=True)
                done = torch.cuda.Event()
                done.record(torch.cuda.current_stream(self.device))
        self.recon = tuple(recon)
        frame_base = self.frame_idx
        self.frame_idx += k

        def download():
            """The bit counts and, within the cap, the used stream words
            as uint32 on the host (None past the cap)."""
            if cuda:
                wait_for_chunk(done)
                bits = bits_h.numpy()
            else:
                bits = bits_d.cpu().numpy()
            if int(bits.max()) > cap * 32:
                return bits, None
            nw = stream_prefix_words(int(bits.max()), cap)
            if not cuda:
                return bits, streams_d[:, :nw].cpu().numpy().astype(
                    np.uint32)
            words = words_h[: k * nw].view(k, nw)
            copy = self._copy_stream
            copy.wait_event(done)
            streams_d.record_stream(copy)
            with torch.cuda.stream(copy):
                words.copy_(streams_d[:, :nw], non_blocking=True)
            copied = torch.cuda.Event()
            copied.record(copy)
            copied.synchronize()
            return bits, words.numpy().astype(np.uint32)

        def finish() -> list[bytes]:
            with span("enc.p.finish"):
                with span("enc.p.download"):
                    bits, streams_np = download()
                cap_eff = cap
                if streams_np is None and cap < enc.cap_words:
                    # Adaptive cap overflowed: retry on the device at the
                    # full budget (the bitstream is identical; only the
                    # buffer size differs).
                    streams_np, bits, _recon = enc.encode_pframes_packed(
                        ys, us, vs, *prev_recon, cfg.qp, deblock=cfg.deblock,
                        cap=enc.cap_words)
                    cap_eff = enc.cap_words
                self._note_bits(int(bits.max()))
                if int(bits.max()) <= cap_eff * 32:
                    with span("enc.p.assemble"):
                        if cfg.cabac:
                            return self._cabac_aus_from_cavlc_chunk(
                                [(streams_np[j], int(bits[j]), cfg.qp,
                                  frame_base + j) for j in range(k)])
                        return [self._pslice_au_packed(
                            streams_np[j], int(bits[j]),
                            frame_idx=frame_base + j) for j in range(k)]
                # Rare overflow (bits above the device stream budget): re-run
                # for symbols and pack on the host. Recon is unaffected.
                symbols, _recon = enc.encode_pframes_batch(
                    ys, us, vs, *prev_recon, cfg.qp, deblock=cfg.deblock)
                return [self._pslice_au(unpack_symbols(symbols[j]),
                                        frame_idx=frame_base + j)
                        for j in range(k)]

        return finish

    def _dispatch_cbr_cabac_chunk(self, ys_d, us_d, vs_d, k: int):
        """Dispatch one CBR+CABAC P chunk; returns the deferred finisher.

        Device: CBR loop + CAVLC pack (rate feedback = CAVLC bits x the
        running CABAC/CAVLC ratio). Host (in the finisher, after the next
        chunk is dispatched): download the packed streams, transcode each
        slice CAVLC -> CABAC in C++, correct the virtual buffer with the
        exact AU sizes."""
        cfg = self.cfg
        enc = self._frame_encoder
        prev_recon = self.recon
        if self._rc_dev is not None:
            rc_in = {"qp": self._rc_dev[0],
                     "buf": self._rc_dev[1] + self._rc_corr,
                     "cplx": self._rc_dev[2]}
            self._rc_corr = 0.0
        else:
            rc_in = self.rc_state
        scale_used = self._cabac_scale
        cap = self._device_cap()

        def run(cap_words):
            return enc.encode_pframes_cbr_dev(
                ys_d, us_d, vs_d, prev_recon, rc_in, int(self._rc_target),
                bits_scale=scale_used, deblock=cfg.deblock,
                adaptive_qp=cfg.adaptive_qp, cap=cap_words)

        first = run(cap)
        self.recon = tuple(first[3])
        self._rc_dev = first[4]
        frame_base = self.frame_idx
        self.frame_idx += k

        def finish() -> list[bytes]:
            streams_d, bits_d, qps_d, _recon, new_rc = first
            bits = bits_d.cpu().numpy()
            cap_eff = cap
            if int(bits.max()) > cap * 32 and cap < enc.cap_words:
                # Adaptive stream cap overflowed: retry at the full budget
                # (same rc inputs => identical QPs and streams).
                streams_d, bits_d, qps_d, recon2, new_rc = run(enc.cap_words)
                self.recon = tuple(recon2)
                self._rc_dev = new_rc
                bits = bits_d.cpu().numpy()
                cap_eff = enc.cap_words
            qps = qps_d.cpu().numpy()
            self._note_bits(int(bits.max()))
            nw = stream_prefix_words(int(bits.max()), cap_eff)
            # The device words are int64 holding 32-bit values: uint32 once,
            # here, before the transcoder's byte swap.
            streams = streams_d[:, :nw].cpu().numpy().astype(np.uint32)
            aus = self._cabac_aus_from_cavlc_chunk(
                [(streams[j], int(bits[j]), int(qps[j]), frame_base + j)
                 for j in range(k)])
            ratios = []
            for j, au in enumerate(aus):
                actual = len(au) * 8
                est = float(bits[j]) * scale_used
                self._rc_corr += actual - est
                if bits[j] > 0:
                    ratios.append(actual / float(bits[j]))
            if ratios:
                r = float(np.mean(ratios))
                self._cabac_scale = min(max(
                    0.7 * self._cabac_scale + 0.3 * r, 0.6), 1.3)
            # Refresh the host-visible rc mirror (IDR budgeting and the
            # single-frame path read it).
            self.rc_state = {
                "qp": float(new_rc[0]),
                "buf": float(new_rc[1]) + self._rc_corr,
                "cplx": float(new_rc[2]),
            }
            return aus

        return finish

    def _cabac_aus_from_cavlc_chunk(self, rows) -> list[bytes]:
        """A chunk's CABAC P-slice AUs, in frame order, from its device
        CAVLC packs; rows: (stream_words, total_bits, qp, frame_idx) a
        frame. The C++ transcodes run side by side on the process's pool
        (transcode_chunk); each AU is then built here, one after another,
        as _cabac_au_from_cavlc_stream builds it from its slice's payload:
        the bytes of one call a row."""
        pending = [None] * len(rows)
        if self._native:
            R = self.slice_rows[0][1] - self.slice_rows[0][0]
            pending = transcode_chunk([row[:3] for row in rows], R,
                                      self.sps.pic_width_in_mbs,
                                      self.cfg.cabac_init_idc)
        return [self._cabac_au_from_cavlc_stream(*row, transcoded=fut)
                for row, fut in zip(rows, pending)]

    def _cabac_au_from_cavlc_stream(self, stream_words, total_bits: int,
                                    qp: int, frame_idx: int,
                                    transcoded=None) -> bytes:
        """One CABAC P-slice AU from a device CAVLC pack: the C++
        transcoder's payload (awaited from `transcoded`, the slice's Future
        from transcode_chunk, or computed here without one), or the Python
        parse + recode where it refuses the slice."""
        from .decoder_tpu import parse_pslice_symbols

        R = self.slice_rows[0][1] - self.slice_rows[0][0]
        C = self.sps.pic_width_in_mbs
        with span("enc.p.transcode"):
            payload = None
            if transcoded is not None:
                payload = transcoded.result()
            elif self._native:
                payload = native.transcode_pslice_native(
                    _slice_bytes(stream_words), total_bits, 0, R, C, qp,
                    cabac_init_idc=self.cfg.cabac_init_idc)
            if payload is None:
                sym = parse_pslice_symbols(BitReader(_slice_bytes(
                    stream_words)), R, C, slice_qp=qp)
                payload = cabac_slice.write_pslice_cabac(
                    sym["mv"], sym["luma_levels"], sym["cdc_levels"],
                    sym["cac_levels"], qp,
                    cabac_init_idc=self.cfg.cabac_init_idc,
                    qp_map=sym["qp_map"])
        bw = self._pslice_header_writer(qp, frame_idx=frame_idx)
        while not bw.byte_aligned():
            bw.u(1, 1)  # cabac_alignment_one_bit (7.3.4)
        return self._aud(primary_pic_type=1) + wrap_nal(
            H264NalType.SLICE, bw.get_bytes() + payload, nal_ref_idc=2)

    def _encode_p_run_cbr(self, ys, us, vs, k: int) -> list[bytes]:
        """CBR with CAVLC: one rate-controlled device batch; the QP of each
        frame rides in its slice header."""
        cfg = self.cfg
        self._rc_dev = None
        self._rc_corr = 0.0
        enc = self._frame_encoder
        cap = self._device_cap()

        def run(cap_words):
            return enc.encode_pframes_cbr(
                ys, us, vs, *self.recon, self.rc_state, int(self._rc_target),
                deblock=cfg.deblock, adaptive_qp=cfg.adaptive_qp,
                cap=cap_words)

        streams, bits, qps, recon, new_state = run(cap)
        if int(bits.max()) > cap * 32 and cap < enc.cap_words:
            # Adaptive stream cap overflowed: retry at the full budget
            # (identical result; only the buffer size differs).
            streams, bits, qps, recon, new_state = run(enc.cap_words)
        self._note_bits(int(bits.max()))
        out = []
        if len(self.slice_rows) == 1 and int(bits.max()) <= enc.cap_words * 32:
            self.recon = tuple(recon)
            self.rc_state = new_state
            for j in range(k):
                out.append(self._pslice_au_packed(streams[j], int(bits[j]),
                                                  qp=int(qps[j])))
                self.frame_idx += 1
        else:
            # Several slices, or the device bit budget exceeded: host entropy
            # at the mean chosen QP.
            qp = int(np.round(qps.mean()))
            symbols, self.recon = enc.encode_pframes_batch(
                ys, us, vs, *self.recon, qp, deblock=cfg.deblock)
            self.rc_state["qp"] = float(qp)
            for j in range(k):
                au = self._pslice_au(unpack_symbols(symbols[j]), qp=qp)
                self.rc_state["buf"] += len(au) * 8 - self._rc_target
                out.append(au)
                self.frame_idx += 1
        return out

    def _encode_p_cbr_cabac(self, y, u, v, qp_min: int = 12,
                            qp_max: int = 44) -> bytes:
        """One CBR P frame with CABAC entropy: the same virtual-buffer /
        complexity model as the device loop, but in host floats and
        integrating the exact CABAC AU size."""
        cfg = self.cfg
        # Host-exact path: the float mirror is current (callers drain the
        # batch pipeline first); drop any device-side rc carry.
        self._rc_dev = None
        self._rc_corr = 0.0
        st = self.rc_state
        target = self._rc_target
        adj_target = max(target - 0.35 * st["buf"], 0.25 * target)
        want_qstep = min(max(st["cplx"] / adj_target, 0.625), 1024.0)
        qp_f = min(max(6.0 * math.log2(want_qstep / 0.625), qp_min), qp_max)
        qp = int(round(qp_f))
        symbols, self.recon = self._frame_encoder.encode_pframes_batch(
            y[None], u[None], v[None], *self.recon, qp, deblock=cfg.deblock)
        au = self._pslice_au(unpack_symbols(symbols[0]), qp=qp)
        bits = len(au) * 8
        st["cplx"] = 0.75 * st["cplx"] + 0.25 * bits * (
            0.625 * 2.0 ** (qp_f / 6.0))
        st["buf"] += bits - target
        st["qp"] = qp_f
        return au

    def _encode_p(self, y, u, v) -> bytes:
        cfg = self.cfg
        if cfg.rc_mode == "cbr" and cfg.cabac:
            return self._encode_p_cbr_cabac(y, u, v)
        if cfg.rc_mode == "cbr":
            aus = self._encode_p_run_cbr(y[None], u[None], v[None], 1)
            self.frame_idx -= 1  # the run helper counted; encode_frame will
            return aus[0]
        symbols, self.recon = self._frame_encoder.encode_pframes_batch(
            y[None], u[None], v[None], *self.recon, cfg.qp,
            deblock=cfg.deblock)
        return self._pslice_au(unpack_symbols(symbols[0]))

    # ------------------------------------------------------------- AU output

    def _pslice_au_packed(self, stream_words, total_bits: int,
                          qp: int | None = None,
                          frame_idx: int | None = None) -> bytes:
        bw = self._pslice_header_writer(qp, frame_idx=frame_idx)
        merge_slice_data(bw, stream_words, total_bits)
        return self._aud(primary_pic_type=1) + wrap_nal(
            H264NalType.SLICE, bw.get_bytes(), nal_ref_idc=2)

    def _aud(self, primary_pic_type: int) -> bytes:
        if not self.cfg.insert_aud:
            return b""
        return wrap_nal(H264NalType.AUD, write_aud_rbsp(primary_pic_type),
                        nal_ref_idc=0)

    def _idr_sei(self) -> bytes:
        if not self.cfg.insert_sei:
            return b""
        # The same user-data payload as the JAX package, so the AUs match.
        rbsp = write_sei_rbsp([
            sei_recovery_point(0),
            sei_user_data(b"media_tpu H.264 TPU-native encoder"),
        ])
        return wrap_nal(H264NalType.SEI, rbsp, nal_ref_idc=0)

    def _pslice_header_writer(self, qp: int | None = None,
                              first_mb: int = 0,
                              frame_idx: int | None = None,
                              frame_num: int | None = None,
                              poc: int | None = None) -> BitWriter:
        qp = self.cfg.qp if qp is None else qp
        if frame_idx is None:
            frame_idx = self.frame_idx
        if frame_num is None:
            frame_num = (frame_idx - self.frame_idx_of_idr) % (
                1 << self.sps.log2_max_frame_num)
        bw = BitWriter()
        hdr = SliceHeader(
            slice_type=5,
            idr=False,
            frame_num=frame_num,
            pic_order_cnt_lsb=(poc or 0) % (
                1 << self.sps.log2_max_pic_order_cnt_lsb),
            first_mb_in_slice=first_mb,
            slice_qp_delta=qp - self.pps.pic_init_qp,
            disable_deblocking_filter_idc=self._deblock_idc,
            cabac_init_idc=self.cfg.cabac_init_idc,
        )
        hdr.write(bw, self.sps, self.pps)
        return bw

    def _pslice_au(self, fields: dict, qp: int | None = None,
                   frame_idx: int | None = None) -> bytes:
        """One P picture's AU from host symbol arrays, at the slice QP `qp`
        (cfg.qp when None), one NAL per slice of slice_rows."""
        au = b""
        for r0, r1 in self.slice_rows:
            bw = self._pslice_header_writer(
                qp, first_mb=r0 * self.sps.pic_width_in_mbs,
                frame_idx=frame_idx)
            au += self._pslice_nal(bw, fields, r0, r1, qp)
        return self._aud(primary_pic_type=1) + au

    def _pslice_nal(self, bw: BitWriter, fields: dict, r0: int, r1: int,
                    qp: int | None = None) -> bytes:
        """The slice NAL of MB rows r0..r1 of a P picture, after the header
        already in `bw`: CABAC or CAVLC, through the C++ writer or, for
        host_coder="python" and where the C++ writer refuses, the Python
        one. The writers see only the slice's rows, so MV and nC prediction
        restart at its top."""
        sym = tuple(fields[k][r0:r1] for k in (
            "mv", "luma_levels", "cdc_levels", "cac_levels"))
        if self.cfg.cabac:
            while not bw.byte_aligned():
                bw.u(1, 1)  # cabac_alignment_one_bit (7.3.4)
            qp_eff = self.cfg.qp if qp is None else qp
            idc = self.cfg.cabac_init_idc
            payload = native.cabac_write_pslice_native(
                *sym, qp_eff, cabac_init_idc=idc) if self._native else None
            if payload is None:
                payload = cabac_slice.write_pslice_cabac(
                    *sym, qp_eff, cabac_init_idc=idc)
            rbsp = bw.get_bytes() + payload
        else:
            if self._native:
                native.write_pslice_native(bw, *sym)
            else:
                slice_coder.write_pslice_mbs(
                    bw, mv=sym[0], luma_levels=sym[1], cdc_levels=sym[2],
                    cac_levels=sym[3])
                bw.rbsp_trailing_bits()
            rbsp = bw.get_bytes()
        return wrap_nal(H264NalType.SLICE, rbsp, nal_ref_idc=2)

    # ------------------------------------------------------------- B frames

    def _encode_frames_bgop(self, planes: list) -> list[bytes]:
        """The IBPBP GOP loop: every pair (f[i], f[i+1]) encodes as the anchor
        P (display i+1) followed by the non-reference B (display i): coding
        order, which is also the returned AU order. One AU per input
        frame."""
        cfg = self.cfg
        fnmask = (1 << self.sps.log2_max_frame_num) - 1
        out: list[bytes] = []
        i = 0
        n = len(planes)
        while i < n:
            idr_due = (self._display_since_idr is None
                       or self._display_since_idr >= cfg.gop_size
                       or self._force_idr or self.recon is None)
            if idr_due:
                self._force_idr = False
                out.append(self._encode_idr(*planes[i]))
                self._display_since_idr = 1
                self._ref_frame_num = 1
                self.frame_idx += 1
                i += 1
                continue
            d = self._display_since_idr
            until_idr = cfg.gop_size - d
            if i + 1 < n and until_idr >= 2:
                prev_recon = self.recon
                p_fn = self._ref_frame_num & fnmask
                p_au = self._encode_p_anchor(planes[i + 1], frame_num=p_fn,
                                             poc=2 * (d + 1))
                b_au = self._encode_b(planes[i], prev_recon, self.recon,
                                      frame_num=(p_fn + 1) & fnmask,
                                      poc=2 * d)
                self._ref_frame_num += 1
                out.extend([p_au, b_au])
                self._display_since_idr += 2
                self.frame_idx += 2
                i += 2
            else:
                out.append(self._encode_p_anchor(
                    planes[i], frame_num=self._ref_frame_num & fnmask,
                    poc=2 * d))
                self._ref_frame_num += 1
                self._display_since_idr += 1
                self.frame_idx += 1
                i += 1
        return out

    def _encode_p_anchor(self, plane, frame_num: int, poc: int) -> bytes:
        """One P anchor with explicit frame_num/POC (B-GOP coding order)."""
        cfg = self.cfg
        result = self._frame_encoder.encode_pframe(
            *plane, *self.recon, cfg.qp, deblock=cfg.deblock)
        self.recon = (result.recon_y, result.recon_u, result.recon_v)
        fields = {k: getattr(result, k) for k in (
            "mv", "luma_levels", "cdc_levels", "cac_levels")}
        bw = self._pslice_header_writer(frame_num=frame_num, poc=poc)
        return self._aud(primary_pic_type=1) + self._pslice_nal(
            bw, fields, *self.slice_rows[0])

    def _encode_b(self, plane, ref0, ref1, frame_num: int, poc: int) -> bytes:
        """One non-reference B picture (B_Bi_16x16): ME against both
        anchors on the device, host CAVLC B-slice entropy (the Python
        writer; there is no C++ one). Deblocking is disabled per slice (idc
        1): a per-slice choice the spec allows, and B recon never feeds
        prediction."""
        cfg = self.cfg
        qp_b = min(cfg.qp + 2, 51)  # standard B-picture QP offset
        fields = self._frame_encoder.encode_bframe(*plane, ref0, ref1, qp_b)
        bw = BitWriter()
        SliceHeader(
            slice_type=6,  # B (all slices in the picture are B)
            idr=False,
            frame_num=frame_num,
            pic_order_cnt_lsb=poc % (
                1 << self.sps.log2_max_pic_order_cnt_lsb),
            slice_qp_delta=qp_b - self.pps.pic_init_qp,
            disable_deblocking_filter_idc=1,
            nal_ref_idc=0,
        ).write(bw, self.sps, self.pps)
        slice_coder.write_bslice_mbs(bw, **fields)
        bw.rbsp_trailing_bits()
        return self._aud(primary_pic_type=2) + wrap_nal(
            H264NalType.SLICE, bw.get_bytes(), nal_ref_idc=0)

    # ------------------------------------------------------------------- IDR

    def _islice_header_writer(self, r0: int, qp_i: int) -> BitWriter:
        """The header of the IDR slice that starts at MB row r0."""
        bw = BitWriter()
        SliceHeader(
            slice_type=7,  # I (all slices in the picture are I)
            idr=True,
            idr_pic_id=self.idr_pic_id,
            frame_num=0,
            first_mb_in_slice=r0 * self.sps.pic_width_in_mbs,
            slice_qp_delta=qp_i - self.pps.pic_init_qp,
            disable_deblocking_filter_idc=self._deblock_idc,
        ).write(bw, self.sps, self.pps)
        return bw

    def _idr_au_prefix(self) -> bytes:
        """What precedes the slice NALs of an IDR AU: AUD, SPS, PPS, SEI."""
        sps_w = BitWriter()
        self.sps.write(sps_w)
        sps_w.rbsp_trailing_bits()
        pps_w = BitWriter()
        self.pps.write(pps_w)
        pps_w.rbsp_trailing_bits()
        return (self._aud(primary_pic_type=0)
                + wrap_nal(H264NalType.SPS, sps_w.get_bytes())
                + wrap_nal(H264NalType.PPS, pps_w.get_bytes())
                + self._idr_sei())

    def _encode_ipcm(self, y, u, v) -> bytes:
        """One all-I_PCM IDR AU: raw 8-bit samples, mathematically lossless
        (spec 7.3.5 pcm_sample_luma/chroma; mb_type 25 in I slices). Host
        numpy throughout: no device is touched, and the reference planes
        are the source planes themselves.

        Every MB is byte-aligned after its type code, so the whole slice
        body is assembled as one numpy byte layout: a 2-byte prefix per MB
        (ue(25) = 9 bits '000011010' + 7 pcm_alignment_zero_bits) followed
        by 256 luma + 64 Cb + 64 Cr samples."""
        C = self.sps.pic_width_in_mbs
        R = self.sps.pic_height_in_mbs
        self.recon = (y, u, v)  # recon == source by construction
        self.frame_idx_of_idr = self.frame_idx

        def mbs(p, size):
            return (p.reshape(R, size, C, size).transpose(0, 2, 1, 3)
                    .reshape(R, C, size * size).astype(np.uint8))

        pre = np.zeros((R, C, 2), np.uint8)
        pre[..., 0] = 0x0D
        body = np.concatenate([pre, mbs(y, 16), mbs(u, 8), mbs(v, 8)], axis=2)
        slice_nals = b""
        for r0, r1 in self.slice_rows:
            bw = self._islice_header_writer(r0, self.pps.pic_init_qp)
            bw.ue(25)  # mb_type I_PCM (first MB; header end is unaligned)
            while not bw.byte_aligned():
                bw.u(1, 0)  # pcm_alignment_zero_bit
            # The first MB's 2-byte prefix is the bits written above.
            bw.put_bytes(body[r0:r1].tobytes()[2:])
            bw.rbsp_trailing_bits()
            slice_nals += wrap_nal(H264NalType.IDR_SLICE, bw.get_bytes(),
                                   nal_ref_idc=3)
        self.idr_pic_id = (self.idr_pic_id + 1) & 0xFFFF
        return self._idr_au_prefix() + slice_nals

    def _idr_qp(self) -> int:
        if self.cfg.rc_mode == "cbr":
            # I frames: slightly below the running P QP, budgeted separately.
            return int(np.clip(round(self.rc_state["qp"]) - 2, 10, 46))
        return self.cfg.qp

    def _encode_idr(self, y, u, v) -> bytes:
        # Callers drain pending P chunks before an IDR, so the float rc
        # mirror is current; the device-side carry is superseded.
        self._rc_dev = None
        self._rc_corr = 0.0
        qp_i = self._idr_qp()
        result = self._frame_encoder.encode_iframe(
            y, u, v, qp_i, deblock=self.cfg.deblock, i4x4=self.cfg.i4x4)
        return self._idr_au_from_result(result, qp_i)

    def _idr_au_from_result(self, result, qp_i: int) -> bytes:
        """Assemble the IDR AU (SPS + PPS + one NAL per slice) from an
        IFrameResult."""
        cfg = self.cfg
        self.recon = (result.recon_y, result.recon_u, result.recon_v)
        self.frame_idx_of_idr = self.frame_idx
        with span("enc.idr.write"):
            slice_nals = b""
            for r0, r1 in self.slice_rows:
                bw = self._islice_header_writer(r0, qp_i)
                sym = tuple(getattr(result, k)[r0:r1] for k in (
                    "mode16", "chroma_mode", "dc_levels", "ac_levels",
                    "cdc_levels", "cac_levels"))
                i4 = {}
                if result.is_i4 is not None:
                    i4 = dict(is_i4=result.is_i4[r0:r1],
                              modes4=result.modes4[r0:r1],
                              luma4_levels=result.luma4_levels[r0:r1])
                if cfg.cabac:
                    while not bw.byte_aligned():
                        bw.u(1, 1)  # cabac_alignment_one_bit
                    payload = (native.cabac_write_islice_native(
                        *sym, qp_i, **i4) if self._native else None)
                    if payload is None:
                        payload = cabac_slice.write_islice_cabac(
                            *sym, qp_i, **i4)
                    rbsp = bw.get_bytes() + payload
                else:
                    # The C++ CAVLC writer codes I_16x16 only.
                    if self._native and not i4:
                        native.write_islice_native(bw, *sym)
                    else:
                        slice_coder.write_islice_mbs(
                            bw, mode16=sym[0], chroma_mode=sym[1],
                            dc_levels=sym[2], ac_levels=sym[3],
                            cdc_levels=sym[4], cac_levels=sym[5], **i4)
                        bw.rbsp_trailing_bits()
                    rbsp = bw.get_bytes()
                slice_nals += wrap_nal(H264NalType.IDR_SLICE, rbsp,
                                       nal_ref_idc=3)
            self.idr_pic_id = (self.idr_pic_id + 1) & 0xFFFF

            au = self._idr_au_prefix() + slice_nals
        if cfg.rc_mode == "cbr":
            # Charge the I frame against the buffer at an allowance of 4x the
            # per-frame target (typical I/P size ratio at equal quality).
            self.rc_state["buf"] += len(au) * 8 - 4 * self._rc_target
        # Seed the stream-buffer high-water-mark (I frames are typically ~4x
        # the following P frames).
        self._note_bits(len(au) * 8)
        return au
