"""Top-level encoder session: I420 frames in, Annex-B H.264 access units out.

PyTorch twin of media_tpu/pipeline/codec.py:EncoderSession for the slice the
port covers: CAVLC, constant QP, one slice, I_16x16 IDR + P frames, in-loop
deblocking, P-slice entropy packed on the device or on the host. The AU
bytes equal the JAX package's for the same input. The session runs on the
GPU unless the caller passes device="cpu"; other configurations raise
NotImplementedError naming the ROADMAP item that ports them.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..core.bitstream import BitWriter
from ..core.nal import H264NalType, wrap_nal
from ..core.syntax import (
    PPS, SPS, SliceHeader, sei_recovery_point, sei_user_data, write_aud_rbsp,
    write_sei_rbsp)
from ..device import resolve_device
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
    rc_mode: str = "cq"
    bitrate: int = 5_000_000
    framerate: int = 30
    deblock: bool = True
    num_slices: int = 1
    deblock_across_slices: bool = True
    signal_timing: bool = True
    insert_aud: bool = False
    insert_sei: bool = False
    cabac: bool = False
    i4x4: bool = False
    cabac_init_idc: int = 0
    adaptive_qp: bool = False
    b_frames: int = 0
    lossless: bool = False


def _check_supported(cfg: EncoderConfig) -> None:
    todo = [
        (cfg.rc_mode != "cq", "rc_mode='cbr' (ROADMAP queue 1, item 9)"),
        (cfg.adaptive_qp, "adaptive_qp (ROADMAP queue 1, item 9)"),
        (cfg.cabac, "cabac (ROADMAP queue 1, item 9)"),
        (cfg.i4x4, "i4x4 (ROADMAP queue 1, item 10)"),
        (cfg.num_slices != 1, "num_slices > 1 (ROADMAP queue 1, item 10)"),
        (bool(cfg.b_frames), "b_frames (ROADMAP queue 1, item 10)"),
        (cfg.lossless, "lossless (ROADMAP queue 1, item 10)"),
    ]
    for bad, what in todo:
        if bad:
            raise NotImplementedError(f"media_tpu_torch does not port {what} "
                                      "yet")
    if cfg.entropy_mode not in ("auto", "device", "host"):
        raise ValueError(f"entropy_mode {cfg.entropy_mode!r}")


class EncoderSession:
    """Stateful H.264 encoder on one torch device: IDR + P-frame GOPs at a
    constant QP."""

    # P-run pipeline chunk size (frames per device batch).
    PIPELINE_CHUNK = 4

    def __init__(self, cfg: EncoderConfig, device="cuda"):
        _check_supported(cfg)
        self.device = resolve_device(device)
        self.cfg = cfg
        self.sps = SPS.for_size(cfg.width, cfg.height, level_idc=cfg.level_idc)
        if cfg.signal_timing and cfg.framerate > 0:
            self.sps.vui_timing = (1, 2 * cfg.framerate)
        self.pps = PPS(pic_init_qp=cfg.qp, deblocking_filter_control_present=True)
        self._pad_w = self.sps.pic_width_in_mbs * 16
        self._pad_h = self.sps.pic_height_in_mbs * 16
        self._frame_encoder = FrameEncoder(self._pad_w, self._pad_h,
                                           self.device)
        self._deblock_idc = 0 if cfg.deblock else 1
        self.frame_idx = 0
        self.frame_idx_of_idr = 0
        self.idr_pic_id = 0
        self._force_idr = False
        self.recon = None  # (y, u, v) uint8 reference planes on the device
        # High-water-mark of per-frame slice_data bits, for right-sizing the
        # device stream buffer.
        self._bits_hwm: int | None = None

    def reset_gop_state(self, idr_pic_id: int = 0) -> None:
        """Return to a pristine GOP boundary: the next frame is an IDR and
        the reference planes and stream-cap high-water-mark are reset."""
        self.recon = None
        self.frame_idx = 0
        self.idr_pic_id = idr_pic_id & 0xFFFF
        self._force_idr = False
        self._bits_hwm = None

    def force_keyframe(self) -> None:
        self._force_idr = True

    def load_reference_state(self, state: dict) -> None:
        """Continue a GOP that another session (e.g. the JAX package's)
        started: state holds numpy "recon" (y, u, v) planes and the
        counters "frame_idx", "frame_idx_of_idr", "idr_pic_id" and
        "_bits_hwm"."""
        self.recon = tuple(
            torch.tensor(np.asarray(p, dtype=np.uint8), device=self.device)
            for p in state["recon"])
        self.frame_idx = int(state["frame_idx"])
        self.frame_idx_of_idr = int(state["frame_idx_of_idr"])
        self.idr_pic_id = int(state["idr_pic_id"])
        hwm = state["_bits_hwm"]
        self._bits_hwm = None if hwm is None else int(hwm)
        self._force_idr = False

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
            run = planes[i : i + self.PIPELINE_CHUNK]
            host = [np.stack([p[j] for p in run]) for j in range(3)]
            dev = [torch.as_tensor(h).to(self.device) for h in host]
            chunks.append((*dev, *host, len(run)))
        self._sync()
        return chunks

    def encode_frames_staged(self, chunks) -> list[bytes]:
        """Encode P-frame chunks pre-staged by upload_frames. The bitstream
        equals encode_frames' on the same frames. The session must be
        mid-GOP (a reference exists and no IDR falls inside the run)."""
        cfg = self.cfg
        if self.recon is None:
            raise RuntimeError("encode_frames_staged needs a reference frame "
                               "(encode an IDR first)")
        n_frames = sum(ch[6] for ch in chunks)
        until_idr = cfg.gop_size - (self.frame_idx % cfg.gop_size)
        if self._force_idr or n_frames > until_idr:
            raise RuntimeError("IDR due inside a staged run; use encode_frames")
        out: list[bytes] = []
        pending: list = []
        for ys_d, us_d, vs_d, ys, us, vs, k in chunks:
            pending.append(self._dispatch_packed(ys_d, us_d, vs_d, ys, us, vs,
                                                 k))
            while len(pending) > 1:  # depth-2 pipeline
                out.extend(pending.pop(0)())
        while pending:
            out.extend(pending.pop(0)())
        return out

    def encode_frames(self, i420_frames) -> list[bytes]:
        """Encode a sequence of frames, batching runs of P frames into
        chunked device dispatches; the host assembles chunk i-1's AUs after
        chunk i is dispatched. Same bitstream as repeated encode_frame
        calls. Returns one Annex-B AU per input frame."""
        cfg = self.cfg
        planes = [self._planes(buf) for buf in i420_frames]
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
            use_device = (cfg.entropy_mode == "device"
                          or (cfg.entropy_mode == "auto"
                              and self.device.type != "cpu"))
            if not use_device:
                drain(0)
                host = [np.stack([p[j] for p in planes[i : i + k]])
                        for j in range(3)]
                symbols, self.recon = self._frame_encoder.encode_pframes_batch(
                    *host, *self.recon, cfg.qp, deblock=cfg.deblock)
                for j in range(k):
                    out.append(self._pslice_au(unpack_symbols(symbols[j])))
                    self.frame_idx += 1
                i += k
                continue
            k = min(k, self.PIPELINE_CHUNK)
            host = [np.stack([p[j] for p in planes[i : i + k]])
                    for j in range(3)]
            dev = [torch.as_tensor(h).to(self.device) for h in host]
            pending.append(self._dispatch_packed(*dev, *host, k))
            drain(1)  # depth-2 pipeline: keep one chunk in flight
            i += k
        drain(0)
        return out

    def _dispatch_packed(self, ys_d, us_d, vs_d, ys, us, vs, k: int):
        """Dispatch one P chunk with on-device packing; returns the deferred
        finisher that downloads the streams and assembles the AUs."""
        cfg = self.cfg
        enc = self._frame_encoder
        prev_recon = self.recon
        cap = self._device_cap()
        streams_d, bits_d, recon = enc.encode_pframes_packed_dev(
            ys_d, us_d, vs_d, prev_recon, cfg.qp, deblock=cfg.deblock,
            cap=cap)
        self.recon = tuple(recon)
        frame_base = self.frame_idx
        self.frame_idx += k

        def finish() -> list[bytes]:
            bits = bits_d.cpu().numpy()
            if int(bits.max()) > cap * 32 and cap < enc.cap_words:
                # Adaptive cap overflowed: retry on the device at the full
                # budget (the bitstream is identical; only the buffer size
                # differs).
                streams, bits, _recon = enc.encode_pframes_packed(
                    ys, us, vs, *prev_recon, cfg.qp, deblock=cfg.deblock,
                    cap=enc.cap_words)
                streams_np, cap_eff = streams, enc.cap_words
            else:
                streams_np, cap_eff = None, cap
            self._note_bits(int(bits.max()))
            if int(bits.max()) <= cap_eff * 32:
                if streams_np is None:
                    nw = stream_prefix_words(int(bits.max()), cap_eff)
                    streams_np = streams_d[:, :nw].cpu().numpy().astype(
                        np.uint32)
                return [self._pslice_au_packed(streams_np[j], int(bits[j]),
                                               frame_idx=frame_base + j)
                        for j in range(k)]
            # Rare overflow (bits above the device stream budget): re-run for
            # symbols and pack on the host. Recon is unaffected.
            symbols, _recon = enc.encode_pframes_batch(
                ys, us, vs, *prev_recon, cfg.qp, deblock=cfg.deblock)
            return [self._pslice_au(unpack_symbols(symbols[j]),
                                    frame_idx=frame_base + j)
                    for j in range(k)]

        return finish

    def _encode_p(self, y, u, v) -> bytes:
        symbols, self.recon = self._frame_encoder.encode_pframes_batch(
            y[None], u[None], v[None], *self.recon, self.cfg.qp,
            deblock=self.cfg.deblock)
        return self._pslice_au(unpack_symbols(symbols[0]))

    # ------------------------------------------------------------- AU output

    def _pslice_au_packed(self, stream_words, total_bits: int,
                          frame_idx: int | None = None) -> bytes:
        bw = self._pslice_header_writer(frame_idx=frame_idx)
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

    def _pslice_header_writer(self, frame_idx: int | None = None) -> BitWriter:
        if frame_idx is None:
            frame_idx = self.frame_idx
        bw = BitWriter()
        hdr = SliceHeader(
            slice_type=5,
            idr=False,
            frame_num=(frame_idx - self.frame_idx_of_idr) % (
                1 << self.sps.log2_max_frame_num),
            pic_order_cnt_lsb=0,
            first_mb_in_slice=0,
            slice_qp_delta=self.cfg.qp - self.pps.pic_init_qp,
            disable_deblocking_filter_idc=self._deblock_idc,
            cabac_init_idc=self.cfg.cabac_init_idc,
        )
        hdr.write(bw, self.sps, self.pps)
        return bw

    def _pslice_au(self, fields: dict, frame_idx: int | None = None) -> bytes:
        bw = self._pslice_header_writer(frame_idx=frame_idx)
        slice_coder.write_pslice_mbs(
            bw, mv=fields["mv"], luma_levels=fields["luma_levels"],
            cdc_levels=fields["cdc_levels"], cac_levels=fields["cac_levels"])
        bw.rbsp_trailing_bits()
        return self._aud(primary_pic_type=1) + wrap_nal(
            H264NalType.SLICE, bw.get_bytes(), nal_ref_idc=2)

    def _encode_idr(self, y, u, v) -> bytes:
        result = self._frame_encoder.encode_iframe(y, u, v, self.cfg.qp,
                                                   deblock=self.cfg.deblock)
        return self._idr_au_from_result(result, self.cfg.qp)

    def _idr_au_from_result(self, result, qp_i: int) -> bytes:
        """Assemble the IDR AU (SPS + PPS + slice NAL) from an IFrameResult."""
        self.recon = (result.recon_y, result.recon_u, result.recon_v)
        self.frame_idx_of_idr = self.frame_idx
        bw = BitWriter()
        SliceHeader(
            slice_type=7,  # I (all slices in the picture are I)
            idr=True,
            idr_pic_id=self.idr_pic_id,
            frame_num=0,
            first_mb_in_slice=0,
            slice_qp_delta=qp_i - self.pps.pic_init_qp,
            disable_deblocking_filter_idc=self._deblock_idc,
        ).write(bw, self.sps, self.pps)
        slice_coder.write_islice_mbs(
            bw, mode16=result.mode16, chroma_mode=result.chroma_mode,
            dc_levels=result.dc_levels, ac_levels=result.ac_levels,
            cdc_levels=result.cdc_levels, cac_levels=result.cac_levels)
        bw.rbsp_trailing_bits()
        self.idr_pic_id = (self.idr_pic_id + 1) & 0xFFFF

        sps_w = BitWriter()
        self.sps.write(sps_w)
        sps_w.rbsp_trailing_bits()
        pps_w = BitWriter()
        self.pps.write(pps_w)
        pps_w.rbsp_trailing_bits()
        au = (
            self._aud(primary_pic_type=0)
            + wrap_nal(H264NalType.SPS, sps_w.get_bytes())
            + wrap_nal(H264NalType.PPS, pps_w.get_bytes())
            + self._idr_sei()
            + wrap_nal(H264NalType.IDR_SLICE, bw.get_bytes(), nal_ref_idc=3)
        )
        # Seed the stream-buffer high-water-mark (I frames are typically ~4x
        # the following P frames).
        self._note_bits(len(au) * 8)
        return au
