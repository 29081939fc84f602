"""VideoDecoder lifecycle API — behavioral parity with the reference's
decoder contract (video_decoder/include/VideoDecoder.h:83-192):

  CreateDecoder(format) -> InitDecoder -> SetDecodeParams/SetCallbacks ->
  StartDecoder -> { SendStreamData / RetrieveFrameData }* -> Flush ->
  StopDecoder -> DestroyDecoder

Reproduced semantics (SURVEY.md §3.5):
  - two-call pull model: the caller owns pacing; WRITE_OVERFLOW /
    READ_UNDERFLOW are the flow-control protocol (VideoDecoderNetint.cpp:595-597,646-658),
  - leading SPS/PPS NALs are saved to the session so decoding survives Flush
    (ni_logan_device_dec_session_save_hdrs analog, VideoDecoderNetint.cpp:737-792),
  - resolution change fires the event callback then returns BAD_PIC_SIZE
    (VideoDecoderNetint.cpp:667-700),
  - len==0 feed marks end-of-stream; draining past it returns EOS,
  - 1 Hz decoded-fps PERF log (VideoDecoderNetint.cpp:609-622).

The port's copy of media_tpu/api/decoder_api.py: the same contract and
codes, with a `device` argument on VideoDecoder and create_video_decoder
("cuda" unless the caller passes another; a CUDA device that is not there
raises) that the H.264 device decoder runs on. Payloads come from numpy
planes on the host, as the device decoder's frames hand them out.
"""

from __future__ import annotations

import time
from collections import deque

from ..core import nal as nal_mod
from ..core.log import Logger
from ..device import resolve_device
from ..ref.decoder import ReferenceDecoder
from .errors import CodecFormat, DecoderEvent, DecoderRetCode, PixelFormat

log = Logger("VideoDecoder")

MAX_PENDING_FRAMES = 8  # backpressure bound for the decoded-frame queue


class _HevcDecoderAdapter:
    """ReferenceDecoder-shaped wrapper around the HEVC oracle (same
    decode_annexb contract; frame objects expose .y/.u/.v)."""

    def __init__(self, inner):
        self._inner = inner
        self.sps = None
        self.pps = None

    def decode_annexb(self, chunk: bytes):
        return self._inner.decode_annexb(chunk)


class VideoDecoder:
    def __init__(self, backend: str = "auto", device="cuda"):
        """backend: "auto" uses the TPU decode path (device IQ/IDCT/MC/
        deblock, pipeline/decoder_tpu.py) on accelerator backends and the
        scalar reference decoder on CPU; "tpu"/"reference" force one.
        (As in the original, only "ref" is tested for: it selects the
        scalar reference decoder; any other value the device decoder.)
        device: the torch device of the device decoder."""
        self._device = resolve_device(device)
        self._created = False
        self._inited = False
        self._started = False
        self._format = CodecFormat.H264
        self._pix_fmt = PixelFormat.YUV420P
        self._width = 1280
        self._height = 720
        self._event_cb = None
        self._copy_frame = None
        self._saved_headers = b""
        self._leftover = b""
        self._frames = deque()
        self._eos_pending = False
        self._eos_delivered = False
        self._backend = backend
        self._decoder = self._make_decoder()
        # fps stat
        self._frame_count = 0
        self._stat_t0 = time.monotonic()
        self._stat_frames = 0

    def _make_decoder(self):
        if self._format == CodecFormat.H265:
            # H.265 decode (the reference decodes both formats via the Logan
            # session, VideoDecoderNetint.cpp:822-824): independent scalar
            # oracle implementation.
            from ..hevc.ref_decoder import HevcOracleDecoder

            return _HevcDecoderAdapter(HevcOracleDecoder())
        if self._backend == "ref":
            return ReferenceDecoder()
        # TpuDecoder on every JAX backend (CPU included): it covers the full
        # envelope this framework emits — CABAC included, which the scalar
        # oracle does not parse — and falls back to the oracle per chunk on
        # UnsupportedStream.
        from ..pipeline.decoder_tpu import TpuDecoder

        return TpuDecoder(device=self._device)

    def _fallback_to_reference(self, chunk: bytes):
        """Swap the TPU decoder for the scalar reference mid-stream (feature
        outside the device path's envelope), carrying over parameter sets and
        reference planes (device tensors, taken to the host), then retry
        the chunk."""
        import numpy as np

        old = self._decoder
        ref = ReferenceDecoder()
        ref.sps, ref.pps = old.sps, old.pps
        if getattr(old, "ref_planes", None) is not None:
            ref.ref_planes = tuple(
                p.cpu().numpy().astype(np.int32) for p in old.ref_planes)
        self._decoder = ref
        return ref.decode_annexb(chunk)

    # ------------------------------------------------------------- lifecycle

    def create_decoder(self, codec_format: int) -> DecoderRetCode:
        if codec_format not in (CodecFormat.H264, CodecFormat.H265):
            return DecoderRetCode.VIDEO_DECODER_UNSUPPORTED
        self._format = CodecFormat(codec_format)
        self._decoder = self._make_decoder()
        self._created = True
        return DecoderRetCode.VIDEO_DECODER_SUCCESS

    def init_decoder(self) -> DecoderRetCode:
        if not self._created:
            return DecoderRetCode.VIDEO_DECODER_NOT_INITED
        self._inited = True
        return DecoderRetCode.VIDEO_DECODER_SUCCESS

    def reset_decoder(self) -> DecoderRetCode:
        """Stop + fresh decode engine + start, keeping the configured format
        and geometry (the decoder twin of the encoder's ResetEncoder =
        destroy+init+start policy; stream state and queued frames drop)."""
        if not self._created:
            return DecoderRetCode.VIDEO_DECODER_NOT_INITED
        was_started = self._started
        self._started = False
        self._decoder = self._make_decoder()
        self._frames.clear()
        self._leftover = b""
        self._eos_pending = False
        self._eos_delivered = False
        self._saved_headers = b""
        self._inited = True
        # Preserve the pre-reset run state: reset after create/init but
        # before start_decoder must not leave the session started (matches
        # the encoder twin's stop+init+start contract).
        self._started = was_started
        return DecoderRetCode.VIDEO_DECODER_SUCCESS

    def set_decode_params(self, *, width: int | None = None,
                          height: int | None = None,
                          pixel_format: int | None = None) -> DecoderRetCode:
        if width is not None:
            self._width = width
        if height is not None:
            self._height = height
        if pixel_format is not None:
            if pixel_format not in (PixelFormat.YUV420P,):
                return DecoderRetCode.VIDEO_DECODER_UNSUPPORTED
            self._pix_fmt = PixelFormat(pixel_format)
        return DecoderRetCode.VIDEO_DECODER_SUCCESS

    def get_decode_params(self) -> dict:
        return {
            "width": self._width,
            "height": self._height,
            "pixel_format": int(self._pix_fmt),
            "codec_format": int(self._format),
        }

    def set_callbacks(self, event_callback) -> DecoderRetCode:
        self._event_cb = event_callback
        return DecoderRetCode.VIDEO_DECODER_SUCCESS

    def set_copy_frame_func(self, copy_func) -> DecoderRetCode:
        """copy_func(src_planes, pic_info) -> bytes, the injected copy hook
        (reference SetCopyFrameFunc / m_copyFrame)."""
        self._copy_frame = copy_func
        return DecoderRetCode.VIDEO_DECODER_SUCCESS

    def start_decoder(self) -> DecoderRetCode:
        if not self._inited:
            return DecoderRetCode.VIDEO_DECODER_NOT_INITED
        self._started = True
        return DecoderRetCode.VIDEO_DECODER_SUCCESS

    def stop_decoder(self) -> DecoderRetCode:
        self._started = False
        return DecoderRetCode.VIDEO_DECODER_SUCCESS

    def destroy_decoder(self) -> DecoderRetCode:
        # Idempotent destroy, like the reference's guard.
        self._created = self._inited = self._started = False
        self._frames.clear()
        return DecoderRetCode.VIDEO_DECODER_SUCCESS

    def flush(self) -> DecoderRetCode:
        """Drop pending output but keep saved parameter sets so the stream can
        resume mid-GOP after re-feeding headers (reference flush-resume)."""
        self._frames.clear()
        self._leftover = b""
        self._eos_pending = False
        self._eos_delivered = False
        if self._saved_headers:
            self._decoder = self._make_decoder()
            self._decoder.decode_annexb(self._saved_headers)
        return DecoderRetCode.VIDEO_DECODER_SUCCESS

    def _recover_decode_fail(self) -> DecoderRetCode:
        """Per-AU failure: report DECODE_FAIL but KEEP the session alive —
        reset the internal decoder and re-feed the saved parameter sets so
        decoding resumes at the next intact IDR/AU. The reference only
        stops the session on transport-class errors (txSize < 0,
        VideoDecoderNetint.cpp:591-594); a corrupt access unit is not a
        transport error."""
        self._decoder = self._make_decoder()
        self._leftover = b""  # drop buffered bytes of the failed segment
        if self._saved_headers:
            try:
                self._decoder.decode_annexb(self._saved_headers)
            except Exception:
                pass
        return DecoderRetCode.VIDEO_DECODER_DECODE_FAIL

    # ------------------------------------------------------------------ I/O

    def send_stream_data(self, data: bytes) -> DecoderRetCode:
        if not self._started:
            return DecoderRetCode.VIDEO_DECODER_NOT_INITED
        if len(data) == 0:  # end-of-stream marker (reference len==0 rule)
            self._eos_pending = True
            # Flush the leftover assembly: with no more data coming, the
            # buffered trailing NAL is complete by definition. The normal
            # backpressure bound still applies — the caller drains and
            # re-sends the EOS marker (eos_pending stays set).
            if self._leftover and len(self._frames) >= MAX_PENDING_FRAMES:
                return DecoderRetCode.VIDEO_DECODER_WRITE_OVERFLOW
            chunk, self._leftover = self._leftover, b""
            if chunk:
                return self._decode_chunk(chunk)
            return DecoderRetCode.VIDEO_DECODER_SUCCESS
        if len(self._frames) >= MAX_PENDING_FRAMES:
            return DecoderRetCode.VIDEO_DECODER_WRITE_OVERFLOW

        buf = self._leftover + bytes(data)
        # Keep any trailing partial NAL for the next feed (leftover assembly,
        # reference InitPacketData/packet_copy).
        cut = self._find_last_complete(buf)
        chunk, self._leftover = buf[:cut], buf[cut:]
        if not chunk:
            return DecoderRetCode.VIDEO_DECODER_SUCCESS
        return self._decode_chunk(chunk)

    def _decode_chunk(self, chunk: bytes) -> DecoderRetCode:
        if self._format == CodecFormat.H264:
            headers, _rest = nal_mod.split_parameter_sets(chunk)
            if headers:
                self._saved_headers = headers  # save_hdrs analog

        try:
            decoded = self._decoder.decode_annexb(chunk)
        except Exception as e:
            from ..pipeline.decoder_tpu import UnsupportedStream

            if isinstance(e, UnsupportedStream):
                log.warn("TPU decode path: %s; falling back to reference", e)
                try:
                    decoded = self._fallback_to_reference(chunk)
                except Exception as e2:
                    log.err("decode failed: %s", e2)
                    return self._recover_decode_fail()
            else:
                log.err("decode failed: %s", e)
                return self._recover_decode_fail()
        for f in decoded:
            self._frames.append(f)
        return DecoderRetCode.VIDEO_DECODER_SUCCESS

    def retrieve_frame_data(self, max_len: int | None = None):
        """Returns (code, frame_bytes, pic_info). READ_UNDERFLOW when no frame
        is ready; EOS after the last frame of an ended stream."""
        if not self._started:
            return DecoderRetCode.VIDEO_DECODER_NOT_INITED, b"", {}
        if not self._frames:
            if self._eos_pending and not self._eos_delivered:
                self._eos_delivered = True
                return DecoderRetCode.VIDEO_DECODER_EOS, b"", {}
            return DecoderRetCode.VIDEO_DECODER_READ_UNDERFLOW, b"", {}

        f = self._frames.popleft()
        h, w = f.y.shape
        pic_info = {"width": w, "height": h, "stride": w, "pixel_format": int(self._pix_fmt)}
        if (w, h) != (self._width, self._height):
            # Resolution change: fire the event, adopt the new geometry, and
            # return BAD_PIC_SIZE for this call (reference semantics).
            self._width, self._height = w, h
            self._frames.appendleft(f)
            if self._event_cb:
                self._event_cb(DecoderEvent.INDEX_PIC_INFO_CHANGE, pic_info)
            return DecoderRetCode.VIDEO_DECODER_BAD_PIC_SIZE, b"", pic_info

        if self._copy_frame is not None:
            payload = self._copy_frame((f.y, f.u, f.v), pic_info)
        else:
            payload = f.y.tobytes() + f.u.tobytes() + f.v.tobytes()
        if max_len is not None and len(payload) > max_len:
            self._frames.appendleft(f)
            return DecoderRetCode.VIDEO_DECODER_INVALID_PARAM, b"", pic_info

        self._frame_count += 1
        self._stat_frames += 1
        now = time.monotonic()
        if now - self._stat_t0 >= 1.0:
            log.info("PERF-DEC-FPS: %0.2f", self._stat_frames / (now - self._stat_t0))
            self._stat_t0 = now
            self._stat_frames = 0
        return DecoderRetCode.VIDEO_DECODER_SUCCESS, payload, pic_info

    # --------------------------------------------------------------- helpers

    @staticmethod
    def _find_last_complete(buf: bytes) -> int:
        """Byte offset after the last complete NAL (a NAL is complete when a
        following start code exists)."""
        last = 0
        pos, sc = nal_mod.find_start_code(buf, 0)
        while pos != -1:
            nxt, _ = nal_mod.find_start_code(buf, pos + sc)
            if nxt == -1:
                break
            last = nxt
            pos, sc = nxt, _
        return last


def create_video_decoder(device="cuda") -> VideoDecoder:
    """Factory (reference: CreateVideoDecoder always constructs the single
    decoder backend, VideoDecoderApi.cpp:12-22). device: as VideoDecoder's."""
    return VideoDecoder(device=device)


def destroy_video_decoder(dec: VideoDecoder) -> DecoderRetCode:
    if dec is None:
        return DecoderRetCode.VIDEO_DECODER_DESTROY_FAIL
    return dec.destroy_decoder()
