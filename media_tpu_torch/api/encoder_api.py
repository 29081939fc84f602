"""VideoEncoder lifecycle API — behavioral parity with the reference's
encoder contract (video_codec/VideoCodecApi.h:22-78):

  InitEncoder -> StartEncoder -> EncodeOneFrame* -> StopEncoder -> DestroyEncoder
  plus ResetEncoder (= stop+init+start, VideoEncoderOpenH264.cpp:388-404).

Per-frame semantics reproduced from the OpenH264 adapter's hot loop
(VideoEncoderOpenH264.cpp:304-352):
  - input size guard (>= w*h*3/2),
  - per-frame poll of the param-adjust key -> re-read params, reset if changed,
  - per-frame poll of the force-keyframe key -> IDR now,
  - output bytes are valid until the next EncodeOneFrame call.

The port's copy of media_tpu/api/encoder_api.py: the same contract, policy
and codes, with a `device` argument on VideoEncoder and
create_video_encoder ("cuda" unless the caller passes another; a CUDA
device that is not there raises) that the H.264 session runs on, and the
same multi-device placement (_place_session). One difference: a CABAC or
lossless configuration placed on several devices keeps the single-device
session (parallel/sharding.py refuses it), where the original's sharded
session writes a stream that does not decode.
"""

from __future__ import annotations

import torch

from ..core import params as P
from ..core.log import Logger
from ..device import resolve_device
from ..pipeline.codec import EncoderConfig, EncoderSession
from .errors import CodecFormat, EncoderRetCode

log = Logger("VideoEncoder")


class _HevcSessionAdapter:
    """EncoderSession-shaped wrapper around the intra-only HEVC skeleton
    (media_tpu/hevc): I420 bytes in, Annex-B HEVC AU out."""

    def __init__(self, width: int, height: int, qp: int,
                 bitrate: int = 0, framerate: int = 30):
        from ..hevc import HevcEncoderSession

        self._s = HevcEncoderSession(width, height, qp)
        if bitrate > 0:
            self._s.enable_cbr(bitrate, framerate)
        self.width, self.height = width, height

    def force_keyframe(self):  # every frame is intra already
        pass

    def encode_frame(self, data) -> bytes:
        from ..utils import yuv

        y, u, v = yuv.split_i420(data, self.width, self.height)
        return self._s.encode_frame(y, u, v)


class _EncoderStats:
    """Per-session counters behind get_encoder_statistics (the
    SEncoderStatistics analog, codec_app_def.h:735-760)."""

    def __init__(self):
        import time

        self.frames = 0
        self.bytes_out = 0
        self.qp_sum = 0.0
        self.speed_sum_s = 0.0
        self.idr_reqs = 0
        self.t_start = time.monotonic()
        self.t_last = self.t_start
        self.latest_dt = 0.0

    def on_frame(self, nbytes: int, speed_s: float, qp: float) -> None:
        import time

        now = time.monotonic()
        self.latest_dt = now - self.t_last
        self.t_last = now
        self.frames += 1
        self.bytes_out += nbytes
        self.qp_sum += qp
        self.speed_sum_s += speed_s

    def avg_speed_ms(self) -> float:
        return round(self.speed_sum_s / self.frames * 1000, 3) if self.frames else 0.0

    def avg_fps(self) -> float:
        dt = self.t_last - self.t_start
        return round(self.frames / dt, 3) if dt > 0 and self.frames > 1 else 0.0

    def latest_fps(self) -> float:
        return round(1.0 / self.latest_dt, 3) if self.latest_dt > 0 else 0.0

    def avg_qp(self) -> float:
        return round(self.qp_sum / self.frames, 2) if self.frames else 0.0

    def bitrate_bps(self) -> int:
        dt = self.t_last - self.t_start
        return int(self.bytes_out * 8 / dt) if dt > 0 and self.frames > 1 else 0

    def ts(self) -> float:
        import time

        return time.monotonic()


class VideoEncoder:
    """GPU-backed H.264 encoder behind the reference lifecycle contract.

    device: the torch device of the H.264 session. The format-2 (HEVC)
    session is host numpy and takes it only for the rule of the entry
    points."""

    def __init__(self, store: P.ParamStore | None = None,
                 codec: CodecFormat = CodecFormat.H264, device="cuda"):
        self._device = resolve_device(device)
        self._store = store if store is not None else P.ParamStore()
        self._codec = codec
        self._session: EncoderSession | None = None
        self._params: P.EncodeParams | None = None
        self._started = False
        self._last_output: bytes = b""
        self._stats = _EncoderStats()

    # ------------------------------------------------------------- lifecycle

    def init_encoder(self) -> EncoderRetCode:
        if self._codec not in (CodecFormat.H264, CodecFormat.H265):
            log.err("codec %s not yet supported", self._codec)
            return EncoderRetCode.VIDEO_ENCODER_UNSUPPORTED
        try:
            self._params = P.read_encode_params(self._store)
        except ValueError as e:
            log.err("invalid encode params: %s", e)
            return EncoderRetCode.VIDEO_ENCODER_INIT_FAIL
        p = self._params
        qp = _bitrate_to_qp(p.bitrate, p.width, p.height, p.framerate)
        if self._codec == CodecFormat.H265:
            # Format-2 slot (reference: VideoEncoderNetint H.265 mode,
            # VideoCodecApi.cpp:23-38): intra-only skeleton session.
            self._session = _HevcSessionAdapter(p.width, p.height, qp,
                                                bitrate=p.bitrate,
                                                framerate=p.framerate)
            log.info("init HEVC %dx%d qp0=%d cbr=%d (intra-only)", p.width,
                     p.height, qp, p.bitrate)
            return EncoderRetCode.VIDEO_ENCODER_SUCCESS
        cfg = self._reference_policy_config(p, qp)
        self._session = self._place_session(cfg, p)
        log.info("init %dx%d@%d gop=%d profile=%s rc=%s bitrate=%d cabac=%s "
                 "qp0=%d", p.width, p.height, p.framerate, p.gop_size,
                 p.profile, cfg.rc_mode, cfg.bitrate, cfg.cabac, qp)
        return EncoderRetCode.VIDEO_ENCODER_SUCCESS

    @staticmethod
    def _reference_policy_config(p: P.EncodeParams, qp: int) -> EncoderConfig:
        """The reference's InitParamExt policy
        (video_codec/VideoEncoderOpenH264.cpp:239-291): RC_BITRATE_MODE at
        the persist bitrate property, CABAC (iEntropyCodingModeFlag = 1;
        gated here on profile >= main since baseline forbids it), in-loop
        deblocking on, full intra toolset (I_4x4 + I_16x16), GOP =
        uiIntraPeriod. qp seeds the rate controller's starting point."""
        return EncoderConfig(
            width=p.width, height=p.height, qp=qp, gop_size=p.gop_size,
            profile=p.profile, rc_mode="cbr", bitrate=p.bitrate,
            framerate=p.framerate, deblock=True, i4x4=True,
            cabac=p.profile in ("main", "high"))

    def _place_session(self, cfg: EncoderConfig, p: P.EncodeParams):
        """Least-load multi-device placement (ni_rsrc_allocate_auto analog,
        vendor/netint/ni_rsrc_api.h:343-348): with more than one CUDA
        device and a session device of type cuda, the session lands on a
        ShardedEncoderSession over the pool's least-loaded devices.
        Otherwise (one card, or the CPU) the single-device session;
        property media.tpu.multichip=1/0 forces/disables. A forced
        placement draws from parallel.sharding.get_pool(), whose devices
        are every CUDA device (one tile on the one card of a one-GPU
        host). A placement that fails (a CABAC or lossless configuration,
        which the sharded session refuses, or a pool without CUDA) logs a
        warning and keeps the single-device session."""
        want = self._store.get_str(P.KEY_MULTICHIP)
        auto = (self._device.type == "cuda"
                and torch.cuda.device_count() > 1)
        if (want == "1") or (auto and want != "0"):
            try:
                from ..parallel.sharding import ShardedEncoderSession, get_pool

                pool = get_pool()
                n_dev = len(pool.loads())
                if p.height // 16 >= n_dev:
                    sid, devs = pool.allocate(p.width, p.height, p.framerate,
                                              n_devices=n_dev)
                    try:
                        sess = ShardedEncoderSession(cfg, devices=devs)
                    except Exception:
                        pool.release(sid)
                        raise
                    sess._pool_sid = sid
                    log.info("placed on %d-device mesh (pool id %d)",
                             len(devs), sid)
                    return sess
            except Exception as e:
                log.warn("multi-chip placement failed (%s); single chip", e)
        return EncoderSession(cfg, device=self._device)

    def start_encoder(self) -> EncoderRetCode:
        if self._session is None:
            return EncoderRetCode.VIDEO_ENCODER_NOT_INITED
        self._started = True
        return EncoderRetCode.VIDEO_ENCODER_SUCCESS

    def encode_one_frame(self, data) -> tuple[EncoderRetCode, bytes]:
        """Returns (code, annexb_bytes). The bytes reference is valid until
        the next call, matching the reference's buffer-aliasing contract."""
        if not self._started or self._session is None:
            return EncoderRetCode.VIDEO_ENCODER_NOT_INITED, b""
        p = self._params
        if len(data) < p.width * p.height * 3 // 2:
            # Reference: short input is an encode failure, not a param error
            # (VideoEncoderOpenH264.cpp:307-310).
            log.err("input size %d < frame size %d", len(data),
                    p.width * p.height * 3 // 2)
            return EncoderRetCode.VIDEO_ENCODER_ENCODE_FAIL, b""

        # Per-frame reconfiguration poll (the reference polls properties every
        # frame: VideoEncoderOpenH264.cpp:312-341).
        if self._store.get_str(P.KEY_PARAM_ADJUSTING) == "1":
            self._store.set(P.KEY_PARAM_ADJUSTING, "0")
            code = self._maybe_reconfigure()
            if code != EncoderRetCode.VIDEO_ENCODER_SUCCESS:
                return code, b""
        if self._store.get_str(P.KEY_FORCE_KEYFRAME) == "1":
            self._store.set(P.KEY_FORCE_KEYFRAME, "0")
            self._session.force_keyframe()
            self._stats.idr_reqs += 1
            log.info("forced keyframe")

        import time as _time

        t0 = _time.perf_counter()
        try:
            self._last_output = self._session.encode_frame(data)
        except Exception as e:  # encode must not propagate, per the C contract
            log.err("encode failed: %s", e)
            return EncoderRetCode.VIDEO_ENCODER_ENCODE_FAIL, b""
        self._stats.on_frame(len(self._last_output),
                             _time.perf_counter() - t0,
                             self._current_qp())
        return EncoderRetCode.VIDEO_ENCODER_SUCCESS, self._last_output

    def stop_encoder(self) -> EncoderRetCode:
        self._started = False
        return EncoderRetCode.VIDEO_ENCODER_SUCCESS

    def destroy_encoder(self) -> EncoderRetCode:
        # Idempotent, like the reference's guarded destroy. A pool-placed
        # session returns its capacity (ni_rsrc_release_resource analog).
        sid = getattr(self._session, "_pool_sid", None)
        if sid is not None:
            try:
                from ..parallel.sharding import get_pool

                get_pool().release(sid)
            except Exception:
                pass
        self._session = None
        self._started = False
        return EncoderRetCode.VIDEO_ENCODER_SUCCESS

    def reset_encoder(self) -> EncoderRetCode:
        """Destroy+init+start (reference ResetEncoder semantics)."""
        self.destroy_encoder()
        code = self.init_encoder()
        if code != EncoderRetCode.VIDEO_ENCODER_SUCCESS:
            return EncoderRetCode.VIDEO_ENCODER_RESET_FAIL
        return self.start_encoder()

    # --------------------------------------------------------------- helpers

    def _maybe_reconfigure(self) -> EncoderRetCode:
        try:
            new = P.read_encode_params(self._store)
        except ValueError as e:
            log.err("param adjust rejected: %s", e)
            return EncoderRetCode.VIDEO_ENCODER_INVALID_PARAM
        if new != self._params:
            log.info("params changed -> reset")
            self._params = new
            return self.reset_encoder()
        return EncoderRetCode.VIDEO_ENCODER_SUCCESS

    def _current_qp(self) -> float:
        s = self._session
        if s is None:
            return 0.0
        rc = getattr(s, "rc_state", None) or getattr(
            getattr(s, "base", None), "rc_state", None)
        if rc and getattr(s, "cfg", None) is not None and s.cfg.rc_mode == "cbr":
            return float(rc["qp"])
        cfg = getattr(s, "cfg", None)
        return float(cfg.qp) if cfg is not None else 0.0

    def get_encoder_statistics(self) -> dict:
        """Queryable counters, the SEncoderStatistics analog
        (vendor/openh264/codec_app_def.h:735-760): geometry, frame/byte
        counts, average/latest frame rate and encode speed, average QP,
        forced-IDR requests. The reference exposes this struct but never
        surfaces it through the adapter; here it is a first-class API."""
        p = self._params
        st = self._stats
        return {
            "width": p.width if p else 0,
            "height": p.height if p else 0,
            "input_frame_count": st.frames,
            "encoded_bytes": st.bytes_out,
            "bitrate_bps": st.bitrate_bps(),
            "average_frame_speed_ms": st.avg_speed_ms(),
            "average_frame_rate": st.avg_fps(),
            "latest_frame_rate": st.latest_fps(),
            "average_frame_qp": st.avg_qp(),
            "idr_req_num": st.idr_reqs,
            "statistics_ts": st.ts(),
        }

    @property
    def session(self) -> EncoderSession | None:
        return self._session


def _bitrate_to_qp(bitrate: int, width: int, height: int, fps: int) -> int:
    """Seed QP for the CBR rate controller's first frame (the controller
    converges from here): bits-per-pixel -> QP on a log curve."""
    import math

    bpp = bitrate / (width * height * fps)
    qp = int(round(18 - 6 * math.log2(max(bpp, 1e-4) / 0.8)))
    return max(10, min(44, qp))


def create_video_encoder(store: P.ParamStore | None = None,
                         device="cuda") -> VideoEncoder | None:
    """Factory honoring the backend-select key (reference:
    VideoCodecApi.cpp:21-38; 0 was OpenH264-SW, 1/2 the HW H.264/H.265).
    device: as VideoEncoder's; resolved first, so that it raises without
    CUDA whatever the format."""
    device = resolve_device(device)
    store = store if store is not None else P.ParamStore()
    fmt = store.get_int(P.KEY_ENCODE_FORMAT, 1)
    if fmt in (0, 1):
        return VideoEncoder(store, CodecFormat.H264, device=device)
    if fmt == 2:
        return VideoEncoder(store, CodecFormat.H265, device=device)
    log.err("unknown encode format %d", fmt)
    return None


def destroy_video_encoder(encoder: VideoEncoder) -> EncoderRetCode:
    if encoder is None:
        return EncoderRetCode.VIDEO_ENCODER_DESTROY_FAIL
    return encoder.destroy_encoder()
