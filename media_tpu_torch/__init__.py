"""media_tpu_torch: the PyTorch/CUDA port of media_tpu's H.264 codec.

Imports torch, never JAX, and nothing of media_tpu: the host modules it
needs (core.bitstream/nal/syntax, utils.yuv, entropy.cavlc and
cavlc_tables, pipeline.mv_pred) are its own copies, at the same relative
paths. Module names mirror media_tpu's.

Entry points, on "cuda" unless the caller passes device="cpu": the public
lifecycle API, media_tpu_torch.api.create_video_encoder(store) /
VideoEncoder and create_video_decoder() / VideoDecoder (H.264, and H.265
through the format-2 slot); beneath it
media_tpu_torch.pipeline.codec.EncoderSession(cfg) and
media_tpu_torch.pipeline.decoder_tpu.TpuDecoder(); and in
media_tpu_torch.parallel, sharding.ShardedEncoderSession(cfg) (MB-row
tiles on a list of devices, e.g. devices=["cpu"] * n), sharding.DevicePool(),
gop_dispatch.GopDispatcher (GOPs over threads) and
gop_dispatch_mp.dispatch_multiprocess (GOPs over spawned processes). The
scalar oracle
media_tpu_torch.ref.decoder.ReferenceDecoder and the HEVC package are host
numpy.
Hand-written CUDA kernels live in csrc/ and are built by kernels.py.
"""

__version__ = "0.1.0"
