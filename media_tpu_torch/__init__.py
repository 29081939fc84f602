"""media_tpu_torch: the PyTorch/CUDA port of media_tpu's H.264 codec.

Imports torch, never JAX, and nothing of media_tpu: the host modules it
needs (core.bitstream/nal/syntax, utils.yuv, entropy.cavlc and
cavlc_tables, pipeline.mv_pred) are its own copies, at the same relative
paths. Module names mirror media_tpu's.

Entry points, on "cuda" unless the caller passes device="cpu":
media_tpu_torch.pipeline.codec.EncoderSession(cfg) and
media_tpu_torch.pipeline.decoder_tpu.TpuDecoder().
Hand-written CUDA kernels live in csrc/ and are built by kernels.py.
"""

__version__ = "0.1.0"
