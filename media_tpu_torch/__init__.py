"""media_tpu_torch: the PyTorch/CUDA port of media_tpu's H.264 encoder.

Imports torch and never JAX. From media_tpu it uses only the JAX-free host
modules (core.bitstream/nal/syntax, utils.yuv, entropy.cavlc and
cavlc_tables, pipeline.mv_pred); everything else it needs is ported or
copied here. Module names mirror media_tpu's.

Entry point: media_tpu_torch.pipeline.codec.EncoderSession(cfg, device=...).
Hand-written CUDA kernels live in csrc/ and are built by kernels.py.
"""

__version__ = "0.1.0"
