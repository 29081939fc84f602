"""The intra wavefront (csrc/intra_wave.cu, pipeline/encoder.py:
intra_encode): one activity a wave, R + C - 1 waves an IDR. Its time counts
in kernel_ms_per_frame; no metric reads its roofline yet."""

PATTERN = r"\bintra_encode_kernel\b"
