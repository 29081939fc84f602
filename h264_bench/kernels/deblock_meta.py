"""The deblocking meta (csrc/deblock_meta.cu, pipeline/deblock_apply.py):
one activity a deblocked picture. Its time counts in kernel_ms_per_frame;
no metric reads its roofline yet."""

PATTERN = r"\bdeblock_meta_kernel\b"
