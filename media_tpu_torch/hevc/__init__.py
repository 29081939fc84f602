"""H.265/HEVC codec path (skeleton: intra-only).

The reference exposes H.265 as encoder format 2
(video_codec/VideoCodecApi.cpp:23-38, VideoEncoderNetint.cpp:107-117) and
decodes its NAL layer (VideoDecoderNetint.cpp:822-824), delegating all math
to the NETINT ASIC. Here the path is first-party: spec 7.3.2 parameter-set
syntax, the 2-byte NAL layer, and an intra-only CTU coding layer (planar/DC
4x4 TUs, DST-VII luma transform, HEVC quantizer scales) entropy-coded with
the shared CABAC engine. See hevc/codec.py for the precise scope and the
documented simplifications.
"""

from .codec import HevcEncoderSession, HevcRefDecoder  # noqa: F401
