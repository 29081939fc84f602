"""Return-code contracts, value-exact with the reference ABIs.

EncoderRetCode: video_codec/VideoCodecApi.h:8-20 (0x00-0x0A).
DecoderRetCode: video_decoder/include/VideoDecoder.h:10-26 (sequential 0-14),
including the backpressure codes (WRITE_OVERFLOW / READ_UNDERFLOW),
BAD_PIC_SIZE and EOS.

Codes >= 0x100 are documented extensions of this framework (lifecycle and
argument-validation outcomes the reference folds into its generic *_FAIL
codes); they never collide with the reference value space.
"""

import enum


class EncoderRetCode(enum.IntEnum):
    VIDEO_ENCODER_SUCCESS = 0x00
    VIDEO_ENCODER_CREATE_FAIL = 0x01
    VIDEO_ENCODER_INIT_FAIL = 0x02
    VIDEO_ENCODER_START_FAIL = 0x03
    VIDEO_ENCODER_ENCODE_FAIL = 0x04
    VIDEO_ENCODER_STOP_FAIL = 0x05
    VIDEO_ENCODER_DESTROY_FAIL = 0x06
    VIDEO_ENCODER_REGISTER_FAIL = 0x07
    VIDEO_ENCODER_RESET_FAIL = 0x08
    VIDEO_ENCODER_FORCE_KEY_FRAME_FAIL = 0x09
    VIDEO_ENCODER_SET_ENCODE_PARAMS_FAIL = 0x0A
    # --- extensions (not in VideoCodecApi.h) ---
    VIDEO_ENCODER_NOT_INITED = 0x100
    VIDEO_ENCODER_INVALID_PARAM = 0x101
    VIDEO_ENCODER_UNSUPPORTED = 0x102


class DecoderRetCode(enum.IntEnum):
    VIDEO_DECODER_SUCCESS = 0
    VIDEO_DECODER_CREATE_FAIL = 1
    VIDEO_DECODER_INIT_FAIL = 2
    VIDEO_DECODER_START_FAIL = 3
    VIDEO_DECODER_DECODE_FAIL = 4
    VIDEO_DECODER_STOP_FAIL = 5
    VIDEO_DECODER_DESTROY_FAIL = 6
    VIDEO_DECODER_RESET_FAIL = 7
    VIDEO_DECODER_GET_DECODE_PARAMS_FAIL = 8
    VIDEO_DECODER_SET_DECODE_PARAMS_FAIL = 9
    VIDEO_DECODER_SET_FUNC_FAIL = 10
    VIDEO_DECODER_WRITE_OVERFLOW = 11
    VIDEO_DECODER_READ_UNDERFLOW = 12
    VIDEO_DECODER_BAD_PIC_SIZE = 13
    VIDEO_DECODER_EOS = 14
    # --- extensions (not in VideoDecoder.h) ---
    VIDEO_DECODER_NOT_INITED = 0x100
    VIDEO_DECODER_INVALID_PARAM = 0x101
    VIDEO_DECODER_UNSUPPORTED = 0x102


class DecoderEvent(enum.IntEnum):
    """Event indices for the decoder event callback (VideoDecoder.h:51-62)."""

    INDEX_PIC_INFO_CHANGE = 0x01
    INDEX_ERROR = 0x02
    INDEX_EOS = 0x03


class PixelFormat(enum.IntEnum):
    """Decoder output pixel formats (VideoDecoder.h:38-48 subset)."""

    YUV420P = 0
    NV12 = 1


class CodecFormat(enum.IntEnum):
    H264 = 0
    H265 = 1
