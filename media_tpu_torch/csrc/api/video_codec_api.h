/* C ABI for the PyTorch/CUDA video codec (media_tpu_torch).
 *
 * Semantic mirror of the reference's encoder contract
 * (video_codec/VideoCodecApi.h: CreateVideoEncoder/DestroyVideoEncoder plus
 * the 6-method VideoEncoder lifecycle, EncoderRetCode 0x00-0x0A) and decoder
 * contract (video_decoder/include/VideoDecoder.h) expressed as C functions
 * over opaque handles, so C/C++ callers of the reference can switch by
 * relinking. The port's copy of the JAX package's csrc/api/video_codec_api.h:
 * the same enum names and values, the same functions and signatures, and two
 * factories more that name the torch device. The implementation embeds the
 * Python/PyTorch runtime.
 */

#ifndef MEDIA_TPU_TORCH_VIDEO_CODEC_API_H_
#define MEDIA_TPU_TORCH_VIDEO_CODEC_API_H_

#include <stdint.h>
#include <stddef.h>

#ifdef __cplusplus
extern "C" {
#endif

/* Value-exact with the reference's EncoderRetCode
 * (video_codec/VideoCodecApi.h:8-20); codes >= 0x100 are extensions. */
typedef enum {
  VIDEO_ENCODER_SUCCESS = 0x00,
  VIDEO_ENCODER_CREATE_FAIL = 0x01,
  VIDEO_ENCODER_INIT_FAIL = 0x02,
  VIDEO_ENCODER_START_FAIL = 0x03,
  VIDEO_ENCODER_ENCODE_FAIL = 0x04,
  VIDEO_ENCODER_STOP_FAIL = 0x05,
  VIDEO_ENCODER_DESTROY_FAIL = 0x06,
  VIDEO_ENCODER_REGISTER_FAIL = 0x07,
  VIDEO_ENCODER_RESET_FAIL = 0x08,
  VIDEO_ENCODER_FORCE_KEY_FRAME_FAIL = 0x09,
  VIDEO_ENCODER_SET_ENCODE_PARAMS_FAIL = 0x0A,
  VIDEO_ENCODER_NOT_INITED = 0x100,
  VIDEO_ENCODER_INVALID_PARAM = 0x101,
  VIDEO_ENCODER_UNSUPPORTED = 0x102,
} MtpuEncoderRetCode;

/* Value-exact with the reference's DecoderRetCode
 * (video_decoder/include/VideoDecoder.h:10-26). */
typedef enum {
  VIDEO_DECODER_SUCCESS = 0,
  VIDEO_DECODER_CREATE_FAIL = 1,
  VIDEO_DECODER_INIT_FAIL = 2,
  VIDEO_DECODER_START_FAIL = 3,
  VIDEO_DECODER_DECODE_FAIL = 4,
  VIDEO_DECODER_STOP_FAIL = 5,
  VIDEO_DECODER_DESTROY_FAIL = 6,
  VIDEO_DECODER_RESET_FAIL = 7,
  VIDEO_DECODER_GET_DECODE_PARAMS_FAIL = 8,
  VIDEO_DECODER_SET_DECODE_PARAMS_FAIL = 9,
  VIDEO_DECODER_SET_FUNC_FAIL = 10,
  VIDEO_DECODER_WRITE_OVERFLOW = 11,
  VIDEO_DECODER_READ_UNDERFLOW = 12,
  VIDEO_DECODER_BAD_PIC_SIZE = 13,
  VIDEO_DECODER_EOS = 14,
  VIDEO_DECODER_NOT_INITED = 0x100,
  VIDEO_DECODER_INVALID_PARAM = 0x101,
  VIDEO_DECODER_UNSUPPORTED = 0x102,
} MtpuDecoderRetCode;

typedef struct MtpuVideoEncoder MtpuVideoEncoder; /* opaque */

/* Factory honoring the ro.vmi.demo.video.encode.format selection, like the
 * reference's CreateVideoEncoder (VideoCodecApi.cpp:21-38), on the torch
 * device "cuda". Returns NULL on failure, also when CUDA is absent: there is
 * no fall-back to the CPU. The selection is read when the encoder is created,
 * from a fresh property store, so the format set later through
 * MtpuEncoderSetParam does not reach it. */
MtpuVideoEncoder* CreateVideoEncoder(void);
/* The same on a named torch device ("cuda", "cuda:1", "cpu"); NULL means
 * "cuda". Returns NULL when the device does not resolve. */
MtpuVideoEncoder* CreateVideoEncoderOn(const char* device);
MtpuEncoderRetCode DestroyVideoEncoder(MtpuVideoEncoder* enc);

/* Session configuration (the property-store analog; call before Init). */
MtpuEncoderRetCode MtpuEncoderSetParam(MtpuVideoEncoder* enc, const char* key,
                                       const char* value);

MtpuEncoderRetCode InitEncoder(MtpuVideoEncoder* enc);
MtpuEncoderRetCode StartEncoder(MtpuVideoEncoder* enc);
/* Output buffer is owned by the encoder and valid until the next
 * EncodeOneFrame call, matching the reference's aliasing contract. */
MtpuEncoderRetCode EncodeOneFrame(MtpuVideoEncoder* enc, const uint8_t* in,
                                  uint32_t in_len, uint8_t** out,
                                  uint32_t* out_len);
MtpuEncoderRetCode StopEncoder(MtpuVideoEncoder* enc);
MtpuEncoderRetCode ResetEncoder(MtpuVideoEncoder* enc);

/* ------------------------- decoder half -----------------------------------
 * Mirrors the reference decoder factories + lifecycle
 * (video_decoder/include/VideoDecoder.h:83-210) flattened to C functions. */

typedef struct MtpuVideoDecoder MtpuVideoDecoder; /* opaque */

/* The decoder on the torch device "cuda"; NULL on failure, also when CUDA is
 * absent. */
MtpuVideoDecoder* CreateVideoDecoder(void);
/* The same on a named torch device; NULL means "cuda". */
MtpuVideoDecoder* CreateVideoDecoderOn(const char* device);
MtpuDecoderRetCode DestroyVideoDecoder(MtpuVideoDecoder* dec);

/* codec_format: 0 = H.264 (VideoDecoder.h CreateDecoder). */
MtpuDecoderRetCode MtpuCreateDecoder(MtpuVideoDecoder* dec,
                                     uint32_t codec_format);
MtpuDecoderRetCode InitDecoder(MtpuVideoDecoder* dec);
MtpuDecoderRetCode SetDecodeParams(MtpuVideoDecoder* dec, uint32_t width,
                                   uint32_t height, uint32_t pixel_format);
MtpuDecoderRetCode StartDecoder(MtpuVideoDecoder* dec);
/* len == 0 marks end of stream (reference SendStreamData semantics). */
MtpuDecoderRetCode SendStreamData(MtpuVideoDecoder* dec, const uint8_t* buf,
                                  uint32_t len);
/* Copies the next decoded I420 frame into dst; *filled receives the byte
 * count. READ_UNDERFLOW when no frame is ready, EOS past the last frame,
 * BAD_PIC_SIZE + geometry adoption on resolution change. */
MtpuDecoderRetCode RetrieveFrameData(MtpuVideoDecoder* dec, uint8_t* dst,
                                     uint32_t max_len, uint32_t* filled,
                                     uint32_t* width, uint32_t* height);
MtpuDecoderRetCode FlushDecoder(MtpuVideoDecoder* dec);
MtpuDecoderRetCode StopDecoder(MtpuVideoDecoder* dec);
/* Stop + fresh decode engine + start (decoder twin of ResetEncoder). */
MtpuDecoderRetCode ResetDecoder(MtpuVideoDecoder* dec);

/* Current session parameters (reference GetDecodeParams). */
MtpuDecoderRetCode GetDecodeParams(MtpuVideoDecoder* dec, uint32_t* width,
                                   uint32_t* height, uint32_t* pixel_format,
                                   uint32_t* codec_format);

/* Decoder events (value-exact with VideoDecoder.h DecodeEventIndex). */
typedef struct {
  uint32_t width;
  uint32_t height;
} MtpuPicInfo;

/* Event callback (reference SetCallbacks, VideoDecoder.h:121-143):
 * event = 1 (PIC_INFO_CHANGE) carries the new geometry in *info. `user`
 * round-trips the registration context. */
typedef void (*MtpuDecoderEventCallback)(uint32_t event,
                                         const MtpuPicInfo* info, void* user);
MtpuDecoderRetCode SetDecoderCallbacks(MtpuVideoDecoder* dec,
                                       MtpuDecoderEventCallback cb,
                                       void* user);

/* Injected output-copy hook (reference SetCopyFrameFunc / m_copyFrame):
 * called with the decoded I420 payload; returns bytes written into dst, or
 * < 0 to fall back to the plain copy. */
typedef int64_t (*MtpuCopyFrameFunc)(const uint8_t* src, uint32_t src_len,
                                     uint8_t* dst, uint32_t dst_cap,
                                     const MtpuPicInfo* info, void* user);
MtpuDecoderRetCode SetCopyFrameFunc(MtpuVideoDecoder* dec,
                                    MtpuCopyFrameFunc fn, void* user);

#ifdef __cplusplus
}
#endif

#endif /* MEDIA_TPU_TORCH_VIDEO_CODEC_API_H_ */
