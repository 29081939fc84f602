/* Third-party conformance oracle: decode/encode via the system libavcodec.
 *
 * Role: TEST/VALIDATION ONLY. A copy of the JAX package's csrc/avshim.c for
 * media_tpu_torch/testing/avref.py. The product encode/decode paths are the
 * port's own (PyTorch + CUDA, and the C++ coders in this directory); this
 * shim exists so the tests and chip_smoke.py can assert that the port's
 * bitstreams are accepted bit-exactly by an independent, widely-deployed
 * conformant decoder (ffmpeg's h264/hevc), and that the port's decoders
 * handle streams produced by an independent conformant encoder (libx264).
 * The reference gets the same property by delegating to OpenH264/NETINT
 * silicon (video_codec/VideoEncoderOpenH264.cpp:344); the port earns it by
 * cross-checking against libavcodec.
 *
 * Build: gcc -O2 -shared -fPIC avshim.c -lavcodec -lavutil -o libavshim.so
 */

#include <libavcodec/avcodec.h>
#include <libavutil/imgutils.h>
#include <libavutil/opt.h>
#include <stdint.h>
#include <string.h>

/* Decode an Annex-B elementary stream; write I420 frames (tightly packed
 * Y then U then V, each frame w*h*3/2 bytes) into out.  Returns the number
 * of frames decoded, or a negative error code.  *out_w/*out_h receive the
 * coded frame geometry of the first frame. */
int64_t avshim_decode(const uint8_t *data, int64_t size,
                      const char *codec_name, uint8_t *out, int64_t out_cap,
                      int32_t *out_w, int32_t *out_h, int32_t max_frames) {
  const AVCodec *codec = avcodec_find_decoder_by_name(codec_name);
  if (!codec) return -1;
  AVCodecContext *ctx = avcodec_alloc_context3(codec);
  if (!ctx) return -2;
  /* single-threaded for determinism */
  ctx->thread_count = 1;
  if (avcodec_open2(ctx, codec, NULL) < 0) {
    avcodec_free_context(&ctx);
    return -3;
  }
  AVCodecParserContext *parser = av_parser_init(codec->id);
  AVPacket *pkt = av_packet_alloc();
  AVFrame *frame = av_frame_alloc();
  int64_t nframes = 0;
  int64_t written = 0;
  int err = 0;

  const uint8_t *p = data;
  int64_t remaining = size;
  int parser_done = 0, flushed = 0;
  while (!err) {
    if (!parser_done) {
      uint8_t *pp = NULL;
      int psize = 0;
      /* a zero-size call drains the parser's buffered final frame */
      int used = av_parser_parse2(parser, ctx, &pp, &psize, p,
                                  (int)remaining, AV_NOPTS_VALUE,
                                  AV_NOPTS_VALUE, 0);
      if (used < 0) { err = -4; break; }
      if (remaining == 0) parser_done = 1;
      p += used;
      remaining -= used;
      if (psize == 0) continue;
      pkt->data = pp;
      pkt->size = psize;
      if (avcodec_send_packet(ctx, pkt) < 0) { err = -5; break; }
    } else if (!flushed) {
      if (avcodec_send_packet(ctx, NULL) < 0) { err = -5; break; }
      flushed = 1;
    } else {
      break;
    }
    for (;;) {
      int r = avcodec_receive_frame(ctx, frame);
      if (r == AVERROR(EAGAIN) || r == AVERROR_EOF) break;
      if (r < 0) { err = -6; goto done; }
      if (nframes == 0) {
        *out_w = frame->width;
        *out_h = frame->height;
      }
      if (nframes < max_frames) {
        int w = frame->width, h = frame->height;
        int64_t need = (int64_t)w * h * 3 / 2;
        if (written + need > out_cap) { err = -7; goto done; }
        if (frame->format != AV_PIX_FMT_YUV420P &&
            frame->format != AV_PIX_FMT_YUVJ420P) { err = -8; goto done; }
        for (int row = 0; row < h; row++)
          memcpy(out + written + (int64_t)row * w,
                 frame->data[0] + (int64_t)row * frame->linesize[0], w);
        written += (int64_t)w * h;
        for (int pl = 1; pl <= 2; pl++) {
          for (int row = 0; row < h / 2; row++)
            memcpy(out + written + (int64_t)row * (w / 2),
                   frame->data[pl] + (int64_t)row * frame->linesize[pl],
                   w / 2);
          written += (int64_t)(w / 2) * (h / 2);
        }
      }
      nframes++;
      av_frame_unref(frame);
    }
    if (flushed) break;
  }
done:
  av_parser_close(parser);
  av_packet_free(&pkt);
  av_frame_free(&frame);
  avcodec_free_context(&ctx);
  return err ? err : nframes;
}

/* Encode n I420 frames with an independent conformant encoder (libx264 if
 * present, else ffmpeg's encoder for the codec).  Produces an Annex-B
 * elementary stream in out.  opts is a ":"-separated list of
 * libx264-style x264-params (may be NULL).  Returns bytes written or <0. */
int64_t avshim_encode(const uint8_t *frames, int32_t n, int32_t w, int32_t h,
                      int32_t qp, int32_t gop, const char *codec_name,
                      const char *x264_params, uint8_t *out, int64_t out_cap) {
  const AVCodec *codec = avcodec_find_encoder_by_name(codec_name);
  if (!codec) return -1;
  AVCodecContext *ctx = avcodec_alloc_context3(codec);
  if (!ctx) return -2;
  ctx->width = w;
  ctx->height = h;
  ctx->time_base = (AVRational){1, 30};
  ctx->framerate = (AVRational){30, 1};
  ctx->pix_fmt = AV_PIX_FMT_YUV420P;
  ctx->gop_size = gop;
  ctx->max_b_frames = 0;
  ctx->thread_count = 1;
  av_opt_set(ctx->priv_data, "preset", "medium", 0);
  {
    char qpbuf[512];
    int rc;
    snprintf(qpbuf, sizeof qpbuf, "qp=%d:annexb=1%s%s", qp,
             x264_params && x264_params[0] ? ":" : "",
             x264_params ? x264_params : "");
    rc = av_opt_set(ctx->priv_data, "x264-params", qpbuf, 0);
    if (rc < 0) {
      avcodec_free_context(&ctx);
      return -100 + rc;
    }
  }
  if (avcodec_open2(ctx, codec, NULL) < 0) {
    avcodec_free_context(&ctx);
    return -3;
  }
  AVFrame *frame = av_frame_alloc();
  AVPacket *pkt = av_packet_alloc();
  frame->format = ctx->pix_fmt;
  frame->width = w;
  frame->height = h;
  av_frame_get_buffer(frame, 0);
  int64_t written = 0;
  int err = 0;
  for (int32_t i = 0; i <= n && !err; i++) {
    AVFrame *f = NULL;
    if (i < n) {
      av_frame_make_writable(frame);
      const uint8_t *src = frames + (int64_t)i * w * h * 3 / 2;
      for (int row = 0; row < h; row++)
        memcpy(frame->data[0] + (int64_t)row * frame->linesize[0],
               src + (int64_t)row * w, w);
      src += (int64_t)w * h;
      for (int pl = 1; pl <= 2; pl++) {
        for (int row = 0; row < h / 2; row++)
          memcpy(frame->data[pl] + (int64_t)row * frame->linesize[pl],
                 src + (int64_t)row * (w / 2), w / 2);
        src += (int64_t)(w / 2) * (h / 2);
      }
      frame->pts = i;
      f = frame;
    }
    if (avcodec_send_frame(ctx, f) < 0) { err = -5; break; }
    for (;;) {
      int r = avcodec_receive_packet(ctx, pkt);
      if (r == AVERROR(EAGAIN) || r == AVERROR_EOF) break;
      if (r < 0) { av_packet_unref(pkt); err = -6; break; }
      if (written + pkt->size > out_cap) { av_packet_unref(pkt); err = -7; break; }
      memcpy(out + written, pkt->data, pkt->size);
      written += pkt->size;
      av_packet_unref(pkt);
    }
  }
  av_frame_free(&frame);
  av_packet_free(&pkt);
  avcodec_free_context(&ctx);
  return err ? err : written;
}
