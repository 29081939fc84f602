/* A standalone C caller of the port's C ABI (libVideoCodec.so): encodes a
 * raw I420 file through the encoder lifecycle and never touches Python
 * itself (the library embeds the interpreter).
 *
 *   capi_drive --in FRAMES.yuv --width W --height H --out AUS.bin
 *              [--device DEV] [--set KEY=VALUE]... [--at I:KEY=VALUE]...
 *
 * --set properties are set through MtpuEncoderSetParam before InitEncoder,
 * --at properties just before frame I (0-based). --device names the torch
 * device (CreateVideoEncoderOn); without it the device is "cuda". Every
 * frame of the file is encoded: CreateVideoEncoderOn -> MtpuEncoderSetParam
 * -> InitEncoder -> StartEncoder -> EncodeOneFrame per frame -> StopEncoder
 * -> DestroyVideoEncoder.
 *
 * AUS.bin holds one record per lifecycle call after the factory, in order:
 * the return code and the byte count as little-endian uint32, then that many
 * bytes (the AU of an EncodeOneFrame, nothing for the other calls). The last
 * line of standard output is a JSON object of host-clock seconds: "create_s"
 * (factory: interpreter start, imports), "init_s" (InitEncoder +
 * StartEncoder), "frame_ms" (each EncodeOneFrame), "stop_s". Exits 0 when
 * every call returned SUCCESS, 1 on a usage or I/O error, 2 when the
 * factory returned NULL, 3 on any other code.
 *
 * Build: media_tpu_torch/native/__init__.py build_capi_drive().
 */

#define _POSIX_C_SOURCE 199309L

#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <time.h>

#include "video_codec_api.h"

#define MAX_PROPS 64

typedef struct {
  long frame; /* -1: before InitEncoder */
  char* key;
  char* value;
} Prop;

static double now_s(void) {
  struct timespec t;
  clock_gettime(CLOCK_MONOTONIC, &t);
  return (double)t.tv_sec + (double)t.tv_nsec * 1e-9;
}

static int usage(const char* why) {
  fprintf(stderr,
          "capi_drive: %s\nusage: capi_drive --in FRAMES.yuv --width W "
          "--height H --out AUS.bin [--device DEV] [--set KEY=VALUE]... "
          "[--at I:KEY=VALUE]...\n",
          why);
  return 1;
}

/* "KEY=VALUE" -> p->key, p->value (in place). */
static int split_prop(char* s, Prop* p) {
  char* eq = strchr(s, '=');
  if (!eq || eq == s) return 0;
  *eq = '\0';
  p->key = s;
  p->value = eq + 1;
  return 1;
}

static int put_u32(FILE* f, uint32_t v) {
  uint8_t b[4] = {(uint8_t)v, (uint8_t)(v >> 8), (uint8_t)(v >> 16),
                  (uint8_t)(v >> 24)};
  return fwrite(b, 1, 4, f) == 4;
}

static int put_record(FILE* f, uint32_t code, const uint8_t* data,
                      uint32_t len) {
  return put_u32(f, code) && put_u32(f, len) &&
         (len == 0 || fwrite(data, 1, len, f) == len);
}

int main(int argc, char** argv) {
  double t_start = now_s();
  const char *in_path = NULL, *out_path = NULL, *device = NULL;
  long width = 0, height = 0;
  Prop props[MAX_PROPS];
  int n_props = 0;
  for (int i = 1; i < argc; i++) {
    if (i + 1 >= argc) return usage("an option lacks its value");
    const char* opt = argv[i];
    char* val = argv[++i];
    if (!strcmp(opt, "--in")) {
      in_path = val;
    } else if (!strcmp(opt, "--out")) {
      out_path = val;
    } else if (!strcmp(opt, "--device")) {
      device = val;
    } else if (!strcmp(opt, "--width")) {
      width = strtol(val, NULL, 10);
    } else if (!strcmp(opt, "--height")) {
      height = strtol(val, NULL, 10);
    } else if (!strcmp(opt, "--set") || !strcmp(opt, "--at")) {
      if (n_props == MAX_PROPS) return usage("too many properties");
      Prop* p = &props[n_props];
      p->frame = -1;
      if (!strcmp(opt, "--at")) {
        char* colon = strchr(val, ':');
        if (!colon) return usage("--at takes I:KEY=VALUE");
        *colon = '\0';
        p->frame = strtol(val, NULL, 10);
        val = colon + 1;
      }
      if (!split_prop(val, p)) return usage("a property is not KEY=VALUE");
      n_props++;
    } else {
      return usage("unknown option");
    }
  }
  if (!in_path || !out_path || width <= 0 || height <= 0 || width % 2 ||
      height % 2)
    return usage("--in, --out and an even --width and --height are needed");

  size_t frame_len = (size_t)width * (size_t)height * 3 / 2;
  FILE* fin = fopen(in_path, "rb");
  if (!fin) return usage("cannot open --in");
  fseek(fin, 0, SEEK_END);
  long in_size = ftell(fin);
  fseek(fin, 0, SEEK_SET);
  if (in_size <= 0 || (size_t)in_size % frame_len) {
    fclose(fin);
    return usage("--in is not a whole number of frames");
  }
  long n_frames = (long)((size_t)in_size / frame_len);
  uint8_t* frames = malloc((size_t)in_size);
  if (!frames || fread(frames, 1, (size_t)in_size, fin) != (size_t)in_size) {
    fclose(fin);
    free(frames);
    return usage("cannot read --in");
  }
  fclose(fin);
  FILE* fout = fopen(out_path, "wb");
  if (!fout) {
    free(frames);
    return usage("cannot open --out");
  }

  int status = 0;
  double t0 = now_s();
  MtpuVideoEncoder* enc = CreateVideoEncoderOn(device);
  double t_create = now_s();
  if (!enc) {
    fprintf(stderr, "capi_drive: CreateVideoEncoderOn(%s) returned NULL\n",
            device ? device : "NULL");
    fclose(fout);
    free(frames);
    return 2;
  }
  uint32_t code = VIDEO_ENCODER_SUCCESS;
  for (int i = 0; i < n_props && !code; i++)
    if (props[i].frame < 0)
      code = MtpuEncoderSetParam(enc, props[i].key, props[i].value);
  if (code) {
    fprintf(stderr, "capi_drive: MtpuEncoderSetParam: 0x%x\n", code);
    status = 3;
  }
  code = InitEncoder(enc);
  status = status ? status : (code ? 3 : 0);
  put_record(fout, code, NULL, 0);
  code = StartEncoder(enc);
  status = status ? status : (code ? 3 : 0);
  put_record(fout, code, NULL, 0);
  double t_init = now_s();

  double* frame_ms = calloc((size_t)n_frames, sizeof(double));
  for (long f = 0; f < n_frames && frame_ms; f++) {
    for (int i = 0; i < n_props; i++) {
      if (props[i].frame != f) continue;
      uint32_t c = MtpuEncoderSetParam(enc, props[i].key, props[i].value);
      if (c) {
        fprintf(stderr, "capi_drive: MtpuEncoderSetParam before frame %ld: "
                "0x%x\n", f, c);
        status = 3;
      }
    }
    uint8_t* out = NULL;
    uint32_t out_len = 0;
    double tf = now_s();
    code = EncodeOneFrame(enc, frames + (size_t)f * frame_len,
                          (uint32_t)frame_len, &out, &out_len);
    frame_ms[f] = (now_s() - tf) * 1e3;
    if (code) out_len = 0;
    if (!put_record(fout, code, out, out_len)) status = 1;
    if (code && !status) status = 3;
  }
  double t_stop = now_s();
  code = StopEncoder(enc);
  put_record(fout, code, NULL, 0);
  if (code && !status) status = 3;
  code = DestroyVideoEncoder(enc);
  put_record(fout, code, NULL, 0);
  if (code && !status) status = 3;
  double t_end = now_s();
  if (fclose(fout) != 0 || !frame_ms) status = 1;

  printf("{\"create_s\": %.6f, \"init_s\": %.6f, \"stop_s\": %.6f, "
         "\"main_s\": %.6f, \"frame_ms\": [",
         t_create - t0, t_init - t_create, t_end - t_stop, t_end - t_start);
  for (long f = 0; f < n_frames && frame_ms; f++)
    printf("%s%.3f", f ? ", " : "", frame_ms[f]);
  printf("]}\n");
  free(frame_ms);
  free(frames);
  return status;
}
