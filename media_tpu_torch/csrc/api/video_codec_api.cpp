// C ABI bridge: embeds the Python/PyTorch runtime behind the reference-style
// encoder lifecycle (see video_codec_api.h). Works both standalone (owns the
// interpreter) and when loaded into an existing Python process (uses
// PyGILState). The port's copy of the JAX package's csrc/api bridge: it
// drives media_tpu_torch.api on a torch device that the caller names (NULL
// or the void factories: "cuda"), and never falls back to another device.
// Build: media_tpu_torch/native/__init__.py build_capi().

#include "video_codec_api.h"

#include <Python.h>

#include <cstring>
#include <string>

namespace {

struct PyRef {
  PyObject* p = nullptr;
  PyRef() = default;
  explicit PyRef(PyObject* o) : p(o) {}
  ~PyRef() { Py_XDECREF(p); }
  PyRef(const PyRef&) = delete;
  PyRef& operator=(const PyRef&) = delete;
  PyObject* release() { PyObject* o = p; p = nullptr; return o; }
};

bool g_we_initialized = false;

void ensure_python() {
  if (!Py_IsInitialized()) {
    Py_InitializeEx(0);
    g_we_initialized = true;
#if PY_VERSION_HEX < 0x03090000
    PyEval_InitThreads();
#endif
    // Release the GIL taken by Py_Initialize so PyGILState works uniformly.
    PyEval_SaveThread();
  }
}

class Gil {
 public:
  Gil() { state_ = PyGILState_Ensure(); }
  ~Gil() { PyGILState_Release(state_); }

 private:
  PyGILState_STATE state_;
};

}  // namespace

struct MtpuVideoEncoder {
  PyObject* store = nullptr;    // media_tpu_torch.core.params.ParamStore
  PyObject* encoder = nullptr;  // media_tpu_torch.api.VideoEncoder
  std::string last_output;      // owns the EncodeOneFrame result
};

namespace {

const char* kDefaultDevice = "cuda";

// api_mod.<factory>(*args, device=<device>): a new reference, or nullptr
// with the Python error set.
PyObject* call_factory(PyObject* api_mod, const char* factory, PyObject* args,
                       const char* device) {
  PyRef fn(PyObject_GetAttrString(api_mod, factory));
  PyRef kwargs(Py_BuildValue("{s:s}", "device",
                             device ? device : kDefaultDevice));
  if (!fn.p || !kwargs.p) return nullptr;
  return PyObject_Call(fn.p, args, kwargs.p);
}

MtpuVideoEncoder* create_encoder_on(const char* device) {
  ensure_python();
  Gil gil;
  PyRef params_mod(PyImport_ImportModule("media_tpu_torch.core.params"));
  PyRef api_mod(PyImport_ImportModule("media_tpu_torch.api"));
  if (!params_mod.p || !api_mod.p) {
    PyErr_Print();
    return nullptr;
  }
  PyRef store(PyObject_CallMethod(params_mod.p, "ParamStore", nullptr));
  PyRef args(store.p ? PyTuple_Pack(1, store.p) : nullptr);
  if (!args.p) {
    PyErr_Print();
    return nullptr;
  }
  PyRef enc(call_factory(api_mod.p, "create_video_encoder", args.p, device));
  if (!enc.p || enc.p == Py_None) {
    PyErr_Print();
    return nullptr;
  }
  auto* h = new MtpuVideoEncoder();
  h->store = store.release();
  h->encoder = enc.release();
  return h;
}

}  // namespace

extern "C" {

MtpuVideoEncoder* CreateVideoEncoder(void) {
  return create_encoder_on(nullptr);
}

MtpuVideoEncoder* CreateVideoEncoderOn(const char* device) {
  return create_encoder_on(device);
}

MtpuEncoderRetCode DestroyVideoEncoder(MtpuVideoEncoder* enc) {
  if (!enc) return VIDEO_ENCODER_DESTROY_FAIL;
  Gil gil;
  PyRef r(PyObject_CallMethod(enc->encoder, "destroy_encoder", nullptr));
  Py_XDECREF(enc->encoder);
  Py_XDECREF(enc->store);
  delete enc;
  return VIDEO_ENCODER_SUCCESS;
}

MtpuEncoderRetCode MtpuEncoderSetParam(MtpuVideoEncoder* enc, const char* key,
                                       const char* value) {
  if (!enc || !key || !value) return VIDEO_ENCODER_INVALID_PARAM;
  Gil gil;
  PyRef r(PyObject_CallMethod(enc->store, "set", "ss", key, value));
  if (!r.p) {
    PyErr_Print();
    return VIDEO_ENCODER_INVALID_PARAM;
  }
  return VIDEO_ENCODER_SUCCESS;
}

static MtpuEncoderRetCode call_simple(MtpuVideoEncoder* enc, const char* name,
                                      MtpuEncoderRetCode fail_code) {
  if (!enc) return VIDEO_ENCODER_NOT_INITED;
  Gil gil;
  PyRef r(PyObject_CallMethod(enc->encoder, name, nullptr));
  if (!r.p) {
    PyErr_Print();
    return fail_code;
  }
  long code = PyLong_AsLong(r.p);
  return static_cast<MtpuEncoderRetCode>(code);
}

MtpuEncoderRetCode InitEncoder(MtpuVideoEncoder* enc) {
  return call_simple(enc, "init_encoder", VIDEO_ENCODER_INIT_FAIL);
}

MtpuEncoderRetCode StartEncoder(MtpuVideoEncoder* enc) {
  return call_simple(enc, "start_encoder", VIDEO_ENCODER_START_FAIL);
}

MtpuEncoderRetCode StopEncoder(MtpuVideoEncoder* enc) {
  return call_simple(enc, "stop_encoder", VIDEO_ENCODER_STOP_FAIL);
}

MtpuEncoderRetCode ResetEncoder(MtpuVideoEncoder* enc) {
  return call_simple(enc, "reset_encoder", VIDEO_ENCODER_RESET_FAIL);
}

MtpuEncoderRetCode EncodeOneFrame(MtpuVideoEncoder* enc, const uint8_t* in,
                                  uint32_t in_len, uint8_t** out,
                                  uint32_t* out_len) {
  if (!enc || !in || !out || !out_len) return VIDEO_ENCODER_INVALID_PARAM;
  Gil gil;
  PyRef buf(PyBytes_FromStringAndSize(reinterpret_cast<const char*>(in),
                                      static_cast<Py_ssize_t>(in_len)));
  if (!buf.p) return VIDEO_ENCODER_ENCODE_FAIL;
  PyRef r(PyObject_CallMethod(enc->encoder, "encode_one_frame", "O", buf.p));
  if (!r.p || !PyTuple_Check(r.p) || PyTuple_Size(r.p) != 2) {
    PyErr_Print();
    return VIDEO_ENCODER_ENCODE_FAIL;
  }
  long code = PyLong_AsLong(PyTuple_GetItem(r.p, 0));
  if (code != VIDEO_ENCODER_SUCCESS) {
    return static_cast<MtpuEncoderRetCode>(code);
  }
  PyObject* data = PyTuple_GetItem(r.p, 1);
  char* raw = nullptr;
  Py_ssize_t n = 0;
  if (PyBytes_AsStringAndSize(data, &raw, &n) != 0) {
    PyErr_Print();
    return VIDEO_ENCODER_ENCODE_FAIL;
  }
  enc->last_output.assign(raw, static_cast<size_t>(n));
  *out = reinterpret_cast<uint8_t*>(enc->last_output.data());
  *out_len = static_cast<uint32_t>(n);
  return VIDEO_ENCODER_SUCCESS;
}

// ----------------------------- decoder half --------------------------------

struct MtpuVideoDecoder {
  PyObject* decoder = nullptr;  // media_tpu_torch.api.VideoDecoder
};

}  // extern "C"

namespace {

MtpuVideoDecoder* create_decoder_on(const char* device) {
  ensure_python();
  Gil gil;
  PyRef api_mod(PyImport_ImportModule("media_tpu_torch.api"));
  PyRef args(PyTuple_New(0));
  if (!api_mod.p || !args.p) {
    PyErr_Print();
    return nullptr;
  }
  PyRef dec(call_factory(api_mod.p, "create_video_decoder", args.p, device));
  if (!dec.p || dec.p == Py_None) {
    PyErr_Print();
    return nullptr;
  }
  auto* h = new MtpuVideoDecoder();
  h->decoder = dec.release();
  return h;
}

}  // namespace

extern "C" {

MtpuVideoDecoder* CreateVideoDecoder(void) {
  return create_decoder_on(nullptr);
}

MtpuVideoDecoder* CreateVideoDecoderOn(const char* device) {
  return create_decoder_on(device);
}

MtpuDecoderRetCode DestroyVideoDecoder(MtpuVideoDecoder* dec) {
  if (!dec) return VIDEO_DECODER_DESTROY_FAIL;
  Gil gil;
  PyRef r(PyObject_CallMethod(dec->decoder, "destroy_decoder", nullptr));
  Py_XDECREF(dec->decoder);
  delete dec;
  return VIDEO_DECODER_SUCCESS;
}

static MtpuDecoderRetCode dec_simple(MtpuVideoDecoder* dec, const char* name,
                                     MtpuDecoderRetCode fail_code) {
  if (!dec) return VIDEO_DECODER_NOT_INITED;
  Gil gil;
  PyRef r(PyObject_CallMethod(dec->decoder, name, nullptr));
  if (!r.p) {
    PyErr_Print();
    return fail_code;
  }
  return static_cast<MtpuDecoderRetCode>(PyLong_AsLong(r.p));
}

MtpuDecoderRetCode MtpuCreateDecoder(MtpuVideoDecoder* dec,
                                     uint32_t codec_format) {
  if (!dec) return VIDEO_DECODER_NOT_INITED;
  Gil gil;
  PyRef r(PyObject_CallMethod(dec->decoder, "create_decoder", "I",
                              codec_format));
  if (!r.p) {
    PyErr_Print();
    return VIDEO_DECODER_CREATE_FAIL;
  }
  return static_cast<MtpuDecoderRetCode>(PyLong_AsLong(r.p));
}

MtpuDecoderRetCode InitDecoder(MtpuVideoDecoder* dec) {
  return dec_simple(dec, "init_decoder", VIDEO_DECODER_INIT_FAIL);
}

MtpuDecoderRetCode SetDecodeParams(MtpuVideoDecoder* dec, uint32_t width,
                                   uint32_t height, uint32_t pixel_format) {
  if (!dec) return VIDEO_DECODER_NOT_INITED;
  Gil gil;
  PyRef kwargs(Py_BuildValue("{s:I,s:I,s:I}", "width", width, "height",
                             height, "pixel_format", pixel_format));
  PyRef meth(PyObject_GetAttrString(dec->decoder, "set_decode_params"));
  PyRef empty(PyTuple_New(0));
  if (!kwargs.p || !meth.p || !empty.p)
    return VIDEO_DECODER_SET_DECODE_PARAMS_FAIL;
  PyRef r(PyObject_Call(meth.p, empty.p, kwargs.p));
  if (!r.p) {
    PyErr_Print();
    return VIDEO_DECODER_SET_DECODE_PARAMS_FAIL;
  }
  return static_cast<MtpuDecoderRetCode>(PyLong_AsLong(r.p));
}

MtpuDecoderRetCode StartDecoder(MtpuVideoDecoder* dec) {
  return dec_simple(dec, "start_decoder", VIDEO_DECODER_START_FAIL);
}

MtpuDecoderRetCode StopDecoder(MtpuVideoDecoder* dec) {
  return dec_simple(dec, "stop_decoder", VIDEO_DECODER_STOP_FAIL);
}

MtpuDecoderRetCode FlushDecoder(MtpuVideoDecoder* dec) {
  return dec_simple(dec, "flush", VIDEO_DECODER_DECODE_FAIL);
}

MtpuDecoderRetCode SendStreamData(MtpuVideoDecoder* dec, const uint8_t* buf,
                                  uint32_t len) {
  if (!dec || (!buf && len)) return VIDEO_DECODER_INVALID_PARAM;
  Gil gil;
  PyRef data(PyBytes_FromStringAndSize(
      reinterpret_cast<const char*>(len ? buf : reinterpret_cast<const uint8_t*>("")),
      static_cast<Py_ssize_t>(len)));
  if (!data.p) return VIDEO_DECODER_DECODE_FAIL;
  PyRef r(PyObject_CallMethod(dec->decoder, "send_stream_data", "O", data.p));
  if (!r.p) {
    PyErr_Print();
    return VIDEO_DECODER_DECODE_FAIL;
  }
  return static_cast<MtpuDecoderRetCode>(PyLong_AsLong(r.p));
}

MtpuDecoderRetCode RetrieveFrameData(MtpuVideoDecoder* dec, uint8_t* dst,
                                     uint32_t max_len, uint32_t* filled,
                                     uint32_t* width, uint32_t* height) {
  if (!dec || !dst || !filled) return VIDEO_DECODER_INVALID_PARAM;
  Gil gil;
  PyRef r(PyObject_CallMethod(dec->decoder, "retrieve_frame_data", "I",
                              max_len));
  if (!r.p || !PyTuple_Check(r.p) || PyTuple_Size(r.p) != 3) {
    PyErr_Print();
    return VIDEO_DECODER_DECODE_FAIL;
  }
  long code = PyLong_AsLong(PyTuple_GetItem(r.p, 0));
  PyObject* info = PyTuple_GetItem(r.p, 2);
  if (width && PyDict_Check(info)) {
    PyObject* w = PyDict_GetItemString(info, "width");
    if (w) *width = static_cast<uint32_t>(PyLong_AsLong(w));
  }
  if (height && PyDict_Check(info)) {
    PyObject* h = PyDict_GetItemString(info, "height");
    if (h) *height = static_cast<uint32_t>(PyLong_AsLong(h));
  }
  if (code != VIDEO_DECODER_SUCCESS) {
    *filled = 0;
    return static_cast<MtpuDecoderRetCode>(code);
  }
  char* raw = nullptr;
  Py_ssize_t n = 0;
  if (PyBytes_AsStringAndSize(PyTuple_GetItem(r.p, 1), &raw, &n) != 0) {
    PyErr_Print();
    return VIDEO_DECODER_DECODE_FAIL;
  }
  if (static_cast<uint32_t>(n) > max_len) {
    *filled = 0;
    return VIDEO_DECODER_INVALID_PARAM;
  }
  std::memcpy(dst, raw, static_cast<size_t>(n));
  *filled = static_cast<uint32_t>(n);
  return VIDEO_DECODER_SUCCESS;
}

MtpuDecoderRetCode ResetDecoder(MtpuVideoDecoder* dec) {
  return dec_simple(dec, "reset_decoder", VIDEO_DECODER_RESET_FAIL);
}

MtpuDecoderRetCode GetDecodeParams(MtpuVideoDecoder* dec, uint32_t* width,
                                   uint32_t* height, uint32_t* pixel_format,
                                   uint32_t* codec_format) {
  if (!dec) return VIDEO_DECODER_NOT_INITED;
  Gil gil;
  PyRef r(PyObject_CallMethod(dec->decoder, "get_decode_params", nullptr));
  if (!r.p || !PyDict_Check(r.p)) {
    PyErr_Print();
    return VIDEO_DECODER_GET_DECODE_PARAMS_FAIL;
  }
  auto get = [&](const char* k, uint32_t* out) {
    PyObject* v = PyDict_GetItemString(r.p, k);
    if (v && out) *out = static_cast<uint32_t>(PyLong_AsLong(v));
  };
  get("width", width);
  get("height", height);
  get("pixel_format", pixel_format);
  get("codec_format", codec_format);
  return VIDEO_DECODER_SUCCESS;
}

// ---- callback trampolines: Python callable -> registered C function ----

namespace {

struct EventCbCtx {
  MtpuDecoderEventCallback fn;
  void* user;
};

void cbctx_capsule_free(PyObject* cap) {
  delete static_cast<EventCbCtx*>(PyCapsule_GetPointer(cap, "mtpu.eventcb"));
}

PyObject* event_trampoline(PyObject* self, PyObject* args) {
  auto* ctx =
      static_cast<EventCbCtx*>(PyCapsule_GetPointer(self, "mtpu.eventcb"));
  unsigned int ev = 0;
  PyObject* info = nullptr;
  if (!PyArg_ParseTuple(args, "IO", &ev, &info)) return nullptr;
  MtpuPicInfo pi = {0, 0};
  if (PyDict_Check(info)) {
    PyObject* w = PyDict_GetItemString(info, "width");
    PyObject* h = PyDict_GetItemString(info, "height");
    if (w) pi.width = static_cast<uint32_t>(PyLong_AsLong(w));
    if (h) pi.height = static_cast<uint32_t>(PyLong_AsLong(h));
  }
  if (ctx && ctx->fn) ctx->fn(ev, &pi, ctx->user);
  Py_RETURN_NONE;
}

PyMethodDef g_event_trampoline_def = {"_mtpu_event_cb", event_trampoline,
                                      METH_VARARGS, nullptr};

struct CopyCbCtx {
  MtpuCopyFrameFunc fn;
  void* user;
};

void copyctx_capsule_free(PyObject* cap) {
  delete static_cast<CopyCbCtx*>(PyCapsule_GetPointer(cap, "mtpu.copycb"));
}

PyObject* copy_trampoline(PyObject* self, PyObject* args) {
  auto* ctx =
      static_cast<CopyCbCtx*>(PyCapsule_GetPointer(self, "mtpu.copycb"));
  PyObject* planes = nullptr;
  PyObject* info = nullptr;
  if (!PyArg_ParseTuple(args, "OO", &planes, &info)) return nullptr;
  MtpuPicInfo pi = {0, 0};
  if (PyDict_Check(info)) {
    PyObject* w = PyDict_GetItemString(info, "width");
    PyObject* h = PyDict_GetItemString(info, "height");
    if (w) pi.width = static_cast<uint32_t>(PyLong_AsLong(w));
    if (h) pi.height = static_cast<uint32_t>(PyLong_AsLong(h));
  }
  // Planes -> contiguous I420 bytes (numpy arrays expose tobytes()).
  std::string src;
  if (PyTuple_Check(planes)) {
    for (Py_ssize_t i = 0; i < PyTuple_Size(planes); i++) {
      PyRef b(PyObject_CallMethod(PyTuple_GetItem(planes, i), "tobytes",
                                  nullptr));
      if (!b.p) return nullptr;
      char* raw = nullptr;
      Py_ssize_t bn = 0;
      if (PyBytes_AsStringAndSize(b.p, &raw, &bn) != 0) return nullptr;
      src.append(raw, static_cast<size_t>(bn));
    }
  }
  int64_t written = -1;
  if (ctx && ctx->fn) {
    std::string dst(src.size() * 2 + 64, '\0');
    written = ctx->fn(reinterpret_cast<const uint8_t*>(src.data()),
                      static_cast<uint32_t>(src.size()),
                      reinterpret_cast<uint8_t*>(&dst[0]),
                      static_cast<uint32_t>(dst.size()), &pi, ctx->user);
    if (written >= 0)
      return PyBytes_FromStringAndSize(dst.data(),
                                       static_cast<Py_ssize_t>(written));
  }
  // Hook declined: fall back to the plain payload.
  return PyBytes_FromStringAndSize(src.data(),
                                   static_cast<Py_ssize_t>(src.size()));
}

PyMethodDef g_copy_trampoline_def = {"_mtpu_copy_cb", copy_trampoline,
                                     METH_VARARGS, nullptr};

}  // namespace

MtpuDecoderRetCode SetDecoderCallbacks(MtpuVideoDecoder* dec,
                                       MtpuDecoderEventCallback cb,
                                       void* user) {
  if (!dec) return VIDEO_DECODER_NOT_INITED;
  Gil gil;
  auto* ctx = new EventCbCtx{cb, user};
  PyRef cap(PyCapsule_New(ctx, "mtpu.eventcb", cbctx_capsule_free));
  if (!cap.p) {
    delete ctx;
    return VIDEO_DECODER_SET_FUNC_FAIL;
  }
  PyRef fn(PyCFunction_New(&g_event_trampoline_def, cap.p));
  if (!fn.p) return VIDEO_DECODER_SET_FUNC_FAIL;
  PyRef r(PyObject_CallMethod(dec->decoder, "set_callbacks", "O", fn.p));
  if (!r.p) {
    PyErr_Print();
    return VIDEO_DECODER_SET_FUNC_FAIL;
  }
  return static_cast<MtpuDecoderRetCode>(PyLong_AsLong(r.p));
}

MtpuDecoderRetCode SetCopyFrameFunc(MtpuVideoDecoder* dec,
                                    MtpuCopyFrameFunc fn_c, void* user) {
  if (!dec) return VIDEO_DECODER_NOT_INITED;
  Gil gil;
  auto* ctx = new CopyCbCtx{fn_c, user};
  PyRef cap(PyCapsule_New(ctx, "mtpu.copycb", copyctx_capsule_free));
  if (!cap.p) {
    delete ctx;
    return VIDEO_DECODER_SET_FUNC_FAIL;
  }
  PyRef fn(PyCFunction_New(&g_copy_trampoline_def, cap.p));
  if (!fn.p) return VIDEO_DECODER_SET_FUNC_FAIL;
  PyRef r(PyObject_CallMethod(dec->decoder, "set_copy_frame_func", "O", fn.p));
  if (!r.p) {
    PyErr_Print();
    return VIDEO_DECODER_SET_FUNC_FAIL;
  }
  return static_cast<MtpuDecoderRetCode>(PyLong_AsLong(r.p));
}

}  // extern "C"
