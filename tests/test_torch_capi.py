"""The port's C ABI (media_tpu_torch/csrc/api, libVideoCodec) against the
JAX package's (csrc/api).

Both bridges are built here and loaded into this process with ctypes.CDLL
(RTLD_LOCAL, so each handle resolves its own functions of the same names).
Each scenario drives one library through the C functions and returns its
trace: every return code, every AU, every payload's digest, every event and
what GetDecodeParams and the copy hook saw. The scenarios are the three
cases of tests/test_capi.py and an API run whose properties go through
MtpuEncoderSetParam: the format-2 selection after the factory, a forced
IDR and a bitrate reset. The JAX library's traces (on the JAX CPU backend)
are read from tests/golden_torch/ (jax_scenarios says what it was asked;
tests/jax_golden.py); the port's, on the CPU through
CreateVideoEncoderOn(b"cpu") / CreateVideoDecoderOn(b"cpu"), must give the
same trace (tolerance 0).
Beside them: the void factories return NULL without CUDA (no fall-back to
the CPU), the standalone C program capi_drive gives the in-process AUs, and
a failed build raises with the compiler's output. 64x48 streams of the
port's own (device="cpu") feed the decoder scenarios of both libraries.
"""

import ctypes
import hashlib
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import chip_smoke as cs
from jax_golden import Golden
from media_tpu_torch import native
from media_tpu_torch.core import nal as tnal
from media_tpu_torch.core import params as P
from media_tpu_torch.pipeline.codec import EncoderConfig, EncoderSession
from media_tpu_torch.ref.decoder import ReferenceDecoder

ROOT = Path(__file__).resolve().parent.parent
W, H = 64, 48
FRAMES = cs.clip_i420(W, H, 5)[0]
EOS_NAL = b"\x00\x00\x01\x0c"

# An API run through C (an API_RUNS entry of chip_smoke.py) at the shipped
# defaults (baseline, 5 Mbit/s), with the format-2 (HEVC) selection set
# after the factory, a forced IDR before frame 3 and a bitrate reset (a new
# IDR) before frame 4.
API_RUN = ({"KEY_ENCODE_FORMAT": "2", "KEY_HW_WIDTH": W, "KEY_HW_HEIGHT": H},
           5, {3: {"KEY_FORCE_KEYFRAME": "1"},
               4: {"KEY_BITRATE": "2000000", "KEY_PARAM_ADJUSTING": "1"}},
           (W, H))


class Side:
    """One library and how its factories are called: the void ones for the
    JAX library (its JAX device), the *On ones with `device` for the
    port's."""

    def __init__(self, path: str, device: bytes | None):
        self.lib = native.bind_capi(path)
        self.device = device

    def encoder(self):
        if self.device is None:
            return self.lib.CreateVideoEncoder()
        return self.lib.CreateVideoEncoderOn(self.device)

    def decoder(self):
        if self.device is None:
            return self.lib.CreateVideoDecoder()
        return self.lib.CreateVideoDecoderOn(self.device)


def _sha(b: bytes) -> str:
    return hashlib.sha256(b).hexdigest()


def _encode(lib, enc, buf):
    ptr = ctypes.POINTER(ctypes.c_uint8)()
    n = ctypes.c_uint32()
    code = lib.EncodeOneFrame(enc, buf, len(buf), ctypes.byref(ptr),
                              ctypes.byref(n))
    return code, (ctypes.string_at(ptr, n.value) if code == 0 else b"")


def _set(lib, enc, key: str, value) -> int:
    return lib.MtpuEncoderSetParam(enc, key.encode(), str(value).encode())


class _Retriever:
    def __init__(self, lib, dec, cap: int):
        self.lib, self.dec = lib, dec
        self.buf = ctypes.create_string_buffer(cap)
        self.filled = ctypes.c_uint32()
        self.w, self.h = ctypes.c_uint32(), ctypes.c_uint32()

    def __call__(self):
        """(code, width, height, bytes filled, payload digest or None)."""
        code = self.lib.RetrieveFrameData(
            self.dec, self.buf, len(self.buf), ctypes.byref(self.filled),
            ctypes.byref(self.w), ctypes.byref(self.h))
        payload = self.buf.raw[: self.filled.value]
        return (code, self.w.value, self.h.value, self.filled.value,
                _sha(payload) if code == 0 else None)


def _params(lib, dec):
    vals = [ctypes.c_uint32() for _ in range(4)]
    code = lib.GetDecodeParams(dec, *map(ctypes.byref, vals))
    return ("params", code, *(v.value for v in vals))


# ------------------------------------------------------------- scenarios


def lifecycle_roundtrip(side, streams):
    """tests/test_capi.py::test_c_abi_lifecycle_roundtrip."""
    lib = side.lib
    enc = side.encoder()
    assert enc
    trace = [_set(lib, enc, P.KEY_HW_WIDTH, W),
             _set(lib, enc, P.KEY_HW_HEIGHT, H),
             lib.InitEncoder(enc), lib.StartEncoder(enc)]
    for buf in FRAMES[:2]:
        trace.append(_encode(lib, enc, buf))
    # The reference's contract for a short input: ENCODE_FAIL (0x04).
    trace.append(_encode(lib, enc, b"xx"))
    trace += [lib.StopEncoder(enc), lib.DestroyVideoEncoder(enc)]
    return trace


def decoder_loop(side, streams):
    """tests/test_capi.py::test_c_abi_decoder_loop."""
    lib = side.lib
    dec = side.decoder()
    assert dec
    trace = [lib.MtpuCreateDecoder(dec, 0), lib.InitDecoder(dec),
             lib.SetDecodeParams(dec, W, H, 0), lib.StartDecoder(dec)]
    get = _Retriever(lib, dec, W * H * 3 // 2)
    trace.append(get())  # READ_UNDERFLOW before any data
    stream = b"".join(streams["cq"]) + EOS_NAL
    trace += [lib.SendStreamData(dec, stream, len(stream)),
              lib.SendStreamData(dec, b"", 0)]
    while True:
        trace.append(get())
        if trace[-1][0] != 0:
            break
    trace += [lib.StopDecoder(dec), lib.DestroyVideoDecoder(dec)]
    return trace


def event_and_params(side, streams):
    """tests/test_capi.py::test_c_abi_decoder_event_and_params, with the
    copy hook: after ResetDecoder the first IDR again through a hook that
    inverts every byte (and declines the next picture)."""
    lib = side.lib
    trace, n_copies = [], []

    @native.EVENT_CB
    def on_event(ev, info, user):
        trace.append(("event", int(ev), info.contents.width,
                      info.contents.height))

    @native.COPY_CB
    def copy(src, n, dst, cap, info, user):
        trace.append(("copy", n, cap >= n, info.contents.width,
                      info.contents.height))
        n_copies.append(n)
        if len(n_copies) > 1:
            return -1  # declined: the plain payload
        raw = np.ctypeslib.as_array(src, (n,))
        np.ctypeslib.as_array(dst, (n,))[:] = 255 - raw
        return n

    dec = side.decoder()
    assert dec
    trace += [lib.MtpuCreateDecoder(dec, 0), lib.InitDecoder(dec),
              lib.SetDecodeParams(dec, W, H, 0),
              lib.SetDecoderCallbacks(dec, on_event, None),
              lib.StartDecoder(dec), _params(lib, dec)]
    get = _Retriever(lib, dec, 96 * 64 * 3 // 2)
    stream = streams["idr64"] + streams["idr96"] + EOS_NAL
    trace += [lib.SendStreamData(dec, stream, len(stream)),
              lib.SendStreamData(dec, b"", 0)]
    trace += [get(), get(), get(), _params(lib, dec)]
    trace += [lib.ResetDecoder(dec), _params(lib, dec),
              lib.SetCopyFrameFunc(dec, copy, None)]
    stream = streams["idr64"] + streams["idr64"] + EOS_NAL
    trace += [lib.SendStreamData(dec, stream, len(stream)),
              lib.SendStreamData(dec, b"", 0)]
    while True:
        trace.append(get())
        if trace[-1][0] not in (0, 13):
            break
    trace.append(get.buf.raw[: W * H])  # the last payload's luma
    trace += [lib.StopDecoder(dec), lib.DestroyVideoDecoder(dec)]
    return trace


def api_run(side, streams):
    """API_RUN through the C functions of both halves, with the functions
    of chip_smoke.py's phase 18. The format-2 selection is set after the
    factory, which read it from its own fresh store: the stream stays
    H.264."""
    enc = cs.drive_capi_encode(side.lib, side.encoder(), P, API_RUN, FRAMES)
    dec = cs.drive_capi_decode(side.lib, side.decoder(), enc["aus"], (W, H))
    return [enc["codes"], enc["aus"], dec["codes"], dec["events"],
            [_sha(p) for p in dec["payloads"]]]


SCENARIOS = {f.__name__: f for f in (lifecycle_roundtrip, decoder_loop,
                                     event_and_params, api_run)}


# --------------------------------------------------------------- fixtures


def _idr(w, h):
    s = EncoderSession(EncoderConfig(width=w, height=h, qp=30, gop_size=4),
                       device="cpu")
    return s.encode_frame(cs.clip_i420(w, h, 1, seed=2)[0][0])


def make_streams():
    s = EncoderSession(EncoderConfig(width=W, height=H, qp=30, gop_size=4),
                       device="cpu")
    return {"cq": [s.encode_frame(b) for b in FRAMES[:3]],
            "idr64": _idr(W, H), "idr96": _idr(96, 64)}


@pytest.fixture(scope="module")
def streams():
    return make_streams()


@pytest.fixture(scope="module")
def port_so():
    return native.build_capi()[0]


@pytest.fixture(scope="module")
def port(port_so):
    return Side(port_so, b"cpu")


# The JAX side deblocks one wave per scan step: the same bytes from smaller
# programs.
GOLDEN = Golden(__file__, env={"MEDIA_TPU_DEBLOCK_UNROLL": "1"})


@GOLDEN.recipe
def jax_scenarios():
    """Every scenario through the JAX package's library (its void
    factories), on the port's streams (make_streams), and those streams."""
    from media_tpu import native as jnative

    streams = make_streams()
    path = jnative.build_capi()
    assert path, "the JAX package's C ABI did not build"
    side = Side(path, None)
    return {"streams": streams,
            "traces": {name: f(side, streams)
                       for name, f in SCENARIOS.items()}}


@pytest.fixture(scope="module")
def jax_traces(streams):
    jax = GOLDEN.read(jax_scenarios)
    assert jax["streams"] == streams, "the port's streams are not the " \
                                      "recorded ones"
    return jax["traces"]


# ------------------------------------------------------------------ tests


def _enums(path: Path) -> dict:
    text = path.read_text()
    return dict(re.findall(r"^\s*(VIDEO_[A-Z_]+) = (0x[0-9A-F]+|\d+),",
                           text, re.M))


def _functions(path: Path) -> set:
    return set(re.findall(r"^[A-Za-z]\w*\*? (\w+)\(", path.read_text(),
                          re.M))


def test_header_is_the_jax_header_and_two_factories():
    """Same codes, name for name and value for value, and the same
    functions, so a caller of the JAX bridge switches by relinking."""
    jh = ROOT / "csrc" / "api" / "video_codec_api.h"
    th = ROOT / "media_tpu_torch" / "csrc" / "api" / "video_codec_api.h"
    assert _enums(th) == _enums(jh) and len(_enums(jh)) == 32
    assert _functions(th) == _functions(jh) | {"CreateVideoEncoderOn",
                                               "CreateVideoDecoderOn"}
    assert len(_functions(jh)) == 22


def test_library_builds_once_under_the_ports_tree(port_so):
    assert Path(port_so).is_relative_to(ROOT / "media_tpu_torch" / "csrc"
                                        / "build")
    assert Path(port_so).parent.name.startswith("capi_")
    assert native.build_capi() == (port_so, 0.0)


@pytest.mark.parametrize("name", ["lifecycle_roundtrip", "decoder_loop",
                                  "event_and_params"])
def test_lifecycle_equals_jax(jax_traces, port, streams, name):
    got = SCENARIOS[name](port, streams)
    assert got == jax_traces[name]
    if name == "lifecycle_roundtrip":
        assert got[:4] == [0] * 4 and got[-2:] == [0, 0]
        assert got[6] == (0x04, b"")
        ref = ReferenceDecoder()
        for code, au in got[4:6]:
            assert code == 0 and au.startswith(b"\x00\x00\x00\x01")
            assert len(ref.decode_annexb(au)) == 1
    elif name == "decoder_loop":
        assert got[4][0] == 12  # READ_UNDERFLOW
        frames = [t for t in got if isinstance(t, tuple) and t[0] == 0]
        assert [t[1:4] for t in frames] == [(W, H, W * H * 3 // 2)] * 3
        assert got[-3][0] == 14  # EOS
    else:
        params = [t for t in got if isinstance(t, tuple) and t[0] == "params"]
        assert [p[2:4] for p in params] == [(W, H), (96, 64), (96, 64)]
        assert ("event", 1, 96, 64) in got  # INDEX_PIC_INFO_CHANGE
        copies = [t for t in got if isinstance(t, tuple) and t[0] == "copy"]
        assert copies == [("copy", W * H * 3 // 2, True, W, H)] * 2
        # The hook's output is the picture inverted: the first picture of
        # the stream came out plain before the reset.
        hooked = [t for t in got if isinstance(t, tuple) and t[0] == 0][-2]
        plain = ReferenceDecoder().decode_annexb(streams["idr64"])[0]
        raw = (plain.y.tobytes() + plain.u.tobytes() + plain.v.tobytes())
        assert hooked[4] == _sha(bytes(255 - np.frombuffer(raw, np.uint8)))
        assert got[-3] == plain.y.tobytes()  # the declined picture: plain


def test_api_run_through_c_equals_jax(jax_traces, port, streams):
    got = api_run(port, streams)
    assert got == jax_traces["api_run"]
    codes, aus, dec_codes, events, payloads = got
    assert codes == [0] * (API_RUN[1] + 4) and not any(dec_codes)
    assert len(payloads) == API_RUN[1] and events == [(1, W, H)]
    idr = [any(nu.nal_type == 5 for nu in tnal.iter_nal_units(a))
           for a in aus]
    assert idr == [True, False, False, True, True]


def test_format2_after_the_factory_stays_h264(jax_traces, port, streams):
    """Inherited from the JAX bridge, kept literally: the factory creates
    its property store and reads the format selection at once, so
    ro.vmi.demo.video.encode.format=2 set through MtpuEncoderSetParam
    never reaches it and the H.265 slot is out of reach through C. The
    same key in the store the Python factory is given selects H.265."""
    aus = api_run(port, streams)[1]
    assert aus == jax_traces["api_run"][1]
    first = list(tnal.iter_nal_units(aus[0]))
    assert [nu.nal_type for nu in first] == [7, 8, 5]  # H.264 SPS, PPS, IDR
    assert aus[0] == jax_traces["lifecycle_roundtrip"][4][1]
    from media_tpu_torch.api import create_video_encoder
    from media_tpu_torch.api.errors import CodecFormat

    enc = create_video_encoder(P.ParamStore({P.KEY_ENCODE_FORMAT: "2"}),
                               device="cpu")
    assert enc._codec == CodecFormat.H265


_NO_CUDA = """
import sys
sys.path.insert(0, sys.argv[2])
from media_tpu_torch import native
lib = native.bind_capi(sys.argv[1])
print([bool(h) for h in (lib.CreateVideoEncoder(), lib.CreateVideoDecoder(),
                         lib.CreateVideoEncoderOn(b"cuda:0"),
                         lib.CreateVideoDecoderOn(None),
                         lib.CreateVideoEncoderOn(b"cpu"))])
"""


def test_void_factories_return_null_without_cuda(port_so):
    """No fall-back to the CPU: in an interpreter without CUDA the void
    factories (and the *On ones asked for CUDA, or for NULL) return NULL
    and print why; the CPU, asked for, works."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-c", _NO_CUDA, port_so,
                           str(ROOT)], capture_output=True, text=True,
                          env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.splitlines()[-1] == "[False, False, False, False, True]"
    assert proc.stderr.count("torch.cuda.is_available() is False") == 4


def test_standalone_c_program_equals_in_process(port, streams, tmp_path):
    """capi_drive, a C program linked to the library, in a child process
    on the CPU: its AUs and codes are the in-process run's."""
    prog, _secs = native.build_capi_drive()
    assert Path(prog).parent == Path(native.build_capi()[0]).parent
    want = api_run(port, streams)[1][:3]
    raw, out = tmp_path / "in.yuv", tmp_path / "aus.bin"
    raw.write_bytes(b"".join(FRAMES[:3]))
    proc = subprocess.run(
        [prog, "--in", str(raw), "--out", str(out), "--device", "cpu",
         *cs.capi_drive_args(P, API_RUN)], capture_output=True, text=True,
        env=cs.child_env(), timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    codes, aus = cs.read_capi_drive_output(str(out))
    assert codes == [0] * 7 and aus == want
    assert "frame_ms" in proc.stdout.splitlines()[-1]


def test_standalone_c_program_exits_nonzero_on_a_failed_factory(tmp_path):
    prog, _secs = native.build_capi_drive()
    raw = tmp_path / "in.yuv"
    raw.write_bytes(FRAMES[0])
    proc = subprocess.run(
        [prog, "--in", str(raw), "--out", str(tmp_path / "o.bin"),
         "--width", str(W), "--height", str(H), "--device", "no-such"],
        capture_output=True, text=True, env=cs.child_env(), timeout=300)
    assert proc.returncode == 2
    assert "returned NULL" in proc.stderr


@pytest.mark.parametrize("compiler,what", [
    ("no-such-c++-compiler", "cannot run the C\\+\\+ compiler"),
    ("false", "build failed \\(1\\)"),
])
def test_failed_build_raises_with_the_command(compiler, what):
    with pytest.raises(RuntimeError, match=what) as err:
        native.build_capi(compiler=compiler)
    assert "video_codec_api.cpp" in str(err.value)
