"""media_tpu_torch EncoderSession against media_tpu's: byte-identical AUs.

One JAX session (CPU) encodes an IDR + P GOP at a size that is not a
multiple of 16; the port's session must emit the same Annex-B bytes along
every entry point (encode_frame, encode_frames with device or host entropy,
upload_frames + encode_frames_staged, the overflow retry and the host
fallback), its recon must be what ReferenceDecoder decodes, and it must
continue a GOP from the JAX session's reference via load_reference_state.
A subprocess with `jax` blocked imports the port and encodes.
"""

import hashlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from media_tpu.pipeline.codec import EncoderConfig as JaxConfig
from media_tpu.pipeline.codec import EncoderSession as JaxSession
from media_tpu.ref.decoder import ReferenceDecoder
from media_tpu.utils import yuv
from media_tpu_torch.pipeline import encoder as tenc
from media_tpu_torch.pipeline.codec import EncoderConfig, EncoderSession

W, H, QP, K = 72, 40, 28, 3


def clip(n, seed=0):
    """Textured pan with a moving bright block (I420 buffers)."""
    rng = np.random.default_rng(seed)
    big = rng.integers(0, 256, (H + 48, W + 48)).astype(np.float64)
    for _ in range(2):
        big = (big + np.roll(big, 1, 0) + np.roll(big, 1, 1)) / 3
    out = []
    for t in range(n):
        y = big[2 * t : 2 * t + H, 3 * t : 3 * t + W].copy()
        y[10 : 22, 5 + 7 * t : 17 + 7 * t] = 235
        y = (y + rng.normal(0, 1.5, y.shape)).round().clip(0, 255).astype(
            np.uint8)
        out.append(yuv.pack_i420(y, (y[::2, ::2] // 2 + 40).astype(np.uint8),
                                 (y[::2, ::2] // 3 + 70).astype(np.uint8)))
    return out


FRAMES = clip(1 + 2 * K)


def cfg(cls, **kw):
    return cls(width=W, height=H, qp=QP, gop_size=30, **kw)


@pytest.fixture(scope="module")
def jax_gop():
    """The JAX session's AUs for IDR + K P, its state after them, and the
    AUs of the next K P frames."""
    with pytest.MonkeyPatch.context() as mp:
        # One deblocking wave per scan step: same bytes, smaller programs.
        mp.setenv("MEDIA_TPU_DEBLOCK_UNROLL", "1")
        s = JaxSession(cfg(JaxConfig, entropy_mode="device"))
        s.PIPELINE_CHUNK = K
        aus = [s.encode_frame(FRAMES[0])] + s.encode_frames(FRAMES[1 : 1 + K])
        state = {
            "recon": tuple(np.asarray(p) for p in s.recon),
            "frame_idx": s.frame_idx,
            "frame_idx_of_idr": s.frame_idx_of_idr,
            "idr_pic_id": s.idr_pic_id,
            "_bits_hwm": s._bits_hwm,
        }
        more = s.encode_frames(FRAMES[1 + K :])
    return aus, state, more


def port_session(**kw):
    s = EncoderSession(cfg(EncoderConfig, **kw), device="cpu")
    s.PIPELINE_CHUNK = K
    return s


@pytest.mark.parametrize("entropy", ["device", "host"])
def test_gop_matches_jax_and_decodes(jax_gop, entropy):
    aus, _state, more = jax_gop
    s = port_session(entropy_mode=entropy)
    got = [s.encode_frame(FRAMES[0])] + s.encode_frames(FRAMES[1:])
    assert got == aus + more
    dec = ReferenceDecoder()
    frames = dec.decode_annexb(b"".join(got))
    assert len(frames) == len(got)
    f = frames[-1]
    for plane, rec in zip((f.y, f.u, f.v), s.recon):
        rec = rec.numpy()
        np.testing.assert_array_equal(plane, rec[: plane.shape[0],
                                                 : plane.shape[1]])


def test_encode_frame_and_staged_paths(jax_gop):
    aus, _state, more = jax_gop
    s = port_session(entropy_mode="device")
    got = [s.encode_frame(b) for b in FRAMES[: 1 + K]]
    got += s.encode_frames_staged(s.upload_frames(FRAMES[1 + K :]))
    assert got == aus + more


def test_load_reference_state_continues_jax_gop(jax_gop):
    _aus, state, more = jax_gop
    s = port_session(entropy_mode="device")
    s.load_reference_state(state)
    assert s.encode_frames(FRAMES[1 + K :]) == more


def test_overflow_retry_and_host_fallback(jax_gop, monkeypatch):
    aus, _state, more = jax_gop
    # A 1-word adaptive cap overflows: the chunk is retried at full budget.
    s = port_session(entropy_mode="device")
    monkeypatch.setattr(s, "_device_cap", lambda: 1)
    assert [s.encode_frame(FRAMES[0])] + s.encode_frames(FRAMES[1:]) == (
        aus + more)
    # A full budget of 8 words overflows too: the host writer packs.
    monkeypatch.setattr(tenc.FrameEncoder, "cap_words", property(lambda _: 8))
    s = port_session(entropy_mode="device")
    assert [s.encode_frame(FRAMES[0])] + s.encode_frames(FRAMES[1:]) == (
        aus + more)


def test_cuda_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    with pytest.raises(RuntimeError, match="cuda"):
        EncoderSession(cfg(EncoderConfig), device="cuda")


@pytest.mark.parametrize("field,value", [
    ("cabac", True), ("rc_mode", "cbr"), ("i4x4", True), ("num_slices", 2),
    ("b_frames", 1), ("lossless", True), ("adaptive_qp", True),
])
def test_configs_outside_the_slice_raise(field, value):
    """No configuration of the JAX session is outside the port any more (the
    name is the test's old one): each of these fields constructs a session
    whose first two access units equal the JAX session's."""
    kw = {field: value}
    if field == "rc_mode":
        kw.update(bitrate=150_000, framerate=30)
    with pytest.MonkeyPatch.context() as mp:
        # One deblocking wave per scan step: same bytes, smaller programs.
        mp.setenv("MEDIA_TPU_DEBLOCK_UNROLL", "1")
        js = JaxSession(cfg(JaxConfig, **kw))
        want = [js.encode_frame(b) for b in FRAMES[:2]]
    s = EncoderSession(cfg(EncoderConfig, **kw), device="cpu")
    assert [s.encode_frame(b) for b in FRAMES[:2]] == want
    assert s.pps.entropy_coding_mode == int(field == "cabac")


_NO_JAX = textwrap.dedent("""
    import hashlib, sys
    sys.modules["jax"] = None  # any import of jax now raises ImportError
    sys.path.insert(0, {root!r})
    import numpy as np
    from media_tpu_torch.pipeline.codec import EncoderConfig, EncoderSession
    import media_tpu_torch.entropy.device_cavlc, media_tpu_torch.kernels
    rng = np.random.default_rng(0)
    y = rng.integers(0, 256, (32, 48), dtype=np.uint8)
    buf = [y.tobytes() + y[::2, ::2].tobytes() * 2,
           np.roll(y, 1, 1).tobytes() + y[::2, ::2].tobytes() * 2]
    s = EncoderSession(EncoderConfig(width=48, height=32, qp=30), device="cpu")
    aus = [s.encode_frame(buf[0])] + s.encode_frames(buf[1:])
    loaded = sorted(m for m, v in sys.modules.items()
                    if v is not None and m.split(".")[0] == "jax")
    print(loaded, hashlib.sha256(b"".join(aus)).hexdigest())
""")


def test_port_imports_and_encodes_without_jax():
    import os

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", _NO_JAX.format(root=root)],
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    loaded, digest = proc.stdout.split()[-2:]
    assert loaded == "[]"
    rng = np.random.default_rng(0)
    y = rng.integers(0, 256, (32, 48), dtype=np.uint8)
    buf = [y.tobytes() + y[::2, ::2].tobytes() * 2,
           np.roll(y, 1, 1).tobytes() + y[::2, ::2].tobytes() * 2]
    s = EncoderSession(EncoderConfig(width=48, height=32, qp=30), device="cpu")
    want = [s.encode_frame(buf[0])] + s.encode_frames(buf[1:])
    assert digest == hashlib.sha256(b"".join(want)).hexdigest()

