"""The encoder's spans (media_tpu_torch.core.trace) and the host P-slice
writer's call counter, on the CPU at 64x48.

One staged call over two chunks and one IDR, traced by torch's kineto
profiler (CPU activities, user ranges only) and untraced: the spans exist only under the profiler,
each chunk gives one of each P span, the downloads and the assembly lie
inside their chunk's finisher, and the access units are the untraced run's
byte for byte. The C++ P-slice writer's counter reads 0 where the packer
takes every frame and one a slice where the chunk's stream budget is too
small for any frame. No JAX.
"""

import contextlib
import threading
from unittest import mock

import numpy as np
import pytest
import torch
from torch._C._profiler import RecordScope, _ExperimentalConfig
from torch.autograd import profiler as autograd_profiler
from torch.profiler import ProfilerActivity

from media_tpu_torch import native
from media_tpu_torch.core import trace
from media_tpu_torch.pipeline.codec import EncoderConfig, EncoderSession
from media_tpu_torch.pipeline.encoder import FrameEncoder

W, H = 64, 48
CHUNK = 1
N_P = 2 * CHUNK  # two staged chunks

P_SPANS = ("enc.p.dispatch", "enc.p.finish", "enc.p.download",
           "enc.p.assemble")
IDR_SPANS = ("enc.idr.launch", "enc.idr.download", "enc.idr.write")


def _frames(n: int) -> list[bytes]:
    rng = np.random.default_rng(17)
    base = rng.integers(0, 256, (H + 8, W + 8), dtype=np.uint8)
    out = []
    for i in range(n):  # a pan, so the P frames carry motion and levels
        y = base[i % 8:i % 8 + H, i:i + W]
        out.append(y.tobytes() + y[::2, ::2].tobytes() * 2)
    return out


@contextlib.contextmanager
def _profiled():
    """torch's kineto profiler on the CPU, observing user ranges alone:
    what torch.profiler.profile turns on, without the hundreds of thousands
    of operator events that a plain CPU encode would add to the trace.
    Yields the list that receives the trace's events."""
    acts = {ProfilerActivity.CPU}
    cfg = autograd_profiler.ProfilerConfig(
        autograd_profiler.ProfilerState.KINETO, False, False, False, False,
        False, _ExperimentalConfig())
    autograd_profiler._prepare_profiler(cfg, acts)
    autograd_profiler._enable_profiler(cfg, acts, {RecordScope.USER_SCOPE})
    events = []
    try:
        yield events
    finally:
        events += autograd_profiler._disable_profiler().events()


def _encode(traced: bool, **cfg) -> tuple[list[bytes], list, int]:
    """IDR + N_P staged P frames; (AUs, the trace's host events as (name,
    start, end), the C++ P writer's calls). cfg: more EncoderConfig
    fields."""
    frames = _frames(1 + N_P)
    sess = EncoderSession(EncoderConfig(width=W, height=H, qp=30, **cfg),
                          device="cpu")
    sess.PIPELINE_CHUNK = CHUNK
    chunks = sess.upload_frames(frames[1:])
    calls0 = native.write_pslice_native.calls
    with _profiled() if traced else contextlib.nullcontext([]) as events:
        aus = [sess.encode_frame(frames[0])]
        aus += sess.encode_frames_staged(chunks)
    spans = sorted((e.name(), e.start_ns(), e.end_ns()) for e in events
                   if e.name().startswith("enc."))
    return aus, spans, native.write_pslice_native.calls - calls0


def _refuse(name):
    raise AssertionError(f"a profiler range {name!r} without a profiler")


@pytest.fixture(scope="module")
def runs():
    """The untraced run, in which building a profiler range fails, then
    the traced run."""
    with mock.patch.object(torch.profiler, "record_function", _refuse):
        untraced = _encode(traced=False)
    traced = _encode(traced=True)
    return untraced, traced


def _spans(events, name):
    return sorted((a, b) for n, a, b in events if n == name)


def test_span_is_a_shared_null_context_without_a_profiler(runs):
    assert trace.span("enc.p.dispatch") is trace.span("enc.idr.write")
    assert isinstance(trace.span("x"), contextlib.nullcontext)
    (aus, events, _), _ = runs
    assert len(aus) == 1 + N_P and events == []


@pytest.mark.parametrize("name,count", [(n, 2) for n in P_SPANS]
                         + [(n, 1) for n in IDR_SPANS])
def test_one_span_a_chunk_and_an_idr(runs, name, count):
    _, (_, events, _) = runs
    assert len(_spans(events, name)) == count


@pytest.mark.parametrize("name", ["enc.p.download", "enc.p.assemble"])
def test_spans_inside_their_finish(runs, name):
    _, (_, events, _) = runs
    finish = _spans(events, "enc.p.finish")
    for i, (a, b) in enumerate(_spans(events, name)):
        fa, fb = finish[i]
        assert fa <= a and b <= fb


def test_finish_pairs_with_dispatch_in_order(runs):
    """Depth 2: chunk 1 is dispatched before chunk 0 finishes, and the
    n-th finish follows the n-th dispatch."""
    _, (_, events, _) = runs
    dispatch = _spans(events, "enc.p.dispatch")
    finish = _spans(events, "enc.p.finish")
    assert dispatch[1][1] <= finish[0][0]
    for (_, d_end), (f_start, _) in zip(dispatch, finish):
        assert d_end <= f_start


def test_traced_aus_equal_untraced(runs):
    (aus, _, _), (traced, _, _) = runs
    assert len(aus) == 1 + N_P and traced == aus


@pytest.mark.parametrize("budget", ["packed", "host"])
def test_host_pslice_writer_counter(runs, monkeypatch, budget):
    """The packer takes every frame: no call. A one-word stream budget
    overflows on every frame, so each chunk falls back to the C++ writer:
    one call a slice, and the same access units."""
    (want, _, _), (_, _, calls) = runs
    if budget == "host":
        monkeypatch.setattr(FrameEncoder, "cap_words", property(lambda s: 1))
        aus, _, calls = _encode(traced=False)
        assert aus == want
    assert calls == {"packed": 0, "host": N_P}[budget]


CABAC_CQ = dict(cabac=True, entropy_mode="device")


@pytest.fixture(scope="module")
def cabac_runs():
    """runs() for single-slice CABAC at constant QP: the device's CAVLC
    pack, transcoded on the host."""
    with mock.patch.object(torch.profiler, "record_function", _refuse):
        untraced = _encode(traced=False, **CABAC_CQ)
    traced = _encode(traced=True, **CABAC_CQ)
    return untraced, traced


def test_one_transcode_a_pframe_inside_its_assembly(cabac_runs):
    (aus, untraced, _), (traced_aus, events, _) = cabac_runs
    assert untraced == [] and traced_aus == aus and len(aus) == 1 + N_P
    assemble = _spans(events, "enc.p.assemble")
    transcode = _spans(events, "enc.p.transcode")
    assert len(assemble) == N_P // CHUNK and len(transcode) == N_P
    for a, b in transcode:
        assert any(fa <= a and b <= fb for fa, fb in assemble)


def test_transcode_spans_stay_on_the_finishers_thread(monkeypatch):
    """A chunk of four CABAC P slices, every transcode handed to the pool's
    threads: four `enc.p.transcode` spans still, each inside the chunk's
    assembly, and every span opened, and every `enc.*` event in the trace,
    on the one thread that encodes (the pool's threads open none), so a
    reader of the window's thread counts one a P frame."""
    from media_tpu_torch.pipeline import codec

    monkeypatch.setattr(codec, "_transcode_workers", lambda k: k)
    opened = []  # (span name, thread) of every span the session opens

    def span(name):
        opened.append((name, threading.get_ident()))
        return trace.span(name)

    monkeypatch.setattr(codec, "span", span)
    frames = _frames(5)
    sess = EncoderSession(EncoderConfig(width=W, height=H, qp=30,
                                        **CABAC_CQ), device="cpu")
    sess.PIPELINE_CHUNK = 4
    chunks = sess.upload_frames(frames[1:])
    pooled = codec.transcode_chunk.pooled
    with _profiled() as events:
        sess.encode_frame(frames[0])
        sess.encode_frames_staged(chunks)
    assert codec.transcode_chunk.pooled - pooled == 4
    assert {t for _, t in opened} == {threading.get_ident()}
    assert [n for n, _ in opened].count("enc.p.transcode") == 4
    ours = [(e.name(), e.start_ns(), e.end_ns(), e.start_thread_id())
            for e in events if e.name().startswith("enc.")]
    assert len({t for *_, t in ours}) == 1
    transcode = _spans([e[:3] for e in ours], "enc.p.transcode")
    (assemble,) = _spans([e[:3] for e in ours], "enc.p.assemble")
    assert len(transcode) == 4
    assert all(assemble[0] <= a and b <= assemble[1] for a, b in transcode)
