"""Spans of the encoder's host work, for a torch.profiler trace.

`span(name)` is a `torch.profiler.record_function` range while a profiler
runs in the process and a shared null context otherwise, so an untraced
encode pays one `torch.autograd._profiler_enabled()` call a span. There is
no switch: the spans exist exactly while some `torch.profiler.profile` is
active. They are host events of the same kineto trace as the device's
activities (CUPTI), so they share its clock and an idle gap on the device
can be set beside the span that was open.

The spans, by name:

- `enc.p.dispatch`: one chunk of the staged P path as launched
  (`EncoderSession._dispatch_packed`): the P core, the deblocking meta and
  kernel 1, the symbol unpack and the packer a frame, the stacks of the
  chunk's streams and bit counts; on CUDA also the copy of the bit counts
  to pinned memory and the chunk's completion event recorded behind it.
  Python, ctypes and launches.
- `enc.p.finish`: that chunk's finisher, which the next chunk's dispatch
  precedes (depth-2 pipeline). It holds the two spans below; its own time
  is the rare re-packs, the device retry at the full stream budget and the
  host writer's fallback.
- `enc.p.download`: on CUDA, the wait for the chunk's own completion event
  (not for the chunk dispatched after it) and the copy of its stream words
  to pinned memory on the session's side stream, which runs beside the
  next chunk's kernels; on other devices, the copies of the bit counts and
  stream words, with the wait for every kernel enqueued before them.
- `enc.p.assemble`: the chunk's access units from the downloaded words:
  slice headers, `merge_slice_data`, `wrap_nal`, the AUD; with CABAC, the
  transcode below and the header, alignment and NAL around it.
- `enc.p.transcode`: one P slice's device CAVLC pack re-coded as CABAC
  (`EncoderSession._cabac_au_from_cavlc_stream`), as the finisher's thread
  spends it: the wait for the C++ `transcode_pslice_native`, which runs on
  the process's pool of host threads (`pipeline.codec.transcode_chunk`,
  every slice of the chunk at once), or the routine itself where the chunk
  gets one worker; and the Python parse and recode where it refuses. One a
  P frame, on the finisher's thread alone (the pool's threads open no
  span); inside `enc.p.assemble` on the constant-QP packed path, and in
  the CBR + CABAC finisher, which has no span of its own.
- `enc.idr.launch`: an IDR's planes uploaded and cast, the intra wavefront
  and the IDR's deblocking enqueued (`FrameEncoder.encode_iframe`).
- `enc.idr.download`: the IDR's symbol arrays copied to the host, with the
  wait for its kernels.
- `enc.idr.write`: the IDR's slices written (the C++ CAVLC or CABAC I
  writer, or the Python one), wrapped in NALs and prefixed with SPS, PPS
  and SEI (`EncoderSession._idr_au_from_result`).

A chunk's `enc.p.dispatch` and `enc.p.finish` pair by their order within a
thread: the pipeline finishes chunks first in, first out, so the n-th
finish of a thread belongs to its n-th dispatch.

The counters beside them, in the port's `.launches` idiom:

- `native.write_pslice_native.calls`: calls of the C++ CAVLC P-slice
  writer. On the staged path each is a P frame that the device packer could
  not take.
- `native.fallbacks["transcode_pslice_native"]`: P slices the C++
  transcoder refused, each then re-coded by the Python parse and recode
  inside its `enc.p.transcode`.
- `pipeline.codec.transcode_chunk.pooled` and `.inline`: P slices whose
  C++ transcode ran on the pool's threads, and those of chunks that got one
  worker (one CPU, or a chunk of one frame), transcoded on the finisher's
  thread.
- `pipeline.codec.wait_for_chunk.ready` and `.waited`: CUDA chunks of the
  packed P path whose completion event had fired when their `enc.p.download`
  began (the host set the pace, and assembly overlapped the device), and
  those whose event had not (the device set it). Their sum is the chunks
  finished.
"""

from __future__ import annotations

import contextlib

import torch

_OFF = contextlib.nullcontext()


def span(name: str):
    """A profiler range called `name` while a profiler runs; else a no-op
    context."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF
