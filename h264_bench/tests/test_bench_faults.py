"""A run with the timed path broken underneath comes out not correct: once
for each fault the cells can have, and for the control in the program's
place. The runs skip the look for a chip and run the program on the CPU
at a tiny size. (One card: no exchange between chips to leave out.)"""

from __future__ import annotations

import json

import pytest
import torch

from h264_bench import control, harness


def run(tiny, cell="tiny.natural"):
    spec, bench = tiny
    return harness.run_cell(spec, cell, 77, 0.0, False, device="cpu",
                            bench=bench)


def test_sound_run_is_correct(tiny):
    out = run(tiny)
    assert out["correct"] is True
    assert all(c["value"] == 0 for c in out["compared"].values())


def test_state_left_unchanged(tiny, monkeypatch):
    """Each P frame hands on the reference it was given."""
    from media_tpu_torch.pipeline import encoder

    step = encoder.FrameEncoder._pframe_step

    def stale(self, ref, frame, *a, **kw):
        symbols, _recon = step(self, ref, frame, *a, **kw)
        return symbols, ref

    monkeypatch.setattr(encoder.FrameEncoder, "_pframe_step", stale)
    out = run(tiny)
    assert out["correct"] is False
    assert out["compared"]["recon_mismatch"]["value"] > 0


def test_half_the_batch_left_out(tiny, monkeypatch):
    from media_tpu_torch.pipeline import codec

    staged = codec.EncoderSession.encode_frames_staged

    def half(self, chunks):
        aus = staged(self, chunks)
        return aus[: (len(aus) + 1) // 2]

    monkeypatch.setattr(codec.EncoderSession, "encode_frames_staged", half)
    out = run(tiny)
    assert out["correct"] is False
    assert out["compared"]["missing_aus"]["value"] > 0


def test_answer_altered_where_produced(tiny, monkeypatch):
    """One bit of every P slice's device stream flipped."""
    from media_tpu_torch.pipeline import codec

    merge = codec.merge_slice_data

    def flipped(bw, words, bits):
        words = words.copy()
        words[0] ^= 1 << 20
        merge(bw, words, bits)

    monkeypatch.setattr(codec, "merge_slice_data", flipped)
    out = run(tiny, "tiny.screen")
    assert out["correct"] is False
    assert out["compared"]["au_mismatch"]["value"] > 0


def test_deblocking_skipped(tiny, monkeypatch):
    from media_tpu_torch.pipeline import encoder

    def unfiltered(y, u, v, *a, **kw):
        return tuple(p.to(torch.uint8) for p in (y, u, v))

    monkeypatch.setattr(encoder, "deblock_pframe_from_symbols", unfiltered)
    out = run(tiny)
    assert out["correct"] is False


def test_control_fails(tiny):
    spec, bench = tiny
    (out,) = control.readings(spec, "tiny.natural", [5], device="cpu",
                              bench=bench)
    prog, ctrl = out["program"], out["control"]
    assert all(c["value"] <= c["limit"] for c in prog.values())
    assert not all(c["value"] <= c["limit"] for c in ctrl.values())
    json.dumps(out)
