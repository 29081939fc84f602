"""The plain reference of Main-profile CABAC with I_4x4 IDRs
(reference/encoder_main.py) against the program on the CPU: the same
access units byte for byte and the same planes after deblocking at small
sizes, with both kinds of intra MB; its envelope; its streams through
libavcodec; and the comparison coming out not correct for a CABAC P
access unit that is not the reference's."""

from __future__ import annotations

import json
import os

import numpy as np
import pytest

from h264_bench import gen, harness
from h264_bench.reference import intra4
from h264_bench.reference.encoder import ReferenceEncoder as CavlcReference
from h264_bench.reference.encoder_main import ReferenceEncoder
from h264_bench.tests.conftest import (TINY_CHUNK, TINY_CONFIG, make_tiny,
                                       tiny_traffic)

CONFIG = "h264_1080p_cabac_cqp"
ENC = dict(qp=32, gop_size=300, level_idc=40, framerate=30, profile="main",
           rc_mode="cq", num_slices=1, deblock=True, cabac=True,
           cabac_init_idc=0, i4x4=True, adaptive_qp=False, b_frames=0,
           entropy_mode="device")
# A value outside the envelope for each of its keys.
OUTSIDE = {"profile": "baseline", "rc_mode": "cbr", "num_slices": 2,
           "deblock": False, "cabac": False, "cabac_init_idc": 1,
           "i4x4": False, "adaptive_qp": True, "b_frames": 1,
           "lossless": True, "insert_aud": True, "insert_sei": True,
           "signal_timing": False}


def pictures(kind: str, w: int, h: int, n_p: int, seed: int):
    t = tiny_traffic(kind)
    return gen.to_host(gen.make_frames(t, w, h, seed, "cpu"))[:n_p + 1]


def encode_both(kind: str, w: int, h: int, n_p: int, seed: int):
    from media_tpu_torch.pipeline.codec import EncoderConfig, EncoderSession

    fr = pictures(kind, w, h, n_p, seed)
    enc = dict(ENC, width=w, height=h)
    s = EncoderSession(EncoderConfig(**enc), device="cpu")
    s.PIPELINE_CHUNK = 4
    aus = [s.encode_frame(gen.i420(fr[0]))]
    aus += s.encode_frames_staged(s.upload_frames([gen.i420(f)
                                                   for f in fr[1:]]))
    ref = ReferenceEncoder(enc)
    au_of, rec = ref.idr(*fr[0])
    want, recs = [au_of(0)], [rec]
    for k in range(1, n_p + 1):
        au, rec = ref.p(*fr[k], rec, k)
        want.append(au)
        recs.append(rec)
    is_i4 = intra4.intra_encode_i4(*ref.planes(*fr[0]), ref.qp, ref.qp_c,
                                   _row_has_top(ref.R))["is_i4"]
    return aus, want, [p.numpy() for p in s.recon], recs, is_i4


def _row_has_top(R: int):
    import torch

    has_top = torch.ones(R, dtype=torch.bool)
    has_top[0] = False
    return has_top


@pytest.mark.parametrize("kind, w, h", [("natural", 64, 48),
                                        ("natural", 176, 144),
                                        ("screen", 64, 48)])
def test_reference_equals_program(kind, w, h):
    aus, want, got_rec, recs, is_i4 = encode_both(kind, w, h, 5, 21)
    assert [len(a) for a in aus] == [len(a) for a in want]
    assert aus == want
    for a, b in zip(got_rec, recs[-1]):
        assert np.array_equal(a, b)
    if (kind, w) == ("natural", 176):  # both kinds of intra MB coded
        assert 0 < int(is_i4.sum()) < is_i4.numel()


def test_configuration_is_the_envelope():
    with open(os.path.join(harness.HERE, "configs", f"{CONFIG}.json")) as f:
        cfg = json.load(f)
    assert cfg["reference"] == "encoder_main"
    ReferenceEncoder(cfg["encoder"])
    with pytest.raises(ValueError):
        CavlcReference(cfg["encoder"])


@pytest.mark.parametrize("key", sorted(OUTSIDE))
def test_reference_refuses_outside_its_envelope(key):
    assert set(OUTSIDE) == set(ReferenceEncoder.ENVELOPE)
    with pytest.raises(ValueError):
        ReferenceEncoder(dict(ENC, width=64, height=48, **{key: OUTSIDE[key]}))


def test_reference_streams_decode_in_libavcodec():
    from media_tpu_torch.testing import avref

    if not avref.available():
        pytest.skip(f"libavcodec unavailable: {avref.build_error()[:200]}")
    fr = pictures("natural", 176, 144, 4, 5)
    ref = ReferenceEncoder(dict(ENC, width=176, height=144))
    au_of, rec = ref.idr(*fr[0])
    aus, recs = [au_of(0)], [rec]
    for k in range(1, 5):
        au, rec = ref.p(*fr[k], rec, k)
        aus.append(au)
        recs.append(rec)
    decoded = avref.decode(b"".join(aus))
    assert len(decoded) == len(aus)
    for got, want in zip(decoded, recs):
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


# ------------------------------------------------- the comparison, whole runs


@pytest.fixture
def tiny_cabac(tmp_path):
    """The tiny benchmark copy with a cell of this configuration at 64x48
    under the tiny natural traffic, reporting what the real cell does."""
    spec, bench = make_tiny(str(tmp_path))
    cfg = harness.load_config(CONFIG)
    cfg["encoder"].update(TINY_CONFIG, level_idc=40)
    cfg["pipeline_chunk"] = TINY_CHUNK
    with open(os.path.join(bench, "configs", "tiny_cabac.json"), "w") as f:
        json.dump(cfg, f)
    cell = "tiny_cabac.natural"
    spec["workloads"].append({"name": cell, "config": "tiny_cabac",
                              "traffic": "tiny_natural", "chips": 1,
                              "why": "a CPU test's cell"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if f"{CONFIG}.natural" in m.get("workloads", []):
            m["workloads"] = m["workloads"] + [cell]
    return spec, bench, cell


def test_traced_run_is_correct_and_reads_the_transcode(tiny_cabac):
    spec, bench, cell = tiny_cabac
    out = harness.run_cell(spec, cell, 2**31 + 91, 0.0, True, device="cpu",
                           bench=bench)
    assert out["correct"] is True
    assert all(c["value"] == 0 for c in out["compared"].values())
    value = out["metrics"]["cabac_transcode_ms.natural"]["value"]
    assert isinstance(value, float) and value > 0


def _flip_a_bit(orig):
    def flipped(self, *a, **kw):
        au = orig(self, *a, **kw)
        return au[:-2] + bytes([au[-2] ^ 0x10]) + au[-1:]
    return flipped


def _other_init_idc(orig):
    def init(self, cfg, *a, **kw):
        orig(self, cfg, *a, **kw)
        self.cfg.cabac_init_idc = 1
    return init


@pytest.mark.parametrize("fault", ["flipped_bit", "other_cabac_init_idc"])
def test_cabac_p_au_not_the_references(tiny_cabac, monkeypatch, fault):
    """A bit flipped in every transcoded P access unit; every P slice coded
    (and its header written) with cabac_init_idc 1, a stream a decoder
    reads but not the one the configuration asks for."""
    from media_tpu_torch.pipeline import codec

    S = codec.EncoderSession
    if fault == "flipped_bit":
        monkeypatch.setattr(S, "_cabac_au_from_cavlc_stream",
                            _flip_a_bit(S._cabac_au_from_cavlc_stream))
    else:
        monkeypatch.setattr(S, "__init__", _other_init_idc(S.__init__))
    spec, bench, cell = tiny_cabac
    out = harness.run_cell(spec, cell, 31, 0.0, False, device="cpu",
                           bench=bench)
    assert out["correct"] is False
    assert out["compared"]["au_mismatch"]["value"] > 0
