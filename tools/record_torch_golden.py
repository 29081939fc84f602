#!/usr/bin/env python
"""Record the golden digests that chip_smoke.py holds the PyTorch port to.

Runs the JAX package (the reference) on the CPU over chip_smoke.py's
synthetic 1920x1080 clip, down the same session path chip_smoke drives
(IDR through encode_frame, then P frames through encode_frames and through
upload_frames + encode_frames_staged, PIPELINE_CHUNK 8, QP 30, deblocking on,
CAVLC, one slice), then decodes the IDR and the first run of P access units
with the JAX package's TpuDecoder; then down the rate-controlled runs of
chip_smoke.RATE_RUNS (CBR at 8 Mbit/s with CABAC, the same with adaptive_qp,
and CBR with CAVLC), recording per AU a digest and a size, per P frame the
device loop's bits and QP, per chunk its (qp, buf, cplx) carry, the final
controller state, and the CABAC streams' decoded pictures (for the run with
the I_4x4 decision also the IDR's count of I_4x4 macroblocks); then down
chip_smoke.TOOL_RUNS (four slices with CAVLC and slice-local deblocking,
four slices with CABAC under CBR, the IBPBP B-GOP, lossless I_PCM), recording
per AU a digest and a size, the QP of every P picture and, where the device
decoder takes the stream, its decoded pictures. It writes the sha256 of the
input clip, of the access units and of every decoded picture's planes to
media_tpu_torch/golden_1080p.json.

    JAX_PLATFORMS=cpu python tools/record_torch_golden.py
    JAX_PLATFORMS=cpu python tools/record_torch_golden.py --only bgop,lossless

--only name[,name] records the named runs of RATE_RUNS and TOOL_RUNS into
the existing file and leaves every other entry as it is.

A full run takes some tens of minutes of CPU time (most of it XLA compiling
the 1080p programs).
"""

from __future__ import annotations

import hashlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
os.environ.setdefault("JAX_PLATFORMS", "cpu")

OUT = os.path.join(ROOT, "media_tpu_torch", "golden_1080p.json")


def record_constant_qp(cs, bufs, clip_sha: str) -> dict:
    """The constant-QP CAVLC run and its decoded pictures."""
    from media_tpu.pipeline.codec import EncoderConfig, EncoderSession
    from media_tpu.pipeline.decoder_tpu import TpuDecoder

    sess = EncoderSession(EncoderConfig(width=cs.WIDTH, height=cs.HEIGHT,
                                        qp=cs.QP, gop_size=300))
    sess.PIPELINE_CHUNK = cs.CHUNK
    aus = [sess.encode_frame(bufs[0])]
    aus += sess.encode_frames(bufs[1 : 1 + cs.N_P])
    staged = sess.encode_frames_staged(
        sess.upload_frames(bufs[1 + cs.N_P : 1 + 2 * cs.N_P]))
    dec = TpuDecoder()
    decoded = [cs.planes_sha(f) for au in aus for f in dec.decode_annexb(au)]
    return {
        "width": cs.WIDTH, "height": cs.HEIGHT, "qp": cs.QP,
        "seed": cs.SEED, "n_p": cs.N_P, "chunk": cs.CHUNK,
        "clip_sha256": clip_sha,
        "aus_sha256": hashlib.sha256(b"".join(aus)).hexdigest(),
        "staged_sha256": hashlib.sha256(b"".join(staged)).hexdigest(),
        "au_bytes": [len(a) for a in aus + staged],
        "au_sha256": [hashlib.sha256(a).hexdigest() for a in aus + staged],
        "decoded_sha256": decoded,
    }


def record_run(cs, bufs, name: str) -> dict:
    """One run of chip_smoke.RATE_RUNS or chip_smoke.TOOL_RUNS."""
    from media_tpu.pipeline.codec import EncoderConfig, EncoderSession
    from media_tpu.pipeline.decoder_tpu import TpuDecoder

    def session(fields):
        sess = EncoderSession(EncoderConfig(
            width=cs.WIDTH, height=cs.HEIGHT, qp=cs.QP, gop_size=300,
            **fields))
        sess.PIPELINE_CHUNK = cs.CHUNK
        return sess

    def decoded(aus):
        dec = TpuDecoder()
        return [cs.planes_sha(f) for au in aus for f in dec.decode_annexb(au)]

    if name in cs.RATE_RUNS:
        fields, n_p, n_staged = cs.RATE_RUNS[name]
        sess = session(fields)
        run = cs.drive_rate_run(sess, bufs, n_p, n_staged)
        rec = {"n_p": n_p, "n_staged": n_staged,
               **cs.rate_record(sess, run["aus"] + run["staged"], run["log"])}
        if name in ("cbr_cabac", cs.I4_RUN):
            rec["decoded_sha256"] = decoded(run["aus"])
        if name == cs.I4_RUN:
            rec["i4_mbs"] = run["i4_mbs"]
        return rec
    fields, n = cs.TOOL_RUNS[name]
    sess = session(fields)
    run = cs.drive_tool_run(sess, bufs, n)
    rec = {"n": n, **cs.tool_record(sess, run)}
    if name in cs.TOOL_RUNS_DECODED:
        rec["decoded_sha256"] = decoded(run["aus"])
    return rec


def main() -> None:
    import chip_smoke as cs

    t0 = time.perf_counter()
    names = [*cs.RATE_RUNS, *cs.TOOL_RUNS]
    only = None
    if "--only" in sys.argv[1:]:
        only = sys.argv[sys.argv.index("--only") + 1].split(",")
        unknown = [n for n in only if n not in names]
        if unknown:
            raise SystemExit(f"--only: no run named {unknown}; the runs are "
                             f"{names}")
    bufs, clip_sha = cs.clip_i420()
    if only is None:
        rec = record_constant_qp(cs, bufs, clip_sha)
        print(f"constant QP, CAVLC: {time.perf_counter() - t0:.1f} s",
              flush=True)
    else:
        with open(OUT) as f:
            rec = json.load(f)
        if rec["clip_sha256"] != clip_sha:
            raise SystemExit("--only: the recorded file is of another clip")
    for name in names if only is None else only:
        rec[name] = record_run(cs, bufs, name)
        print(f"{name}: {time.perf_counter() - t0:.1f} s", flush=True)
        # Written after every run, so that an interrupted recording keeps
        # what it finished.
        with open(OUT, "w") as f:
            json.dump(rec, f, indent=1)
            f.write("\n")
    print(json.dumps(rec), f"({time.perf_counter() - t0:.1f} s)")


if __name__ == "__main__":
    main()
