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
controller state, and the CABAC stream's decoded pictures. It writes the
sha256 of the input clip, of the access units and of every decoded
picture's planes to media_tpu_torch/golden_1080p.json.

    JAX_PLATFORMS=cpu python tools/record_torch_golden.py

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


def main() -> None:
    import chip_smoke as cs
    from media_tpu.pipeline.codec import EncoderConfig, EncoderSession
    from media_tpu.pipeline.decoder_tpu import TpuDecoder

    t0 = time.perf_counter()
    bufs, clip_sha = cs.clip_i420()
    sess = EncoderSession(EncoderConfig(width=cs.WIDTH, height=cs.HEIGHT,
                                        qp=cs.QP, gop_size=300))
    sess.PIPELINE_CHUNK = cs.CHUNK
    aus = [sess.encode_frame(bufs[0])]
    aus += sess.encode_frames(bufs[1 : 1 + cs.N_P])
    staged = sess.encode_frames_staged(
        sess.upload_frames(bufs[1 + cs.N_P : 1 + 2 * cs.N_P]))
    dec = TpuDecoder()
    decoded = [cs.planes_sha(f) for au in aus for f in dec.decode_annexb(au)]
    rec = {
        "width": cs.WIDTH, "height": cs.HEIGHT, "qp": cs.QP,
        "seed": cs.SEED, "n_p": cs.N_P, "chunk": cs.CHUNK,
        "clip_sha256": clip_sha,
        "aus_sha256": hashlib.sha256(b"".join(aus)).hexdigest(),
        "staged_sha256": hashlib.sha256(b"".join(staged)).hexdigest(),
        "au_bytes": [len(a) for a in aus + staged],
        "au_sha256": [hashlib.sha256(a).hexdigest() for a in aus + staged],
        "decoded_sha256": decoded,
    }
    print(f"constant QP, CAVLC: {time.perf_counter() - t0:.1f} s", flush=True)
    # The rate-controlled runs (chip_smoke.RATE_RUNS), and the CABAC stream
    # of the first through the JAX TpuDecoder.
    for name, (fields, n_p, n_staged) in cs.RATE_RUNS.items():
        sess = EncoderSession(EncoderConfig(
            width=cs.WIDTH, height=cs.HEIGHT, qp=cs.QP, gop_size=300,
            **fields))
        sess.PIPELINE_CHUNK = cs.CHUNK
        run = cs.drive_rate_run(sess, bufs, n_p, n_staged)
        rec[name] = {"n_p": n_p, "n_staged": n_staged,
                     **cs.rate_record(sess, run["aus"] + run["staged"],
                                      run["log"])}
        if name == "cbr_cabac":
            dec = TpuDecoder()
            rec[name]["decoded_sha256"] = [
                cs.planes_sha(f) for au in run["aus"]
                for f in dec.decode_annexb(au)]
        print(f"{name}: {time.perf_counter() - t0:.1f} s", flush=True)
    with open(OUT, "w") as f:
        json.dump(rec, f, indent=1)
        f.write("\n")
    print(json.dumps(rec), f"({time.perf_counter() - t0:.1f} s)")


if __name__ == "__main__":
    main()
