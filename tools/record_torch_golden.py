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
decoder takes the stream, its decoded pictures; then down chip_smoke.API_RUNS
through the public API (VideoEncoder at the shipped property defaults, at
1080p on main with a bitrate change, and the format-2 HEVC slot), recording
every return code, per AU a digest and a size, the encoder's QP after each
frame, and the digest of every payload that VideoDecoder hands out for the
stream; then down chip_smoke.ORACLE_RUNS (five 176x144 streams at constant
QP: IDR + 4 P, the same with I_4x4, four slices, the B-GOP, lossless),
recording per AU a digest and a size and the digest of every picture the
scalar ReferenceDecoder decodes; then chip_smoke.SHARDED_RUN (CBR with
CAVLC and adaptive_qp over four row tiles, IDR + 4 P) through the JAX
ShardedEncoderSession on four virtual CPU devices (the script sets
XLA_FLAGS=--xla_force_host_platform_device_count=4 before JAX loads),
recording per AU a digest and a size, per P frame the tiles' bits and the
QP, and the final rate state. It writes the sha256 of the
input clip, of the access units and of every decoded picture's planes to
media_tpu_torch/golden_1080p.json.

    JAX_PLATFORMS=cpu python tools/record_torch_golden.py
    JAX_PLATFORMS=cpu python tools/record_torch_golden.py --only bgop,lossless
    JAX_PLATFORMS=cpu python tools/record_torch_golden.py --only sharded4_cbr_aq

--only name[,name] records the named runs of RATE_RUNS, TOOL_RUNS,
API_RUNS, ORACLE_RUNS and SHARDED_RUN into
the existing file and leaves every other entry as it is.

A full run takes some tens of minutes of CPU time (most of it XLA compiling
the 1080p programs).

--tests records instead the JAX side of the port's CPU tests: every
tests/test_torch_*.py that keeps a jax_golden.Golden (its recipes, the
functions that say what the JAX package is asked) is imported and each
recipe run on each of its cases, on the CPU with the test configuration's
eight virtual devices; the results go to tests/golden_torch/<module>.npz
with the JAX package's source digest and JAX version (tests/jax_golden.py
holds the format). Each module runs in a process of its own, --jobs N of
them at once; --only module[,module] re-records only the named modules;
--out DIR writes the files to DIR instead.

    JAX_PLATFORMS=cpu python tools/record_torch_golden.py --tests --jobs 4
    JAX_PLATFORMS=cpu python tools/record_torch_golden.py --tests \
        --only test_torch_decoder
"""

from __future__ import annotations

import hashlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.join(ROOT, "tests")
sys.path[:0] = [ROOT, TESTS]
os.environ.setdefault("JAX_PLATFORMS", "cpu")

# chip_smoke.SHARDED_RUN runs the JAX ShardedEncoderSession over four
# virtual CPU devices (chip_smoke.SHARDED_TILES); the tests' recipes run
# on the eight of tests/conftest.py. Set before JAX loads.
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    _n = 8 if "--tests" in sys.argv[1:] else 4
    os.environ["XLA_FLAGS"] = (
        _flags + f" --xla_force_host_platform_device_count={_n}").strip()

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


def record_sharded_run(cs, bufs) -> dict:
    """chip_smoke.SHARDED_RUN through the JAX package's
    ShardedEncoderSession over chip_smoke.SHARDED_TILES virtual CPU
    devices: per AU a digest and a size, per P frame the tiles' bits and
    the QP, and the final rate state."""
    import jax

    from media_tpu.parallel.sharding import ShardedEncoderSession
    from media_tpu.pipeline.codec import EncoderConfig

    devices = jax.devices()[: cs.SHARDED_TILES]
    if len(devices) != cs.SHARDED_TILES:
        raise SystemExit(f"{cs.SHARDED_RUN}: {len(devices)} JAX devices; "
                         "XLA_FLAGS was set before this script")
    sess = ShardedEncoderSession(EncoderConfig(
        width=cs.WIDTH, height=cs.HEIGHT, qp=cs.QP, gop_size=300,
        **cs.SHARDED_FIELDS), devices=devices)
    run = cs.drive_sharded_run(sess, bufs, cs.N_SHARDED)
    return {"n": cs.N_SHARDED, "tiles": cs.SHARDED_TILES,
            **cs.sharded_record(sess, run["aus"], run["log"])}


def record_api_run(cs, name: str) -> dict:
    """One run of chip_smoke.API_RUNS through the JAX package's public API:
    the encoder lifecycle on the run's clip, then its stream through the
    VideoDecoder."""
    from media_tpu import api
    from media_tpu.core import params

    enc_run = cs.drive_api_encode(api, params, name, cs.api_clip(name))
    dec_run = cs.drive_api_decode(api, enc_run["aus"],
                                  cs.api_codec_format(name))
    return {"n": len(enc_run["aus"]), **cs.api_record(enc_run, dec_run)}


def record_oracle_run(cs, name: str) -> dict:
    """One run of chip_smoke.ORACLE_RUNS: the JAX session's AUs at 176x144,
    and the pictures the JAX package's scalar ReferenceDecoder decodes from
    them."""
    from media_tpu.pipeline.codec import EncoderConfig, EncoderSession
    from media_tpu.ref.decoder import ReferenceDecoder

    bufs = cs.clip_i420(cs.ORACLE_W, cs.ORACLE_H, cs.ORACLE_RUNS[name][1])[0]
    _sess, aus, _recon = cs.drive_oracle_run(EncoderSession, EncoderConfig,
                                             name, bufs)
    dec = ReferenceDecoder()
    return {"au_sha256": [hashlib.sha256(a).hexdigest() for a in aus],
            "au_bytes": [len(a) for a in aus],
            "decoded_sha256": [cs.planes_sha(f) for au in aus
                               for f in dec.decode_annexb(au)]}


def record_test_module(module: str, out_dir: str) -> None:
    """Run one test module's recipes and write its golden file."""
    import importlib

    import jax
    import jax_golden

    t0 = time.perf_counter()
    golden = importlib.import_module(module).GOLDEN
    goldens = golden.record(log=lambda line: print(line, flush=True))
    meta = {"module": module,
            "jax_source_sha256": jax_golden.source_digest(),
            "jax_version": jax.__version__}
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, module + ".npz")
    with open(path, "wb") as f:
        f.write(jax_golden.dump(meta, goldens))
    print(f"{module}: {os.path.getsize(path)} bytes, "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


def record_tests(argv: list) -> None:
    """--tests: every module's golden, or the --only ones, each recorded
    in a child process (one process compiling every module's programs
    outgrows what XLA:CPU keeps loaded), --jobs at a time."""
    import subprocess
    from concurrent.futures import ThreadPoolExecutor

    import jax_golden

    modules = jax_golden.golden_modules()
    out_dir = os.path.join(TESTS, "golden_torch")
    if "--out" in argv:
        out_dir = os.path.abspath(argv[argv.index("--out") + 1])
    jobs = int(argv[argv.index("--jobs") + 1]) if "--jobs" in argv else 1
    if "--only" in argv:
        only = argv[argv.index("--only") + 1].split(",")
        unknown = [m for m in only if m not in modules]
        if unknown:
            raise SystemExit(f"--only: no golden module {unknown}; they are "
                             f"{modules}")
        modules = only
    if "--child" in argv:
        record_test_module(modules[0], out_dir)
        return

    def child(module):
        return subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--tests", "--child",
             "--only", module, "--out", out_dir]).returncode

    t0 = time.perf_counter()
    with ThreadPoolExecutor(jobs) as pool:
        codes = dict(zip(modules, pool.map(child, modules)))
    print(f"{len(modules)} modules, {time.perf_counter() - t0:.1f} s")
    failed = [m for m, rc in codes.items() if rc]
    if failed:
        raise SystemExit(f"recording failed: {failed}")


def main() -> None:
    if "--tests" in sys.argv[1:]:
        record_tests(sys.argv[1:])
        return
    import chip_smoke as cs

    t0 = time.perf_counter()
    names = [*cs.RATE_RUNS, *cs.TOOL_RUNS, *cs.API_RUNS, *cs.ORACLE_RUNS,
             cs.SHARDED_RUN]
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
        if name in cs.API_RUNS:
            rec[name] = record_api_run(cs, name)
        elif name in cs.ORACLE_RUNS:
            rec[name] = record_oracle_run(cs, name)
        elif name == cs.SHARDED_RUN:
            rec[name] = record_sharded_run(cs, bufs)
        else:
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
