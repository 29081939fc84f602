"""media_tpu_torch/parallel/gop_dispatch{,_mp}.py against a media_tpu session.

Both dispatchers cut the clip into GOPs, encode each from a pristine
session state (reset_gop_state(g)) in a worker — a thread, or a spawned
process — and stitch the AUs in presentation order: the bytes of one JAX
session that applies the same resets GOP by GOP (one run per
configuration, read from tests/golden_torch/; jax_sequential says what it
was asked; tests/jax_golden.py), tolerance 0. At constant QP the thread
dispatcher (two threads) and dispatch_multiprocess (two processes on the
CPU, prewarm on, no process group), the latter in a child interpreter under
a timeout, so that a hung spawn fails instead of holding a test worker;
under CBR the thread dispatcher. Then the reports' accounting against the
original's dataclasses, errors that surface, a sharded session as the
factory, and the device rule of the entry points. Four processes in a gloo
process group are slow-marked.
"""

import json
import os
import subprocess
import sys

import pytest
import torch

import chip_smoke as cs
from jax_golden import Golden
from media_tpu.parallel import gop_dispatch as jgd
from media_tpu.parallel import gop_dispatch_mp as jmp
from media_tpu_torch.parallel import gop_dispatch as tgd
from media_tpu_torch.parallel import gop_dispatch_mp as tmp
from media_tpu_torch.parallel.gop_dispatch import GopDispatcher
from media_tpu_torch.parallel.gop_dispatch_mp import dispatch_multiprocess
from media_tpu_torch.parallel.sharding import DevicePool, ShardedEncoderSession
from media_tpu_torch.pipeline.codec import EncoderConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, H, GOP, NGOPS, SEED = 64, 48, 3, 2, 4
FRAMES = cs.clip_i420(W, H, GOP * NGOPS, seed=SEED)[0]
CONFIGS = {"cq": dict(width=W, height=H, qp=30, gop_size=GOP),
           "cbr": dict(width=W, height=H, qp=30, gop_size=GOP,
                       rc_mode="cbr", bitrate=150_000, framerate=30)}


def sequential(session) -> list:
    """One session over the clip, reset at every GOP as the workers are."""
    out = []
    for g in range(NGOPS):
        session.reset_gop_state(g)
        out += session.encode_frames(FRAMES[g * GOP : (g + 1) * GOP])
    return out


# The JAX side deblocks one wave per scan step: the same bytes from smaller
# programs.
GOLDEN = Golden(__file__, env={"MEDIA_TPU_DEBLOCK_UNROLL": "1"})


@GOLDEN.recipe(cases=list(CONFIGS))
def jax_sequential(name):
    """sequential() through one JAX session of the configuration."""
    from media_tpu.pipeline.codec import EncoderConfig as JaxConfig
    from media_tpu.pipeline.codec import EncoderSession as JaxSession

    return sequential(JaxSession(JaxConfig(**CONFIGS[name])))


@pytest.fixture(scope="module")
def jax_aus():
    return {name: GOLDEN.read(jax_sequential, name) for name in CONFIGS}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_thread_dispatch_equals_the_jax_session(jax_aus, name):
    disp = GopDispatcher(EncoderConfig(**CONFIGS[name]), n_workers=2,
                         device="cpu")
    assert disp.pool.loads() == [W * H * 30] * 2
    aus = disp.encode(FRAMES)
    assert aus == jax_aus[name]
    rep = disp.report
    assert [g.gop_index for g in rep.gops] == list(range(NGOPS))
    assert sorted({g.worker for g in rep.gops}) <= [0, 1]
    assert rep.bytes_in == sum(len(f) for f in FRAMES)
    assert rep.bytes_out == sum(len(a) for a in aus)
    assert rep.to_json()["n_gops"] == NGOPS
    disp.close()
    assert disp.pool.loads() == [0, 0]


# Run in a child interpreter: dispatch_multiprocess over two spawned CPU
# workers, then one whose session cannot be built (it must raise, not
# hang). Prints one JSON line.
CHILD = r"""
import json, sys
import chip_smoke as cs
from media_tpu_torch.parallel.gop_dispatch_mp import dispatch_multiprocess
w, h, gop, ngops, seed, n_procs, dist = json.loads(sys.argv[1])
frames = cs.clip_i420(w, h, gop * ngops, seed=seed)[0]
cfg = dict(width=w, height=h, qp=30, gop_size=gop)
aus, rep = dispatch_multiprocess(cfg, frames, gop, n_procs=n_procs,
                                 use_distributed=dist, prewarm=True,
                                 device="cpu")
try:
    dispatch_multiprocess(dict(cfg, entropy_mode="nowhere"), frames, gop,
                          n_procs=1, use_distributed=False, prewarm=False,
                          device="cpu")
    error = None
except RuntimeError as e:
    error = str(e)
print(json.dumps({"aus": [a.hex() for a in aus], "n_procs": rep.n_procs,
                  "distributed": rep.distributed, "prewarm_s": rep.prewarm_s,
                  "gops": [[g.gop_index, g.worker] for g in rep.gops],
                  "scaling_efficiency": rep.scaling_efficiency,
                  "launches": rep.kernel_launches, "error": error}))
"""


def run_child(n_procs: int, distributed: bool) -> dict:
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run(
        [sys.executable, "-c", CHILD,
         json.dumps([W, H, GOP, NGOPS, SEED, n_procs, distributed])],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=180)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def process_run():
    return run_child(2, False)


def test_process_dispatch_equals_the_jax_session(jax_aus, process_run):
    run = process_run
    assert [bytes.fromhex(a) for a in run["aus"]] == jax_aus["cq"]
    assert (run["n_procs"], run["distributed"]) == (2, False)
    assert [g for g, _w in run["gops"]] == list(range(NGOPS))
    assert run["prewarm_s"] > 0 and run["scaling_efficiency"] > 0
    assert run["launches"] == 0  # the CPU runs the kernel's plain version


def test_a_dead_worker_process_raises(process_run):
    assert process_run["error"].startswith(
        "worker process(es) died with exit codes [1]")


@pytest.mark.slow
def test_four_processes_in_a_gloo_group_equal_the_jax_session(jax_aus):
    run = run_child(4, True)
    assert [bytes.fromhex(a) for a in run["aus"]] == jax_aus["cq"]
    assert (run["n_procs"], run["distributed"]) == (4, True)


def test_reports_account_as_the_originals_do():
    kw = dict(n_frames=3, compute_s=0.0)
    gops = [(0, 0, 1.5), (1, 1, 0.5), (2, 0, 1.0)]
    reps = [mod.DispatchReport(wall_s=3.0, n_workers=2, gops=[
        mod.GopStats(gop_index=g, worker=w, bytes_in=10, bytes_out=4 + g,
                     **dict(kw, compute_s=s)) for g, w, s in gops])
        for mod in (tgd, jgd)]
    assert reps[0].to_json() == reps[1].to_json()
    assert reps[0].dispatch_overhead == pytest.approx(1 / 6)
    mps = [mod.MpDispatchReport(wall_s=9.0, warm_wall_s=2.0, prewarm_s=1.0,
                                n_procs=2, distributed=False, gops=[
        mod.MpGopStats(gop_index=g, worker=w, bytes_out=5, **dict(
            kw, compute_s=s)) for g, w, s in gops]) for mod in (tmp, jmp)]
    assert mps[0].scaling_efficiency == mps[1].scaling_efficiency == 0.75
    assert mps[0].compute_s_total == mps[1].compute_s_total == 3.0


def test_a_worker_error_surfaces():
    class Broken:
        def reset_gop_state(self, g):
            pass

        def encode_frames(self, frames):
            raise RuntimeError("kernel launch failed")

    disp = GopDispatcher(EncoderConfig(**CONFIGS["cq"]), n_workers=2,
                         session_factory=lambda c: Broken(),
                         pool=DevicePool(["cpu"] * 2))
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        disp.encode(FRAMES)


def test_sharded_sessions_as_the_factory():
    """ShardedEncoderSession workers (three row tiles each): the dispatcher
    resets their base session, and the AUs are one sharded session's with
    the same resets (which tests/test_torch_multislice.py holds to the JAX
    three-slice session)."""
    def factory(c):
        return ShardedEncoderSession(c, devices=["cpu"] * 3)

    cfg = EncoderConfig(**CONFIGS["cq"])
    disp = GopDispatcher(cfg, n_workers=2, session_factory=factory,
                         pool=DevicePool(["cpu"] * 2))
    aus = disp.encode(FRAMES)
    one = factory(EncoderConfig(**CONFIGS["cq"]))
    want = []
    for g in range(NGOPS):
        one.base.reset_gop_state(g)
        want += one.encode_frames(FRAMES[g * GOP : (g + 1) * GOP])
    assert aus == want


def test_entry_points_default_to_cuda_and_raise_without_it():
    if torch.cuda.is_available():
        pytest.skip("checks a host without CUDA")
    cfg = EncoderConfig(**CONFIGS["cq"])
    for call in (lambda: GopDispatcher(cfg, n_workers=2),
                 lambda: dispatch_multiprocess(CONFIGS["cq"], FRAMES, GOP)):
        with pytest.raises(RuntimeError, match="cuda"):
            call()
