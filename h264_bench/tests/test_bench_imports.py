"""The whole-name check for JAX and the JAX package, and what the
benchmark's own modules import."""

from __future__ import annotations

import subprocess
import sys

from h264_bench import harness
from h264_bench.tests.conftest import ROOT


def test_whole_top_level_names(monkeypatch):
    for name in ("media_tpu_torch", "media_tpu_torch.pipeline",
                 "media_tpu_tools", "jaxtyping", "flaxen"):
        monkeypatch.setitem(sys.modules, name, object())
    found = harness.forbidden_modules()
    assert not [m for m in found if m.startswith(("media_tpu_", "jaxt",
                                                  "flaxen"))]
    for name in ("media_tpu", "media_tpu.pipeline.codec", "jax", "jaxlib",
                 "flax.linen"):
        monkeypatch.setitem(sys.modules, name, object())
    found = harness.forbidden_modules()
    for name in ("media_tpu", "media_tpu.pipeline.codec", "jax", "jaxlib",
                 "flax.linen"):
        assert name in found


def loaded_after(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", "import sys; sys.path.insert(0, %r); %s; "
         "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))"
         % (ROOT, code)], capture_output=True, text=True, check=True,
        timeout=300).stdout.split()
    return set(out)


def test_harness_loads_no_jax():
    tops = loaded_after(
        "from h264_bench import harness, gen, trace, control; "
        "from media_tpu_torch.pipeline.codec import EncoderSession; "
        "from media_tpu_torch.entropy import device_cavlc")
    assert not tops & set(harness.FORBIDDEN)


def test_reference_imports_nothing_of_the_program():
    tops = loaded_after(
        "from h264_bench.reference import encoder, deblock, vlc, pcore, "
        "intra")
    assert not tops & {"media_tpu_torch", *harness.FORBIDDEN}
