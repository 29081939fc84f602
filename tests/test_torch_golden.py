"""The JAX package's recorded outputs that the port's CPU tests read.

tests/golden_torch/ holds one file per test module that keeps a
jax_golden.Golden, written by tools/record_torch_golden.py --tests. Each
file must name the sha256 of the JAX package's source as it is now (a
change to media_tpu/ or csrc/ fails here until the goldens are recorded
again), the directory must stay within its budget, and no member may need
a pickle. The slow test records every golden again into a temporary
directory and holds it to the checked-in files byte for byte.
"""

import os
import shutil
import subprocess
import sys
import zipfile

import numpy as np
import pytest

import jax_golden
from jax_golden import BUDGET, GOLDEN_DIR, ROOT


def test_goldens_are_locked_to_the_jax_source_and_within_budget():
    digest = jax_golden.source_digest()
    files = sorted(os.listdir(GOLDEN_DIR))
    assert [f[:-4] for f in files] == jax_golden.golden_modules()
    total = 0
    for name in files:
        path = os.path.join(GOLDEN_DIR, name)
        total += os.path.getsize(path)
        with zipfile.ZipFile(path) as z:
            for member in z.namelist():
                assert member.endswith(".npy"), (name, member)
                with z.open(member) as f:
                    a = np.lib.format.read_array(f, allow_pickle=False)
                assert a.dtype != object, (name, member)
        meta, _goldens = jax_golden.load(path)
        assert meta["module"] == name[:-4]
        assert meta["jax_source_sha256"] == digest, (
            f"{name} was recorded from other JAX package source: record it "
            f"again with tools/record_torch_golden.py --tests")
        assert meta["jax_version"]
    assert total <= BUDGET, f"tests/golden_torch/ holds {total} bytes"


def test_source_digest_sees_every_source_byte_and_skips_build_output(
        tmp_path):
    for top in jax_golden.SOURCE_DIRS:
        shutil.copytree(os.path.join(ROOT, top), tmp_path / top,
                        ignore=shutil.ignore_patterns("__pycache__", "build"))
    digest = jax_golden.source_digest(str(tmp_path))
    assert digest == jax_golden.source_digest()
    for skipped in ("media_tpu/__pycache__/x.cpython-312.pyc",
                    "csrc/build/libx.so", "csrc/cavlc_tables.inc"):
        os.makedirs(os.path.dirname(tmp_path / skipped), exist_ok=True)
        (tmp_path / skipped).write_bytes(b"\x00")
    assert jax_golden.source_digest(str(tmp_path)) == digest
    src = tmp_path / "media_tpu" / "__init__.py"
    data = src.read_bytes()
    src.write_bytes(data[:-1] + bytes([data[-1] ^ 1]))
    assert jax_golden.source_digest(str(tmp_path)) != digest
    src.write_bytes(data)
    (tmp_path / "csrc" / "new.cpp").write_text("")
    assert jax_golden.source_digest(str(tmp_path)) != digest


def test_format_round_trips_and_is_reproducible(tmp_path):
    value = {"aus": [b"\x00\x00\x01\x65", b"", b"\x01"], "t": (1, 2.5, None),
             "scalars": [np.float32(0.1), np.int64(-3), np.bool_(True)],
             "planes": (np.arange(12, dtype=np.uint8).reshape(3, 4),),
             "keys": {3: "x", (1, 2): [b"a"]}, "raw": b"raw",
             "big": np.ones((jax_golden.BIG // 4 + 1,), np.int32)}
    data = jax_golden.dump({"module": "m"}, value)
    assert data == jax_golden.dump({"module": "m"}, value)
    path = tmp_path / "m.npz"
    path.write_bytes(data)
    meta, got = jax_golden.load(str(path))
    assert meta == {"module": "m"}
    assert got["aus"] == value["aus"] and got["t"] == value["t"]
    assert got["raw"] == b"raw" and got["keys"] == value["keys"]
    for a, b in zip(got["scalars"], value["scalars"]):
        assert type(a) is type(b) and a == b
    np.testing.assert_array_equal(got["planes"][0], value["planes"][0])
    assert isinstance(got["big"], jax_golden.Digest)
    assert got["big"] == value["big"] and got["big"] != value["big"] + 1


@pytest.mark.slow
def test_recorder_reproduces_the_goldens(tmp_path):
    """tools/record_torch_golden.py --tests into a temporary directory: the
    same files, byte for byte (tens of minutes of CPU)."""
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools", "record_torch_golden.py"),
         "--tests", "--jobs", "4", "--out", str(tmp_path)],
        cwd=ROOT, capture_output=True, text=True, timeout=5400)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    want = sorted(os.listdir(GOLDEN_DIR))
    assert sorted(os.listdir(tmp_path)) == want
    for name in want:
        with open(os.path.join(GOLDEN_DIR, name), "rb") as f:
            assert (tmp_path / name).read_bytes() == f.read(), name
