"""The JAX package's outputs for the port's CPU tests, recorded once.

tests/test_torch_*.py hold media_tpu_torch to media_tpu, the JAX package it
was ported from. That package is frozen, so on fixed inputs its outputs are
constants: each test module keeps what it asks the JAX package as plain
functions (recipes, registered with `Golden.recipe`), and
tools/record_torch_golden.py --tests runs them once on the CPU and writes
their results to tests/golden_torch/<module>.npz. A test reads a result
with `Golden.read(recipe, *case)` and runs only the port's side.

Each file is locked to the JAX package's source: it stores the sha256 of
the files of media_tpu/ and csrc/ (`source_digest`), and reading a file
recorded from other source raises. Re-record after any change there:

    JAX_PLATFORMS=cpu python tools/record_torch_golden.py --tests

Format: a deflated zip of .npy members (`np.load` with
allow_pickle=False reads it). `__tree__` holds the recorded values as
JSON, with arrays, byte strings and lists of access units replaced by
references to members; numpy scalars keep their dtype, tuples stay tuples.
An array of more than BIG bytes is kept as its sha256, shape and dtype
(`Digest`).
"""

from __future__ import annotations

import copy
import dataclasses
import functools
import hashlib
import io
import json
import os
import re
import zipfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_DIR = os.path.join(ROOT, "tests", "golden_torch")
# The JAX package's source: every file under these, but for what building
# and importing it leave behind.
SOURCE_DIRS = ("media_tpu", "csrc")
SOURCE_SKIP = ("csrc/build", "csrc/cavlc_tables.inc")
BUDGET = 8 << 20  # bytes, the whole directory
BIG = 256 << 10  # bytes; a larger array is kept as its digest
_DATE = (1980, 1, 1, 0, 0, 0)


def source_digest(root: str = ROOT) -> str:
    """sha256 over the JAX package's source files, paths and contents."""
    h = hashlib.sha256()
    for top in SOURCE_DIRS:
        for d, dirs, files in os.walk(os.path.join(root, top)):
            rel_d = os.path.relpath(d, root).replace(os.sep, "/")
            dirs[:] = sorted(x for x in dirs if x != "__pycache__"
                             and f"{rel_d}/{x}" not in SOURCE_SKIP)
            for name in sorted(files):
                rel = f"{rel_d}/{name}"
                if rel in SOURCE_SKIP or name.endswith(".pyc"):
                    continue
                with open(os.path.join(d, name), "rb") as f:
                    data = f.read()
                h.update(f"{rel}\0{len(data)}\0".encode())
                h.update(data)
    return h.hexdigest()


@dataclasses.dataclass(frozen=True)
class Digest:
    """An array too large to keep: its sha256, shape and dtype."""

    sha256: str
    shape: tuple
    dtype: str

    @classmethod
    def of(cls, a) -> "Digest":
        a = np.ascontiguousarray(a)
        return cls(hashlib.sha256(a.tobytes()).hexdigest(), tuple(a.shape),
                   a.dtype.str)

    def __eq__(self, other):
        """Equal to the same digest, or to an array that has it."""
        if not isinstance(other, Digest):
            other = Digest.of(np.asarray(other))
        return dataclasses.astuple(self) == dataclasses.astuple(other)

    __hash__ = None


# ------------------------------------------------------------ the format


class _Packer:
    def __init__(self):
        self.members: dict[str, np.ndarray] = {}

    def _member(self, a: np.ndarray) -> str:
        name = f"a{len(self.members)}"
        self.members[name] = a
        return name

    def pack(self, obj):
        if isinstance(obj, np.generic):  # before float: np.float64 is one
            return {"$scalar": obj.dtype.str, "v": obj.item()}
        if obj is None or isinstance(obj, (bool, int, float, str)):
            return obj
        if isinstance(obj, (bytes, bytearray)):
            return {"$bytes": self._member(np.frombuffer(bytes(obj),
                                                         np.uint8))}
        if isinstance(obj, (list, tuple)):
            if obj and all(isinstance(x, (bytes, bytearray)) for x in obj):
                off = np.cumsum([0] + [len(x) for x in obj], dtype=np.int64)
                data = np.frombuffer(b"".join(obj), np.uint8)
                return {"$aus": [self._member(data), self._member(off)],
                        "tuple": isinstance(obj, tuple)}
            items = [self.pack(x) for x in obj]
            return {"$tuple": items} if isinstance(obj, tuple) else items
        if isinstance(obj, dict):
            if all(isinstance(k, str) and not k.startswith("$") for k in obj):
                return {k: self.pack(v) for k, v in obj.items()}
            return {"$dict": [[self.pack(k), self.pack(v)]
                              for k, v in obj.items()]}
        if isinstance(obj, Digest):
            return {"$digest": obj.sha256, "shape": list(obj.shape),
                    "dtype": obj.dtype}
        a = np.asarray(obj)
        if a.dtype == object:
            raise TypeError(f"cannot record {type(obj).__name__}")
        if a.nbytes > BIG:
            return self.pack(Digest.of(a))
        return {"$array": self._member(np.ascontiguousarray(a))}


def _unpack(node, members):
    if isinstance(node, list):
        return [_unpack(x, members) for x in node]
    if not isinstance(node, dict):
        return node
    if "$scalar" in node:
        return np.dtype(node["$scalar"]).type(node["v"])
    if "$bytes" in node:
        return members[node["$bytes"]].tobytes()
    if "$aus" in node:
        data, off = (members[k] for k in node["$aus"])
        aus = [data[a:b].tobytes() for a, b in zip(off[:-1], off[1:])]
        return tuple(aus) if node["tuple"] else aus
    if "$tuple" in node:
        return tuple(_unpack(x, members) for x in node["$tuple"])
    if "$dict" in node:
        return {_unpack(k, members): _unpack(v, members)
                for k, v in node["$dict"]}
    if "$digest" in node:
        return Digest(node["$digest"], tuple(node["shape"]), node["dtype"])
    if "$array" in node:
        return members[node["$array"]]
    return {k: _unpack(v, members) for k, v in node.items()}


def dump(meta: dict, goldens: dict) -> bytes:
    """The file's bytes: the same values give the same bytes."""
    packer = _Packer()
    tree = json.dumps({"meta": meta, "goldens": packer.pack(goldens)})
    members = {"__tree__": np.frombuffer(tree.encode(), np.uint8),
               **packer.members}
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as z:
        for name, a in members.items():
            npy = io.BytesIO()
            np.lib.format.write_array(npy, a, allow_pickle=False)
            info = zipfile.ZipInfo(name + ".npy", _DATE)
            info.compress_type = zipfile.ZIP_DEFLATED
            info.external_attr = 0o644 << 16
            z.writestr(info, npy.getvalue(), compresslevel=9)
    return buf.getvalue()


def load(path: str) -> tuple[dict, dict]:
    """(meta, goldens) of a file written by `dump`."""
    with np.load(path, allow_pickle=False) as z:
        members = {k: z[k] for k in z.files}
    tree = json.loads(members.pop("__tree__").tobytes())
    return tree["meta"], _unpack(tree["goldens"], members)


def golden_modules() -> list:
    """The test modules that keep a Golden (a line `GOLDEN = Golden(...`)."""
    tests = os.path.join(ROOT, "tests")
    out = []
    for name in sorted(os.listdir(tests)):
        if name.startswith("test_torch_") and name.endswith(".py"):
            with open(os.path.join(tests, name)) as f:
                if re.search(r"^GOLDEN = Golden\(", f.read(), re.M):
                    out.append(name[:-3])
    return out


# -------------------------------------------------------------- recipes


def _key(case) -> str:
    return json.dumps(list(case))


class Golden:
    """The recorded JAX outputs of one test module.

    `recipe` registers a function that runs the JAX package (its body
    imports media_tpu, and only the recorder calls it); `read` returns what
    the recorder got from it. `env` holds environment variables the
    recorder sets around every recipe of the module, as the test module
    once did around its JAX side."""

    def __init__(self, module_file: str, env: dict | None = None):
        self.module = os.path.splitext(os.path.basename(module_file))[0]
        self.path = os.path.join(GOLDEN_DIR, self.module + ".npz")
        self.env = dict(env or {})
        self.recipes: dict[str, tuple] = {}

    def recipe(self, fn=None, *, cases=((),)):
        """Register `fn`; the recorder calls fn(*case) for every case."""
        if fn is None:
            return functools.partial(self.recipe, cases=cases)
        cases = [c if isinstance(c, tuple) else (c,) for c in cases]
        self.recipes[fn.__name__] = (fn, cases)
        return fn

    @functools.cached_property
    def _loaded(self) -> dict:
        if not os.path.exists(self.path):
            raise FileNotFoundError(
                f"{self.path} is missing: record it with "
                f"tools/record_torch_golden.py --tests --only {self.module}")
        meta, goldens = load(self.path)
        if meta["jax_source_sha256"] != _current_digest():
            raise AssertionError(
                f"{self.path} was recorded from other JAX package source; "
                f"re-record it with tools/record_torch_golden.py --tests")
        return goldens

    def read(self, fn, *case):
        """The recorded result of fn(*case)."""
        runs = self._loaded.get(fn.__name__)
        if runs is None or _key(case) not in runs:
            raise KeyError(f"{self.module}: no recording of "
                           f"{fn.__name__}{case}; re-record with "
                           f"tools/record_torch_golden.py --tests --only "
                           f"{self.module}")
        return copy.deepcopy(runs[_key(case)])

    def record(self, log=print) -> dict:
        """Run every recipe on every case (the recorder's side)."""
        import time

        import jax
        import pytest

        out = {}
        for name, (fn, cases) in self.recipes.items():
            out[name] = {}
            for case in cases:
                t0 = time.perf_counter()
                with pytest.MonkeyPatch.context() as mp:
                    for k, v in self.env.items():
                        mp.setenv(k, v)
                    out[name][_key(case)] = fn(*case)
                # One process compiles every program of the module: drop
                # them between recipes, as the test configuration does.
                jax.clear_caches()
                log(f"{self.module}.{name}{case}: "
                    f"{time.perf_counter() - t0:.1f} s")
        return out


@functools.lru_cache(maxsize=None)
def _current_digest() -> str:
    return source_digest()
