"""A small copy of the benchmark for the CPU tests: the cells' files under
a temporary folder, with one tiny configuration and tiny traffic of each
kind, found by name as the real ones are."""

from __future__ import annotations

import json
import os
import shutil

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)

TINY_CONFIG = {"width": 64, "height": 48, "gop_size": 12}
TINY_CHUNK = 4
# Screen content at a tiny size: the painters a later screen cell would
# name in its traffic file, with boxes for a 64x48 picture.
TINY_SCREEN = {
    "ring_frames": 8,
    "layers": [
        {"kind": "fill", "level": 200},
        {"kind": "rect", "box": [0, 0, 64, 4], "level": 32},
        {"kind": "rect", "box": [0, 4, 12, 44], "level": 150},
        {"kind": "text", "box": [16, 10, 40, 32], "glyph": [8, 16],
         "scroll_px_per_frame": 4, "ink": 16, "paper": 236, "glyphs": 12,
         "density": 0.4, "line_fill": 0.85},
    ],
    "chroma": {"u": [1, 2, 64], "v": [1, 4, 96]},
}


def tiny_traffic(kind: str) -> dict:
    """The natural traffic file at a tiny size (its ring the tiny GOP's P
    frames, as the file's is the real GOP's), or the tiny screen."""
    if kind == "screen":
        return json.loads(json.dumps(TINY_SCREEN))
    with open(os.path.join(BENCH, "traffic", "natural.json")) as f:
        t = json.load(f)
    t["ring_frames"] = TINY_CONFIG["gop_size"] - 1
    t["layers"][1]["size"] = 16
    return t


def make_tiny(dest: str) -> tuple[dict, str]:
    """A copy of h264_bench under dest with cells tiny.natural and
    tiny.screen, which report what the real cell reports. Returns (spec,
    bench folder)."""
    bench = os.path.join(dest, "h264_bench")
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    with open(os.path.join(bench, "configs", "h264_2160p_cqp.json")) as f:
        cfg = json.load(f)
    cfg["encoder"].update(TINY_CONFIG, level_idc=40)
    cfg["pipeline_chunk"] = TINY_CHUNK
    with open(os.path.join(bench, "configs", "tiny.json"), "w") as f:
        json.dump(cfg, f)
    cells = []
    for kind in ("natural", "screen"):
        with open(os.path.join(bench, "traffic", f"tiny_{kind}.json"),
                  "w") as f:
            json.dump(tiny_traffic(kind), f)
        cells.append({"name": f"tiny.{kind}", "config": "tiny",
                      "traffic": f"tiny_{kind}", "chips": 1,
                      "why": "a CPU test's cell"})
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        spec = json.load(f)
    spec["configs"].append({"name": "tiny", "source": "tests",
                            "file": "h264_bench/configs/tiny.json",
                            "reduced": ["width", "height", "gop_size"],
                            "why": "tests"})
    spec["workloads"] += cells
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            m["workloads"] = m["workloads"] + [c["name"] for c in cells]
    with open(os.path.join(dest, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f)
    return spec, bench


@pytest.fixture
def tiny(tmp_path):
    return make_tiny(str(tmp_path))
