"""BENCHMARK.json against the benchmark's contract, and cells, metrics and
kernel stages found by name: a file dropped into a copy becomes a cell."""

from __future__ import annotations

import json
import os
import re

import pytest

from h264_bench import harness
from h264_bench.tests.conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def spec():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_top_level(spec):
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert spec["command"] == ["python3", "h264_bench/run.py"]
    assert spec["paths"] == ["h264_bench"]
    assert 1 <= spec["run_seconds"] <= 51
    assert len(json.dumps(spec)) < 64 * 1024


def test_configs(spec):
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("h264_bench/")
        cfg = harness.load_config(c["name"])
        assert c["file"] == f"h264_bench/configs/{c['name']}.json"
        assert cfg["source"] == c["source"]
        assert any(w["config"] == c["name"] for w in spec["workloads"])
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200


def test_config_states_its_departures(spec):
    """Each key in `reduced` is in the configuration's file with the value
    that runs, and the ring of each cell's traffic covers the GOP's P
    frames, so that no picture repeats inside a GOP."""
    from h264_bench import gen
    from h264_bench.reference.encoder import SEARCH_RANGE

    for c in spec["configs"]:
        cfg = harness.load_config(c["name"])
        enc = cfg["encoder"]
        assert set(c["reduced"]) <= set(cfg) & set(cfg["source_settings"])
        assert cfg["gop_size"] == enc["gop_size"]
        assert cfg["bit_depth"] == 8 and cfg["search_range"] == SEARCH_RANGE
        assert cfg["prediction_structure"] == "IPPP" and enc["b_frames"] == 0
        for w in spec["workloads"]:
            if w["config"] == c["name"]:
                ring = gen.load(w["traffic"])["ring_frames"]
                assert ring >= enc["gop_size"] - 1


def test_workloads(spec):
    four = 0
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200 and "\n" not in w["why"]
        assert os.path.exists(os.path.join(harness.HERE, "traffic",
                                           f"{w['traffic']}.json"))
        four += w["chips"] == 4
    assert four <= max(1, len(spec["workloads"]) // 4)
    pairs = [(w["config"], w["traffic"]) for w in spec["workloads"]]
    assert len(set(pairs)) == len(pairs)


def test_metrics(spec):
    names = [m["name"] for m in spec["end_to_end"] + spec["per_layer"]]
    assert len(set(names)) == len(names)
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    cells = {w["name"] for w in spec["workloads"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    for m in spec["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in {"host_clock", "device_trace"}
        assert 0.01 <= m["bound"] <= 0.25
    for cell in cells:  # setup_s and one more end to end, one per layer
        mine = [m for m in spec["end_to_end"] + spec["per_layer"]
                if cell in m.get("workloads", [cell])]
        assert sum("bound" in m for m in mine) >= 2
        assert any("layer" in m for m in mine)
    for m in spec["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and m["source"] in SOURCES
        assert set(m["workloads"]) <= set(
            e2e[m["moves"]].get("workloads", cells))
        assert hasattr(harness.load_module("metrics", m["name"]), "read")
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")


def test_kernel_stages():
    stages = harness.kernel_stages()
    assert {"pcore", "cavlc_pack", "deblock", "deblock_meta",
            "intra"} <= set(stages)
    for mod in stages.values():
        re.compile(mod.PATTERN)
    for name in ("pcore", "cavlc_pack", "deblock"):  # read by a roofline
        assert callable(stages[name].bound_s)


def test_dropped_files_make_a_cell(tiny):
    """A configuration, a traffic mix and a metric added as files (and as
    entries of BENCHMARK.json) run with no change to the harness."""
    spec, bench = tiny
    with open(os.path.join(bench, "metrics", "gops_in_window.py"), "w") as f:
        f.write("def read(run):\n    return float(run.idr_frames)\n")
    spec["per_layer"].append({"name": "gops_in_window", "unit": "GOPs",
                              "better": "higher", "source": "host_clock",
                              "layer": "encoder session", "moves":
                              "encode_fps.natural", "workloads":
                              ["tiny.screen"]})
    out = harness.run_cell(spec, "tiny.screen", 3, 0.0, True, device="cpu",
                           bench=bench)
    assert out["correct"] is True
    assert out["metrics"]["gops_in_window"]["value"] == 1.0
