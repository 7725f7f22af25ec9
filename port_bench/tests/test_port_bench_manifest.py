"""The manifest keeps to the benchmark's contract, and a cell, a mix and a
metric are found by name when added as files."""

import json
import os
import re
import shutil

import pytest

from port_bench import harness

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def manifest():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_manifest_keys_names_and_units(manifest):
    assert set(manifest) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    names = []
    for c in manifest["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and all(NAME.match(k) for k in c["reduced"])
        assert os.path.exists(os.path.join(ROOT, c["file"])) and c["file"].startswith("port_bench/")
        names.append(c["name"])
    for w in manifest["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["config"] in names
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert os.path.exists(os.path.join(BENCH, "metrics", f"{m['name']}.py"))
    for m in manifest["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0 < m["bound"] <= 0.25
    e2e = {m["name"] for m in manifest["end_to_end"]}
    for m in manifest["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
    every = [m["name"] for m in manifest["end_to_end"] + manifest["per_layer"]]
    assert len(every) == len(set(every))
    assert len({w["name"] for w in manifest["workloads"]}) == len(manifest["workloads"])
    assert len({(w["config"], w["traffic"]) for w in manifest["workloads"]}) == len(manifest["workloads"])
    assert {c["name"] for c in manifest["configs"]} == {w["config"] for w in manifest["workloads"]}
    for p in manifest["paths"]:
        assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", p) and ".." not in p and not p.startswith("/")
    assert 1 <= manifest["run_seconds"] <= 51
    assert len(json.dumps(manifest)) < 64 * 1024


def test_every_cell_reports_its_metrics(manifest):
    for w in manifest["workloads"]:
        cell, config, mix = harness.cell_files(w["name"])
        assert (cell["config"], cell["traffic"]) == (w["config"], w["traffic"])
        e2e = {m["name"] for m in harness.cell_metrics(manifest, w["name"], False)}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert harness.cell_metrics(manifest, w["name"], True)
        for k in ("warmup_s", "range_drop_prob"):
            assert k in mix


def test_added_files_are_found_by_name(tmp_path, manifest):
    """A cell, a mix and a per-layer metric added as new files (and
    manifest entries) in a copy are found with no other file edited."""
    bench = tmp_path / "port_bench"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {p: open(p, "rb").read() for p in map(str, bench.rglob("*")) if os.path.isfile(p)}
    (bench / "mixes" / "bursty.json").write_text(json.dumps(
        {"why": "test", "warmup_s": 1.0, "range_drop_prob": 0.5, "outage_period_s": 0.0, "outage_s": 0.0}))
    (bench / "cells" / "uwb_corridor.bursty.json").write_text(
        json.dumps({"config": "uvio_corridor_sim", "traffic": "bursty"}))
    (bench / "metrics" / "frames_seen.py").write_text("def read(run):\n    return len(run.frames)\n")
    m = dict(manifest)
    m["workloads"] = manifest["workloads"] + [{"name": "uwb_corridor.bursty", "config": "uvio_corridor_sim",
                                               "traffic": "bursty", "chips": 1, "why": "test"}]
    m["per_layer"] = manifest["per_layer"] + [{
        "name": "frames_seen", "unit": "count", "better": "higher", "source": "program_counter",
        "layer": "host loop", "moves": "pose_latency_p95_ms", "workloads": ["uwb_corridor.bursty"]}]
    cell, config, mix = harness.cell_files("uwb_corridor.bursty", str(bench))
    assert mix["range_drop_prob"] == 0.5 and config["name"] == "uvio_corridor_sim"
    names = [x["name"] for x in harness.cell_metrics(m, "uwb_corridor.bursty", True)]
    assert names == ["frames_seen"]
    run = harness.Run(frames=[1, 2, 3])
    assert harness.reader("frames_seen", str(bench))(run) == 3
    after = {p: open(p, "rb").read() for p in before}
    assert after == before
