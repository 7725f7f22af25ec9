"""The manifest keeps to the benchmark's contract, every configuration
names a driver that keeps to the harness's, and a cell, a mix, a metric
and a whole system are found by name when added as files."""

import inspect
import json
import os
import re
import shutil
import sys
import time

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
        assert set(harness.driver(config["system"]).MIX_KEYS) <= set(mix)


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


ESTIMATOR_METHODS = ("initialize", "feed_frame", "frame_timing", "record", "outputs", "graph_count")


def missing_from_contract(drv) -> list:
    """What of the driver contract (`harness.py`'s docstring) `drv` lacks."""
    missing = [k for k in ("make_traffic", "judge", "control_outputs")
               if not callable(getattr(drv, k, None))]
    missing += [k for k in ("MODULES", "MIX_KEYS", "STAGES") if not isinstance(getattr(drv, k, None), tuple)]
    est = getattr(drv, "Estimator", None)
    if not inspect.isclass(est):
        return missing + ["Estimator"]
    missing += [f"Estimator.{m}" for m in ESTIMATOR_METHODS if not callable(getattr(est, m, None))]
    if list(inspect.signature(est).parameters)[:5] != ["pkg", "config", "traffic", "root", "device"]:
        missing.append("Estimator(pkg, config, traffic, root, device)")
    return missing


def test_every_config_names_a_driver_with_the_whole_contract(manifest):
    for c in manifest["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            system = json.load(f)["system"]
        assert NAME.match(system) and os.path.isfile(os.path.join(BENCH, "drivers", f"{system}.py")), c["name"]
        drv = harness.driver(system)
        assert missing_from_contract(drv) == [], system
        assert all(isinstance(m, str) for m in drv.MODULES + drv.MIX_KEYS)
        assert all(isinstance(k, str) and isinstance(n, str) for k, n in drv.STAGES)


# A second system, added by files alone: the port's plain `VioManager` on
# the corridor's simulated tracks with no range sets, timed by its own key
# and judged by a number of its own.
TOY_DRIVER = '''"""System `toy_vio`: the port's VioManager on the corridor's tracks, no ranges."""

import dataclasses
import os
import time
import types

import numpy as np

from port_bench.traffic.generate import make_traffic as corridor_traffic

MODULES = ("utils.config", "manager")
MIX_KEYS = ("warmup_s",)
STAGES = (("feed_s", "feed"),)


def make_traffic(config, mix, seed, seconds, root, frames=None):
    tr = corridor_traffic(config, mix, seed, seconds, root, frames=frames)
    events = [e for e in tr.stream.events if e[0] != "uwb"]
    return dataclasses.replace(tr, stream=dataclasses.replace(tr.stream, events=events))


class Estimator:
    def __init__(self, pkg, config, traffic, root, device):
        cfg, _ = pkg.utils.config.load_config(os.path.join(root, "configs", config["estimator"]), device=str(device))
        fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(pkg.manager.VioConfig)}
        self.mgr = pkg.manager.VioManager(pkg.manager.VioConfig(
            **dict(fields, use_static_init=False, use_dynamic_init=False, dtype=config["dtype"])))
        self.traffic, self.stream = traffic, traffic.stream
        self.poses = np.full((len(self.stream.cam_t), 7), np.nan)
        self.feed_s = None

    def initialize(self):
        g = self.traffic.gt0
        self.mgr.initialize_with_gt(self.stream.t_begin, g["q_GtoI"], g["p_IinG"], g["v_IinG"], g["bg"], g["ba"])

    def feed_imu(self, i):
        s = self.stream
        self.mgr.feed_imu(float(s.imu_t[i]), s.imu_w[i], s.imu_a[i])

    def feed_frame(self, k):
        t0 = time.perf_counter()
        self.mgr.feed_features(float(self.stream.cam_t[k]), self.stream.tracks[k])
        self.feed_s = time.perf_counter() - t0

    def frame_timing(self):
        return {"feed_s": self.feed_s}

    def record(self, k):
        st = self.mgr.state
        self.poses[k] = np.concatenate([st.q.cpu().numpy(), st.p.cpu().numpy()])

    def outputs(self, n):
        return types.SimpleNamespace(rows=self.poses[:n])

    def graph_count(self):
        return 0


def judge(config, traffic, out, root):
    """poses_finite: the frames whose pose is not finite."""
    bad = float(np.sum(~np.isfinite(out.rows).all(axis=1)))
    return {"poses_finite": (bad, config["limits"]["poses_finite"])}


def control_outputs(pkg, config, traffic, root, device, n):
    raise NotImplementedError("the toy system has no control")
'''


def add_toy_system(tmp_path, manifest, driver_source=TOY_DRIVER):
    """A copy of the benchmark with the toy system added as new files: a
    driver, a configuration naming it, a mix without `range_drop_prob`, a
    cell and a metric reading the driver's own timing key. Returns the
    copy and its files' bytes before the toy's were added."""
    bench = tmp_path / "port_bench"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {p: open(p, "rb").read() for p in map(str, bench.rglob("*")) if os.path.isfile(p)}
    (bench / "drivers" / "toy_vio.py").write_text(driver_source)
    corridor = json.loads((bench / "configs" / "uvio_corridor_sim.json").read_text())
    (bench / "configs" / "toy_corridor.json").write_text(json.dumps(
        dict(corridor, name="toy_corridor", system="toy_vio", limits={"poses_finite": 0})))
    (bench / "mixes" / "toy.json").write_text(json.dumps({"why": "test", "warmup_s": 1.5}))
    (bench / "cells" / "toy_corridor.live.json").write_text(json.dumps({"config": "toy_corridor", "traffic": "toy"}))
    (bench / "metrics" / "feed_ms.py").write_text(
        "def read(run):\n    return 1e3 * sum(f['feed_s'] for f in run.frames) / len(run.frames)\n")
    m = dict(manifest)
    m["configs"] = manifest["configs"] + [{"name": "toy_corridor", "source": "test", "reduced": [], "why": "test",
                                           "file": "port_bench/configs/toy_corridor.json"}]
    m["workloads"] = manifest["workloads"] + [{"name": "toy_corridor.live", "config": "toy_corridor", "traffic": "toy",
                                               "chips": 1, "why": "test"}]
    m["end_to_end"] = manifest["end_to_end"] + [{"name": "feed_ms", "unit": "ms", "better": "lower", "bound": 0.25,
                                                 "source": "host_clock", "workloads": ["toy_corridor.live"]}]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(m))
    return bench, before


def toy_run(bench):
    return harness.run_cell("toy_corridor.live", 2468013579, 1.0, False, "cpu", time.perf_counter(),
                            bench_dir=str(bench), frames=8)


def test_a_system_is_added_by_files_alone(tmp_path, manifest):
    """The toy system, added as new files in a copy, runs through
    `run_cell` on the CPU with the toy's traffic, estimator, timing and
    judge; no file of the copy changes."""
    bench, before = add_toy_system(tmp_path, manifest)
    drv = harness.driver("toy_vio", str(bench))
    assert missing_from_contract(drv) == []
    _, config, mix = harness.cell_files("toy_corridor.live", str(bench))
    assert "range_drop_prob" not in mix and set(drv.MIX_KEYS) <= set(mix)
    r = toy_run(bench)
    assert r["attempted"] == 8 and r["failed"] == 0 and r["correct"]
    assert r["checks"] == {"poses_finite": {"value": 0.0, "limit": 0}}
    assert set(r["metrics"]) == {"setup_s", "pose_latency_p50_ms", "pose_latency_p95_ms", "feed_ms"}
    assert r["metrics"]["feed_ms"]["value"] > 0
    assert {p: open(p, "rb").read() for p in before} == before


def test_a_mix_without_a_key_of_its_driver_fails_the_run(tmp_path, manifest):
    """A mix that lacks one of its driver's `MIX_KEYS` stops the run
    before it starts."""
    bench, _ = add_toy_system(tmp_path, manifest, TOY_DRIVER.replace(
        'MIX_KEYS = ("warmup_s",)', 'MIX_KEYS = ("warmup_s", "range_drop_prob")'))
    with pytest.raises(KeyError, match="range_drop_prob"):
        toy_run(bench)


def test_a_judge_that_loads_jax_ends_the_run_without_a_result(tmp_path, manifest, monkeypatch):
    """Modules a driver's judge loads after the window are looked for
    too: a judge that imports `jax` (a stand-in package here) ends the run
    with no result."""
    bench, _ = add_toy_system(tmp_path, manifest, TOY_DRIVER + '''

_judge = judge


def judge(config, traffic, out, root):
    import jax  # noqa: F401

    return _judge(config, traffic, out, root)
''')
    fake = tmp_path / "fake"
    (fake / "jax").mkdir(parents=True)
    (fake / "jax" / "__init__.py").write_text("")
    monkeypatch.syspath_prepend(str(fake))
    assert "jax" not in sys.modules
    try:
        with pytest.raises(SystemExit, match="jax"):
            toy_run(bench)
        assert sys.modules["jax"].__file__ == str(fake / "jax" / "__init__.py")
    finally:
        sys.modules.pop("jax", None)
