"""The benchmark's EuRoC cell (`euroc_v101.klt_live`, system `klt_vio`) on
the CPU at a small size: the port's tracker and filter against the plain
references (`port_bench/reference/klt.py`, `slam_vio.py`), faults that
the check must see, the control it must fail, the references' isolation
from the program, the tracker's timing row and the driver's contract.

The small size keeps every switch of the configuration and its
calibration, and cuts the frames to 188x120 (the intrinsics a quarter,
the pixel noise four times, so the filter sees the same angles), 30
features on a 3x3 grid, 2 pyramid levels, 4 SLAM slots, and 40 frames
from 18 s into the trajectory (the stretch where the first second holds
enough parallax to triangulate)."""

import ast
import json
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from port_bench import check, check_klt, harness, rooflines

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "port_bench")
CELL = "euroc_v101.klt_live"
FRAMES, WARMUP_S = 30, 0.5  # the window's frames and the warm-up's seconds (10 frames)
SEED = 2147483659
SMALL = {"max_slam": 4, "num_pts": 30, "grid_x": 3, "grid_y": 3, "dt_slam_delay": 0.5,
         "up_msckf_sigma_px": 4, "up_slam_sigma_px": 4}


@pytest.fixture(scope="module", autouse=True)
def full_precision():
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32


def small_bench(dst) -> str:
    """A copy of the benchmark with the cell cut to the small size."""
    shutil.copytree(BENCH, dst, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    d = os.path.join(dst, "configs", "euroc_v101_mono")
    y = open(os.path.join(d, "estimator_config.yaml")).read()
    for k, v in SMALL.items():
        y, n = re.subn(rf"^{k}:.*$", f"{k}: {v}", y, flags=re.M)
        assert n == 1, k
    open(os.path.join(d, "estimator_config.yaml"), "w").write(y)
    c = open(os.path.join(d, "kalibr_imucam_chain.yaml")).read()
    c = c.replace("intrinsics: [458.654, 457.296, 367.215, 248.375]",
                  "intrinsics: [114.6635, 114.324, 91.80375, 62.09375]")
    c = c.replace("resolution: [752, 480]", "resolution: [188, 120]")
    open(os.path.join(d, "kalibr_imucam_chain.yaml"), "w").write(c)
    p = os.path.join(dst, "configs", "euroc_v101_mono.json")
    cfg = json.load(open(p))
    cfg["tracker"]["pyramid_levels"] = 2
    cfg["start_s"] = 18.0
    json.dump(cfg, open(p, "w"), indent=1)
    return str(dst)


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    """(bench dir, driver, config, traffic) of the small cell."""
    bench = small_bench(tmp_path_factory.mktemp("euroc") / "port_bench")
    _, config, mix = harness.cell_files(CELL, bench)
    drv = harness.cell_driver(config, mix, bench)
    traffic = drv.make_traffic(config, dict(mix, warmup_s=WARMUP_S), SEED, 1.0, bench, frames=FRAMES)
    return bench, drv, config, traffic


def program(small, dtype=None):
    """The program's outputs over the small cell's frames, fed as fast as
    they go."""
    bench, drv, config, traffic = small
    est = drv.Estimator(harness.program_package(drv.MODULES), config, traffic, bench, "cpu", dtype=dtype)
    n = traffic.n_warmup + traffic.n_window
    harness.run_events(est, traffic.stream.events, n)
    return est.outputs(n)


@pytest.fixture(scope="module")
def base(small):
    return program(small)


def judged(small, out):
    bench, drv, config, traffic = small
    return drv.judge(config, traffic, out, bench)


def test_the_program_matches_the_references_at_a_small_size(small, base):
    """Every number within its limit, on a run that enters, updates,
    re-anchors and drops landmarks and moves the calibration."""
    checks = judged(small, base)
    assert set(checks) == set(small[2]["limits"])
    assert check.passed(checks), checks
    assert checks["pose_gap_m"][0] < 1e-9 and checks["final_gap_rel"][0] < 1e-9
    S = (base.rows.shape[1] - check_klt.WIDTH) // 6
    lms = [check_klt.program_landmarks(r, S) for r in base.rows]
    assert max(len(x) for x in lms) >= 2
    anchors = {}
    for x in lms:
        for fid, (_, t) in x.items():
            anchors.setdefault(fid, set()).add(t)
    assert any(len(a) > 1 for a in anchors.values())  # a landmark changed its anchor
    assert abs(base.rows[-1, 16]) > 0 and np.any(base.rows[-1, 24:32] != base.rows[0, 24:32])
    assert all(len(ids) for ids, _ in base.emitted)


def _lk_fault(kind):
    """A wrapper of the tracker's LK that plants `kind`."""
    from uvio_tpu_torch.frontend import tracker

    lk_track, calls = tracker.lk_track, [0]

    def planted(*a, **k):
        uv, ok = lk_track(*a, **k)
        calls[0] += 1
        if kind == "lk_float16":
            return uv.to(torch.float16).to(torch.float32), ok
        if calls[0] == 15:  # one kept track moved 0.1 px
            i = int(torch.nonzero(ok)[0, 0])
            uv = uv.clone()
            uv[i, 0] += 0.1
        return uv, ok

    return planted


def _slam_fault():
    """A wrapper of the fused step's SLAM update that skips the first one
    with observations."""
    from uvio_tpu_torch import pipeline

    slam_update, skipped = pipeline.slam_update, [False]

    def planted(state, *a, **k):
        new, info = slam_update(state, *a, **k)
        if not skipped[0] and bool(info["kept"].any()):
            skipped[0] = True
            return state, info
        return new, info

    return planted


@pytest.mark.parametrize("fault,fails", [
    ("lk_moved", ("lk_gap_px",)),
    ("lk_float16", ("lk_gap_px",)),
    ("slam_update_skipped", ("pose_gap_m", "state_gap", "final_gap_rel")),
])
def test_a_planted_fault_reads_incorrect(small, monkeypatch, fault, fails):
    from uvio_tpu_torch import pipeline
    from uvio_tpu_torch.frontend import tracker

    if fault == "slam_update_skipped":
        monkeypatch.setattr(pipeline, "slam_update", _slam_fault())
    else:
        monkeypatch.setattr(tracker, "lk_track", _lk_fault(fault))
    checks = judged(small, program(small))
    assert not check.passed(checks)
    for k in fails:
        v, lim = checks[k]
        assert v > lim, (k, v, lim)


def test_the_float32_control_fails_the_filter_numbers(small):
    """The program's float32 filter in its place fails every filter
    number, while the tracker's, which runs in float32 either way, pass."""
    bench, drv, config, traffic = small
    out = drv.control_outputs(harness.program_package(drv.MODULES), config, traffic, bench, "cpu",
                              traffic.n_warmup + traffic.n_window)
    checks = judged(small, out)
    for k in ("pose_gap_m", "rot_gap_rad", "state_gap", "final_gap_rel"):
        assert checks[k][0] > checks[k][1], (k, checks[k])
    for k in ("lk_gap_px", "lk_drop_mismatch", "ransac_flips", "detect_mismatch"):
        assert checks[k][0] <= checks[k][1], (k, checks[k])


INDEPENDENT = ["port_bench/reference/klt.py", "port_bench/reference/slam_vio.py", "port_bench/check_klt.py",
               "port_bench/traffic/euroc.py", "port_bench/rooflines.py"]


def test_the_references_load_nothing_of_the_program_or_jax():
    """Neither the new references, the check nor the traffic import the
    port, the JAX package or JAX, by their source and by what a process
    that runs them has loaded."""
    for path in INDEPENDENT:
        for node in ast.walk(ast.parse(open(os.path.join(ROOT, path)).read())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for name in names:
                assert name.split(".")[0] not in ("uvio_tpu_torch", "uvio_tpu", "jax", "jaxlib"), (path, name)
    code = ("import sys, numpy as np, torch\n"
            "from port_bench.reference import config, klt, slam_vio\n"
            "from port_bench import check_klt, rooflines\n"
            "from port_bench.traffic import euroc\n"
            "img = torch.zeros((1, 40, 40)); klt.fast_score(img, 20.0); klt.pyramid(img, 2)\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & {'uvio_tpu_torch', 'uvio_tpu', 'jax', 'jaxlib'}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120,
                         env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def _tracker(small):
    from uvio_tpu_torch.frontend.tracker import KLTTracker

    bench, drv, config, traffic = small
    from port_bench.reference import config as ref_config

    c = ref_config.load(os.path.join(bench, "configs", config["estimator"])).cameras[0]
    return KLTTracker(c.intrinsics, 0, num_features=30, grid=(3, 3), levels=2, device="cpu",
                      generator=torch.Generator().manual_seed(5))


def test_the_tracker_outputs_are_bitwise_with_tracing_on_and_off(small):
    """A tracker built with the switch on, fed under the profiler so its
    ranges open, emits exactly what one built with it off emits."""
    from torch.profiler import ProfilerActivity, profile

    from uvio_tpu_torch import tracing

    traffic = small[3]
    off = _tracker(small)
    tracing.enable(True)
    try:
        on = _tracker(small)
    finally:
        tracing.enable(False)
    assert on.tracing and not off.tracing
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for k in range(12):
            t, img = float(traffic.stream.cam_t[k]), traffic.images[k].astype(np.float32)
            a, b = off.feed(t, img), on.feed(t, img)
            assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1]), k
            assert np.array_equal(off.last_readback, on.last_readback)
    names = {e.name for e in prof.events()}
    assert {"uvio/track", "uvio/upload", "uvio/replay", "uvio/readback", "uvio/spawn"} <= names


def test_the_tracker_row_tiles_its_feed_and_counts_its_tracks(small):
    traffic = small[3]
    tr = _tracker(small)
    for k in range(12):
        before = int(tr.active.sum())
        ids, _ = tr.feed(float(traffic.stream.cam_t[k]), traffic.images[k].astype(np.float32))
        row = tr.last_timing
        parts = row["upload"] + row["replay"] + row["readback"] + row["spawn"]
        assert 0 < parts <= row["track"] < parts + 5e-3
        assert row["n_tracked"] + row["n_spawned"] == len(ids) == int(tr.active.sum())
        assert row["n_lk_lost"] + row["n_ransac_lost"] + row["n_tracked"] == before
        width = 3 if k == 0 else 4
        assert tr.last_readback.shape[1] == width


def test_the_manager_row_counts_its_landmarks(small, monkeypatch):
    """`slam_in_state` follows the landmarks in the state, and changes by
    what enters less what is marginalized."""
    bench, drv, config, traffic = small
    est = drv.Estimator(harness.program_package(drv.MODULES), config, traffic, bench, "cpu")
    rows = []
    record = est.record

    def recording(k):
        record(k)
        rows.append((dict(est.mgr.last_timing), int(est.mgr.state.slam_valid.sum())))

    monkeypatch.setattr(est, "record", recording)
    harness.run_events(est, traffic.stream.events, traffic.n_warmup + traffic.n_window)
    prev = 0
    for row, valid in rows:
        assert row["slam_in_state"] == valid
        assert valid == prev + row["slam_inited"] - row["slam_marginalized"]
        assert row["slam_updated"] <= prev
        prev = valid
    assert sum(r["slam_inited"] for r, _ in rows) > 0


RUN_COPY = """
import json, sys, time
import torch
from port_bench import harness
bench, seed, frames, warmup = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), float(sys.argv[4])
rows, reader = [], harness.reader

def reading(metric, bench_dir=harness.BENCH_DIR):
    read = reader(metric, bench_dir)

    def keep(run):
        rows[:] = run.frames
        return read(run)

    return keep

harness.reader = reading
r = harness.run_cell("euroc_v101.klt_live", seed, 1.0, False, "cpu", time.perf_counter(), bench_dir=bench,
                     root=sys.argv[5], frames=frames, warmup_s=warmup)
run = harness.Run(frames=rows, setup_s=1.0, captures=0, trace=None)
r["layer"] = {m: reader(m, bench)(run) for m in ("track_ms", "track_host_ms", "estimator_ms")}
r["row_keys"] = sorted(set.intersection(*[set(f) for f in rows]))
print(json.dumps(r))
"""


def test_the_cell_runs_through_the_harness_from_a_copy(tmp_path):
    """The driver keeps the harness's contract: the cell runs through
    `run_cell` from a copy of the benchmark (in a process of its own, as
    the benchmark runs, which holds no module of JAX), `correct`, each
    window row holding every stage, the cell's per-layer readers reading
    it, and every file of the copy left as it was."""
    bench = small_bench(tmp_path / "port_bench")
    before = {p: open(p, "rb").read() for p in map(str, (tmp_path / "port_bench").rglob("*")) if os.path.isfile(p)}
    drv = harness.driver("klt_vio", bench)
    for name in ("MODULES", "MIX_KEYS", "STAGES", "make_traffic", "Estimator", "judge", "control_outputs"):
        assert hasattr(drv, name), name
    out = subprocess.run([sys.executable, "-c", RUN_COPY, bench, str(SEED), str(FRAMES), str(WARMUP_S), ROOT],
                         cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"] and r["attempted"] == FRAMES and r["failed"] == 0, r["checks"]
    assert set(r["metrics"]) == {"setup_s", "pose_latency_p50_ms", "pose_latency_p95_ms"}
    assert {k for k, _ in drv.STAGES} <= set(r["row_keys"])
    assert all(v is not None and v > 0 for v in r["layer"].values()), r["layer"]
    assert {p: open(p, "rb").read() for p in before} == before


def test_a_program_without_the_tracker_row_fails_at_set_up(small):
    """A port whose tracker keeps no timing row (the parent's) stops the
    run when its estimator is built, before any frame."""
    from uvio_tpu_torch.frontend import tracker

    bench, drv, config, traffic = small
    pkg = harness.program_package(drv.MODULES)

    class Bare(tracker.KLTTracker):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            del self.last_timing

    real = tracker.KLTTracker
    tracker.KLTTracker = Bare
    try:
        with pytest.raises(RuntimeError, match="last_timing"):
            drv.Estimator(pkg, config, traffic, bench, "cpu")
    finally:
        tracker.KLTTracker = real


def test_the_traffic_is_a_function_of_its_seed(small):
    bench, drv, config, traffic = small
    mix = {"warmup_s": WARMUP_S}
    again = drv.make_traffic(config, mix, SEED, 1.0, bench, frames=FRAMES)
    other = drv.make_traffic(config, mix, SEED + 1, 1.0, bench, frames=FRAMES)
    assert traffic.images.dtype == np.uint8 and traffic.images.shape[1:] == (120, 188)
    assert len(traffic.images) == traffic.n_warmup + traffic.n_window + 1
    assert np.array_equal(again.images, traffic.images) and np.array_equal(again.stream.imu_a, traffic.stream.imu_a)
    assert not np.array_equal(other.images, traffic.images)
    assert {k for k, _ in traffic.stream.events} == {"imu", "cam"}


@pytest.mark.parametrize("kernel", ["fast9", "lk_track"])
def test_the_kernels_work_matches_the_kernel_table(kernel):
    """The counts behind PERF.md's kernel table: FAST-9 moves 2,887,680 B
    at 752x480 and its bound is 0.000862 ms; LK over 150 features on 4
    levels is 15,795,000 operations and 0.000236 ms."""
    if kernel == "fast9":
        assert rooflines.fast9_bytes(480, 752) == 2_887_680
        assert rooflines.fast9_flops(480, 752, 33_182) == 12 * 480 * 752 + 96 * 33_182
        assert rooflines.bound_ms(rooflines.fast9_flops(480, 752, 33_182), rooflines.fast9_bytes(480, 752)) == \
            pytest.approx(0.000862, abs=5e-7)
        assert rooflines.roofline_pct(0.003812, nbytes=2_887_680) == pytest.approx(22.6, abs=0.1)
    else:
        assert rooflines.lk_track_flops(150) == 15_795_000
        assert rooflines.bound_ms(rooflines.lk_track_flops(150)) == pytest.approx(0.000236, abs=5e-7)
        assert rooflines.lk_track_flops(150, levels=1) == 150 * 225 * (19 + 14 * 10)


def test_the_tracker_reference_agrees_with_itself_across_batches(small):
    """The reference's FAST-9 scores and grid picks of a batch of frames
    are those of each frame alone, and its pretest keeps every corner."""
    from port_bench.reference import klt

    traffic = small[3]
    eq = torch.stack([klt.equalize(torch.as_tensor(traffic.images[k], dtype=torch.float32)) for k in range(4)])
    batch = klt.fast_score(eq, 20.0)
    for k in range(4):
        assert torch.equal(batch[k], klt.fast_score(eq[k:k + 1], 20.0)[0])
    # the score without the pretest: every ring pixel read everywhere
    img = eq[0]
    H, W = img.shape
    c = img[3:H - 3, 3:W - 3]
    d = torch.stack([img[3 + dy:H - 3 + dy, 3 + dx:W - 3 + dx] - c for dy, dx in klt.CIRCLE])
    corner = torch.zeros_like(c, dtype=torch.bool)
    for side in (d > 20.0, d < -20.0):
        for s in range(16):
            corner |= torch.stack([side[(s + i) % 16] for i in range(9)]).all(0)
    full = torch.where(corner, (d.abs() - 20.0).clamp(min=0).sum(0), torch.zeros_like(c))
    assert torch.equal(batch[0][3:H - 3, 3:W - 3], full)
    # the ring in order around the circle: each pixel beside the next
    ring = klt.CIRCLE + klt.CIRCLE[:1]
    assert len(klt.CIRCLE) == 16 and all(max(abs(a[0] - b[0]), abs(a[1] - b[1])) == 1 for a, b in zip(ring, ring[1:]))


def test_the_traffic_renders_the_sweeping_occluder(small):
    """Every frame holds `render_image_hard`'s occluder: one flat grey
    rectangle a fifth of the width, over the middle half of the height,
    with its six bright pseudo-corners, sweeping with time."""
    from port_bench.traffic import euroc

    traffic = small[3]
    H, W = traffic.images.shape[1:]
    starts = set()
    for k in (0, 7, 19):
        dt = float(traffic.stream.cam_t[k]) - traffic.stream.t_begin
        mask = np.zeros((H, W), np.float32)
        euroc.occlude(mask, dt)
        flat, corner = mask == euroc.OCCLUDER_LEVEL, mask == euroc.OCCLUDER_CORNER_LEVEL
        assert flat.sum() + corner.sum() == (H - 2 * (H // 4)) * int(np.count_nonzero(mask.any(0)))
        assert 0 < corner.sum() <= 6 * 9
        img = traffic.images[k]
        assert len(np.unique(img[flat])) == 1 and img[corner].min() > img[flat][0]
        starts.add(int(np.flatnonzero(mask.any(0))[0]))
    assert len(starts) == 3


@pytest.mark.parametrize("case", range(6))
def test_ransac_judges_the_hypothesis_the_program_keeps(case):
    """`check_klt.program_picks` names exactly the hypotheses that can be
    the first with the most inliers, over every way the undecided tracks
    can fall; with none undecided, the first best alone."""
    import itertools

    rng = np.random.default_rng(case)
    K = 5
    lo = rng.integers(3, 7, K)
    hi = lo + (rng.integers(0, 2, K) if case else 0)
    picks = set()
    for counts in itertools.product(*[range(a, b + 1) for a, b in zip(lo, hi)]):
        picks.add(int(np.argmax(counts)))
    assert set(check_klt.program_picks(lo, hi).tolist()) == picks
    if not case:
        assert check_klt.program_picks(lo, hi).tolist() == [int(np.argmax(lo))]
