"""Port parity, the evaluation toolkit: `uvio_tpu_torch.eval` against
`uvio_tpu.eval` on seeded random trajectories (metrics to 1e-9), the
recorder / simulation report / timing tools on the same files, and each
of the 12 CLI subcommands printing what `uvio_tpu.eval.cli` prints."""

import numpy as np
import pytest

import uvio_tpu.eval as JE
import uvio_tpu.eval.cli as JCLI
import uvio_tpu.eval.proc_monitor as JPM

import uvio_tpu_torch.eval as TE
import uvio_tpu_torch.eval.cli as TCLI
import uvio_tpu_torch.eval.proc_monitor as TPM
from uvio_tpu_torch.eval import traj as TT
from uvio_tpu.eval import traj as JT

TOL = dict(rtol=0, atol=1e-9)


def _trajectory(seed, n=120, noise=0.03, yaw=0.4, scale=1.0):
    """(t, q_est, p_est, q_gt, p_gt): a gt helix with turning attitude and
    an estimate of it that is rotated about z, shifted, scaled and noisy."""
    from scipy.spatial.transform import Rotation as R

    rng = np.random.default_rng(seed)
    t = np.arange(n) * 0.1
    p_gt = np.stack([3 * np.cos(0.3 * t), 3 * np.sin(0.3 * t), 0.2 * t], 1)
    r_gt = R.from_euler("zyx", np.stack([0.3 * t, 0.2 * np.sin(t), 0.1 * np.cos(t)], 1))
    q_gt = r_gt.as_quat()
    Rz = R.from_euler("z", yaw)
    p_est = scale * Rz.apply(p_gt) + np.array([0.5, -0.3, 0.2]) + rng.normal(0, noise, (n, 3))
    r_est = R.from_rotvec(rng.normal(0, 0.02, (n, 3))) * r_gt * Rz.inv()
    return t, r_est.as_quat(), p_est, q_gt, p_gt


def _assert_same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_allclose(b[k], a[k], err_msg=str(k), **TOL)


def test_exports_match():
    assert sorted(TE.__all__) == sorted(JE.__all__)
    for name in JE.__all__:
        assert callable(getattr(TE, name))


@pytest.mark.parametrize("method", ["se3", "sim3", "posyaw", "none"])
@pytest.mark.parametrize("metric", ["ate", "ate_2d"])
def test_ate_matches(method, metric):
    t, q_e, p_e, q_g, p_g = _trajectory(1, scale=1.1 if method == "sim3" else 1.0)
    t_e = t[5:] + 2e-4  # offset stamps: the intersection pairs them within 1e-3
    a = getattr(JT, metric)(t_e, q_e[5:], p_e[5:], t, q_g, p_g, method=method)
    b = getattr(TT, metric)(t_e, q_e[5:], p_e[5:], t, q_g, p_g, method=method)
    _assert_same(a, b)
    assert b["n"] == len(t) - 5
    if method != "none":
        assert b["rmse_pos"] < 0.2


@pytest.mark.parametrize("method", ["se3", "sim3", "posyaw", "none"])
def test_umeyama_matches(method):
    _, _, p_e, _, p_g = _trajectory(2, scale=0.9)
    (s1, R1, t1), (s2, R2, t2) = JT.umeyama_align(p_e, p_g, method), TT.umeyama_align(p_e, p_g, method)
    np.testing.assert_allclose(s2, s1, **TOL)
    np.testing.assert_allclose(R2, R1, **TOL)
    np.testing.assert_allclose(t2, t1, **TOL)
    if method == "posyaw":
        np.testing.assert_allclose(R2[2], [0, 0, 1], atol=1e-12)
        assert abs(np.arctan2(R2[1, 0], R2[0, 0]) + 0.4) < 0.02  # undoes the 0.4 rad yaw


def test_rpe_matches():
    t, q_e, p_e, q_g, p_g = _trajectory(3, n=400, noise=0.01, yaw=0.0)
    a = JT.rpe(t, q_e, p_e, t, q_g, p_g, segment_lengths=(2, 4, 8, 1000))
    b = TT.rpe(t, q_e, p_e, t, q_g, p_g, segment_lengths=(2, 4, 8, 1000))
    assert list(a) == list(b) == [2, 4, 8]
    for L in a:
        _assert_same(a[L], b[L])


def test_nees_matches():
    t, q_e, p_e, q_g, p_g = _trajectory(4, yaw=0.0, noise=0.05)
    rng = np.random.default_rng(4)
    A = rng.normal(size=(len(t), 3, 3))
    cov_o = 0.02**2 * (np.eye(3) + 0.1 * A @ A.transpose(0, 2, 1))
    cov_p = 0.05**2 * (np.eye(3) + 0.1 * A @ A.transpose(0, 2, 1))
    p_e = p_e - np.array([0.5, -0.3, 0.2])
    (o1, p1), (o2, p2) = JT.nees(q_e, p_e, cov_o, cov_p, q_g, p_g), TT.nees(q_e, p_e, cov_o, cov_p, q_g, p_g)
    np.testing.assert_allclose(o2, o1, rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(p2, p1, rtol=1e-9, atol=1e-9)
    assert 0.5 < np.median(o2) < 10 and 0.5 < np.median(p2) < 10


def test_intersect_matches():
    rng = np.random.default_rng(5)
    t_gt = np.sort(rng.uniform(0, 10, 300))
    t_est = np.concatenate([t_gt[::3] + rng.uniform(-9e-4, 9e-4, 100), rng.uniform(0, 10, 20)])
    t_est.sort()
    for tol in (1e-3, 1e-4):
        (a1, a2), (b1, b2) = JT.intersect(t_est, t_gt, tol), TT.intersect(t_est, t_gt, tol)
        np.testing.assert_array_equal(b1, a1)
        np.testing.assert_array_equal(b2, a2)
    assert len(b1) > 5


def test_rot_and_log_match():
    rng = np.random.default_rng(6)
    q = rng.normal(size=(50, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    np.testing.assert_allclose(TT._rot(q), JT._rot(q), **TOL)
    np.testing.assert_allclose(TT._rot(q[0]), JT._rot(q[0]), **TOL)
    # the log map near the identity and at large angles
    import jax.numpy as jnp

    from uvio_tpu.math import exp_so3, log_so3

    w = np.concatenate([rng.normal(size=(20, 3)), 1e-7 * rng.normal(size=(5, 3)), np.zeros((1, 3))])
    Rm = np.array(exp_so3(jnp.asarray(w)))
    np.testing.assert_allclose(TT._log(Rm), np.asarray(log_so3(jnp.asarray(Rm))), **TOL)


def test_tum_round_trip(tmp_path):
    t, q_e, p_e, _, _ = _trajectory(7, n=30)
    a, b = tmp_path / "a.txt", tmp_path / "b.txt"
    JT.save_tum(a, t, q_e, p_e)
    TT.save_tum(b, t, q_e, p_e)
    assert a.read_text() == b.read_text()
    for x, y in zip(JT.load_tum(a), TT.load_tum(b)):
        np.testing.assert_array_equal(y, x)
    from uvio_tpu_torch.sim import load_tum_trajectory

    t2, q2, p2 = load_tum_trajectory(str(b))
    np.testing.assert_allclose(t2, t, atol=1e-9)
    np.testing.assert_allclose(p2, p_e, atol=1e-8)
    np.testing.assert_allclose(np.linalg.norm(q2, axis=1), 1.0, atol=1e-12)


def _make_run(E, outdir, n=200, seed=0):
    """A consistent estimator run written by package E's recorder
    (`tests/test_eval_tools.py::_make_run`)."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) * 0.1
    q_gt = np.tile([0.0, 0.0, 0.0, 1.0], (n, 1))
    p_gt = np.stack([np.cos(t * 0.3), np.sin(t * 0.3), 0.1 * t], 1)
    v_gt = np.gradient(p_gt, 0.1, axis=0)
    bg, ba = np.full((n, 3), 0.01), np.full((n, 3), -0.02)
    s_ori, s_pos = 0.01, 0.05
    q_est = q_gt.copy()
    q_est[:, :3] += 0.5 * rng.normal(0, s_ori, (n, 3))
    q_est /= np.linalg.norm(q_est, axis=1, keepdims=True)
    p_est = p_gt + rng.normal(0, s_pos, (n, 3))
    v_est = v_gt + rng.normal(0, s_pos, (n, 3))
    with E.StateRecorder(str(outdir)) as rec:
        for i in range(n):
            dt_i = 0.004 + 0.016 * np.exp(-i / 20.0)
            rec.write_est(t[i], q_est[i], p_est[i], v_est[i], bg[i], ba[i], [dt_i])
            rec.write_std(t[i], np.full(3, s_ori), np.full(3, s_pos), np.full(3, s_pos),
                          np.full(3, 1e-4), np.full(3, 1e-4), [1e-3])
            rec.write_gt(t[i], q_gt[i], p_gt[i], v_gt[i], bg[i], ba[i], [0.004])
    return t, q_est, p_est, q_gt, p_gt


def _make_timing(path, n=300, seed=1):
    rng = np.random.default_rng(seed)
    cols = dict(tracking=rng.uniform(2e-3, 4e-3, n), propagation=rng.uniform(1e-4, 3e-4, n),
                msckf=rng.uniform(1e-3, 2e-3, n), slam=rng.uniform(5e-4, 1e-3, n),
                marg=rng.uniform(1e-4, 2e-4, n))
    total = sum(cols.values())
    with open(path, "w") as f:
        f.write("# t," + ",".join(cols) + ",total\n")
        for i in range(n):
            f.write(",".join(f"{x:.9g}" for x in [i * 0.1] + [cols[k][i] for k in cols] + [total[i]]) + "\n")


def test_recorder_round_trip(tmp_path):
    """Both recorders write the same bytes; both loaders read them alike."""
    _make_run(JE, tmp_path / "j")
    _make_run(TE, tmp_path / "t")
    for name in ("state_est.txt", "state_std.txt", "state_gt.txt"):
        assert (tmp_path / "j" / name).read_text() == (tmp_path / "t" / name).read_text()
    for load_j, load_t, name in ((JE.load_state_file, TE.load_state_file, "state_est.txt"),
                                 (JE.load_std_file, TE.load_std_file, "state_std.txt")):
        a, b = load_j(tmp_path / "j" / name), load_t(tmp_path / "t" / name)
        assert len(a) == len(b) == 7
        for x, y in zip(a, b):
            np.testing.assert_array_equal(y, x)
    assert TE.load_state_file(tmp_path / "t" / "state_est.txt")[6].shape == (200, 1)
    rec = TE.StateRecorder(str(tmp_path / "nogt"), record_gt=False)
    rec.write_gt(0.0, *[np.zeros(k) for k in (4, 3, 3, 3, 3)])
    rec.close()
    assert not (tmp_path / "nogt" / "state_gt.txt").exists()


def test_error_simulation_matches(tmp_path):
    _make_run(TE, tmp_path)
    files = [tmp_path / n for n in ("state_est.txt", "state_std.txt", "state_gt.txt")]
    a, b = JE.error_simulation(*files), TE.error_simulation(*files)
    assert a.keys() == b.keys()
    for k in a:
        if k == "calib":
            assert len(a[k]) == len(b[k]) == 1
            for ca, cb in zip(a[k], b[k]):
                _assert_same(ca, cb)
        else:
            np.testing.assert_allclose(b[k], a[k], err_msg=k, **TOL)
    assert 2.0 < b["ori_nees"] < 4.5 and 2.0 < b["pos_nees"] < 4.5
    assert b["calib"][0]["converged"]
    assert JE.format_report(a) == TE.format_report(b)


def test_timing_tools_match(tmp_path):
    csv = tmp_path / "timing.csv"
    _make_timing(csv)
    for (na, a, da), (nb, b, db) in [(JE.load_timing_csv(csv), TE.load_timing_csv(csv))]:
        assert na == nb
        np.testing.assert_array_equal(b, a)
        np.testing.assert_array_equal(db, da)
    assert TE.timing_histogram(str(csv)) == JE.timing_histogram(str(csv))
    assert TE.timing_histogram(str(csv), column="msckf", bins=7) == JE.timing_histogram(str(csv), column="msckf", bins=7)
    assert TE.timing_percentages(str(csv)) == JE.timing_percentages(str(csv))
    assert TE.timing_flamegraph(str(csv)) == JE.timing_flamegraph(str(csv))
    assert TE.timing_comparison([str(csv), str(csv)]) == JE.timing_comparison([str(csv), str(csv)])
    with pytest.raises(ValueError):
        TE.timing_histogram(str(csv), column="nope")


def test_proc_monitor(tmp_path):
    """The process recorder samples this process and reads its CSV back
    as `uvio_tpu`'s does."""
    pytest.importorskip("psutil")
    import os

    out = tmp_path / "mon.csv"
    n = TPM.monitor(os.getpid(), str(out), hz=50.0, duration=0.1)
    assert n >= 2
    a, b = JPM.load_monitor_csv(str(out)), TPM.load_monitor_csv(str(out))
    assert list(a) == list(b) == [os.getpid()]
    for x, y in zip(a[os.getpid()], b[os.getpid()]):
        np.testing.assert_array_equal(y, x)
    assert b[os.getpid()][2].min() > 1.0  # resident MB
    with pytest.raises(ValueError):
        TPM.monitor("no-such-process-name-xyz", str(out), duration=0.01)


@pytest.fixture(scope="module")
def cli_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    t, q_est, p_est, q_gt, p_gt = _make_run(TE, d)
    TE.save_tum(d / "est.txt", t, q_est, p_est)
    rng = np.random.default_rng(9)
    TE.save_tum(d / "est2.txt", t, q_est, p_est + rng.normal(0, 0.02, p_est.shape))
    TE.save_tum(d / "gt.txt", t, q_gt, p_gt)
    _make_timing(d / "timing.csv")
    _make_timing(d / "timing2.csv", seed=2)
    n = 50
    ns = (1.4e18 + np.arange(n) * 5e7).astype(np.int64)
    rows = [f"{ns[i]},{0.1 * i},{0.2 * i},{0.0},1.0,0.0,0.0,0.0" for i in range(n)]
    (d / "euroc.csv").write_text("#timestamp [ns],...\n" + "\n".join(rows) + "\n")
    return d


CLI_CASES = {
    "error_singlerun": ["error_singlerun", "posyaw", "{d}/est.txt", "{d}/gt.txt"],
    "error_dataset": ["error_dataset", "se3", "{d}/gt.txt", "{d}/est.txt", "{d}/est2.txt"],
    "error_comparison": ["error_comparison", "sim3", "{d}/gt.txt", "{d}/est.txt", "{d}/est2.txt"],
    "error_simulation": ["error_simulation", "{d}/state_est.txt", "{d}/state_std.txt", "{d}/state_gt.txt"],
    "timing_histogram": ["timing_histogram", "{d}/timing.csv", "msckf"],
    "timing_comparison": ["timing_comparison", "{d}/timing.csv", "{d}/timing2.csv"],
    "timing_percentages": ["timing_percentages", "{d}/timing.csv"],
    "timing_flamegraph": ["timing_flamegraph", "{d}/timing.csv"],
    "plot_trajectories": ["plot_trajectories", "se3", "{d}/gt.txt", "{d}/est.txt", "{d}/est2.txt"],
    "pose_to_file": ["pose_to_file", "{d}/state_est.txt", "{d}/{pkg}_tum.txt"],
    "format_converter": ["format_converter", "{d}/euroc.csv", "{d}/{pkg}_conv.txt"],
    "live_align_trajectory": ["live_align_trajectory", "none", "{d}/state_est.txt", "{d}/gt.txt", "--chunks", "4"],
}


@pytest.mark.parametrize("cmd", sorted(CLI_CASES))
def test_cli_subcommand_prints_the_same(cmd, cli_files, capsys):
    outs = {}
    for pkg, main in (("pkgj", JCLI.main), ("pkgt", TCLI.main)):
        argv = [a.format(d=cli_files, pkg=pkg) for a in CLI_CASES[cmd]]
        assert main(argv) == 0
        outs[pkg] = capsys.readouterr().out.replace(pkg, "pkg")
    assert outs["pkgt"] == outs["pkgj"]
    assert len(outs["pkgt"].strip().splitlines()) >= 1
    for name in ("tum.txt", "conv.txt"):  # the files written are the same too
        a, b = cli_files / f"pkgj_{name}", cli_files / f"pkgt_{name}"
        if cmd in ("pose_to_file", "format_converter") and a.exists():
            assert a.read_text() == b.read_text()


def test_cli_covers_the_twelve(tmp_path):
    assert len(CLI_CASES) == 12
    with pytest.raises(SystemExit):
        TCLI.main(["no_such_command"])
    empty = tmp_path / "empty.txt"
    empty.write_text("# nothing\n")
    with pytest.raises(ValueError, match="empty"):
        TCLI.main(["format_converter", str(empty), str(tmp_path / "out.txt")])
