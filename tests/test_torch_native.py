"""The port's native host code (`uvio_tpu_torch/native`, built with g++ at
first use): `select_imu_readings` bit for bit against the numpy
specification `select_imu_readings_spec`, the two error codes
included, and `load_csv` exactly against `numpy.loadtxt` on the vendored
streams (every value is parsed from the same decimal text, so both round
it the same way) and on `uvio_tpu`'s own case (`tests/test_aux.py`)."""

import gzip
import os

import numpy as np
import pytest

from uvio_tpu_torch import native
from uvio_tpu_torch.filter.propagator import select_imu_readings_np, select_imu_readings_spec

STREAMS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data", "streams")


@pytest.fixture(scope="module")
def lib():
    lib = native.get_lib()
    assert lib is not None, "g++ is on this machine: the native library must build"
    return lib


def _imu(seed, n=400, hz=200.0):
    rng = np.random.default_rng(seed)
    t = 100.0 + np.cumsum(rng.uniform(0.5, 1.5, n) / hz)
    return t, rng.standard_normal((n, 3)), rng.standard_normal((n, 3)) + [0, 0, 9.81]


def test_select_imu_readings_bitwise(lib):
    """Windows inside the stream, on sample times, between them, and off
    either end (extrapolated from the first or last pair), with short and
    long padding."""
    for seed in range(4):
        times, ws, accs = _imu(seed)
        rng = np.random.default_rng(100 + seed)
        cases = [(times[10], times[30], 32), (times[0] - 0.01, times[5], 16),
                 (times[-5], times[-1] + 0.02, 16), (times[7] + 1e-7, times[9] - 1e-7, 4)]
        for _ in range(40):
            t0 = rng.uniform(times[0], times[-1] - 0.2)
            cases.append((t0, t0 + rng.uniform(1e-4, 0.2), 64))
        for t0, t1, m in cases:
            got = native.select_imu_readings(times, ws, accs, t0, t1, m)
            ref = select_imu_readings_spec(times, ws, accs, t0, t1, m)
            for a, b in zip(got, ref):
                assert a.shape == b.shape
                np.testing.assert_array_equal(a, b)
            for a, b in zip(select_imu_readings_np(times, ws, accs, t0, t1, m), ref):
                np.testing.assert_array_equal(a, b)  # the dispatcher takes the native copy


@pytest.mark.parametrize("code", [-1, -2])
def test_select_imu_readings_errors(lib, code):
    times, ws, accs = _imu(7)
    t0, t1, m = (times[20], times[20], 16) if code == -1 else (times[20], times[60], 16)
    for fn in (native.select_imu_readings, select_imu_readings_spec):
        with pytest.raises(ValueError, match="backwards" if code == -1 else "max_imu_batch=16"):
            fn(times, ws, accs, t0, t1, m)


def test_select_imu_readings_checks_shapes(lib):
    """Arrays that disagree in length never reach the native code, which
    would read past the shorter one."""
    times, ws, accs = _imu(8)
    for w, a in ((ws[:-1], accs), (ws, accs[:, :2])):
        with pytest.raises(ValueError, match="want"):
            native.select_imu_readings(times, w, a, times[10], times[20], 16)


@pytest.mark.parametrize("name", ["uwb/imu.csv.gz", "mono/gt.txt", "uwb/uwb.csv.gz"])
def test_load_csv_matches_loadtxt(lib, tmp_path, name):
    path = os.path.join(STREAMS, name)
    if name.endswith(".gz"):
        plain = tmp_path / os.path.basename(name)[:-3]
        with gzip.open(path, "rt") as f:
            plain.write_text("#timestamp and columns\n" + f.read())
        path = str(plain)
    delim = "," if name.endswith(".csv.gz") else None
    ref = np.loadtxt(path, delimiter=delim, comments="#", ndmin=2)
    got = native.load_csv(path)
    assert got.shape == ref.shape and got.shape[0] > 400
    np.testing.assert_array_equal(got, ref)


def test_load_csv_reference_case(lib, tmp_path):
    p = tmp_path / "data.csv"
    p.write_text(
        "#timestamp [ns],w_x,w_y,w_z\n"
        "1403636579758555392,0.1,-0.2,0.3\n"
        "1403636579763555584, 0.4, 0.5, -0.6\n"
        "\n"
        "1403636579768555776,0.7,0.8,0.9\n"
    )
    arr = native.load_csv(str(p))
    assert arr.shape == (3, 4)
    np.testing.assert_allclose(arr[1, 1:], [0.4, 0.5, -0.6])
    p2 = tmp_path / "gt.txt"
    p2.write_text("# ts x y z\n1.5 0.1 0.2 0.3\n2.5 0.4 0.5 0.6\n")
    np.testing.assert_array_equal(native.load_csv(str(p2)), [[1.5, 0.1, 0.2, 0.3], [2.5, 0.4, 0.5, 0.6]])
    p3 = tmp_path / "ragged.csv"
    p3.write_text("1,2,3\n4,5\n")
    with pytest.raises(ValueError, match="ragged"):
        native.load_csv(str(p3))
    with pytest.raises(FileNotFoundError):
        native.load_csv(str(tmp_path / "missing.csv"))
