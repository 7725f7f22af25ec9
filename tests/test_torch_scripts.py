"""The port's example scripts `examples/profile_step_torch.py` and
`examples/scaling_torch.py` (twins of `examples/profile_step.py` and
`examples/scaling.py`), run on the CPU at tiny sizes: exit code 0, the
lines and JSON keys of the JAX scripts, and (read from their source)
no import of JAX or of `uvio_tpu`."""

import ast
import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TWINS = ("examples/profile_step_torch.py", "examples/scaling_torch.py")


def _run(script, *args, timeout=300):
    # two threads a script: the test workers share the host's cores
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="2")
    out = subprocess.run([sys.executable, os.path.join(ROOT, script), *args], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=timeout)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


@pytest.mark.parametrize("script", TWINS)
def test_twin_imports_neither_jax_nor_uvio_tpu(script):
    with open(os.path.join(ROOT, script)) as f:
        tree = ast.parse(f.read())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    names += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module]
    assert names and not [m for m in names if m.split(".")[0] in ("jax", "jaxlib", "uvio_tpu")]


def test_profile_step_twin_on_cpu():
    out = _run(TWINS[0], "--cpu", "--iters", "2", "--chunk", "3", "--chunk-iters", "1")
    lines = out.strip().splitlines()
    for label in ("marginalize", "propagate+clone", "msckf update", "fused step", "chunk/frame"):
        assert any(line.startswith(label) for line in lines), label
    res = json.loads(lines[-1])
    assert res["platform"] == "cpu" and res["chunk_frames"] == 3
    assert set(res["stages"]) == {"marginalize", "propagate_clone", "msckf_update", "fused_step", "chunk"}
    assert all(r["host_ms"] > 0 and r["event_ms"] is None for r in res["stages"].values())


@pytest.mark.parametrize("nproc", [1, 2])
def test_scaling_twin_on_cpu(nproc, tmp_path):
    table = tmp_path / "scaling.json"
    out = _run(TWINS[1], "--cpu", "--nproc", str(nproc), "--batches", "2", "--frames", "2", "--reps", "1",
               "--ba-reps", "1", "--write", str(table))
    res = json.loads(out.strip().splitlines()[-1])
    assert json.loads(table.read_text()) == res
    # the keys of examples/scaling.py's table
    assert res["platform"] == "cpu" and res["nproc"] == nproc
    assert res["filter_dp_seq_frames_per_s"]["2"] > 0 and res["ba_strong_solve_s"][str(nproc)] > 0
    assert res["filter_dp"]["2"]["ms_per_step"] > 0


def test_scaling_twin_multiproc_demo():
    out = _run(TWINS[1], "--cpu", "--multiproc")
    assert "[multiproc] mesh {'kf': 2, 'lm': 1} procs=2" in out and "OK" in out
    assert "multiproc demo: 2 processes OK" in out
