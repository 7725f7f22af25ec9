"""What the benchmark may import, and that it measures only a card."""

import ast
import os
import subprocess
import sys

from port_bench import harness

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
FORBIDDEN = {"jax", "jaxlib", "flax", "uvio_tpu"}


def imported_top_names(path):
    """Top-level names (before the first dot) of the absolute imports in
    a source file."""
    tree = ast.parse(open(path).read())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module.split(".")[0])
    return out


def sources(sub=""):
    for d, _, files in os.walk(os.path.join(BENCH, sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_module_imports_jax_or_the_jax_package():
    for path in sources():
        bad = imported_top_names(path) & FORBIDDEN
        assert not bad, f"{path} imports {bad}"


def test_top_level_names_compare_whole():
    assert "uvio_tpu_torch" not in FORBIDDEN
    saved = dict(sys.modules)
    try:
        sys.modules["uvio_tpu_torch_fake"] = sys
        assert harness.forbidden_modules() == []
        sys.modules["uvio_tpu.fake"] = sys
        assert harness.forbidden_modules() == ["uvio_tpu"]
    finally:
        sys.modules.clear()
        sys.modules.update(saved)


def test_reference_imports_nothing_of_the_program():
    for path in sources("reference"):
        names = imported_top_names(path)
        assert "uvio_tpu_torch" not in names and not names & FORBIDDEN, path
    code = ("import sys; sys.path.insert(0, %r); import port_bench.reference.uvio, port_bench.traffic.generate; "
            "bad = sorted({m.split('.')[0] for m in sys.modules} & {'uvio_tpu_torch', 'uvio_tpu', 'jax'}); "
            "print(bad); sys.exit(1 if bad else 0)" % ROOT)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr


def imported_modules(path):
    """Every module a source file imports, anywhere in it, relative ones
    resolved inside `port_bench`."""
    out = set()
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.Import):
            out |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            base = node.module or ""
            if node.level:
                base = "port_bench" + ("." + base if base else "")
            out |= {base} | {f"{base}.{a.name}" for a in node.names}
    return out


SYSTEM_MODULES = ("port_bench.drivers", "port_bench.traffic", "port_bench.reference")


def test_the_harness_names_no_system():
    """`harness.py` and `readings.py` reach a system's traffic, estimator,
    timings and judge only through its driver: they import no driver,
    traffic or reference module, read no manager, and importing them
    loads none of those."""
    for name in ("harness.py", "readings.py"):
        path = os.path.join(BENCH, name)
        assert not [m for m in imported_modules(path) if m.startswith(SYSTEM_MODULES)], name
        assert ".mgr" not in open(path).read(), name
    code = ("import sys; sys.path.insert(0, %r); import port_bench.harness, port_bench.readings; "
            "print(sorted(m for m in sys.modules if m.startswith(%r)))" % (ROOT, SYSTEM_MODULES))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert r.returncode == 0 and r.stdout.strip() == "[]", r.stdout + r.stderr


def test_no_card_no_result(monkeypatch):
    """Without a CUDA device the run fails and prints no result: no CPU
    fall-back."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sys.path.insert(0, BENCH)
    import run

    assert run.main(["--workload", "uwb_corridor.live", "--seed", "1", "--seconds", "1"]) != 0
    r = subprocess.run([sys.executable, "-c", "import torch, runpy, sys; torch.cuda.is_available = lambda: False; "
                        f"sys.argv = ['run.py', '--workload', 'uwb_corridor.live', '--seed', '1', '--seconds', '1']; "
                        f"runpy.run_path({os.path.join(BENCH, 'run.py')!r}, run_name='__main__')"],
                       capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert r.returncode != 0 and r.stdout.strip() == ""


def test_without_the_program_the_run_fails(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark,
    the program cannot be imported and the run fails."""
    import shutil

    shutil.copytree(BENCH, tmp_path / "port_bench", ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    code = ("import sys; sys.path.insert(0, %r); from port_bench import harness; harness.program_package()"
            % str(tmp_path))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert r.returncode != 0 and "uvio_tpu_torch" in r.stderr
