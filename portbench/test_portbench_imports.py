"""Nothing the benchmark runs loads JAX or the JAX package ``repro``:
module names compared whole, by their part before the first dot."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import harness

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


@pytest.mark.parametrize("name,caught", [
    ("repro_torch", []), ("repro_torch.solvers.krylov", []), ("reprox", []),
    ("repro", ["repro"]), ("repro.solvers", ["repro"]), ("jax", ["jax"]),
    ("jax.numpy", ["jax"]), ("jaxlib.xla_client", ["jaxlib"]),
    ("flax.linen", ["flax"]), ("jax_tpu_extra", []),
])
def test_forbidden_by_whole_top_level_name(monkeypatch, name, caught):
    clean = {k: v for k, v in sys.modules.items()
             if k.split(".")[0] not in harness.FORBIDDEN}
    monkeypatch.setattr(sys, "modules", {**clean, name: object()})
    assert harness.forbidden_modules() == caught


def test_no_source_of_the_benchmark_imports_jax_or_repro():
    for path in BENCH.rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] not in harness.FORBIDDEN, (path, n)


def test_a_run_loads_neither(tmp_path):
    # a fresh interpreter, as run.py is, driving a small cell on the CPU
    code = (
        "import json, sys\n"
        "from portbench import harness\n"
        "harness.run_cell('p3d256-bjcg-f32', 5, 0.1, False, device='cpu',"
        " executor='torch', overrides={'config': {'problem': {'params':"
        " {'n_side': 6}}, 'sizes': None}})\n"
        "print(json.dumps(harness.forbidden_modules()))\n")
    env = {**os.environ, "PYTHONPATH": f"{ROOT / 'src'}{os.pathsep}{ROOT}"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=tmp_path, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_without_a_card_no_result(tmp_path):
    out = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload", "p3d256-bjcg-f32",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=tmp_path, timeout=300,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    if out.returncode == 0:
        pytest.skip("a CUDA card is present")
    assert out.stdout == ""


def test_bare_benchmark_directory_gives_no_result(tmp_path):
    # only BENCHMARK.json and the files under paths: the program is missing
    import shutil
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "p3d256-bjcg-f32",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=tmp_path, timeout=300,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert out.returncode != 0
    assert out.stdout == ""
