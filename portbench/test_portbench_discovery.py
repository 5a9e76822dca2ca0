"""A cell, a configuration, a traffic mix and a per-layer metric added as new
files and new ``BENCHMARK.json`` entries only, in a copy of the benchmark:
the harness finds and runs them, and no file that was there changes."""

import hashlib
import json
import shutil
from pathlib import Path

from portbench import harness, spec

BENCH = Path(__file__).resolve().parent

NEW_CONFIG = {
    "name": "poisson3d-small-jcg",
    "source": "a small stencil for this test",
    "problem": {"generator": "poisson3d_7pt", "params": {"n_side": 9}},
    "sizes": {"rows": 729, "nonzeros": 7 * 729 - 6 * 81},
    "program": {
        "executor": "torch",
        "format": {"fn": "repro_torch.sparse.ell_from_csr_host", "kwargs": {}},
        "preconditioner": {"kind": "jacobi", "opts": {}},
        "solver": {"class": "repro_torch.solvers.CgSolver", "opts": {}},
        "stop": {"max_iters": 500, "reduction_factor": 1e-6},
    },
    "reference": {"operator": "csr", "preconditioner": "jacobi", "solver": "cg"},
    "reduced": [],
}
NEW_TRAFFIC = {"kind": "closed_loop_solves", "dtype": "float64", "rhs": "normal",
               "pool": 4, "check_solves": 2, "profile_min_s": 0.05}
NEW_LIMITS = {"numbers": {"unconverged": {"limit": 0}, "resid_gap": {"limit": 1e-6}}}
NEW_METRIC = '''"""``mean_solve_rows``: rows a window's solve handles (a test metric)."""


def read(ctx):
    return float(ctx["problem"]["n"])
'''


def _digests(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_new_files_and_entries_are_enough(tmp_path):
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digests(tmp_path / "portbench")

    pb = tmp_path / "portbench"
    (pb / "configs" / "poisson3d-small-jcg.json").write_text(json.dumps(NEW_CONFIG))
    (pb / "traffic" / "solves-f64-small.json").write_text(json.dumps(NEW_TRAFFIC))
    (pb / "limits" / "p3d9-jcg-f64.json").write_text(json.dumps(NEW_LIMITS))
    (pb / "metrics" / "mean_solve_rows.py").write_text(NEW_METRIC)
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "poisson3d-small-jcg", "source": "a test",
                             "file": "portbench/configs/poisson3d-small-jcg.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "p3d9-jcg-f64", "config": "poisson3d-small-jcg",
                               "traffic": "solves-f64-small", "chips": 1,
                               "why": "a test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] in ("solve_s", "iterations"):
            m["workloads"].append("p3d9-jcg-f64")
    bench["per_layer"].append({"name": "mean_solve_rows", "unit": "rows",
                               "better": "higher", "source": "program_counter",
                               "layer": "solver loop", "moves": "solve_s",
                               "workloads": ["p3d9-jcg-f64"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    assert spec.validate(bench, tmp_path) == []

    res = harness.run_cell("p3d9-jcg-f64", 7, 0.1, True, root=tmp_path,
                           device="cpu")["result"]
    assert res["correct"] is True
    assert res["metrics"]["mean_solve_rows"] == {"value": 729.0, "unit": "rows"}
    assert set(res["metrics"]) == {"mean_solve_rows", "iterations"}
    assert set(res["checks"]) == {"unconverged", "resid_gap"}
    # the cells that were there do not report the new metric
    old = harness.run_cell("p3d256-bjcg-f64", 7, 0.1, True, root=tmp_path,
                           device="cpu", executor="torch",
                           overrides={"config": {"problem": {"params": {"n_side": 6}},
                                                 "sizes": None}})["result"]
    assert "mean_solve_rows" not in old["metrics"]

    after = _digests(pb)
    assert {k: v for k, v in after.items() if k in before} == before
