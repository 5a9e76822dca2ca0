"""A cell, a configuration, a traffic mix, its limits, its CPU size and a
per-layer metric added as new files and appended ``BENCHMARK.json`` entries
only, in a copy of the benchmark: the spec check passes, the harness finds
and runs them, the new cell passes the result, fault and control checks
every cell passes, and no file that was there changes.  Breaking an
accepted entry in that copy fails the spec check."""

import copy
import hashlib
import json
import shutil
from pathlib import Path

import pytest

from portbench import harness, spec
from portbench.test_portbench_control import check_control
from portbench.test_portbench_faults import FAULTS, assert_caught, run_under
from portbench.test_portbench_result import check_traced, check_untraced
from portbench.test_portbench_spec import spec_breaches

BENCH = Path(__file__).resolve().parent
CELL = "p3d9-bjcg-f64"

NEW_CONFIG = {
    "name": "poisson3d-small-bjcg",
    "source": "a small stencil for this test",
    "problem": {"generator": "poisson3d_7pt", "params": {"n_side": 9}},
    "sizes": {"rows": 729, "nonzeros": 7 * 729 - 6 * 81},
    "program": {
        "executor": "torch",
        "format": {"fn": "repro_torch.sparse.ell_from_csr_host", "kwargs": {}},
        "preconditioner": {"kind": "block_jacobi",
                           "opts": {"block_size": 8, "adaptive": True, "tau": 0.01}},
        "solver": {"class": "repro_torch.solvers.CgSolver", "opts": {"fused": True}},
        "stop": {"max_iters": 500, "reduction_factor": 1e-6},
    },
    "reference": {"operator": "csr", "preconditioner": "block_jacobi", "solver": "cg"},
    "reduced": [],
}
NEW_TRAFFIC = {"kind": "closed_loop_solves", "dtype": "float64", "rhs": "normal",
               "pool": 4, "check_solves": 2, "profile_min_s": 0.05}
#: those of the float64 stencil cell
NEW_LIMITS = {"numbers": {"unconverged": {"limit": 0}, "resid_ratio": {"limit": 2.2},
                          "resid_max": {"limit": 5}, "resid_gap": {"limit": 1e-4},
                          "x_err": {"limit": 1e-10}}}
NEW_SMALL = {"config": {"problem": {"params": {"n_side": 8}}, "sizes": None}}
NEW_METRIC = '''"""``mean_solve_rows``: rows a window's solve handles (a test metric)."""


def read(ctx):
    return float(ctx["problem"]["n"])
'''


def _digests(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


@pytest.fixture(scope="module")
def grown(tmp_path_factory):
    """A copy of the benchmark with the new files and appended entries, its
    entries, and the digests of the files that were there."""
    root = tmp_path_factory.mktemp("grown")
    shutil.copy(spec.ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    shutil.copytree(BENCH, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digests(root / "portbench")

    pb = root / "portbench"
    (pb / "configs" / "poisson3d-small-bjcg.json").write_text(json.dumps(NEW_CONFIG))
    (pb / "traffic" / "solves-f64-small.json").write_text(json.dumps(NEW_TRAFFIC))
    (pb / "limits" / f"{CELL}.json").write_text(json.dumps(NEW_LIMITS))
    (pb / "small" / f"{CELL}.json").write_text(json.dumps(NEW_SMALL))
    (pb / "metrics" / "mean_solve_rows.py").write_text(NEW_METRIC)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "poisson3d-small-bjcg", "source": "a test",
                             "file": "portbench/configs/poisson3d-small-bjcg.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": CELL, "config": "poisson3d-small-bjcg",
                               "traffic": "solves-f64-small", "chips": 1,
                               "why": "a test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] in ("solve_s", "iterations"):
            m["workloads"].append(CELL)
    bench["per_layer"].append({"name": "mean_solve_rows", "unit": "rows",
                               "better": "higher", "source": "program_counter",
                               "layer": "solver loop", "moves": "solve_s",
                               "workloads": [CELL]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root, bench, before


def test_new_files_and_entries_are_enough(grown):
    root, bench, before = grown
    assert spec_breaches(bench, root) == []

    res = harness.run_cell(CELL, 7, 0.1, True, root=root, device="cpu")["result"]
    assert res["correct"] is True
    assert res["metrics"]["mean_solve_rows"] == {"value": 729.0, "unit": "rows"}
    assert set(res["metrics"]) == {"mean_solve_rows", "iterations"}
    assert set(res["checks"]) == set(NEW_LIMITS["numbers"])
    # the cells that were there do not report the new metric
    old = harness.run_cell("p3d256-bjcg-f64", 7, 0.1, True, root=root,
                           device="cpu", executor="torch",
                           overrides={"config": {"problem": {"params": {"n_side": 6}},
                                                 "sizes": None}})["result"]
    assert "mean_solve_rows" not in old["metrics"]

    after = _digests(root / "portbench")
    assert {k: v for k, v in after.items() if k in before} == before


def test_new_cell_passes_the_result_fault_and_control_checks(grown, monkeypatch):
    root = grown[0]
    check_untraced(CELL, root)
    check_traced(CELL, root)
    for fault in FAULTS:
        with monkeypatch.context() as m:
            assert_caught(run_under(CELL, fault, m, root))
    check_control(CELL, root)


def _drop_cell(bench, cell="p3d256-bjcg-f64"):
    bench["workloads"] = [w for w in bench["workloads"] if w["name"] != cell]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if cell in m.get("workloads", []):
            m["workloads"].remove(cell)


def _raise_bound(bench):
    next(m for m in bench["end_to_end"] if m["name"] == "solve_s")["bound"] = 0.1


def _change_moves(bench):
    next(m for m in bench["per_layer"] if m["name"] == "iterations")["moves"] = "setup_s"


@pytest.mark.parametrize("edit,needle", [
    (_drop_cell, "workloads p3d256-bjcg-f64: the accepted entry is gone"),
    (_raise_bound, "end_to_end solve_s: bound 0.1 != 0.08"),
    (_change_moves, "per_layer iterations: moves 'setup_s' != 'solve_s'"),
], ids=["cell_removed", "bound_raised", "moves_changed"])
def test_breaking_an_accepted_entry_fails(grown, edit, needle):
    root, bench, _ = grown
    bad = copy.deepcopy(bench)
    edit(bad)
    assert spec.validate(bad, root) == []  # the contract alone lets it by
    errs = spec_breaches(bad, root)
    assert needle in errs, errs
