"""``BENCHMARK.json`` against the contract's shape and name rules."""

import copy
import json

import pytest

from portbench import spec


@pytest.fixture
def bench():
    return spec.load()


def test_benchmark_json_is_valid(bench):
    assert spec.validate(bench) == []


def test_cells_configs_and_metrics(bench):
    assert [c["name"] for c in bench["configs"]] == [
        "poisson3d-7pt-bjcg", "graph500-kron-sellp-jcg"]
    assert [w["name"] for w in bench["workloads"]] == [
        "p3d256-bjcg-f32", "kron23-sellp-jcg-f32", "p3d256-bjcg-f64"]
    assert all(w["chips"] == 1 for w in bench["workloads"])
    assert {m["name"] for m in bench["end_to_end"]} == {"solve_s", "setup_s"}
    moves = {m["name"]: m["moves"] for m in bench["per_layer"]}
    assert moves == {"iterations": "solve_s", "solve_mfu": "solve_s",
                     "launches_per_iter": "solve_s", "spmv_roofline": "solve_s",
                     "precond_apply_roofline": "solve_s", "idle_share": "solve_s",
                     "precond_setup_s": "setup_s", "format_setup_s": "setup_s"}


def test_every_cell_finds_its_files(bench):
    for w in bench["workloads"]:
        files = spec.cell_files(bench, w["name"])
        assert set(files["metrics"]) == {
            m["name"] for m in bench["end_to_end"] + bench["per_layer"]
            if w["name"] in m.get("workloads", [w["name"]])}
        assert "unconverged" in files["limits"]["numbers"]


def test_rooflines_and_mfu_are_percent(bench):
    for m in bench["per_layer"]:
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("edit,needle", [
    (lambda b: b["workloads"][0].update(name="has space"), "bad name"),
    (lambda b: b["workloads"][0].update(name="a/b"), "bad name"),
    (lambda b: b["end_to_end"][0].update(unit="tokens per second"), "bad unit"),
    (lambda b: b["end_to_end"][0].update(unit="µs"), "bad unit"),
    (lambda b: b["end_to_end"][0].update(bound=0.3), "bound"),
    (lambda b: b["end_to_end"][0].update(bound=0.005), "bound"),
    (lambda b: b["end_to_end"].pop(1), "setup_s"),
    (lambda b: b["per_layer"][0].update(why="no such key"), "has keys"),
    (lambda b: b["per_layer"][0].update(moves="nothing"), "moves"),
    (lambda b: b["per_layer"][0].update(source="guess"), "source"),
    (lambda b: b["workloads"][1].update(config="poisson3d-7pt-bjcg",
                                         traffic="solves-f32"), "pair"),
    (lambda b: b["workloads"][0].update(chips=2), "chips"),
    (lambda b: b["workloads"][0].update(why="x" * 201), "why"),
    (lambda b: b.update(run_seconds=52), "run_seconds"),
    (lambda b: b.update(run_seconds=20.5), "run_seconds"),
    (lambda b: b.update(paths=["/abs"]), "bad path"),
    (lambda b: b.update(command=["python3", "../run.py"]), "leaves"),
    (lambda b: b.update(command=["python3", "chip_smoke.py"]), "outside paths"),
    (lambda b: b["configs"][0].update(file="src/x.json"), "not under paths"),
    (lambda b: b["configs"][0].update(reduced=["a b"]), "reduced"),
    (lambda b: b.update(extra=1), "top-level"),
])
def test_breaches_are_found(bench, edit, needle):
    bad = copy.deepcopy(bench)
    edit(bad)
    errs = spec.validate(bad)
    assert any(needle in e for e in errs), errs


def test_file_under_64k():
    assert len((spec.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_metrics_for_splits_by_trace(bench):
    e2e = spec.metrics_for(bench, "kron23-sellp-jcg-f32", trace=False)
    assert [m["name"] for m in e2e] == ["solve_s", "setup_s"]
    layer = [m["name"] for m in spec.metrics_for(bench, "kron23-sellp-jcg-f32", True)]
    assert "precond_apply_roofline" not in layer and "spmv_roofline" in layer
    assert json.dumps(bench)  # plain JSON
