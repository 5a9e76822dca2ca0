"""``BENCHMARK.json`` against the contract's shape and name rules, and against
the accepted entries, which a later change keeps as they are and appends to."""

import copy
import json

import pytest

from portbench import small, spec


@pytest.fixture
def bench():
    return spec.load()


def test_benchmark_json_is_valid(bench):
    assert spec.validate(bench) == []


STENCIL = ["p3d256-bjcg-f32", "p3d256-bjcg-f64"]
ALL = ["p3d256-bjcg-f32", "kron23-sellp-jcg-f32", "p3d256-bjcg-f64"]

#: The accepted entries of ``BENCHMARK.json``, each with the keys that define
#: it.  A later PR appends configurations, cells and metrics and may add its
#: cells to a metric's ``workloads``; it leaves these as they are, so that
#: every number in the ledger stays comparable.  A metric without
#: ``workloads`` is reported in every cell.
ACCEPTED = {
    "configs": {
        "poisson3d-7pt-bjcg": {"file": "portbench/configs/poisson3d-7pt-bjcg.json"},
        "graph500-kron-sellp-jcg": {
            "file": "portbench/configs/graph500-kron-sellp-jcg.json"},
    },
    "workloads": {
        "p3d256-bjcg-f32": {"config": "poisson3d-7pt-bjcg", "traffic": "solves-f32",
                            "chips": 1},
        "kron23-sellp-jcg-f32": {"config": "graph500-kron-sellp-jcg",
                                 "traffic": "solves-f32", "chips": 1},
        "p3d256-bjcg-f64": {"config": "poisson3d-7pt-bjcg", "traffic": "solves-f64",
                            "chips": 1},
    },
    "end_to_end": {
        "solve_s": {"unit": "s", "better": "lower", "bound": 0.08,
                    "source": "host_clock", "workloads": ALL},
        "setup_s": {"unit": "s", "better": "lower", "bound": 0.25,
                    "source": "host_clock", "workloads": ALL},
    },
    "per_layer": {
        "iterations": {"unit": "iter", "better": "lower", "source": "program_counter",
                       "layer": "solver loop", "moves": "solve_s", "workloads": ALL},
        "solve_mfu": {"unit": "%", "better": "higher", "source": "host_clock",
                      "layer": "solver loop", "moves": "solve_s", "workloads": ALL},
        "launches_per_iter": {"unit": "launches/iter", "better": "lower",
                              "source": "device_trace", "layer": "dispatch",
                              "moves": "solve_s", "workloads": ALL},
        "spmv_roofline": {"unit": "%", "better": "higher", "source": "device_trace",
                          "layer": "kernels", "moves": "solve_s", "workloads": ALL},
        "precond_apply_roofline": {"unit": "%", "better": "higher",
                                   "source": "device_trace", "layer": "kernels",
                                   "moves": "solve_s", "workloads": STENCIL},
        "idle_share": {"unit": "ratio", "better": "lower", "source": "device_trace",
                       "layer": "device", "moves": "solve_s", "workloads": ALL},
        "precond_setup_s": {"unit": "s", "better": "lower", "source": "host_clock",
                            "layer": "preconditioner", "moves": "setup_s",
                            "workloads": ALL},
        "format_setup_s": {"unit": "s", "better": "lower", "source": "host_clock",
                           "layer": "sparse formats", "moves": "setup_s",
                           "workloads": ALL},
        "precond_apply_whole_roofline": {"unit": "%", "better": "higher",
                                         "source": "program_span",
                                         "layer": "preconditioner",
                                         "moves": "solve_s", "workloads": STENCIL},
        "stop_test_idle_share": {"unit": "ratio", "better": "lower",
                                 "source": "device_trace", "layer": "solver loop",
                                 "moves": "solve_s", "workloads": ALL},
        "dispatch_host_us": {"unit": "us", "better": "lower", "source": "device_trace",
                             "layer": "dispatch", "moves": "solve_s", "workloads": ALL},
        "sellp_useful_share": {"unit": "ratio", "better": "higher",
                               "source": "program_counter", "layer": "sparse formats",
                               "moves": "solve_s",
                               "workloads": ["kron23-sellp-jcg-f32"]},
    },
}


def accepted_breaches(bench: dict, section: str, name: str) -> list:
    """How ``bench`` departs from the accepted entry ``name`` of ``section``:
    gone, a defining key changed, or an accepted cell dropped from the
    metric's ``workloads`` (empty: none)."""
    want = ACCEPTED[section][name]
    got = [e for e in bench[section] if e.get("name") == name]
    if not got:
        return [f"{section} {name}: the accepted entry is gone"]
    cells = [w.get("name") for w in bench["workloads"]]
    errs = []
    for key, value in want.items():
        if key == "workloads":
            lost = set(value) - set(got[0].get("workloads", cells))
            if lost:
                errs.append(f"{section} {name}: accepted cells {sorted(lost)} dropped")
        elif got[0].get(key) != value:
            errs.append(f"{section} {name}: {key} {got[0].get(key)!r} != {value!r}")
    return errs


def spec_breaches(bench: dict, root=spec.ROOT) -> list:
    """The whole spec check: the contract's rules, every accepted entry as
    accepted, and a CPU size for every cell."""
    errs = spec.validate(bench, root)
    for section, entries in ACCEPTED.items():
        for name in entries:
            errs += accepted_breaches(bench, section, name)
    errs += [f"cell {w['name']}: no {small.path(w['name'], root)}"
             for w in bench["workloads"] if not small.path(w["name"], root).is_file()]
    return errs


@pytest.mark.parametrize("section,name", [(s, n) for s in ACCEPTED for n in ACCEPTED[s]],
                         ids=lambda v: v)
def test_cells_configs_and_metrics(bench, section, name):
    assert accepted_breaches(bench, section, name) == []


@pytest.mark.parametrize("cell", [w["name"] for w in spec.load()["workloads"]])
def test_every_cell_has_a_small_size(cell):
    over = small.overrides(cell)
    assert over and set(over) <= {"config", "traffic", "limits"}


def test_spec_check_passes(bench):
    assert spec_breaches(bench) == []


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
