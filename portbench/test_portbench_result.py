"""The result line's shape, from whole runs of small cells on the CPU (the
torch kernel space in place of the card's)."""

import json

import pytest

from portbench import harness, small, spec

CELLS = [w["name"] for w in spec.load()["workloads"]]

#: per-layer metrics that read the host alone, so a CPU run reports them
#: wherever its cell lists them
HOST_READ = {"iterations", "precond_setup_s", "format_setup_s"}


def run(cell, trace, root=spec.ROOT, seed=2 ** 31 + 17, seconds=0.2):
    return harness.run_cell(cell, seed, seconds, trace, root=root, device="cpu",
                            executor="torch", overrides=small.overrides(cell, root))


def check_untraced(cell, root=spec.ROOT):
    out = run(cell, False, root)
    res = out["result"]
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(res)[-1] == "checks"
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] >= 1
    # a CPU run reports every end-to-end metric of the cell on the host's clock
    assert set(res["metrics"]) == {
        m["name"] for m in spec.metrics_for(spec.load(root), cell, trace=False)
        if m["source"] == "host_clock"}
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(res["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    for name, c in res["checks"].items():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"], name
    assert set(out["setup_split_s"]) >= {"inputs", "format", "precond", "solver",
                                          "warmup"}
    json.dumps(harness.json_safe(res), allow_nan=False)


def check_traced(cell, root=spec.ROOT):
    res = run(cell, True, root)["result"]
    assert res["correct"] is True
    # on the CPU the trace holds no device activity: no device metric and no
    # share of a device peak is written, and busy_s reads 0
    listed = {m["name"]: m for m in spec.metrics_for(spec.load(root), cell, trace=True)}
    assert set(res["metrics"]) <= set(listed)
    assert HOST_READ & set(listed) <= set(res["metrics"])
    for name in res["metrics"]:
        assert listed[name]["source"] != "device_trace" and listed[name]["unit"] != "%"
    assert res["device"]["busy_s"] == 0.0 and res["device"]["window_s"] > 0
    assert "breakdown" not in res
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("cell", CELLS)
def test_untraced_line(cell):
    check_untraced(cell)


@pytest.mark.parametrize("cell", CELLS)
def test_traced_line(cell):
    check_traced(cell)


def test_same_seed_same_inputs():
    import torch
    traffic = {"pool": 3, "dtype": "float32"}
    a = harness.make_pool(traffic, 2 ** 31 + 5, 50, "cpu")
    assert torch.equal(a, harness.make_pool(traffic, 2 ** 31 + 5, 50, "cpu"))
    assert not torch.equal(a, harness.make_pool(traffic, 2 ** 31 + 6, 50, "cpu"))


def test_sample_is_drawn_from_the_seed():
    # the reservoir's draws depend on the seed alone, not on timing
    a = harness._sampler(9, 3)
    b = harness._sampler(9, 3)
    assert [a(i) for i in range(200)] == [b(i) for i in range(200)]


def test_non_finite_numbers_stay_strict_json():
    safe = harness.json_safe({"a": float("inf"), "b": [float("nan"), 1.0]})
    assert json.loads(json.dumps(safe, allow_nan=False)) == {"a": "inf",
                                                             "b": ["nan", 1.0]}
