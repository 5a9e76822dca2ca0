"""The control — the reference in the program's place, computed in the
precision below the cell's — comes out not correct under each cell's own
limits, at a size a test run holds; the program's runs come out correct."""

import pytest

from portbench import control, harness, small, spec

CELLS = [w["name"] for w in spec.load()["workloads"]]


def check_control(cell, root=spec.ROOT):
    out = control.readings(cell, [2 ** 31 + 1, 5], [2 ** 31 + 2, 6, 7], 0.1,
                           device="cpu", executor="torch",
                           overrides=small.overrides(cell, root),
                           emit=lambda line: None, root=root)
    s = out["summary"]
    assert s["program_correct"] == [True, True]
    assert s["control_correct"] == [False, False, False]
    working = harness.load_cell(cell, root)["traffic"]["dtype"]
    for r in out["runs"]:
        if r["kind"] == "control":
            assert r["precision"] == control.LOWER[working]


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_program_passes(cell):
    check_control(cell)
