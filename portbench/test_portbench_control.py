"""The control — the reference in the program's place, computed in the
precision below the cell's — comes out not correct under each cell's own
limits, at a size a test run holds; the program's runs come out correct."""

import pytest

from portbench import control

SMALL = {
    "p3d256-bjcg-f32": {"config": {"problem": {"params": {"n_side": 12}}, "sizes": None}},
    "p3d256-bjcg-f64": {"config": {"problem": {"params": {"n_side": 12}}, "sizes": None}},
    "kron23-sellp-jcg-f32": {"config": {"problem": {"params": {"scale": 11}},
                                        "sizes": None}},
}


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_control_fails_program_passes(cell):
    out = control.readings(cell, [2 ** 31 + 1, 5], [2 ** 31 + 2, 6, 7], 0.1,
                           device="cpu", executor="torch", overrides=SMALL[cell],
                           emit=lambda line: None)
    s = out["summary"]
    assert s["program_correct"] == [True, True]
    assert s["control_correct"] == [False, False, False]
    for r in out["runs"]:
        if r["kind"] == "control":
            assert r["precision"] == control.LOWER[
                "float64" if cell.endswith("f64") else "float32"]
