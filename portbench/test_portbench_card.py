"""On the card only (marked ``card``; skipped, inside the fixture, without
one): each cell's run at its own size with a short window comes out
correct; the control at the cell's size, and a wrong format conversion or
a weaker preconditioner underneath a run at the cell's size, come out not
correct.  The fault runs print the numbers they were judged by."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import spec

ROOT = Path(__file__).resolve().parent.parent
CELLS = [w["name"] for w in spec.load()["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_cell_is_correct_on_the_card(card, cell):
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", cell, "--seed",
         str(2 ** 31 + 3), "--seconds", "3", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=1500)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True, res["checks"]
    assert res["device"]["kind"] == card


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct_on_the_card(card, cell):
    from portbench import control

    out = control.readings(cell, [2 ** 31 + 5], [2 ** 31 + 7], 1.0, emit=lambda s: None)
    assert out["summary"]["program_correct"] == [True]
    assert out["summary"]["control_correct"] == [False]


@pytest.mark.card
@pytest.mark.parametrize("fault", ["format_wrong", "preconditioner_wrong"])
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_not_correct_on_the_card(card, monkeypatch, cell, fault):
    from portbench import harness, test_portbench_faults

    getattr(test_portbench_faults, fault)(monkeypatch,
                                          harness.load_cell(cell, ROOT)["config"])
    out = harness.run_cell(cell, 2 ** 31 + 11, 3.0, False, root=ROOT, device="cuda")
    res = out["result"]
    print(json.dumps(harness.json_safe({"cell": cell, "fault": fault,
                                        "checks": res["checks"],
                                        "uncompared": out["uncompared"],
                                        "samples": out["samples"]})))
    assert res["correct"] is False, res["checks"]
