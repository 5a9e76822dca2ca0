"""``python -m repro_torch.launch.inspect`` against the JAX package's
``repro.launch.inspect``: on the artifacts the JAX tracer and metrics
writer produce, ``metrics`` prints the JAX command's text, ``trace`` its
span table and its dispatch rows (op, space, target, count; the port gives
host time where the JAX command gives bytes and GB/s), and ``validate``
exits as the JAX command does; ``solve`` on the CPU converges within 2
iterations of the JAX command's."""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro.launch import inspect as jax_inspect
from repro_torch.launch import inspect as port_inspect

ROOT = Path(__file__).resolve().parents[1]
SOLVERS = ("cg", "fcg", "bicgstab", "cgs", "gmres")


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _run(module: str, *args: str, cwd: Path) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, "-m", module, *args], cwd=cwd,
                          env=env, capture_output=True, text=True, timeout=240)


_JAX_SOLVES = """
import sys
from repro.launch import inspect
d = sys.argv[1]
for solver in sys.argv[2:]:
    print("SOLVER", solver, flush=True)
    rc = inspect.main(["solve", "--smoke", "--solver", solver, "--executor",
                       "xla", "--trace", f"{d}/{solver}.json", "--metrics",
                       f"{d}/{solver}.jsonl"])
    assert rc == 0, solver
"""


@pytest.fixture(scope="module")
def jax_artifacts(tmp_path_factory):
    """The JAX command's ``solve --smoke`` for each solver (xla executor, one
    process: each file holds the events and metrics so far), with its trace
    and metrics files and its iteration count."""
    d = tmp_path_factory.mktemp("jax_inspect")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-c", _JAX_SOLVES, str(d), *SOLVERS],
                       cwd=d, env=env, capture_output=True, text=True,
                       timeout=240)
    assert r.returncode == 0, r.stderr[-2000:]
    out = {}
    for block in r.stdout.split("SOLVER ")[1:]:
        solver = block.split()[0]
        out[solver] = {"trace": d / f"{solver}.json",
                       "metrics": d / f"{solver}.jsonl",
                       "iters": int(re.search(r"(\d+) iters", block).group(1))}
    assert sorted(out) == sorted(SOLVERS)
    return out


def _cli(module, argv, capsys):
    rc = module.main(argv)
    return rc, capsys.readouterr().out


def _trace_parts(text):
    """A ``trace`` summary's span table, and its dispatch rows cut to
    (op, space, target, count)."""
    head, spans, dispatch = text.split("\n\n")
    rows = [ln.split()[:4] for ln in dispatch.splitlines()[3:]]
    return head + spans, rows


def _same_trace_summary(got, want):
    assert got[0] == want[0]
    spans, rows = _trace_parts(got[1])
    jspans, jrows = _trace_parts(want[1])
    assert spans == jspans
    assert rows == jrows and rows


@pytest.mark.parametrize("solver", SOLVERS)
def test_trace_prints_the_jax_table(jax_artifacts, solver, capsys):
    path = str(jax_artifacts[solver]["trace"])
    want = _cli(jax_inspect, ["trace", path], capsys)
    got = _cli(port_inspect, ["trace", path], capsys)
    _same_trace_summary(got, want)
    assert "dispatches (host time" in got[1] and "gbs" not in got[1]
    _same_trace_summary((0, port_inspect.summarize_trace(path)),
                        (0, jax_inspect.summarize_trace(path)))


@pytest.mark.parametrize("solver", SOLVERS)
def test_metrics_prints_the_jax_table(jax_artifacts, solver, capsys):
    path = str(jax_artifacts[solver]["metrics"])
    want = _cli(jax_inspect, ["metrics", path], capsys)
    got = _cli(port_inspect, ["metrics", path], capsys)
    assert got == want
    assert "dispatch_total" in got[1]


def _broken(src: Path, dst: Path) -> Path:
    data = json.loads(src.read_text())
    events = data["traceEvents"]
    del events[0]["ph"]
    events[1]["dur"] = -1.0
    events[2]["pid"] = "zero"
    dst.write_text(json.dumps(data))
    return dst


def test_validate_exits_as_the_jax_command(jax_artifacts, tmp_path, capsys):
    good = str(jax_artifacts["cg"]["trace"])
    bad = str(_broken(jax_artifacts["cg"]["trace"], tmp_path / "bad.json"))
    for path, rc in ((good, 0), (bad, 1)):
        want = _cli(jax_inspect, ["validate", path], capsys)
        got = _cli(port_inspect, ["validate", path], capsys)
        assert got == want and got[0] == rc
    missing = str(tmp_path / "missing.json")
    assert _cli(port_inspect, ["validate", missing], capsys)[0] == 1


def test_empty_metrics_and_sparkline(tmp_path, capsys):
    empty = tmp_path / "empty.jsonl"
    empty.write_text("")
    assert _cli(port_inspect, ["metrics", str(empty)], capsys) == \
        _cli(jax_inspect, ["metrics", str(empty)], capsys)
    for vals in ([], [1.0], [1e2, 1e-1, 1e-4, 0.0, float("nan")],
                 [10.0 ** -k for k in range(200)]):
        assert port_inspect.sparkline(vals) == jax_inspect.sparkline(vals)
        assert port_inspect.sparkline(vals, log=False, width=10) == \
            jax_inspect.sparkline(vals, log=False, width=10)


@pytest.mark.parametrize("solver", SOLVERS)
def test_solve_converges_within_two_iterations_of_jax(jax_artifacts, solver,
                                                      capsys):
    rc, out = _cli(port_inspect, ["solve", "--smoke", "--device", "cpu",
                                  "--executor", "torch", "--solver", solver],
                   capsys)
    assert rc == 0, out
    iters = int(re.search(r"(\d+) iters", out).group(1))
    assert abs(iters - jax_artifacts[solver]["iters"]) <= 2, (
        iters, jax_artifacts[solver]["iters"])
    assert "residual history" in out


def test_solve_writes_artifacts_both_commands_read(tmp_path, capsys):
    tr, me = tmp_path / "t.json", tmp_path / "m.jsonl"
    r = _run("repro_torch.launch.inspect", "solve", "--smoke", "--device", "cpu",
             "--executor", "torch", "--trace", str(tr), "--metrics", str(me),
             cwd=tmp_path)
    assert r.returncode == 0, r.stderr[-2000:]
    got = _cli(port_inspect, ["validate", str(tr)], capsys)
    assert got == _cli(jax_inspect, ["validate", str(tr)], capsys)
    assert got[0] == 0
    got = _cli(port_inspect, ["trace", str(tr)], capsys)
    _same_trace_summary(got, _cli(jax_inspect, ["trace", str(tr)], capsys))
    got = _cli(port_inspect, ["metrics", str(me)], capsys)
    assert got == _cli(jax_inspect, ["metrics", str(me)], capsys)
    assert "dispatch_total" in got[1]
