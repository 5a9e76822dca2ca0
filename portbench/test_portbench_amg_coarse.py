"""The multigrid cell's span and its reader: ``amg.coarse`` (the apply's
work below the finest level) is one span per ``precond.apply`` while the
program traces and none while it does not; ``amg_coarse_share`` reads the
two spans' device seconds and is ``None`` where its input is missing or
off the card."""

from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import spec

ROOT = Path(__file__).resolve().parent.parent
KIND = "NVIDIA H100 80GB HBM3"
READ = spec.load_module(ROOT / "portbench" / "metrics" / "amg_coarse_share.py",
                        "test").read
OPTS = {"smooth_prolongator": False, "coarse_size": 64}


def _ctx(trace=None, kind=KIND):
    return {"trace": trace, "device_kind": kind, "problem": {}, "spans": {},
            "setup_s": 1.0, "window": {"seconds": 1.0, "solves": 1,
                                       "iterations": [9]}}


def _slice(iterations=9, solves=1):
    return {"lo_ns": 0, "hi_ns": 1000, "window_s": 1e-6, "device": [],
            "host": [], "iterations": iterations, "solves": solves}


@pytest.fixture
def totals(monkeypatch):
    """Set what ``trace.device_span_totals()`` returns."""
    from repro_torch.observability import trace

    box = {}
    monkeypatch.setattr(trace, "device_span_totals", lambda: dict(box))
    return box


def test_share_reads_the_spans_device_seconds(totals):
    totals["precond.apply"] = {"count": 10, "device_s": 4e-3}
    totals["amg.coarse"] = {"count": 10, "device_s": 1e-3}
    assert READ(_ctx(_slice())) == pytest.approx(0.25)


def test_share_is_none_without_its_input(totals):
    tr = _slice()
    assert READ(_ctx(tr)) is None  # no spans: a program without them
    totals["precond.apply"] = {"count": 10, "device_s": 4e-3}
    assert READ(_ctx(tr)) is None  # no coarse span: another preconditioner
    totals["amg.coarse"] = {"count": 9, "device_s": 1e-3}
    assert READ(_ctx(tr)) is None  # an apply without its coarse span
    totals["amg.coarse"] = {"count": 11, "device_s": 1e-3}
    totals["precond.apply"] = {"count": 11, "device_s": 4e-3}
    assert READ(_ctx(tr)) is None  # spans from outside the slice
    totals["amg.coarse"] = {"count": 10, "device_s": 1e-3}
    totals["precond.apply"] = {"count": 10, "device_s": 4e-3}
    assert READ(_ctx(None)) is None
    assert READ(_ctx(tr, kind=None)) is None  # off the card
    assert READ(_ctx(tr)) is not None


def test_share_without_the_function(monkeypatch):
    from repro_torch.observability import trace

    monkeypatch.delattr(trace, "device_span_totals")
    assert READ(_ctx(_slice())) is None


def _solver():
    from repro_torch.core import make_executor
    from repro_torch.precond import make_preconditioner
    from repro_torch.solvers import CgSolver, Stop
    from repro_torch.sparse import ell_from_csr_host
    from portbench.generators import poisson3d_7pt

    ip, ix, vals, shape = poisson3d_7pt.generate({"n_side": 10}, device="cpu")
    A = ell_from_csr_host(ip, ix, vals.astype(np.float64), shape, device="cpu")
    ex = make_executor("torch")
    M = make_preconditioner(A, "amg", executor=ex, **OPTS)
    assert len(M.levels) >= 2
    solver = CgSolver(A, stop=Stop(max_iters=200, reduction_factor=1e-6), M=M,
                      executor=ex, fused=True)
    return solver, torch.randn(shape[0], dtype=torch.float64,
                               generator=torch.Generator().manual_seed(4))


def test_coarse_span_once_an_apply_when_traced():
    from repro_torch.observability import trace

    solver, b = _solver()
    events = []

    class _Tracer:
        def rel_us(self, t):
            return t * 1e-3

        def complete(self, name, ts_us, dur_us, cat="span", args=None):
            events.append(name)

    trace.set_tracer(_Tracer())
    try:
        res = solver.solve(b)
    finally:
        trace.set_tracer(None)
    applies = events.count("precond.apply")
    assert applies == res.iterations + 1
    assert events.count("amg.coarse") == applies


def test_no_coarse_span_with_tracing_off(monkeypatch):
    from repro_torch.observability import trace

    solver, b = _solver()
    made = []
    real = trace._Span

    def counting(*a, **k):
        made.append(a[1])
        return real(*a, **k)
    monkeypatch.setattr(trace, "_Span", counting)
    assert not trace.enabled()
    res = solver.solve(b)
    assert res.converged and made == []
