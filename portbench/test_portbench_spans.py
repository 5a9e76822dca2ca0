"""The per-layer metrics that read the program's spans and gauges
(``precond_apply_whole_roofline``, ``stop_test_idle_share``,
``dispatch_host_us``, ``sellp_useful_share``) on synthetic contexts, each
``None`` where its input is missing; ``dispatch_host_us`` on a real CPU
trace.  On the card only (marked ``card``): a small stencil solve under the
profiler, with the spans and with them patched out, leaves the device
trace as it was."""

import math
from pathlib import Path

import pytest
import torch

from portbench import counting, profiling, spec

ROOT = Path(__file__).resolve().parent.parent
KIND = "NVIDIA H100 80GB HBM3"
METRICS = {name: spec.load_module(ROOT / "portbench" / "metrics" / f"{name}.py",
                                  "test")
           for name in ("precond_apply_whole_roofline", "stop_test_idle_share",
                        "dispatch_host_us", "sellp_useful_share")}
SPAN_NAMES = ("solve", "cg.stop_test", "precond.apply")


def _problem():
    return {"n": 1000, "nnz": 7000, "s": 4, "dtype": "float32",
            "precond_storage_bytes": 40000, "precond_flops": 16000}


def _ctx(trace=None, kind=KIND):
    return {"trace": trace, "device_kind": kind, "problem": _problem(),
            "spans": {}, "setup_s": 1.0,
            "window": {"seconds": 1.0, "solves": 1, "iterations": [10]}}


def _slice(device=(), host=(), lo=0, hi=1000, iterations=9, solves=1):
    return {"lo_ns": lo, "hi_ns": hi, "window_s": (hi - lo) * 1e-9,
            "device": list(device), "host": list(host),
            "iterations": iterations, "solves": solves}


@pytest.fixture
def totals(monkeypatch):
    """Set what ``trace.device_span_totals()`` returns."""
    from repro_torch.observability import trace

    box = {}
    monkeypatch.setattr(trace, "device_span_totals", lambda: dict(box))
    return box


def test_whole_apply_roofline_reads_the_spans_device_time(totals):
    read = METRICS["precond_apply_whole_roofline"].read
    tr = _slice(iterations=9, solves=1)
    totals["precond.apply"] = {"count": 10, "device_s": 2e-3}
    p = _problem()
    least = counting.least_seconds(counting.precond_bytes(p),
                                   counting.precond_flops(p), "float32", KIND)
    assert read(_ctx(tr)) == pytest.approx(100.0 * 10 * least / 2e-3)
    # the same numerator as precond_apply_roofline: a kernel time equal to
    # the spans' reads the same
    tr_k = dict(tr, device=[("block_jacobi_kernel", 0, 2_000_000)])
    old = spec.load_module(ROOT / "portbench" / "metrics" /
                           "precond_apply_roofline.py", "test")
    assert old.read(_ctx(tr_k)) == pytest.approx(read(_ctx(tr)))


def test_whole_apply_roofline_is_none_without_its_input(totals):
    read = METRICS["precond_apply_whole_roofline"].read
    tr = _slice(iterations=9, solves=1)
    assert read(_ctx(tr)) is None  # no spans: a program without them
    totals["precond.apply"] = {"count": 11, "device_s": 2e-3}
    assert read(_ctx(tr)) is None  # spans from outside the slice
    totals["precond.apply"] = {"count": 10, "device_s": 2e-3}
    assert read(_ctx(None)) is None
    assert read(_ctx(tr, kind=None)) is None
    assert read(_ctx(tr)) is not None


def test_whole_apply_roofline_without_the_function(monkeypatch):
    from repro_torch.observability import trace

    monkeypatch.delattr(trace, "device_span_totals")
    assert METRICS["precond_apply_whole_roofline"].read(_ctx(_slice())) is None


def test_stop_test_idle_counts_gaps_that_begin_in_a_stop_test():
    read = METRICS["stop_test_idle_share"].read
    dev = [("k", 0, 100), ("k", 300, 400), ("k", 600, 900)]
    host = [("cg.stop_test", 90, 350),   # gap 100-300 begins inside: 200
            ("cg.stop_test", 500, 650),  # gap 400-600 began before it
            ("aten::add", 380, 420),
            ("cg.stop_test", 880, 990)]  # the slice's tail 900-1000: 100
    assert read(_ctx(_slice(dev, host))) == pytest.approx(0.3)
    # below the slice's idle share, which counts every gap
    idle = 1.0 - profiling.busy_seconds(_slice(dev, host)) / 1e-6
    assert idle == pytest.approx(0.5)


def test_stop_test_idle_is_none_without_its_input():
    read = METRICS["stop_test_idle_share"].read
    dev = [("k", 0, 100)]
    assert read(_ctx(_slice(dev, [("aten::add", 0, 5)]))) is None
    assert read(_ctx(_slice((), [("cg.stop_test", 0, 5)]))) is None
    assert read(_ctx(_slice(dev, [("cg.stop_test", 0, 5)]), kind=None)) is None
    assert read(_ctx(None)) is None
    # a stop test outside the slice is not in it
    assert read(_ctx(_slice(dev, [("cg.stop_test", 2000, 2100)]))) is None


def test_dispatch_host_us_is_the_mean_op_range_in_the_slice():
    read = METRICS["dispatch_host_us"].read
    host = [("op.spmv_ell", 10, 20), ("op.blas_dot", 30, 60),
            ("aten::dot", 31, 59), ("op.late", 2000, 2100)]
    assert read(_ctx(_slice(host=host))) == pytest.approx(0.02)
    assert read(_ctx(_slice(host=[("aten::dot", 1, 2)]))) is None
    assert read(_ctx(_slice(host=host), kind=None)) is None
    assert read(_ctx(None)) is None


def test_dispatch_host_us_on_a_cpu_trace():
    """A real slice of a small solve on the CPU holds the ``op.*`` ranges
    (read here as if the card's); every one lies inside a ``solve``."""
    from repro_torch.core import make_executor
    from repro_torch.solvers import CgSolver, Stop
    from repro_torch.sparse import ell_from_csr_host
    from portbench.generators import poisson3d_7pt

    ip, ix, vals, shape = poisson3d_7pt.generate({"n_side": 6}, device="cpu")
    A = ell_from_csr_host(ip, ix, vals, shape, device="cpu")
    solver = CgSolver(A, stop=Stop(max_iters=100, reduction_factor=1e-6),
                      M="block_jacobi", precond_opts={"block_size": 8},
                      executor=make_executor("torch"))
    b = torch.ones(shape[0])
    tr = profiling.profile_slice(lambda: solver.solve(b), 0.0, False)
    us = METRICS["dispatch_host_us"].read(_ctx(tr))
    assert us is not None and 0 < us < 1e5
    names = {n for n, _, _ in tr["host"]}
    assert set(SPAN_NAMES) <= names and "op.block_jacobi_apply" in names
    assert not tr["device"]


def test_sellp_useful_share_reads_the_gauges():
    from repro_torch.observability import metrics
    from repro_torch.sparse import sellp_from_csr_host

    read = METRICS["sellp_useful_share"].read
    metrics.reset()
    try:
        assert read(_ctx()) is None  # no gauges: a program without them
        # rows of 1 and 9 entries in one slice of 2: 16 + 16 slots, 10 used
        ip = [0, 1, 10]
        ix = [0] + list(range(9))
        A = sellp_from_csr_host(ip, ix, [1.0] * 10, (2, 9), slice_size=2,
                                stride_factor=8, device="cpu")
        assert A.nnz == 32
        assert read(_ctx()) == pytest.approx(10 / 32)
        assert read(_ctx(kind=None)) is None
    finally:
        metrics.reset()


@pytest.mark.card
def test_spans_leave_the_device_trace_alone(card, monkeypatch):
    """A small stencil solve on the card under the profiler: no span name
    among the device events, the same kernels as with the spans patched
    out, and one device-timed preconditioner apply an iteration and one a
    solve."""
    from repro_torch.core import make_executor
    from repro_torch.kernels import _build
    from repro_torch.observability import trace
    from repro_torch.solvers import CgSolver, Stop
    from repro_torch.sparse import ell_from_csr_host
    from portbench.generators import poisson3d_7pt

    _build.load()
    ip, ix, vals, shape = poisson3d_7pt.generate({"n_side": 48}, device="cuda")
    A = ell_from_csr_host(ip, ix, vals, shape, device="cuda")
    solver = CgSolver(A, stop=Stop(max_iters=500, reduction_factor=1e-6),
                      M="block_jacobi",
                      precond_opts={"block_size": 8, "adaptive": True},
                      executor=make_executor("cuda", device="cuda"))
    b = torch.randn(shape[0], generator=torch.Generator(device="cuda").manual_seed(3),
                    device="cuda")
    solver.solve(b)  # warm-up
    torch.cuda.synchronize()

    def slice_():
        return profiling.profile_slice(lambda: solver.solve(b), 0.0, True)

    trace.reset_device_spans()
    with_spans = slice_()
    totals = trace.device_span_totals()
    dev_names = {n for n, _, _ in with_spans["device"]}
    assert not dev_names & set(SPAN_NAMES)
    assert not any(n.startswith("op.") for n in dev_names)
    host_names = {n for n, _, _ in with_spans["host"]}
    assert set(SPAN_NAMES) <= host_names
    applies = with_spans["iterations"] + with_spans["solves"]
    assert totals["precond.apply"]["count"] == applies
    assert totals["precond.apply"]["device_s"] > 0

    monkeypatch.setattr(trace, "span", lambda *a, **k: trace._NULL_SPAN)
    monkeypatch.setattr(trace, "host_range", lambda name: trace._NULL_SPAN)
    without = slice_()
    assert without["iterations"] == with_spans["iterations"]
    assert not {n for n, _, _ in without["host"]} & set(SPAN_NAMES)
    assert profiling.kernel_launches(with_spans) == profiling.kernel_launches(without)
    busy = [profiling.busy_seconds(t) for t in (with_spans, without)]
    print(f"spans on/off: {profiling.kernel_launches(with_spans)} launches, "
          f"{with_spans['iterations']} iterations, busy {busy[0]:.6f} / "
          f"{busy[1]:.6f} s, window {with_spans['window_s']:.6f} / "
          f"{without['window_s']:.6f} s, precond.apply device "
          f"{totals['precond.apply']['device_s']:.6f} s")
    assert math.isfinite(busy[0])
