"""The port's observability layer against the JAX package's.

Mirrors ``tests/observability/`` (tracer, metrics, dispatch events and the
traced CG's launch structure) on the port, and holds the pure functions
against the JAX package's on the same inputs: ``shape_bucket`` and
``summarize_operands`` on numpy operands, the histogram buckets and
quantiles, and a traced CG whose body launches equal the JAX package's live
traced solve and ``BENCH_pr6.json``'s pins.  The port's own part: spans to
``torch.profiler`` as host-only ranges on the profiler's clock, the
device-timed spans' totals, and a traced dispatch that never synchronises.
"""

import argparse
import collections
import functools
import gc
import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import sparse as jsparse
from repro.core import make_executor as jax_make_executor
from repro.observability import events as jevents
from repro.observability import metrics as jmetrics
from repro.observability import trace as jtrace
from repro.solvers import krylov as jkrylov
from repro.solvers.common import Stop as JStop
from repro_torch.core import make_executor, registry
from repro_torch.observability import convergence, events, metrics, trace
from repro_torch.observability.events import (
    DispatchEvent,
    DispatchLog,
    shape_bucket,
    summarize_operands,
)
from repro_torch.solvers import CgSolver, Stop, cg
from repro_torch.sparse import formats as F
from repro_torch.sparse import ops as blas

BENCH_PR6 = os.path.join(os.path.dirname(__file__), "..", "BENCH_pr6.json")


@pytest.fixture(autouse=True)
def _one_thread_clean_state():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    trace.reset()
    metrics.reset()
    yield
    trace.reset()
    metrics.reset()
    torch.set_num_threads(prev)


# -- the tracer ----------------------------------------------------------------


def test_disabled_span_is_shared_singleton():
    assert not trace.enabled()
    s1 = trace.span("a", n=1)
    s2 = trace.span("b", other="x")
    assert s1 is s2  # no allocation on the disabled path
    with s1:
        pass
    trace.instant("nothing")  # a no-op without a tracer


def test_nested_spans_record_complete_events():
    tracer = trace.enable()
    with trace.span("outer", level=0):
        with trace.span("inner", level=1):
            pass
    trace.disable()
    names = [ev["name"] for ev in tracer.events]
    assert names == ["inner", "outer"]  # inner closes first
    inner, outer = tracer.events
    assert outer["ph"] == "X" and inner["ph"] == "X"
    assert outer["ts"] <= inner["ts"]
    assert outer["ts"] + outer["dur"] >= inner["ts"] + inner["dur"]
    assert outer["args"] == {"level": 0}


def test_instant_events_and_validation():
    tracer = trace.enable()
    trace.instant("marker", detail="here")
    data = tracer.to_json()
    assert trace.validate_trace(data) == []
    (ev,) = data["traceEvents"]
    assert ev["ph"] == "i" and ev["s"] == "t" and ev["args"] == {"detail": "here"}


def test_export_roundtrip(tmp_path):
    path = str(tmp_path / "trace.json")
    with trace.tracing(path):
        with trace.span("work", n=3):
            pass
    assert trace.validate_trace(path) == []
    with open(path) as f:
        data = json.load(f)
    assert data["traceEvents"][0]["name"] == "work"
    assert data["displayTimeUnit"] == "ms"
    assert not trace.enabled()  # the context disabled tracing on exit


def test_validate_catches_malformed_events_as_the_jax_package():
    bad = {"traceEvents": [
        {"name": "", "ph": "X", "ts": 0, "dur": 1, "pid": 1, "tid": 1},
        {"name": "x", "ph": "?", "ts": 0, "pid": 1, "tid": 1},
        {"name": "y", "ph": "X", "ts": 0, "pid": 1, "tid": 1},  # no dur
        {"name": "z", "ph": "X", "ts": 0, "dur": 1, "pid": "a", "tid": 1},
    ]}
    errors = trace.validate_trace(bad)
    assert len(errors) == 4 and errors == jtrace.validate_trace(bad)
    assert trace.validate_trace({"nope": []}) == ["missing 'traceEvents' list"]
    assert trace.validate_trace([1, 2]) != []
    assert trace.validate_trace("/nonexistent/trace.json")[0].startswith(
        "unreadable")


def test_enable_from_args_and_cli_flag(tmp_path):
    ap = argparse.ArgumentParser()
    trace.add_cli_flag(ap)
    path = str(tmp_path / "t.json")
    assert trace.enable_from_args(ap.parse_args(["--trace", path])) == path
    assert trace.enabled()
    with trace.span("s"):
        pass
    assert trace.export() == path  # the default path is the flag's
    assert trace.validate_trace(path) == []
    trace.reset()
    assert trace.enable_from_args(ap.parse_args([])) is None
    assert not trace.enabled() and trace.export() is None


@pytest.mark.parametrize("flag,on", [("1", True), ("yes", True), ("0", False),
                                     ("", False)])
def test_maybe_enable_from_env(monkeypatch, tmp_path, flag, on):
    path = str(tmp_path / "env.json")
    monkeypatch.setenv(trace.ENV_FLAG, flag)
    monkeypatch.setenv(trace.ENV_PATH, path)
    assert trace.maybe_enable_from_env() is on
    assert trace.enabled() is on
    if on:
        with trace.span("env"):
            pass
        assert trace.export() == path and trace.validate_trace(path) == []


def test_disabled_dispatch_retains_no_allocations():
    """With tracing and the profiler off, repeated dispatches inside a span
    retain no memory: no event objects, no trace records, no per-call
    state, and the span is the shared no-op one."""
    ex = make_executor("torch")
    x = torch.ones(64)

    def run(n):
        for _ in range(n):
            with trace.span("precond.apply", device_of=x):
                blas.dot(x, x, executor=ex)

    assert not trace.enabled()
    assert trace.span("precond.apply", device_of=x) is trace._NULL_SPAN
    run(20)  # first-call caches, Counter keys
    deltas = []
    for _ in range(3):
        gc.collect()
        before = sys.getallocatedblocks()
        run(50)
        gc.collect()
        deltas.append(sys.getallocatedblocks() - before)
    assert min(deltas) <= 8, f"dispatch path retained blocks: {deltas}"
    assert not ex.dispatch_log.events


# -- metrics -------------------------------------------------------------------


def test_counter_gauge_histogram_basics():
    c = metrics.counter("reqs", op="spmv")
    c.inc()
    c.inc(2)
    assert c.value == 3
    with pytest.raises(ValueError):
        c.inc(-1)
    g = metrics.gauge("gbs", op="spmv")
    g.set(12.5)
    g.set(10.0)
    assert g.value == 10.0
    h = metrics.histogram("wall_us", op="spmv")
    for v in (1.0, 3.0, 100.0):
        h.observe(v)
    assert h.count == 3 and h.min == 1.0 and h.max == 100.0
    assert h.mean == pytest.approx(104.0 / 3)
    assert h.buckets == {1: 1, 4: 1, 128: 1}


def test_buckets_and_quantiles_equal_the_jax_package():
    """The sub-unit buckets (second-scale latencies) and the bucket
    quantiles, value for value the JAX package's."""
    rng = np.random.default_rng(0)
    values = np.concatenate([rng.uniform(0, 1e-5, 50), rng.uniform(0, 1e-2, 45),
                             rng.uniform(0.3, 3.0, 5), [0.0, 1.0, 0.5, 2.0 ** -30]])
    for v in values:
        assert metrics._bucket_of(float(v)) == jmetrics._bucket_of(float(v))
    h, hj = metrics.Histogram(), jmetrics.Histogram()
    assert h.quantile(0.5) is None
    for v in values:
        h.observe(v)
        hj.observe(v)
    assert h.sample() == hj.sample()
    for q in (0.0, 0.5, 0.9, 0.99, 1.0):
        assert h.quantile(q) == hj.quantile(q)
    with pytest.raises(ValueError):
        h.quantile(1.5)
    assert isinstance(metrics._bucket_of(3.0), int)


def test_series_identity_and_kind_conflicts():
    a = metrics.counter("n", op="x", space="torch")
    assert a is metrics.counter("n", space="torch", op="x")
    assert metrics.counter("n", op="y") is not a
    with pytest.raises(TypeError):
        metrics.gauge("n", op="x", space="torch")
    assert metrics.default_registry().counter("n", op="x", space="torch") is a


def test_jsonl_roundtrip_and_table(tmp_path):
    metrics.counter("dispatch_total", op="spmv_csr").inc(4)
    metrics.gauge("gbs", op="spmv_csr").set(1.25)
    metrics.histogram("wall", op="spmv_csr").observe(7.0)
    path = str(tmp_path / "m.jsonl")
    assert metrics.export_jsonl(path) == path
    records = metrics.load_jsonl(path)
    assert records == jmetrics.load_jsonl(path) == json.loads(
        json.dumps(metrics.samples()))
    by_name = {r["name"]: r for r in records}
    assert by_name["dispatch_total"]["value"] == 4
    assert by_name["dispatch_total"]["labels"] == {"op": "spmv_csr"}
    assert by_name["wall"]["count"] == 1
    table = metrics.render_table()
    assert "dispatch_total" in table and "op=spmv_csr" in table
    metrics.reset()
    assert metrics.render_table() == "(no metrics recorded)"


def _event(host_us=10.0):
    return DispatchEvent(op="spmv_csr", space="torch", executor="TorchExecutor",
                         target="cpu_torch", host_us=host_us, ts_us=0.0,
                         shapes=((8,), (8, 8)), shape_bucket=64, launch=None)


def test_observe_dispatch_folds_counters_and_gauges():
    labels = dict(op="spmv_csr", space="torch", target="cpu_torch")
    metrics.observe_dispatch(_event())
    metrics.observe_dispatch(_event(host_us=5.0))
    assert metrics.counter("dispatch_total", **labels).value == 2
    h = metrics.histogram("dispatch_host_us", **labels)
    assert (h.count, h.min, h.max) == (2, 5.0, 10.0)
    # a host time gives no rate: no gauge series is folded in
    assert not [r for r in metrics.samples() if r["kind"] == "gauge"]


def test_dispatch_event_has_host_time_and_no_bytes():
    ev = _event(host_us=3.5)
    assert ev.host_us == 3.5
    assert not hasattr(ev, "est_bytes") and not hasattr(ev, "gbs")
    assert "est_bytes" not in ev.to_args()
    assert not hasattr(events, "roofline_summary")


# -- dispatch events -----------------------------------------------------------


def test_dispatch_log_counter_face_is_plain_counter():
    log = DispatchLog()
    assert isinstance(log, collections.Counter)
    log.record("spmv_csr")
    log.record("spmv_csr")
    log.record("blas_dot")
    assert dict(log) == {"spmv_csr": 2, "blas_dot": 1}
    assert log.most_common(1) == [("spmv_csr", 2)]
    assert not log.events
    log.clear()
    assert dict(log) == {} and not log.events


def test_shape_bucket_and_operand_summary_equal_the_jax_package():
    """On the same operands (numpy, then torch tensors and the port's
    formats against JAX arrays and formats) the two packages agree."""
    for shapes in ([(8,), (8, 8)], [(5,)], [], [(3, 7), (100,)]):
        assert shape_bucket(shapes) == jevents.shape_bucket(shapes)
    x = np.ones(16, np.float32)
    bag = [x, 3, None, "label", [x, {"k": x.astype(np.float64)}]]
    assert summarize_operands(bag) == jevents.summarize_operands(bag)
    shapes, nbytes = summarize_operands(
        [torch.ones(16), 3, None, [torch.ones(16), {"k": torch.ones(16, dtype=torch.float64)}]])
    assert sorted(shapes) == [(16,)] * 3 and nbytes == 2 * 64 + 128
    a = np.eye(8, dtype=np.float32) + np.eye(8, k=1, dtype=np.float32)
    for mk, jmk in ((F.csr_from_dense, jsparse.csr_from_dense),
                    (F.ell_from_dense, jsparse.ell_from_dense)):
        A, J = mk(a, device="cpu"), jmk(a)
        got, want = summarize_operands([A]), jevents.summarize_operands([J])
        assert got == want and got[1] == A.memory_bytes


def test_events_recorded_only_while_tracing():
    ex = make_executor("torch")
    x = torch.ones(32)
    ex.dispatch_log.clear()
    blas.norm2(x, executor=ex)
    assert ex.dispatch_log["blas_norm2"] == 1 and not ex.dispatch_events
    trace.enable()
    blas.norm2(x, executor=ex)
    assert ex.dispatch_log["blas_norm2"] == 2
    (ev,) = ex.dispatch_events
    assert (ev.op, ev.space, ev.target) == ("blas_norm2", "torch", "cpu_torch")
    assert ev.shapes == ((32,),) and ev.shape_bucket == 32
    assert ev.host_us >= 0.0 and ev.ts_us >= 0.0
    (rec,) = [r for r in metrics.samples() if r["name"] == "dispatch_total"]
    assert rec["labels"] == {"op": "blas_norm2", "space": "torch",
                             "target": "cpu_torch"}


_PROBE = registry.operation("observability_launch_probe",
                            "test op: resolves a launch geometry")


@_PROBE.register("torch")
def _probe_torch(ex, x):
    ex.launch_config("spmv_ell", {"m": x.shape[0], "k": 4, "itemsize": 4})
    return x + 1


def test_event_carries_resolved_launch_config():
    """A kernel that consults the tuning table leaves its LaunchConfig on
    the traced event; a dispatch that does not leaves None."""
    ex = make_executor("torch")
    trace.enable()
    _PROBE(torch.ones(64), executor=ex)
    blas.norm2(torch.ones(4), executor=ex)
    probe, norm = ex.dispatch_events
    assert probe.launch["op"] == "spmv_ell" and probe.launch["block"]
    assert probe.launch["target"] == "cpu_torch"
    assert probe.to_args()["launch"] == probe.launch
    assert norm.launch is None and "launch" not in norm.to_args()


def test_traced_dispatch_does_not_synchronise(monkeypatch):
    """A traced dispatch on an executor whose device is a card calls no
    ``torch.cuda.synchronize``: the event's time is the host's."""
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a, **k: calls.append(a))
    ex = make_executor("torch")
    monkeypatch.setattr(ex, "device", torch.device("cuda"), raising=False)
    assert ex.device.type == "cuda"
    trace.enable()
    _PROBE(torch.ones(64), executor=ex)
    blas.norm2(torch.ones(4), executor=ex)
    assert calls == []
    assert [e.op for e in ex.dispatch_events] == [
        "observability_launch_probe", "blas_norm2"]


def test_event_deque_is_bounded():
    log = DispatchLog()
    for _ in range(events.EVENT_CAPACITY + 10):
        log.record("op", event=object())
    assert len(log.events) == events.EVENT_CAPACITY
    assert log["op"] == events.EVENT_CAPACITY + 10  # counts are never dropped


# -- a traced CG reproduces the launch structure ---------------------------------


def _spd(n):
    a = np.zeros((n, n), np.float32)
    for i in range(n):
        a[i, i] = 4.0
        if i > 0:
            a[i, i - 1] = a[i - 1, i] = -1.0
        if i > 2:
            a[i, i - 3] = a[i - 3, i] = -0.5
    return a


def _system():
    a = _spd(96)
    x = np.random.default_rng(4).normal(size=96).astype(np.float32)
    return a, (a @ x).astype(np.float32)


def _body(counts, fused):
    if fused:
        return counts.get("spmv_dot_csr", 0) + counts.get("axpy_norm", 0)
    return ((counts.get("spmv_csr", 0) - 1) + (counts.get("blas_dot", 0) - 1)
            + (counts.get("blas_norm2", 0) - 2) + counts.get("blas_axpy", 0))


@functools.lru_cache(maxsize=None)
def _jax_traced_body(fused):
    """The JAX package's traced CG (its launches are counted once, at trace
    time): the body launches of its Chrome trace."""
    a, b = _system()
    ex = jax_make_executor("xla")
    jtrace.reset()
    try:
        with jtrace.tracing(None) as tracer:
            jkrylov.cg(jsparse.csr_from_dense(a), jnp.asarray(b),
                       stop=JStop(max_iters=500, reduction_factor=1e-6),
                       executor=ex, fused=fused)
            counts = collections.Counter(e["name"] for e in tracer.events
                                         if e["cat"] == "dispatch")
    finally:
        jtrace.reset()
    return _body(counts, fused)


@pytest.mark.parametrize("fused", [True, False])
def test_traced_cg_matches_bench_pins(tmp_path, fused):
    """A traced CG solve writes a valid Chrome trace whose dispatch spans
    give the body launches of the JAX package's traced solve and of
    ``BENCH_pr6.json`` per iteration; the counter face, the event stream and
    the trace agree."""
    with open(BENCH_PR6) as f:
        pinned = json.load(f)["pinned"]
    want = pinned["fused_cg_body_launches" if fused else "unfused_cg_body_launches"]
    assert _jax_traced_body(fused) == want

    a, b = _system()
    ex = make_executor("torch")
    path = str(tmp_path / "cg_trace.json")
    with trace.tracing(path):
        ex.dispatch_log.clear()
        res = cg(F.csr_from_dense(a, device="cpu"), torch.from_numpy(b),
                 stop=Stop(max_iters=500, reduction_factor=1e-6), executor=ex,
                 fused=fused, history=True)
        counts = dict(ex.dispatch_log)
        evs = list(ex.dispatch_events)
    assert res.converged
    assert trace.validate_trace(path) == []
    k = int(res.iterations)
    assert _body(counts, fused) == want * k
    assert dict(collections.Counter(e.op for e in evs)) == counts
    with open(path) as f:
        spans = collections.Counter(ev["name"] for ev in json.load(f)["traceEvents"]
                                    if ev.get("cat") == "dispatch")
    assert _body(spans, fused) == want * k
    assert convergence.trim(res.history) is not None


# -- spans to torch.profiler, on its clock ---------------------------------------


def _profiled(fn):
    """``fn()`` under torch.profiler (CPU activity): its host events as
    ``(name, scope, start_ns, end_ns)``, and ``fn``'s result."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    evs = [(e.name(), int(e.scope()), e.start_ns(), e.start_ns() + e.duration_ns())
           for e in prof.profiler.kineto_results.events()]
    return evs, out


def _stencil_solver(n=64):
    a = _spd(n)
    A = F.ell_from_dense(a, device="cpu")
    ex = make_executor("torch")
    solver = CgSolver(A, stop=Stop(max_iters=200, reduction_factor=1e-6),
                      M="block_jacobi", precond_opts={"block_size": 4},
                      executor=ex)
    b = torch.from_numpy(a @ np.ones(n, np.float32))
    return solver, b


def test_spans_are_function_scope_host_ranges_under_the_profiler():
    """Under torch.profiler the solve's spans are host events of FUNCTION
    scope, nested as written: every stop test, preconditioner apply and
    dispatch inside the solve, the block kernel's dispatch inside an
    apply."""
    from torch._C._profiler import RecordScope

    solver, b = _stencil_solver()
    assert not trace.enabled()
    evs, res = _profiled(lambda: solver.solve(b))
    assert res.converged
    ours = [e for e in evs if e[0] in ("solve", "cg.stop_test", "precond.apply")
            or e[0].startswith("op.")]
    assert {e[1] for e in ours} == {int(RecordScope.FUNCTION)}
    by = collections.defaultdict(list)
    for name, _, s, e in ours:
        by[name].append((s, e))
    k = int(res.iterations)
    assert len(by["solve"]) == 1
    assert len(by["cg.stop_test"]) == k + 1
    assert len(by["precond.apply"]) == k + 1
    assert len(by["op.block_jacobi_apply"]) >= k + 1
    (s0, e0), = by["solve"]
    for name, spans in by.items():
        assert all(s0 <= s and e <= e0 for s, e in spans), name

    def inside(span, outer):
        return any(s <= span[0] and span[1] <= e for s, e in outer)

    assert all(inside(x, by["precond.apply"]) for x in by["op.block_jacobi_apply"])
    assert not any(inside(x, by["cg.stop_test"]) for x in by["precond.apply"])
    # the spans feed no tracer: the port's tracing stayed off
    assert trace.get_tracer() is None


def test_both_sinks_share_the_profilers_clock():
    """With the tracer and the profiler both on, a span is in each, and the
    tracer's ``ts`` plus its ``t0_ns`` lands within 5 ms of the profiler's
    start of the same span.  The file validates; the solve span carries a
    solve index."""
    solver, b = _stencil_solver(32)
    tracer = trace.enable()
    evs, _ = _profiled(lambda: solver.solve(b))
    trace.disable()
    data = tracer.to_json()
    assert trace.validate_trace(data) == []
    t0 = data["otherData"]["t0_ns"]
    assert data["otherData"]["clock"] == "unix_epoch_ns"
    (ours,) = [e for e in data["traceEvents"] if e["name"] == "solve"]
    assert isinstance(ours["args"]["solve"], int)
    (prof,) = [e for e in evs if e[0] == "solve"]
    assert abs(t0 + ours["ts"] * 1e3 - prof[2]) < 5e6
    names = collections.Counter(e["name"] for e in data["traceEvents"])
    assert names["cg.stop_test"] == names["precond.apply"] >= 2
    # a dispatch is a range for the profiler and an event for the tracer
    n_dot = sum(1 for e in evs if e[0] == "op.blas_dot")
    assert n_dot and n_dot == names["blas_dot"]


def test_solve_index_counts_this_processs_solves():
    solver, b = _stencil_solver(16)
    tracer = trace.enable()
    solver.solve(b)
    solver.solve(b)
    trace.disable()
    a, c = [e["args"]["solve"] for e in tracer.events if e["name"] == "solve"]
    assert c == a + 1


class _FakeEvent:
    """A timing event whose completion and time the test sets."""

    def __init__(self):
        self.done, self.at, self.records, self.waits = False, 0.0, 0, 0

    def record(self, stream):
        self.records += 1

    def query(self):
        return self.done

    def synchronize(self):
        self.waits += 1
        self.done = True

    def elapsed_time(self, end):
        return end.at - self.at  # ms


def test_device_spans_fold_completed_pairs_and_pool_them():
    made = []

    def event():
        made.append(_FakeEvent())
        return made[-1]

    ds = trace._DeviceSpans(event=event, stream=lambda dev: None)
    ds.FOLD_AT = 1  # fold at every close
    x = torch.ones(2)
    first = ds.open(x)
    ds.close("precond.apply", first)
    a, b = first[2]
    assert len(ds._pending) == 1 and ds._totals == {}  # not complete yet
    b.at, b.done = 2.5, True
    second = ds.open(x)  # a new pair: the first is not back in the pool
    assert second[2][0] is not a and len(made) == 4
    ds.close("precond.apply", second)  # folds the first, the second waits
    assert ds._totals == {"precond.apply": [1, 2.5e-3]}
    assert len(ds._pending) == 1
    second[2][1].at = 1.0
    tot = ds.totals()  # waits for the pair still in flight
    assert tot == {"precond.apply": {"count": 2, "device_s": 3.5e-3}}
    assert second[2][1].waits == 1 and not ds._pending
    third = ds.open(x)  # from the pool: no event made
    assert len(made) == 4 and third[2] in ((a, b), second[2])
    ds.close("cg.stop_test", third)
    ds.reset()
    assert ds.totals() == {}


def test_device_spans_fold_in_batches_and_bound_their_pending_pairs():
    ds = trace._DeviceSpans(event=_FakeEvent, stream=lambda dev: None)
    x = torch.ones(2)
    for _ in range(ds.FOLD_AT - 1):
        ds.close("s", ds.open(x))
    assert len(ds._pending) == ds.FOLD_AT - 1 and not ds._totals
    ds.FOLD_AT, ds.MAX_PENDING = 2, 3
    for _ in range(10):
        ds.close("s", ds.open(x))  # none completes: each close waits
    assert len(ds._pending) <= 3
    assert ds.totals()["s"]["count"] == 10 + 31


def test_a_cpu_tensor_is_not_device_timed():
    tracer = trace.enable()
    with trace.span("precond.apply", device_of=torch.ones(3)):
        pass
    trace.disable()
    assert [e["name"] for e in tracer.events] == ["precond.apply"]
    assert "precond.apply" not in trace.device_span_totals()
