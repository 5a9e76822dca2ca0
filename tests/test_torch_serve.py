"""The port's solve serving against the JAX package's.

Mirrors ``tests/serve/`` (setup cache, engine, service, the ParILU and AMG
lanes) on the port in its two CPU spaces, and holds it against the JAX
package on the same inputs:

* ``pattern_key`` / ``values_fingerprint`` digests and ``generate_traffic``
  arrays are equal;
* ``amg_serve_pattern`` tables are equal; ``amg_serve_factors`` and
  ``batch_amg_apply`` agree within 1e-6 relative to the largest entry (f32
  sums in another order);
* on the ``BENCH_pr10.json`` serve stream (32 requests of 24 rows, the
  JAX engine run once on its XLA executor) every request takes the JAX
  engine's iterations within 1 and ``‖x − x_jax‖ ≤ 1e-5 ‖x_jax‖``, with the
  same cache-hit flags;
* the four serve pins — 3 cold generate launches, 0 for a full-hit
  request, 3 pattern misses, a hit rate of 0.9062 — computed live from the
  JAX engine and equal to the port's through its own dispatch log.

Within the port: busy = solo, cache hit = cold and service = inline, each
bit for bit; a torch-space service dispatches nothing outside its space and
never looks up an ambient executor.
"""

import copy
import functools
import json
import os
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import make_executor as jax_make_executor
from repro.precond import amg as jamg
from repro.serve import ContinuousBatchEngine as JaxEngine
from repro.serve import ServeConfig as JaxServeConfig
from repro.serve import TrafficConfig as JaxTrafficConfig
from repro.serve import cache as jcache
from repro.serve import generate_traffic as jax_generate_traffic
from repro.solvers import Stop as JStop
from repro_torch import batch, precond
from repro_torch.core import executor as executor_mod
from repro_torch.core import make_executor
from repro_torch.launch import solve_serve
from repro_torch.observability import metrics, trace
from repro_torch.precond import amg as tamg
from repro_torch.serve import (
    ContinuousBatchEngine,
    PatternSetup,
    ServeConfig,
    SetupCache,
    SolveRequest,
    SolveService,
    TrafficConfig,
    generate_traffic,
    pattern_key,
    values_fingerprint,
)
from repro_torch.solvers import Stop
from repro_torch.sparse.gallery import poisson_2d

BENCH_PR10 = os.path.join(os.path.dirname(__file__), "..", "BENCH_pr10.json")
STOP = Stop(max_iters=200, reduction_factor=1e-5)
PRECOND_STOP = Stop(max_iters=300, reduction_factor=1e-6)
SPACES = ("torch", "reference")
#: the BENCH serve record's stream and engine (benchmarks/report.py)
PIN_TRAFFIC = dict(num_requests=32, gallery_size=3, repeat_ratio=0.6, n=24, seed=5)
PIN_CONFIG = dict(slots=4, chunk_sweeps=4)
PIN_STOP = (300, 1e-5)
X_RTOL = 1e-5


@pytest.fixture(autouse=True)
def _one_thread_clean_state():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    metrics.reset()
    trace.reset()
    yield
    metrics.reset()
    trace.reset()
    torch.set_num_threads(prev)


def _ex(space="torch"):
    return make_executor(space, device="cpu")


def _traffic(num, seed=0, gallery=2, repeat=0.5, n=16):
    return generate_traffic(TrafficConfig(num_requests=num, gallery_size=gallery,
                                          repeat_ratio=repeat, n=n, seed=seed))


def _dense(req) -> np.ndarray:
    a = np.zeros(req.shape, np.float64)
    for i in range(req.shape[0]):
        lo, hi = int(req.indptr[i]), int(req.indptr[i + 1])
        a[i, req.indices[lo:hi]] = req.values[lo:hi]
    return a


def _true_residual(req, x) -> float:
    """‖b − A x‖ / ‖b‖ in f64."""
    b = req.b.astype(np.float64)
    return float(np.linalg.norm(b - _dense(req) @ x.astype(np.float64))
                 / np.linalg.norm(b))


def _poisson_requests(count, seed=0, scale=None):
    indptr, indices, values, shape = poisson_2d(8)
    rng = np.random.default_rng(seed)
    out = []
    for i in range(count):
        vals = values.astype(np.float32)
        if scale is not None:
            vals = vals * np.float32(scale[i % len(scale)])
        out.append(SolveRequest(indptr=indptr, indices=indices, values=vals,
                                b=rng.normal(size=shape[0]).astype(np.float32),
                                shape=shape))
    return out


# -- against the JAX package: keys, traffic, AMG tables ---------------------------


@pytest.mark.parametrize("config", ["", "csr|block_jacobi|bs4", "ell|amg|bs8"])
def test_digests_equal_the_jax_package(config):
    for (_, req) in _traffic(6, seed=3, gallery=3):
        assert pattern_key(req.indptr, req.indices, req.shape, config) == \
            jcache.pattern_key(req.indptr, req.indices, req.shape, config)
        # int32 index arrays hash as their int64 copies, as in the JAX package
        assert pattern_key(req.indptr.astype(np.int32),
                           req.indices.astype(np.int32), req.shape, config) == \
            jcache.pattern_key(req.indptr, req.indices, req.shape, config)
        assert values_fingerprint(req.values) == \
            jcache.values_fingerprint(req.values)
    assert pattern_key(np.arange(3), np.arange(2), (2, 2), "a") != \
        pattern_key(np.arange(3), np.arange(2), (2, 2), "b")


@pytest.mark.parametrize("cfg", [
    dict(num_requests=40, gallery_size=4, repeat_ratio=0.6, n=24, seed=0),
    dict(num_requests=24, gallery_size=8, repeat_ratio=0.3, n=17, seed=9,
         rate_hz=50.0),
    dict(num_requests=30, gallery_size=2, repeat_ratio=0.5, n=25, seed=3,
         nonsym_ratio=0.7),
])
def test_traffic_equals_the_jax_generator(cfg):
    ours = generate_traffic(TrafficConfig(**cfg))
    theirs = jax_generate_traffic(JaxTrafficConfig(**cfg))
    assert len(ours) == len(theirs) == cfg["num_requests"]
    for (g, a), (gj, b) in zip(ours, theirs):
        assert g == gj and a.shape == b.shape
        for f in ("indptr", "indices", "values", "b"):
            x, y = getattr(a, f), getattr(b, f)
            assert x.dtype == y.dtype and np.array_equal(x, y), f


@pytest.mark.parametrize("n", [17, 1024])
def test_spd_banded_equals_the_jax_gallery(n):
    """The port builds the serve family's CSR arrays from the band structure
    (no scan of the dense matrix); every offset set of the gallery gives the
    JAX package's arrays, bit for bit, at a test's size and the chip's."""
    from repro.sparse import gallery as jgallery
    from repro_torch.sparse import gallery as tgallery

    assert tgallery.BANDED_OFFSETS == jgallery.BANDED_OFFSETS
    for g, offsets in enumerate(tgallery.BANDED_OFFSETS + ((2, 1), (1, 1, 3))):
        shift = 3.0 + g
        ours = tgallery.spd_banded(n, offsets, shift, np.random.default_rng(g))
        theirs = jgallery.spd_banded(n, offsets, shift, np.random.default_rng(g))
        assert ours[3] == theirs[3]
        for a, b in zip(ours[:3], theirs[:3]):
            assert a.dtype == b.dtype and np.array_equal(a, b), offsets


def test_nonsym_ratio_requires_square_grid_size():
    with pytest.raises(ValueError, match="square"):
        generate_traffic(TrafficConfig(num_requests=2, gallery_size=1, n=17,
                                       nonsym_ratio=0.5))
    with pytest.raises(ValueError, match="exceeds"):
        generate_traffic(TrafficConfig(num_requests=2, gallery_size=9))


@pytest.mark.parametrize("n_side", [8, 12])
def test_amg_serve_half_against_the_jax_package(n_side):
    """The pattern tier's tables are the JAX package's; the values tier's
    factor row and the batched two-level apply agree within 1e-6 of the
    largest entry (f32, fixed-order segment sums against XLA's)."""
    ip, ix, v, shape = poisson_2d(n_side)
    n = shape[0]
    pat = tamg.amg_serve_pattern(ip, ix, n)
    jpat = jamg.amg_serve_pattern(ip, ix, n)
    for f in ("agg", "coarse_indptr", "coarse_indices", "seg", "diag_slots"):
        assert np.array_equal(getattr(pat, f), getattr(jpat, f)), f
    assert (pat.n_agg, pat.flat_len) == (jpat.n_agg, jpat.flat_len)
    rng = np.random.default_rng(n_side)
    rows = []
    for _ in range(3):
        vals = (v * rng.uniform(0.8, 1.25, v.size)).astype(np.float32)
        got = tamg.amg_serve_factors(pat, torch.from_numpy(vals)).numpy()
        want = np.asarray(jamg.amg_serve_factors(jpat, jnp.asarray(vals)))
        assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
        rows.append(want)
    flat = np.stack(rows)
    R = rng.normal(size=(3, n)).astype(np.float32)
    got = tamg.batch_amg_apply(pat, torch.from_numpy(flat), torch.from_numpy(R))
    want = np.asarray(jamg.batch_amg_apply(jpat, jnp.asarray(flat), jnp.asarray(R)))
    assert np.abs(got.numpy() - want).max() <= 1e-6 * np.abs(want).max()
    # at one batch size a row's apply depends neither on its position nor
    # on the other rows, even NaN ones (a frozen slot after 0/0)
    perm = [1, 0, 2]
    R2 = R[perm].copy()
    R2[1] = np.nan
    moved = tamg.batch_amg_apply(pat, torch.from_numpy(flat[perm]),
                                 torch.from_numpy(R2))
    assert torch.equal(moved[0], got[1]) and torch.equal(moved[2], got[2])
    assert torch.isnan(moved[1]).all()


# -- against the JAX package: the BENCH stream and its pins ------------------------


def _pin_run(engine, traffic, log):
    """The BENCH serve record's protocol: the stream cold, then a guaranteed
    full-hit request (the first arrival's matrix); generate launches from
    the executor's dispatch log."""
    hit_req = copy.deepcopy(traffic[0][1])
    log.clear()
    for _, req in traffic:
        engine.submit(req)
    responses = engine.drain()
    cold = dict(log).get("serve_generate_pattern", 0)
    log.clear()
    engine.submit(hit_req)
    (hit,) = engine.drain()
    hit_log = dict(log)
    num = len(responses)
    p_hits = sum(r.pattern_hit for r in responses)
    pins = {
        "serve_cold_generate_launches": int(cold),
        "serve_hit_request_generate_launches": int(
            hit_log.get("serve_generate_pattern", 0)
            + hit_log.get("serve_generate_factors", 0)),
        "serve_pattern_misses": int(num - p_hits),
        "serve_pattern_hit_rate": round(p_hits / num, 4),
        "serve_all_converged": bool(all(r.converged for r in responses)
                                    and hit.converged),
        "serve_hit_request_full_hit": bool(hit.pattern_hit and hit.factors_hit),
    }
    return {r.request_id: r for r in responses}, pins


@functools.lru_cache(maxsize=None)
def _jax_pin_run():
    ex = jax_make_executor("xla")
    engine = JaxEngine(JaxServeConfig(**PIN_CONFIG, stop=JStop(*PIN_STOP)),
                       executor=ex)
    return _pin_run(engine, jax_generate_traffic(JaxTrafficConfig(**PIN_TRAFFIC)),
                    ex.dispatch_log)


@pytest.mark.parametrize("space", SPACES)
def test_bench_serve_pins_against_the_jax_engine(space):
    """The four serve pins of ``BENCH_pr10.json``, computed live from the
    JAX engine, through the port's own dispatch log; per request the JAX
    engine's iterations within 1, x within X_RTOL, the same hit flags."""
    jax_responses, jax_pins = _jax_pin_run()
    with open(BENCH_PR10) as f:
        bench = json.load(f)["pinned"]
    ex = _ex(space)
    engine = ContinuousBatchEngine(ServeConfig(**PIN_CONFIG, stop=Stop(*PIN_STOP)),
                                   executor=ex)
    responses, pins = _pin_run(engine, generate_traffic(TrafficConfig(**PIN_TRAFFIC)),
                               ex.dispatch_log)
    assert pins == jax_pins == {k: bench[k] for k in pins}
    assert pins["serve_cold_generate_launches"] == 3
    assert pins["serve_hit_request_generate_launches"] == 0
    assert pins["serve_pattern_misses"] == 3
    assert pins["serve_pattern_hit_rate"] == 0.9062
    assert responses.keys() == jax_responses.keys()
    for rid, want in jax_responses.items():
        got = responses[rid]
        assert abs(got.iterations - want.iterations) <= 1, rid
        assert (np.linalg.norm(got.x - want.x)
                <= X_RTOL * np.linalg.norm(want.x)), rid
        assert (got.pattern_hit, got.factors_hit) == (want.pattern_hit,
                                                      want.factors_hit)


# -- the setup cache ---------------------------------------------------------------


def _stub_entry(tag: int) -> PatternSetup:
    n = 4
    return PatternSetup(key="", indptr=np.arange(n + 1, dtype=np.int64),
                        indices=np.full(n, tag % n, np.int64), shape=(n, n),
                        fmt="csr")


def test_pattern_tier_hit_miss_accounting():
    cache = SetupCache(capacity=8)
    for k in ("a", "b", "a", "c", "a", "b"):
        cache.setup(k, build=lambda: _stub_entry(0))
    stats = cache.stats()
    assert stats["serve_cache_misses_pattern"] == 3
    assert stats["serve_cache_hits_pattern"] == 3
    assert stats["serve_cache_evictions_pattern"] == 0
    assert metrics.counter("serve_cache_hits", tier="pattern").value == 3


def test_pattern_tier_lru_eviction_order():
    cache = SetupCache(capacity=2)
    cache.setup("a", build=lambda: _stub_entry(0))
    cache.setup("b", build=lambda: _stub_entry(1))
    assert cache.keys == ("a", "b")
    _, hit = cache.setup("a", build=lambda: _stub_entry(0))
    assert hit
    cache.setup("c", build=lambda: _stub_entry(2))  # evicts b
    assert cache.keys == ("a", "c") and "b" not in cache
    assert cache.stats()["serve_cache_evictions_pattern"] == 1
    _, hit = cache.setup("b", build=lambda: _stub_entry(1))
    assert not hit and cache.keys == ("c", "b")


def test_values_tier_lru_and_accounting():
    cache = SetupCache(capacity=4, factors_capacity=2)
    entry, _ = cache.setup("p", build=lambda: _stub_entry(0))

    def mk(v):
        return torch.full((1, 2, 2), float(v))

    cache.factors(entry, "f1", build=lambda: mk(1))
    cache.factors(entry, "f2", build=lambda: mk(2))
    inv, hit = cache.factors(entry, "f1", build=lambda: mk(-1))
    assert hit and float(inv[0, 0, 0]) == 1.0  # cached, not rebuilt
    cache.factors(entry, "f3", build=lambda: mk(3))  # evicts f2
    assert tuple(entry.factors) == ("f1", "f3")
    stats = cache.stats()
    assert stats["serve_cache_misses_values"] == 3
    assert stats["serve_cache_hits_values"] == 1
    assert stats["serve_cache_evictions_values"] == 1


def test_capacity_validation():
    with pytest.raises(ValueError):
        SetupCache(capacity=0)
    with pytest.raises(ValueError):
        SetupCache(capacity=4, factors_capacity=0)


def _one_request(seed: int) -> SolveRequest:
    return generate_traffic(TrafficConfig(num_requests=1, gallery_size=1,
                                          repeat_ratio=0.0, n=16,
                                          seed=seed))[0][1]


@pytest.mark.parametrize("space", SPACES)
@pytest.mark.parametrize("fmt", ["csr", "ell"])
def test_cache_hit_solve_bitwise_identical_to_cold(space, fmt):
    """A warm cache changes nothing about the numbers: the hit request
    launches no generate operation and gives the cold solution bit for
    bit; the cold request launched one of each."""
    ex = _ex(space)
    config = ServeConfig(slots=4, chunk_sweeps=3, fmt=fmt, stop=STOP)
    req = _one_request(0)
    cold = ContinuousBatchEngine(config, executor=ex)
    ex.dispatch_log.clear()
    cold.submit(copy.deepcopy(req))
    (r_cold,) = cold.drain()
    assert r_cold.converged and not r_cold.pattern_hit and not r_cold.factors_hit
    assert ex.dispatch_log["serve_generate_pattern"] == 1
    assert ex.dispatch_log["serve_generate_factors"] == 1

    warm = ContinuousBatchEngine(config, executor=ex, cache=cold.cache)
    ex.dispatch_log.clear()
    warm.submit(copy.deepcopy(req))
    (r_warm,) = warm.drain()
    assert r_warm.pattern_hit and r_warm.factors_hit
    assert ex.dispatch_log.get("serve_generate_pattern", 0) == 0
    assert ex.dispatch_log.get("serve_generate_factors", 0) == 0
    assert np.array_equal(r_cold.x, r_warm.x)
    assert (r_cold.iterations, r_cold.residual_norm) == (r_warm.iterations,
                                                         r_warm.residual_norm)


def test_engine_traffic_hit_accounting():
    engine = ContinuousBatchEngine(ServeConfig(slots=4, chunk_sweeps=4, stop=STOP),
                                   executor=_ex())
    for _, req in _traffic(16, seed=1, gallery=2, repeat=0.6):
        engine.submit(req)
    responses = engine.drain()
    assert len(responses) == 16
    p_hits = sum(r.pattern_hit for r in responses)
    f_hits = sum(r.factors_hit for r in responses)
    stats = engine.cache.stats()
    assert stats["serve_cache_hits_pattern"] == p_hits
    assert stats["serve_cache_misses_pattern"] == 16 - p_hits
    assert stats["serve_cache_hits_values"] == f_hits
    assert p_hits > 0 and f_hits > 0


# -- the engine --------------------------------------------------------------------


def test_mixed_stream_drains_and_converges():
    engine = ContinuousBatchEngine(ServeConfig(slots=4, chunk_sweeps=4, stop=STOP),
                                   executor=_ex())
    traffic = _traffic(20, seed=2, gallery=3, repeat=0.6)
    ids = [engine.submit(req) for _, req in traffic]
    by_id = {r.request_id: r for r in engine.drain()}
    assert sorted(by_id) == sorted(ids)
    for (_, req), rid in zip(traffic, ids):
        assert by_id[rid].converged
        assert _true_residual(req, by_id[rid].x) <= 1e-4
    assert metrics.counter("serve_solves").value == 20
    assert metrics.counter("serve_failures").value == 0


def test_more_requests_than_slots():
    engine = ContinuousBatchEngine(ServeConfig(slots=2, chunk_sweeps=3, stop=STOP),
                                   executor=_ex())
    ids = [engine.submit(req) for _, req in _traffic(9, seed=4, repeat=0.4)]
    responses = engine.drain()
    assert sorted(r.request_id for r in responses) == sorted(ids)
    assert all(r.converged for r in responses)


BUSY_LANES = [
    dict(fmt="csr", precond="block_jacobi", solver="cg"),
    dict(fmt="ell", precond="block_jacobi", solver="cg"),
    dict(fmt="ell", precond="block_jacobi", solver="bicgstab"),
    dict(fmt="csr", precond="amg", solver="cg"),
    dict(fmt="csr", precond="parilu", solver="bicgstab"),
]


@pytest.mark.parametrize("space", SPACES)
@pytest.mark.parametrize("lane", BUSY_LANES,
                         ids=lambda d: "-".join(d.values()))
def test_busy_vs_solo_serve_bitwise(space, lane):
    """A request in a busy lane (other systems in flight, any slot, any
    admission tick) equals the same request served alone in an engine of
    the same configuration, bit for bit."""
    ex = _ex(space)
    config = ServeConfig(slots=4, chunk_sweeps=3, stop=STOP, **lane)
    if lane["precond"] == "block_jacobi":
        reqs = [req for _, req in _traffic(8, seed=7)]
    else:
        reqs = _poisson_requests(6, seed=3, scale=(1.0, 1.5))
    solo_reqs = [copy.deepcopy(r) for r in reqs]
    busy = ContinuousBatchEngine(config, executor=ex)
    ids = [busy.submit(r) for r in reqs]
    busy_by_id = {r.request_id: r for r in busy.drain()}
    solo_cache = SetupCache()  # deterministic products: sharing changes no bit
    for req, rid in zip(solo_reqs, ids):
        solo = ContinuousBatchEngine(config, executor=ex, cache=solo_cache)
        solo.submit(req)
        (solo_resp,) = solo.drain()
        b = busy_by_id[rid]
        assert b.converged and np.array_equal(b.x, solo_resp.x), rid
        assert (b.iterations, b.residual_norm) == (solo_resp.iterations,
                                                   solo_resp.residual_norm)


@pytest.mark.parametrize("kernel", ["spmv_batch_ell", "axpy_norm_rows",
                                    "block_jacobi_apply"])
def test_nan_row_stays_in_its_row(kernel):
    """A frozen slot may hold NaN after 0/0: the lane kernels' wrappers (the
    plain versions on the CPU) keep it in its row, the other rows bitwise
    those of the NaN-free call."""
    from repro_torch import kernels as K

    gen = torch.Generator().manual_seed(3)
    S, m, k, bs = 6, 24, 3, 4
    r = 2
    keep = torch.ones(S, dtype=torch.bool)
    keep[r] = False
    if kernel == "spmv_batch_ell":
        cols = torch.randint(0, m, (m, k), generator=gen, dtype=torch.int32)
        vals = torch.randn(S, m, k, generator=gen)
        X = torch.randn(S, m, generator=gen)
        Xn, valsn = X.clone(), vals.clone()
        Xn[r], valsn[r] = float("nan"), float("nan")
        outs = [(K.spmv_batch_ell(cols, vals, X), K.spmv_batch_ell(cols, valsn, Xn))]
    elif kernel == "axpy_norm_rows":
        alpha = torch.randn(S, generator=gen)
        X, Y = torch.randn(S, m, generator=gen), torch.randn(S, m, generator=gen)
        Xn = X.clone()
        Xn[r] = float("nan")
        outs = list(zip(K.axpy_norm_rows(alpha, X, Y), K.axpy_norm_rows(alpha, Xn, Y)))
    else:
        nbl = m // bs
        inv = torch.randn(S * nbl, bs, bs, generator=gen)
        vp = torch.randn(S * nbl, bs, generator=gen)
        vpn = vp.clone()
        vpn[r * nbl:(r + 1) * nbl] = float("nan")
        outs = [(K.block_jacobi_apply(inv, vp), K.block_jacobi_apply(inv, vpn))]
        keep = keep.repeat_interleave(nbl)
    for clean, dirty in outs:
        assert torch.equal(clean[keep], dirty[keep])
        assert torch.isnan(dirty[~keep]).all()


@pytest.mark.parametrize("space", SPACES)
def test_admission_mid_flight_leaves_other_slots_bitwise(space):
    """Refresh takes the new state for the admitted rows only: the rows in
    flight keep their iterates bit for bit (no write into the state)."""
    ex = _ex(space)
    engine = ContinuousBatchEngine(
        ServeConfig(slots=4, chunk_sweeps=2, stop=STOP), executor=ex)
    traffic = _traffic(3, seed=11, gallery=1, repeat=0.0)
    for _, req in traffic[:2]:
        engine.submit(req)
    engine.tick()  # admits both, two sweeps
    (lane,) = engine.lanes.values()
    before = [t.clone() for t in (lane.state.X, lane.state.R, lane.state.P,
                                  lane.state.rnorm, lane.state.iters)]
    kept = [t for t in (lane.state.X, lane.state.R)]
    engine.submit(traffic[2][1])
    engine._admit(lane)
    after = (lane.state.X, lane.state.R, lane.state.P, lane.state.rnorm,
             lane.state.iters)
    for old, new in zip(before, after):
        assert torch.equal(old[:2], new[:2])
    assert not torch.equal(before[0][2], after[0][2]) or not bool(
        before[3][2] == after[3][2])
    assert int(after[4][2]) == 0 and torch.isfinite(lane.thresh[2])
    for old, t in zip(before[:2], kept):  # the replaced tensors were not written
        assert torch.equal(old, t)


def test_solo_serve_matches_batch_cg():
    """Iterations equal the standalone preconditioned batch_cg's; iterates
    agree to rounding (the slot count differs, so bits are not claimed)."""
    ex = _ex()
    config = ServeConfig(slots=4, chunk_sweeps=3, stop=STOP, block_size=4)
    req = _traffic(1, seed=5, gallery=1, repeat=0.0)[0][1]
    engine = ContinuousBatchEngine(config, executor=ex)
    engine.submit(copy.deepcopy(req))
    (resp,) = engine.drain()
    A = batch.BatchCsr(torch.as_tensor(req.indptr.astype(np.int32)),
                       torch.as_tensor(req.indices.astype(np.int32)),
                       torch.as_tensor(req.values)[None, :], req.shape)
    M = precond.batch_block_jacobi(A, 4, executor=ex)
    ref = batch.batch_cg(A, torch.as_tensor(req.b)[None, :], stop=STOP, M=M,
                         executor=ex)
    assert resp.converged and bool(ref.converged[0])
    assert resp.iterations == int(ref.iterations[0])
    np.testing.assert_allclose(resp.x, ref.x[0].numpy(), rtol=1e-5, atol=1e-6)


def test_iteration_cap_retires_unconverged():
    engine = ContinuousBatchEngine(
        ServeConfig(slots=2, chunk_sweeps=1,
                    stop=Stop(max_iters=3, reduction_factor=1e-30)),
        executor=_ex())
    engine.submit(_traffic(1, seed=6, gallery=1, repeat=0.0)[0][1])
    (resp,) = engine.drain()
    assert not resp.converged and resp.iterations == 3
    assert metrics.counter("serve_failures").value == 1


def test_latency_histogram_feeds_quantiles():
    engine = ContinuousBatchEngine(ServeConfig(slots=4, chunk_sweeps=4, stop=STOP),
                                   executor=_ex())
    for _, req in _traffic(6, seed=8):
        engine.submit(req)
    engine.drain()
    metrics.reset()
    for _, req in _traffic(6, seed=88):
        engine.submit(req)
    responses = engine.drain()
    assert all(r.latency_s is not None and r.latency_s > 0 for r in responses)
    h = metrics.histogram("serve_latency_s")
    p50, p99 = h.quantile(0.5), h.quantile(0.99)
    assert p50 is not None and 0 < p50 <= p99 < 1.0


def test_ell_lane_agrees_with_csr():
    req = _traffic(1, seed=9, gallery=1, repeat=0.0)[0][1]
    results = {}
    for fmt in ("csr", "ell"):
        engine = ContinuousBatchEngine(
            ServeConfig(slots=2, chunk_sweeps=4, stop=STOP, fmt=fmt),
            executor=_ex())
        engine.submit(copy.deepcopy(req))
        (results[fmt],) = engine.drain()
    assert results["csr"].converged and results["ell"].converged
    np.testing.assert_allclose(results["ell"].x, results["csr"].x,
                               rtol=1e-5, atol=1e-6)


def test_nonsym_traffic_served_by_bicgstab_engine():
    engine = ContinuousBatchEngine(
        ServeConfig(slots=3, chunk_sweeps=4, solver="bicgstab", fmt="ell",
                    stop=Stop(max_iters=300, reduction_factor=1e-5)),
        executor=_ex())
    traffic = generate_traffic(TrafficConfig(num_requests=12, gallery_size=2,
                                             repeat_ratio=0.0, n=25, seed=3,
                                             nonsym_ratio=0.7))
    nonsym = sum(1 for _, r in traffic
                 if not np.allclose(_dense(r), _dense(r).T, atol=1e-6))
    assert nonsym >= 3
    by_id = {engine.submit(req): req for _, req in traffic}
    responses = engine.drain()
    assert len(responses) == len(traffic)
    for resp in responses:
        assert resp.converged
        assert _true_residual(by_id[resp.request_id], resp.x) <= 1e-4


def test_degenerate_stop_rejected_at_construction():
    with pytest.raises(ValueError):
        ContinuousBatchEngine(ServeConfig(
            stop=Stop(max_iters=10, reduction_factor=0.0, abs_tol=0.0)),
            executor=_ex())


def test_engine_traces_admits_and_requests(tmp_path):
    """While tracing, each admission is an instant event and each request a
    complete span from submit to retire; the exported trace is valid."""
    path = str(tmp_path / "serve.json")
    with trace.tracing(path) as tracer:
        engine = ContinuousBatchEngine(
            ServeConfig(slots=2, chunk_sweeps=4, stop=STOP, fmt="ell"),
            executor=_ex())
        for _, req in _traffic(5, seed=12):
            engine.submit(req)
        engine.drain()
        names = [e["name"] for e in tracer.events]
    assert names.count("serve.admit") == 5 and names.count("serve.request") == 5
    assert {"spmv_batch_ell", "axpy_norm", "block_jacobi_apply",
            "serve_generate_pattern"} <= set(names)
    assert trace.validate_trace(path) == []


# -- the ParILU and AMG lanes --------------------------------------------------------


@pytest.mark.parametrize("precond,solver", [("parilu", "bicgstab"),
                                            ("parilu", "cg"), ("amg", "cg")])
def test_lane_converges_to_true_solution(precond, solver):
    engine = ContinuousBatchEngine(
        ServeConfig(slots=4, chunk_sweeps=4, solver=solver, precond=precond,
                    stop=PRECOND_STOP), executor=_ex())
    reqs = _poisson_requests(5, seed=1)
    ids = [engine.submit(r) for r in reqs]
    by_id = {r.request_id: r for r in engine.drain()}
    assert sorted(by_id) == sorted(ids)
    for req, rid in zip(reqs, ids):
        assert by_id[rid].converged
        assert _true_residual(req, by_id[rid].x) <= 1e-4


@pytest.mark.parametrize("precond,solver", [("parilu", "bicgstab"), ("amg", "cg")])
def test_cached_hit_launches_zero_generate_dispatches(precond, solver):
    ex = _ex()
    engine = ContinuousBatchEngine(
        ServeConfig(slots=2, chunk_sweeps=4, solver=solver, precond=precond,
                    stop=PRECOND_STOP), executor=ex)
    cold, warm = _poisson_requests(2, seed=2)
    engine.submit(cold)
    (cold_resp,) = engine.drain()
    assert not cold_resp.pattern_hit and not cold_resp.factors_hit
    ex.dispatch_log.clear()
    engine.submit(warm)
    (warm_resp,) = engine.drain()
    assert warm_resp.pattern_hit and warm_resp.factors_hit
    assert ex.dispatch_log.get("serve_generate_pattern", 0) == 0
    assert ex.dispatch_log.get("serve_generate_factors", 0) == 0


def test_same_pattern_new_values_regenerates_factors_only():
    ex = _ex()
    engine = ContinuousBatchEngine(
        ServeConfig(slots=2, chunk_sweeps=4, solver="cg", precond="amg",
                    stop=PRECOND_STOP), executor=ex)
    r1, r2 = _poisson_requests(2, seed=3, scale=(1.0, 2.5))
    engine.submit(r1)
    engine.drain()
    ex.dispatch_log.clear()
    engine.submit(r2)
    (resp,) = engine.drain()
    assert resp.converged and resp.pattern_hit and not resp.factors_hit
    assert ex.dispatch_log.get("serve_generate_pattern", 0) == 0
    assert ex.dispatch_log.get("serve_generate_factors", 0) == 1


def test_parilu_and_amg_share_cache_namespace():
    ex = _ex()
    cache = SetupCache()
    reqs = _poisson_requests(2, seed=4)
    e1 = ContinuousBatchEngine(ServeConfig(slots=2, solver="cg", precond="amg",
                                           stop=PRECOND_STOP),
                               executor=ex, cache=cache)
    e2 = ContinuousBatchEngine(ServeConfig(slots=2, solver="bicgstab",
                                           precond="parilu", stop=PRECOND_STOP),
                               executor=ex, cache=cache)
    e1.submit(reqs[0])
    (ra,) = e1.drain()
    e2.submit(reqs[1])
    (rb,) = e2.drain()
    assert ra.converged and rb.converged and not rb.pattern_hit
    assert len(cache) == 2


def test_unknown_precond_rejected():
    engine = ContinuousBatchEngine(ServeConfig(slots=2, precond="ilu0", stop=STOP),
                                   executor=_ex())
    with pytest.raises(ValueError, match="unknown serve preconditioner"):
        engine.submit(_poisson_requests(1)[0])


# -- the service ---------------------------------------------------------------------

CONFIG = ServeConfig(slots=4, chunk_sweeps=4, stop=STOP)


def test_submit_gather_round_trip():
    traffic = _traffic(10, seed=11)
    with SolveService(CONFIG, executor=_ex()) as svc:
        ids = [svc.submit(req) for _, req in traffic]
        responses = svc.gather(ids, timeout=120.0)
    assert [r.request_id for r in responses] == ids
    assert all(r.converged and r.latency_s > 0 for r in responses)


@pytest.mark.parametrize("space", SPACES)
def test_service_matches_inline_engine(space):
    """The queue is plumbing only: the responses are the inline engine's
    for the same submissions, bit for bit."""
    traffic = _traffic(8, seed=12)
    ex = _ex(space)
    engine = ContinuousBatchEngine(CONFIG, executor=ex)
    for _, req in traffic:
        engine.submit(copy.deepcopy(req))
    inline = {r.request_id: r for r in engine.drain()}
    with SolveService(CONFIG, executor=ex) as svc:
        served = svc.gather([svc.submit(req) for _, req in traffic], timeout=120.0)
    assert {r.request_id for r in served} == set(inline)
    for resp in served:
        ref = inline[resp.request_id]
        assert np.array_equal(resp.x, ref.x)
        assert resp.iterations == ref.iterations


def test_torch_space_service_dispatches_only_torch_space(monkeypatch):
    """The worker thread inherits no executor context, so every call on its
    path must take the service's executor: with the ambient lookup made to
    fail, a traced torch-space service still serves, and each dispatch it
    logs was served by the torch (or reference) space."""
    def no_ambient():
        raise AssertionError("the serve path looked up an ambient executor")

    ex = _ex("torch")
    svc = SolveService(ServeConfig(slots=4, chunk_sweeps=4, stop=STOP, fmt="ell"),
                       executor=ex)
    monkeypatch.setattr(executor_mod, "default_executor", no_ambient)
    monkeypatch.setattr(executor_mod, "current_executor", no_ambient)
    trace.enable()
    with svc:
        responses = svc.gather([svc.submit(req) for _, req in _traffic(6, seed=13)],
                               timeout=120.0)
    assert all(r.converged for r in responses)
    events = list(ex.dispatch_events)
    assert events and {e.space for e in events} <= {"torch", "reference"}
    assert {e.executor for e in events} == {"TorchExecutor"}
    assert {e.target for e in events} == {"cpu_torch"}
    assert sum(ex.dispatch_log.values()) == len(events)
    assert "spmv_batch_ell" in ex.dispatch_log


def test_worker_death_reaches_the_caller(monkeypatch):
    """An error on the worker (here an unknown preconditioner) reaches the
    caller blocked on ``result`` instead of a timeout."""
    monkeypatch.setattr(threading, "excepthook", lambda args: None)
    svc = SolveService(ServeConfig(slots=2, precond="ilu0", stop=STOP),
                       executor=_ex())
    with svc:
        rid = svc.submit(_poisson_requests(1)[0])
        with pytest.raises(RuntimeError, match="worker died"):
            svc.result(rid, timeout=60.0)


def test_concurrent_submitters_each_get_their_responses():
    """Eight client threads submit and gather at once, with a short switch
    interval: every request gets one id and its own response."""
    import sys

    traffic = _traffic(32, seed=14)
    chunks = [traffic[i::8] for i in range(8)]
    got, errors = {}, []
    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with SolveService(CONFIG, executor=_ex()) as svc:
            def client(chunk):
                try:
                    ids = [svc.submit(req) for _, req in chunk]
                    for rid, resp in zip(ids, svc.gather(ids, timeout=120.0)):
                        got[rid] = resp
                except Exception as e:  # reported below
                    errors.append(e)

            threads = [threading.Thread(target=client, args=(c,)) for c in chunks]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=180.0)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(prev)
    assert not errors
    assert sorted(got) == list(range(32))
    assert all(r.request_id == rid and r.converged for rid, r in got.items())


def test_result_timeout():
    with SolveService(CONFIG, executor=_ex()) as svc:
        with pytest.raises(TimeoutError):
            svc.result(10_000, timeout=0.05)


def test_submit_before_start_raises():
    svc = SolveService(CONFIG, executor=_ex())
    with pytest.raises(RuntimeError):
        svc.submit(_traffic(1, seed=13)[0][1])


# -- the entry point -----------------------------------------------------------------


@pytest.mark.parametrize("space", SPACES)
def test_solve_serve_main_runs_on_the_cpu(capsys, tmp_path, space):
    trace_path, jsonl = tmp_path / "serve.json", tmp_path / "serve.jsonl"
    argv = ["--smoke", "--no-pace", "--device", "cpu", "--executor", space,
            "--format", "ell", "--trace", str(trace_path),
            "--metrics-jsonl", str(jsonl)]
    assert solve_serve.main(argv) == 0
    out = capsys.readouterr().out
    assert "SERVE-GATE: PASS" in out and "converged 48/48" in out
    assert trace.validate_trace(str(trace_path)) == []
    assert trace.get_tracer() is None
    records = metrics.load_jsonl(str(jsonl))
    solves = [r for r in records if r["name"] == "serve_solves"]
    assert solves and solves[0]["value"] == 48


def test_solve_serve_needs_a_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        solve_serve.main(["--smoke"])
    with pytest.raises(SystemExit):
        solve_serve.main(["--smoke", "--device", "cpu", "--executor", "cuda"])
