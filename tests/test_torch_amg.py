"""The port's smoothed-aggregation AMG against the JAX package's.

On ``poisson_2d(16)`` and ``anisotropic_2d(16)`` (256 rows), with the
default coarse size (one coarsened level) and ``coarse_size=8`` (three):

* ``strength_mask`` and ``aggregate`` give identical arrays;
* the hierarchy is identical level for level, with the smoothed
  prolongator (the default) and without it — rows, ``indptr``,
  ``indices`` and values bit for bit (the port's reference space against
  the JAX reference space, its torch space against ``xla`` and
  ``pallas_interpret``: the SpGEMM products are single multiplies summed in
  the same order by the same numpy routine), and the operator complexity is
  equal;
* the coarse dense inverse is within 1e-5 (f32 LU in another library);
* the V- and W-cycle apply on the JAX hierarchy carried over by
  :func:`repro_torch.convert.multigrid` is within rtol 1e-5 of the JAX apply
  (f32 SpMVs summed in another order, through several levels);
* AMG-CG iterations are within ±1 of the JAX solve for cycle v/w, smoother
  jacobi/block_jacobi and coarse solver dense/cg, and for the unsmoothed
  transfer on both matrices, x within rtol 1e-4 (f32 dots in another
  order);
* ``run_amg_check(16, ...)`` passes its gate on the CPU;
* the dispatch log counts 3 ``spgemm`` (2 unsmoothed) and 1
  ``sptranspose`` per coarsened level, and 4 ``spmv_ell`` per coarsened
  level per V(1,1)-cycle (none in the pre-sweep from zero) — the
  counts ``chip_smoke.py`` holds the kernels' launches to on the card.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import sparse as jsparse
from repro.core import make_executor as jax_make_executor
from repro.precond import amg as jamg
from repro.solvers.common import Stop as JStop
from repro.solvers.krylov import cg as jax_cg
from repro_torch import convert
from repro_torch.core import make_executor
from repro_torch.launch.amg_check import main, run_amg_check
from repro_torch.observability import metrics, trace
from repro_torch.precond import Multigrid, amg, amg_preconditioner, make_preconditioner
from repro_torch.solvers import Stop, cg
from repro_torch.sparse import formats as F
from repro_torch.sparse import gallery, ops

#: port space -> the JAX package's spaces it is held bitwise against
SPACES = [("reference", "reference"), ("torch", "xla"),
          ("torch", "pallas_interpret")]
STOP_KW = dict(max_iters=500, reduction_factor=1e-6)


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _matrix(name):
    return (gallery.poisson_2d(16) if name == "poisson_2d"
            else gallery.anisotropic_2d(16, 0.01))


def _pair(name):
    ip, ix, v, shape = _matrix(name)
    return (jsparse.csr_from_arrays(ip, ix, v, shape),
            F.csr_from_arrays(ip, ix, v, shape, device="cpu"))


def _rhs(n, seed=1):
    return np.random.default_rng(seed).standard_normal(n).astype(np.float32)


def _assert_same_csr(got, want):
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_array_equal(got.indptr.numpy(), np.asarray(want.indptr))
    np.testing.assert_array_equal(got.indices.numpy(), np.asarray(want.indices))
    np.testing.assert_array_equal(got.values.numpy(), np.asarray(want.values))


@functools.lru_cache(maxsize=None)
def _jax_hierarchy(name, jax_space, coarse_size, smooth=True):
    Aj, _ = _pair(name)
    return jamg.Multigrid(Aj, coarse_size=coarse_size,
                          smooth_prolongator=smooth,
                          executor=jax_make_executor(jax_space))


# -- strength and aggregation ------------------------------------------------------


@pytest.mark.parametrize("name", ["poisson_2d", "anisotropic_2d"])
@pytest.mark.parametrize("theta", [0.08, 0.25])
def test_strength_and_aggregation_identical(name, theta):
    ip, ix, v, shape = _matrix(name)
    strong = amg.strength_mask(ip, ix, v, theta)
    np.testing.assert_array_equal(strong, jamg.strength_mask(ip, ix, v, theta))
    agg, n_agg = amg.aggregate(ip, ix, strong, shape[0])
    jagg, jn_agg = jamg.aggregate(ip, ix, strong, shape[0])
    assert n_agg == jn_agg and 1 <= n_agg < shape[0]
    np.testing.assert_array_equal(agg, jagg)


def test_strength_drops_the_weak_direction():
    ip, ix, v, shape = gallery.anisotropic_2d(8, 0.001)
    strong = amg.strength_mask(ip, ix, v, theta=0.08)
    off = np.abs(np.repeat(np.arange(shape[0]), np.diff(ip)) - ix)
    assert strong[off == 1].all() and not strong[off == 8].any()


def test_tentative_prolongator_partition_of_unity():
    agg = np.array([0, 0, 1, 2, 1])
    d = ops.to_dense(amg.tentative_prolongator(agg, 3, device="cpu"),
                     executor=make_executor("reference")).numpy()
    assert d.shape == (5, 3)
    np.testing.assert_array_equal(d.sum(axis=1), np.ones(5))
    np.testing.assert_array_equal(np.argmax(d, axis=1), agg)


# -- the hierarchy -------------------------------------------------------------------


def _assert_same_hierarchy(M, J):
    assert M.num_levels == J.num_levels >= 2
    for L, JL in zip(M.levels, J.levels):
        for f in ("A", "P", "R"):
            _assert_same_csr(getattr(L, f), getattr(JL, f))
        for f in ("A_op", "P_op", "R_op"):
            np.testing.assert_array_equal(getattr(L, f).col_idx.numpy(),
                                          np.asarray(getattr(JL, f).col_idx))
            np.testing.assert_array_equal(getattr(L, f).values.numpy(),
                                          np.asarray(getattr(JL, f).values))
        np.testing.assert_array_equal(L.inv_diag.numpy(), np.asarray(JL.inv_diag))
    _assert_same_csr(M.coarse_A, J.coarse_A)
    assert M.operator_complexity == J.operator_complexity
    np.testing.assert_allclose(M._coarse_inv.numpy(), np.asarray(J._coarse_inv),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("port_space,jax_space", SPACES)
@pytest.mark.parametrize("name", ["poisson_2d", "anisotropic_2d"])
@pytest.mark.parametrize("coarse_size", [64, 8])
def test_hierarchy_identical_to_jax(port_space, jax_space, name, coarse_size):
    J = _jax_hierarchy(name, jax_space, coarse_size)
    _, At = _pair(name)
    M = Multigrid(At, coarse_size=coarse_size, executor=make_executor(port_space))
    _assert_same_hierarchy(M, J)


@pytest.mark.parametrize("port_space,jax_space", SPACES)
@pytest.mark.parametrize("name", ["poisson_2d", "anisotropic_2d"])
@pytest.mark.parametrize("coarse_size", [64, 8])
def test_unsmoothed_hierarchy_identical_to_jax(port_space, jax_space, name,
                                               coarse_size):
    """``smooth_prolongator=False`` (P = T, the Galerkin product TᵀAT): the
    same hierarchy bit for bit, P and R float32 like A and the JAX package's
    T; anisotropic_2d's values are not whole numbers, so the sums' order
    shows."""
    J = _jax_hierarchy(name, jax_space, coarse_size, smooth=False)
    _, At = _pair(name)
    M = Multigrid(At, coarse_size=coarse_size, smooth_prolongator=False,
                  executor=make_executor(port_space))
    _assert_same_hierarchy(M, J)
    for L in M.levels:
        assert L.P.values.dtype == L.R.values.dtype == torch.float32
        assert bool((L.P.values == 1).all()) and bool((L.R.values == 1).all())


def test_galerkin_product_matches_dense():
    _, At = _pair("poisson_2d")
    M = Multigrid(At, max_levels=1, coarse_size=8, executor=make_executor("torch"))
    ref = make_executor("reference")
    L = M.levels[0]
    a, p, r = (ops.to_dense(X, executor=ref).numpy().astype(np.float64)
               for X in (L.A, L.P, L.R))
    np.testing.assert_array_equal(r, p.T)
    np.testing.assert_allclose(ops.to_dense(M.coarse_A, executor=ref).numpy(),
                               r @ a @ p, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("smooth", [True, False])
def test_dispatch_log_counts_per_level(smooth):
    """3 spgemm and 1 sptranspose per coarsened level (2 and 1 when the
    prolongator is not smoothed); the metrics gauges and spans are set."""
    _, At = _pair("poisson_2d")
    ex = make_executor("torch")
    metrics.reset()
    events = []

    class _Tracer:
        def rel_us(self, t):
            return t * 1e6

        def complete(self, name, ts_us, dur_us, cat="span", args=None):
            events.append((name, cat))

    trace.set_tracer(_Tracer())
    try:
        M = Multigrid(At, coarse_size=8, smooth_prolongator=smooth, executor=ex)
    finally:
        trace.set_tracer(None)
    levels = len(M.levels)
    assert levels >= 2
    assert ex.dispatch_log["spgemm"] == (3 if smooth else 2) * levels
    assert ex.dispatch_log["sptranspose"] == levels
    names = [n for n, _ in events]
    assert names.count("amg.level") == levels and names.count("amg.setup") == 1
    assert names.count("spgemm.numeric") == ex.dispatch_log["spgemm"]
    # a traced dispatch also folds into the registry (dispatch_total, the
    # dispatch_wall_us histogram): the gauges are the valued series
    gauges = {(s["name"], s["labels"].get("level")): s["value"]
              for s in metrics.samples() if s["kind"] == "gauge"}
    assert gauges[("amg_level_rows", "0")] == 256
    assert gauges[("amg_level_nnz", str(levels))] == M.coarse_A.nnz
    assert gauges[("amg_operator_complexity", None)] == M.operator_complexity
    assert trace.span("x") is trace.span("y")  # tracing off: the shared no-op


# -- the cycle ---------------------------------------------------------------------


def _levels_of(J):
    def csr(X):
        return (np.asarray(X.indptr), np.asarray(X.indices), np.asarray(X.values),
                X.shape)

    def ell(X):
        return np.asarray(X.col_idx), np.asarray(X.values), X.shape

    return [dict(A=csr(L.A), P=csr(L.P), R=csr(L.R), A_op=ell(L.A_op),
                 P_op=ell(L.P_op), R_op=ell(L.R_op),
                 inv_diag=np.asarray(L.inv_diag)) for L in J.levels]


@pytest.mark.parametrize("cycle", ["v", "w"])
@pytest.mark.parametrize("name", ["poisson_2d", "anisotropic_2d"])
def test_cycle_apply_on_carried_hierarchy(cycle, name):
    """The apply alone, independent of setup: the JAX hierarchy's arrays in,
    the port's cycle out."""
    Aj, _ = _pair(name)
    J = jamg.Multigrid(Aj, coarse_size=8, cycle=cycle,
                       executor=jax_make_executor("xla"))
    cA = J.coarse_A
    M = convert.multigrid(
        _levels_of(J),
        (np.asarray(cA.indptr), np.asarray(cA.indices), np.asarray(cA.values),
         cA.shape),
        np.asarray(J._coarse_inv), cycle=cycle, device="cpu")
    assert M.num_levels == J.num_levels >= 4
    r = _rhs(Aj.shape[0], seed=7)
    want = np.asarray(J.apply(jnp.asarray(r)))
    got = M.apply(torch.from_numpy(r), executor=make_executor("torch")).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


def test_vcycle_spmv_count_and_residual_drop():
    _, At = _pair("poisson_2d")
    ex = make_executor("torch")
    M = amg_preconditioner(At, coarse_size=8, executor=ex)
    b = torch.from_numpy(_rhs(At.shape[0]))
    ex.dispatch_log.clear()
    x = M.apply(b)
    assert ex.dispatch_log["spmv_ell"] == 4 * len(M.levels)
    r = b - ops.apply(At, x, executor=ex)
    assert float(r.norm()) < 0.5 * float(b.norm())


# -- AMG-CG ----------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_amg_cg(name, opts):
    Aj, _ = _pair(name)
    b = _rhs(Aj.shape[0])
    popts = {k: (dict(v) if k == "smoother_opts" else v) for k, v in opts}
    res = jax_cg(Aj, jnp.asarray(b), stop=JStop(**STOP_KW), M="amg",
                 precond_opts=popts, executor=jax_make_executor("xla"))
    return int(res.iterations), np.asarray(res.x), bool(res.converged)


@pytest.mark.parametrize("cycle", ["v", "w"])
@pytest.mark.parametrize("smoother", ["jacobi", "block_jacobi"])
@pytest.mark.parametrize("coarse_solver", ["dense", "cg"])
def test_amg_cg_matches_jax(cycle, smoother, coarse_solver):
    opts = (("cycle", cycle), ("smoother", smoother),
            ("coarse_solver", coarse_solver), ("coarse_size", 8))
    if smoother == "block_jacobi":
        opts += (("smoother_opts", (("block_size", 4),)),)
    it_j, x_j, conv_j = _jax_amg_cg("poisson_2d", opts)
    _, At = _pair("poisson_2d")
    popts = {k: (dict(v) if k == "smoother_opts" else v) for k, v in opts}
    ex = make_executor("torch")
    ex.dispatch_log.clear()
    res = cg(At, torch.from_numpy(_rhs(At.shape[0])), stop=Stop(**STOP_KW),
             M="amg", precond_opts=popts, executor=ex)
    assert conv_j and res.converged
    assert abs(res.iterations - it_j) <= 1
    x = res.x.numpy()
    assert np.linalg.norm(x - x_j) <= 1e-4 * np.linalg.norm(x_j)
    if coarse_solver == "dense":  # (the coarse CG runs its own axpy_norm)
        assert ex.dispatch_log["axpy_norm"] == res.iterations  # fused CG body


@pytest.mark.parametrize("cycle", ["v", "w"])
@pytest.mark.parametrize("name", ["poisson_2d", "anisotropic_2d"])
def test_unsmoothed_amg_cg_matches_jax(cycle, name):
    """CG with the unsmoothed (Pgm) transfer against the JAX package's, as
    :func:`test_amg_cg_matches_jax` holds the smoothed one."""
    opts = (("cycle", cycle), ("smooth_prolongator", False),
            ("coarse_size", 8))
    it_j, x_j, conv_j = _jax_amg_cg(name, opts)
    _, At = _pair(name)
    res = cg(At, torch.from_numpy(_rhs(At.shape[0])), stop=Stop(**STOP_KW),
             M="amg", precond_opts=dict(opts), executor=make_executor("torch"))
    assert conv_j and res.converged
    assert abs(res.iterations - it_j) <= 1
    x = res.x.numpy()
    assert np.linalg.norm(x - x_j) <= 1e-4 * np.linalg.norm(x_j)


def test_amg_cuts_iterations_against_block_jacobi():
    _, At = _pair("poisson_2d")
    ex = make_executor("torch")
    b = torch.from_numpy(_rhs(At.shape[0]))
    base = cg(At, b, stop=Stop(**STOP_KW), M="block_jacobi", executor=ex)
    res = cg(At, b, stop=Stop(**STOP_KW), M="amg", executor=ex)
    assert base.converged and res.converged
    assert 3 * res.iterations <= base.iterations


def test_amg_options_and_errors():
    _, At = _pair("poisson_2d")
    M = make_preconditioner(At, "amg", theta=0.1, cycle="w",
                            smooth_prolongator=False, coarse_solver="cg",
                            coarse_size=16, executor=make_executor("torch"))
    assert isinstance(M, Multigrid)
    assert M.cycle == "w" and M._coarse_inv is None
    with pytest.raises(ValueError):
        make_preconditioner(At, "amg", cycle="x")
    with pytest.raises(ValueError):
        make_preconditioner(At, "amg", smoother="sor")
    with pytest.raises(TypeError):
        make_preconditioner(F.Dense(torch.eye(4)), "amg")


# -- the entry point -----------------------------------------------------------------


@pytest.mark.parametrize("space", ["torch", "reference"])
def test_run_amg_check_passes_on_cpu(space, capsys):
    ex = make_executor(space, device="cpu")
    r = run_amg_check(16, executor=ex)
    out = capsys.readouterr().out
    assert r.ok and "AMG-GATE: PASS" in out
    assert r.M.num_levels == 2 and r.amg.converged and r.block_jacobi.converged
    levels = len(r.M.levels)
    assert r.dispatches["amg_setup"]["spgemm"] == 3 * levels
    assert r.dispatches["amg_setup"]["sptranspose"] == levels
    k = r.amg.iterations
    assert r.dispatches["amg_solve"]["spmv_ell"] == 4 * levels * (k + 1)
    assert r.dispatches["amg_solve"]["axpy_norm"] == k
    # the CPU path takes the plain versions: no kernel launches anywhere
    assert all(n == 0 for phase in r.launches.values() for n in phase.values())
    assert main(["--n-side", "16", "--executor", space, "--device", "cpu"]) == 0
