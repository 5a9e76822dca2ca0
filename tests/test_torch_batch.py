"""The port's batched subsystem against the JAX package's.

* Batched formats and their host constructors, ``batch_solve.build_batch``
  and ``BatchBlockJacobi``'s slot table are integer/array bookkeeping in
  numpy on both sides: identical arrays.
* ``spmv_batch_ell_plain`` (through the kernel's wrapper) against the Pallas
  ``spmv_batch_ell`` in interpret mode at ragged m and k, and the 2-D
  ``axpy_norm_plain`` against ``_axpy_norm_xla``: f32 sums in another order,
  1e-5 relative to the sum of the terms' magnitudes (about 100 eps32).
* ``batch_cg`` / ``batch_bicgstab`` on 16 systems of 32 rows: per-system
  iteration counts within ±1 of the JAX solve and x within 1e-4 relative
  per system (2-norm); frozen systems, the empty batch and the sweep cap.
* A run advanced in chunks equals the monolithic run bit for bit.
"""

import functools
import importlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import batch as jbatch
from repro.core import make_executor as jax_make_executor
from repro.kernels.spmv_batch_ell.kernel import spmv_batch_ell as jax_spmv_batch_ell
from repro.launch import batch_solve as jax_batch_solve
from repro.solvers import Stop as JStop
from repro.sparse.ops import _axpy_norm_xla
from repro_torch import batch as tb
from repro_torch import convert
from repro_torch import kernels as K
from repro_torch.batch import ops as BO
from repro_torch.core import make_executor
from repro_torch.launch import batch_solve
from repro_torch.observability import convergence
from repro_torch.observability.trace import get_tracer
from repro_torch.solvers import Stop

# the packages' ``block_jacobi`` names their generator functions; the modules
jbj = importlib.import_module("repro.precond.block_jacobi")
tbj = importlib.import_module("repro_torch.precond.block_jacobi")

RTOL = 1e-5
NB, N = 16, 32


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _np(t):
    return t.detach().cpu().numpy()


def _stack(nb, n, seed, density=0.3):
    """SPD-ish random systems with different patterns per system: a
    diagonally dominant sparse random part, symmetrised."""
    rng = np.random.default_rng(seed)
    out = np.zeros((nb, n, n), np.float32)
    for b in range(nb):
        a = rng.standard_normal((n, n)) * (rng.random((n, n)) < density)
        a = (a + a.T) / 2
        a[np.arange(n), np.arange(n)] = np.abs(a).sum(axis=1) + 1.0 + b % 3
        out[b] = a
    return out


# -- formats ---------------------------------------------------------------------


@pytest.mark.parametrize("shared", [True, False])
def test_batch_formats_identical(shared):
    stack = _stack(5, 11, seed=3)
    if shared:
        stack = np.broadcast_to(stack[:1], stack.shape) * np.arange(
            1, 6, dtype=np.float32)[:, None, None]
    Je, Pe = jbatch.batch_ell_from_dense(stack), tb.batch_ell_from_dense(
        stack, device="cpu")
    Jc, Pc = jbatch.batch_csr_from_dense(stack), tb.batch_csr_from_dense(
        stack, device="cpu")
    for J, P, fields in ((Je, Pe, ("col_idx", "values")),
                         (Jc, Pc, ("indptr", "indices", "values"))):
        for f in fields:
            want, got = np.asarray(getattr(J, f)), _np(getattr(P, f))
            assert got.dtype == want.dtype, f
            np.testing.assert_array_equal(got, want, err_msg=f)
        assert P.num_batch == J.num_batch and P.nnz == J.nnz
        assert P.shape == tuple(J.shape) and P.memory_bytes == J.memory_bytes
    for k in (None, 16):
        J2 = jbatch.batch_ell_from_batch_csr(Jc, k)
        P2 = tb.batch_ell_from_batch_csr(Pc, k)
        np.testing.assert_array_equal(_np(P2.col_idx), np.asarray(J2.col_idx))
        np.testing.assert_array_equal(_np(P2.values), np.asarray(J2.values))
    with pytest.raises(ValueError, match="max_nnz"):
        tb.batch_ell_from_batch_csr(Pc, 1)
    with pytest.raises(ValueError, match="share a shape"):
        tb.batch_csr_from_list([Pc.system(0), tb.batch_csr_from_dense(
            stack[:, :5, :], device="cpu").system(0)])
    with pytest.raises(ValueError, match="empty list"):
        tb.batch_ell_from_list([])


def test_batch_ell_union_keeps_a_real_column_zero():
    """A system's padding slot (column 0, value 0) must not clobber another
    system's real entry at column 0 when the union pattern is built."""
    a = np.zeros((2, 3, 3), np.float32)
    a[0] = [[2, 0, 0], [1, 2, 1], [0, 1, 2]]
    a[1] = [[2, 1, 0], [0, 2, 1], [0, 1, 2]]
    J, P = jbatch.batch_ell_from_dense(a), tb.batch_ell_from_dense(a, device="cpu")
    np.testing.assert_array_equal(_np(P.col_idx), np.asarray(J.col_idx))
    np.testing.assert_array_equal(_np(P.values), np.asarray(J.values))


def test_convert_carries_batched_objects():
    stack = _stack(4, 9, seed=5)
    Je, Jc = jbatch.batch_ell_from_dense(stack), jbatch.batch_csr_from_dense(stack)
    Pe = convert.batch_ell(Je.col_idx, Je.values, Je.shape, device="cpu")
    Pc = convert.batch_csr(Jc.indptr, Jc.indices, Jc.values, Jc.shape,
                           device="cpu")
    np.testing.assert_array_equal(_np(Pe.values), np.asarray(Je.values))
    np.testing.assert_array_equal(_np(Pc.indices), np.asarray(Jc.indices))
    M = jbj.batch_block_jacobi(Je, 4, adaptive=True)
    Pm = convert.batch_block_jacobi(M.inv_blocks, M.perm, M.inv_perm,
                                    M.gather_idx, M.n, M.num_blocks,
                                    M.block_size, device="cpu")
    V = np.random.default_rng(0).standard_normal((4, 9)).astype(np.float32)
    np.testing.assert_allclose(
        _np(Pm.apply(torch.from_numpy(V), executor=make_executor("torch"))),
        np.asarray(M.apply(jnp.asarray(V), executor=jax_make_executor("xla"))),
        rtol=RTOL, atol=RTOL)


# -- kernels' plain versions -----------------------------------------------------


def _batch_ell_arrays(nb, m, k, n, seed):
    rng = np.random.default_rng(seed)
    cols = rng.integers(0, n, size=(m, k)).astype(np.int32)
    fill = rng.integers(0, k + 1, size=m)
    pad = np.arange(k)[None, :] >= fill[:, None]
    cols[pad] = 0
    vals = rng.standard_normal((nb, m, k)).astype(np.float32)
    vals[:, pad] = 0.0
    return cols, vals, rng.standard_normal((nb, n)).astype(np.float32)


@pytest.mark.parametrize("nb,m,k,n", [(3, 37, 5, 29), (2, 64, 3, 64),
                                      (4, 9, 1, 5), (1, 130, 9, 70)])
def test_spmv_batch_ell_matches_pallas(nb, m, k, n):
    cols, vals, x = _batch_ell_arrays(nb, m, k, n, seed=m + k)
    want = np.asarray(jax_spmv_batch_ell(
        jnp.asarray(cols), jnp.asarray(vals), jnp.asarray(x), block_m=16,
        block_k=4, interpret=True))
    got = K.spmv_batch_ell(torch.from_numpy(cols), torch.from_numpy(vals),
                           torch.from_numpy(x))
    scale = float(np.abs(vals).sum(axis=2).max() * np.abs(x).max())
    assert got.shape == (nb, m)
    np.testing.assert_allclose(_np(got), want, rtol=RTOL, atol=RTOL * scale)
    A = tb.BatchEll(torch.from_numpy(cols), torch.from_numpy(vals), (m, n))
    for space in ("reference", "torch"):
        y = BO.apply_batch(A, torch.from_numpy(x), executor=make_executor(space))
        np.testing.assert_allclose(_np(y), want, rtol=RTOL, atol=RTOL * scale)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("nb,m,k,n", [(3, 37, 37, 37), (2, 24, 24, 30)])
def test_spmv_batch_ell_wide_matches_pallas(nb, m, k, n, dtype):
    """The wide rows the kernel's wide route takes (k > 16: a ragged k = 37
    past a warp of packs, and the middle band's k = 24), in f32 and f64."""
    cols, vals, x = _batch_ell_arrays(nb, m, k, n, seed=m * k)
    vals, x = vals.astype(dtype), x.astype(dtype)
    with jax.enable_x64(dtype == np.float64):
        want = np.asarray(jax_spmv_batch_ell(
            jnp.asarray(cols), jnp.asarray(vals), jnp.asarray(x), block_m=16,
            block_k=16, interpret=True))
    assert want.dtype == dtype
    got = K.spmv_batch_ell(torch.from_numpy(cols), torch.from_numpy(vals),
                           torch.from_numpy(x))
    assert got.dtype == torch.from_numpy(vals).dtype and got.shape == (nb, m)
    eps = np.finfo(dtype).eps
    scale = float(np.abs(vals).sum(axis=2).max() * np.abs(x).max())
    np.testing.assert_allclose(_np(got), want, rtol=0, atol=8 * k * eps * scale)


@pytest.mark.parametrize("dtype,k", [(np.float32, 600), (np.float64, 300)])
def test_spmv_batch_ell_long_rows_match_pallas(dtype, k):
    """Rows longer than the wide route's tile kernel takes (k > 512 in f32,
    256 in f64), which the cuda kernel walks a warp a row in groups of
    WIDE_PACKS packs a lane: the plain version against the Pallas kernel,
    and the wrapper's route check accepts the configuration the binding
    picks (a warp a row) at those shapes."""
    from repro_torch.kernels.spmv_batch_ell.kernel import check_route

    nb, m, n = 2, 16, k + 50
    cols, vals, x = _batch_ell_arrays(nb, m, k, n, seed=k)
    vals, x = vals.astype(dtype), x.astype(dtype)
    with jax.enable_x64(dtype == np.float64):
        want = np.asarray(jax_spmv_batch_ell(
            jnp.asarray(cols), jnp.asarray(vals), jnp.asarray(x), block_m=16,
            block_k=128, interpret=True))
    assert want.dtype == dtype
    got = K.spmv_batch_ell(torch.from_numpy(cols), torch.from_numpy(vals),
                           torch.from_numpy(x))
    eps = np.finfo(dtype).eps
    scale = float(np.abs(vals).sum(axis=2).max() * np.abs(x).max())
    np.testing.assert_allclose(_np(got), want, rtol=0, atol=8 * k * eps * scale)
    size = np.dtype(dtype).itemsize
    cfg = make_executor("h100").launch_config("spmv_batch_ell", {
        "nb": nb, "m": m, "k": k, "n": n, "itemsize": size})
    assert cfg["subgroup"] == 32
    check_route(k, size, cfg["block_threads"], cfg["subgroup"])  # no raise
    with pytest.raises(ValueError, match="wide route"):  # 16 lanes: 1 pack each
        check_route(k, size, cfg["block_threads"], 16)


def test_spmv_batch_ell_dense_nonsym_matches_pallas():
    """BiCGSTAB's dense nonsymmetric systems (``build_batch(..., nonsym=True)``,
    n = 64, so k = 64: the wide route's path shape), the port's BatchEll
    against the JAX package's."""
    Aj, _, At, _, _ = _problem("ell", nonsym=True, nb=4, n=64)
    assert tuple(At.values.shape) == (4, 64, 64)
    np.testing.assert_array_equal(_np(At.col_idx), np.asarray(Aj.col_idx))
    np.testing.assert_array_equal(_np(At.values), np.asarray(Aj.values))
    x = np.random.default_rng(64).standard_normal((4, 64)).astype(np.float32)
    want = np.asarray(jax_spmv_batch_ell(Aj.col_idx, Aj.values, jnp.asarray(x),
                                         block_m=32, block_k=32, interpret=True))
    got = K.spmv_batch_ell(At.col_idx, At.values, torch.from_numpy(x))
    scale = float(np.abs(np.asarray(Aj.values)).sum(axis=2).max() * np.abs(x).max())
    np.testing.assert_allclose(_np(got), want, rtol=0,
                               atol=8 * 64 * np.finfo(np.float32).eps * scale)


def test_spmv_batch_ell_routes_for_h100():
    """At the H100 seed the route follows the row length and the type, never
    the batch size: the CG runs' tridiagonal k = 3 takes the narrow route
    (one thread a row), BiCGSTAB's dense k = 64 the wide route with a
    subgroup covering a row's 16-byte packs (16 lanes in f32, 32 in f64),
    the middle band 16 < k <= 32 the wide route too; each fits the block's
    shared memory."""
    from repro_torch.core.params import H100

    ex = make_executor("h100")
    for (m, k, n, size), want in (((1024, 3, 1024, 4), 1), ((64, 64, 64, 4), 16),
                                  ((64, 64, 64, 8), 32), ((50, 24, 50, 4), 8),
                                  ((50, 16, 50, 4), 1), ((61, 61, 61, 4), 16),
                                  ((300, 200, 300, 4), 32)):
        got = set()
        for nb in (1, 7, 1024, 16384, 10**6):
            cfg = ex.launch_config("spmv_batch_ell", {
                "nb": nb, "m": m, "k": k, "n": n, "itemsize": size})
            assert cfg.smem_bytes <= H100.smem_per_block_bytes
            got.add((cfg["block_threads"], cfg["subgroup"]))
        assert got == {(256, want)}, (m, k, size, got)


def test_spmv_batch_ell_vector_loads():
    """The host decides each call's loads on the wide route: 16-byte packs
    where the values' base is 16-byte aligned and every row is a whole
    number of packs (so every row starts aligned), single entries else."""
    from repro_torch.kernels.spmv_batch_ell.kernel import vector_loads

    def values(nb, m, k, dtype=torch.float32):
        return torch.zeros(nb + 1, m, k, dtype=dtype)

    vals = values(2, 64, 64)
    assert vals.data_ptr() % 16 == 0
    assert vector_loads(vals) and vector_loads(vals[1:])
    # the same shape 4 bytes past a 16-byte boundary
    assert vector_loads(vals.reshape(-1)[1:-4095].view(2, 64, 64)) is False
    assert vector_loads(values(7, 61, 61)) is False  # 244-byte rows
    assert vector_loads(values(5, 50, 24))  # 96-byte rows
    assert vector_loads(values(2, 64, 62, torch.float64))  # 496-byte rows
    assert vector_loads(values(2, 64, 61, torch.float64)) is False


@pytest.mark.parametrize("alpha_kind", ["rows", "scalar"])
@pytest.mark.parametrize("nb,n", [(5, 37), (16, 1024), (1, 3)])
def test_axpy_norm_rows_matches_xla(nb, n, alpha_kind):
    rng = np.random.default_rng(nb * n)
    x = rng.standard_normal((nb, n)).astype(np.float32)
    y = rng.standard_normal((nb, n)).astype(np.float32)
    alpha = (rng.standard_normal(nb).astype(np.float32) if alpha_kind == "rows"
             else np.float32(-0.37))
    zw, sw = _axpy_norm_xla(None, jnp.asarray(alpha), jnp.asarray(x),
                            jnp.asarray(y))
    at = torch.as_tensor(alpha)
    for z, s in (K.axpy_norm_rows(at, torch.from_numpy(x), torch.from_numpy(y)),
                 K.axpy_norm_plain(at, torch.from_numpy(x), torch.from_numpy(y)),
                 BO.batch_axpy_norm(at, torch.from_numpy(x), torch.from_numpy(y),
                                    executor=make_executor("torch"))):
        assert z.shape == (nb, n) and s.shape == (nb,)
        np.testing.assert_allclose(_np(z), np.asarray(zw), rtol=RTOL, atol=RTOL)
        np.testing.assert_allclose(_np(s), np.asarray(sw), rtol=RTOL,
                                   atol=RTOL * float(np.asarray(sw).max()))


def test_axpy_norm_rows_pieces_for_h100():
    """At the H100 seed geometry a row is one block when the batch fills the
    grid (the chip smoke's 16,384 x 1,024) and is cut into pieces, whose
    partials the row's last block adds in the same launch, when it does not
    (256 x 1,024: 4 pieces)."""
    from repro_torch.kernels.axpy_norm.kernel import rows_chunks

    ex = make_executor("h100")
    for (nb, n), want in (((16384, 1024), 1), ((256, 1024), 4), ((1, 10), 1),
                          ((1, 10**6), 1056)):
        cfg = ex.launch_config("axpy_norm_rows", {"nb": nb, "n": n,
                                                  "itemsize": 4})
        assert rows_chunks(nb, n, cfg["block_threads"],
                           cfg["grid_blocks"]) == want, (nb, n)


def test_cuda_space_takes_no_cpu_tensors():
    """The cuda space runs its kernels or raises: on CPU tensors it raises,
    for the batched SpMV and the row-batched axpy_norm alike."""
    cols, vals, x = _batch_ell_arrays(2, 8, 3, 8, seed=1)
    A = tb.BatchEll(torch.from_numpy(cols), torch.from_numpy(vals), (8, 8))
    ex = make_executor("cuda")
    assert BO.spmv_batch_ell.space_used(ex) == "cuda"
    with pytest.raises(ValueError, match="CUDA tensors"):
        BO.apply_batch(A, torch.from_numpy(x), executor=ex)
    X = torch.from_numpy(x)
    with pytest.raises(ValueError, match="CUDA tensors"):
        BO.batch_axpy_norm(torch.ones(2), X, X, executor=ex)
    with pytest.raises(ValueError, match=r"\(nb, n\)"):
        K.axpy_norm_rows(torch.ones(2), X[0], X[0])
    with pytest.raises(ValueError, match="alpha"):
        K.axpy_norm_rows(torch.ones(3), X, X)
    with pytest.raises(ValueError, match=r"\(m, k\)"):
        K.spmv_batch_ell(torch.from_numpy(cols)[:4], torch.from_numpy(vals), X)


# -- solvers ---------------------------------------------------------------------


def _problem(fmt="ell", nonsym=False, nb=NB, n=N):
    Aj, Bj, xstar = jax_batch_solve.build_batch(nb, n, fmt=fmt, nonsym=nonsym)
    At, Bt, xs = batch_solve.build_batch(nb, n, fmt=fmt, nonsym=nonsym,
                                         device="cpu")
    return Aj, Bj, At, Bt, xstar


@functools.lru_cache(maxsize=None)
def _jax_solve(solver, fmt, precond):
    Aj, Bj, _, _, _ = _problem(fmt, solver == "bicgstab")
    fn = {"cg": jbatch.batch_cg, "bicgstab": jbatch.batch_bicgstab}[solver]
    M = {"none": None, "jacobi": "jacobi", "block_jacobi": "block_jacobi"}[precond]
    opts = {"block_size": 4} if precond == "block_jacobi" else None
    res = fn(Aj, Bj, stop=JStop(max_iters=200, reduction_factor=1e-6), M=M,
             precond_opts=opts, executor=jax_make_executor("xla"))
    return (np.asarray(res.iterations), np.asarray(res.x),
            np.asarray(res.converged))


def _close_per_system(x, x_ref):
    err = np.linalg.norm(x - x_ref, axis=1)
    assert (err <= 1e-4 * np.linalg.norm(x_ref, axis=1)).all(), err.max()


@pytest.mark.parametrize("space", ["reference", "torch"])
@pytest.mark.parametrize("precond", ["none", "jacobi", "block_jacobi"])
@pytest.mark.parametrize("fmt", ["ell", "csr"])
@pytest.mark.parametrize("solver", ["cg", "bicgstab"])
def test_batch_solvers_match_jax(solver, fmt, precond, space):
    it_j, x_j, conv_j = _jax_solve(solver, fmt, precond)
    _, _, At, Bt, _ = _problem(fmt, solver == "bicgstab")
    fn = {"cg": tb.batch_cg, "bicgstab": tb.batch_bicgstab}[solver]
    M = {"none": None, "jacobi": "jacobi", "block_jacobi": "block_jacobi"}[precond]
    opts = {"block_size": 4} if precond == "block_jacobi" else None
    res = fn(At, Bt, stop=Stop(max_iters=200, reduction_factor=1e-6), M=M,
             precond_opts=opts, executor=make_executor(space))
    assert conv_j.all() and bool(res.converged.all())
    assert res.iterations.dtype == torch.int32 and res.num_batch == NB
    assert np.abs(_np(res.iterations) - it_j).max() <= 1, (
        _np(res.iterations), it_j)
    _close_per_system(_np(res.x), x_j)


def test_frozen_systems_and_history_match_jax():
    """Systems that start converged (zero right-hand side, or the exact
    solution as x0) freeze at 0 iterations; the history rows record the
    batch after each sweep, frozen systems repeating their norm."""
    Aj, Bj, At, Bt, xstar = _problem()
    B = np.asarray(Bj).copy()
    B[3] = 0.0
    X0 = np.zeros_like(B)
    X0[5] = xstar[5]
    stop = dict(max_iters=200, reduction_factor=1e-6)
    rj = jbatch.batch_cg(Aj, jnp.asarray(B), jnp.asarray(X0), stop=JStop(**stop),
                         executor=jax_make_executor("xla"), history=True)
    rt = tb.batch_cg(At, torch.from_numpy(B), torch.from_numpy(X0),
                     stop=Stop(**stop), executor=make_executor("torch"),
                     history=True)
    it = _np(rt.iterations)
    assert it[3] == 0 and it[5] == 0 and bool(rt.converged.all())
    np.testing.assert_array_equal(it, np.asarray(rj.iterations))
    assert rt.history.shape == (200, NB)
    h_t = convergence.trim(rt.history)
    h_j = np.asarray(rj.history)[: h_t.shape[0]]
    assert h_t.shape[0] == int(it.max())
    np.testing.assert_allclose(h_t, h_j, rtol=1e-4, atol=1e-6)
    assert (h_t[:, 3] == 0).all()


def test_empty_batch_launches_nothing():
    ex = make_executor("torch")
    A = tb.BatchEll(torch.zeros(4, 3, dtype=torch.int32),
                    torch.zeros(0, 4, 3), (4, 4))
    for fn in (tb.batch_cg, tb.batch_bicgstab):
        res = fn(A, torch.zeros(0, 4), executor=ex, history=5)
        assert res.num_batch == 0 and res.iterations.shape == (0,)
        assert res.history.shape == (5, 0)
    assert dict(ex.dispatch_log) == {}
    with pytest.raises(ValueError, match="degenerate"):
        tb.batch_cg(A, torch.zeros(0, 4), stop=Stop(reduction_factor=0.0))


@pytest.mark.parametrize("solver", ["cg", "bicgstab"])
def test_max_iters_cap_matches_jax(solver):
    Aj, Bj, At, Bt, _ = _problem(nonsym=solver == "bicgstab")
    fj = {"cg": jbatch.batch_cg, "bicgstab": jbatch.batch_bicgstab}[solver]
    ft = {"cg": tb.batch_cg, "bicgstab": tb.batch_bicgstab}[solver]
    rj = fj(Aj, Bj, stop=JStop(max_iters=3, reduction_factor=1e-6),
            executor=jax_make_executor("xla"))
    rt = ft(At, Bt, stop=Stop(max_iters=3, reduction_factor=1e-6),
            executor=make_executor("torch"))
    assert int(rt.iterations.max()) == 3 and not bool(rt.converged.all())
    np.testing.assert_array_equal(_np(rt.iterations), np.asarray(rj.iterations))
    np.testing.assert_array_equal(_np(rt.converged), np.asarray(rj.converged))
    _close_per_system(_np(rt.x), np.asarray(rj.x))


@pytest.mark.parametrize("space", ["reference", "torch"])
@pytest.mark.parametrize("solver", ["cg", "bicgstab"])
def test_chunked_advance_equals_monolithic_bitwise(solver, space):
    _, _, At, Bt, _ = _problem(nonsym=solver == "bicgstab")
    ex = make_executor(space)
    stop = Stop(max_iters=200, reduction_factor=1e-6)
    M = tb.batch_jacobi_preconditioner(At, executor=ex)
    thresh = stop.threshold(tb.batch_norm2(Bt, executor=ex))
    X0 = torch.zeros_like(Bt)
    if solver == "cg":
        init = lambda: tb.batch_cg_init(At, Bt, X0, M=M, executor=ex)  # noqa: E731
        adv = functools.partial(tb.batch_cg_advance, At, stop=stop, M=M,
                                executor=ex)
    else:
        init = lambda: tb.batch_bicgstab_init(At, Bt, X0, executor=ex)  # noqa: E731
        adv = functools.partial(tb.batch_bicgstab_advance, At, stop=stop, M=M,
                                executor=ex)
    mono = adv(init(), thresh)
    state, chunks = init(), 0
    while True:
        nxt = adv(state, thresh, num_sweeps=4)
        chunks += 1
        if nxt.k == state.k:
            break
        assert nxt.k - state.k <= 4
        state = nxt
    assert chunks > 2 and state.k == mono.k
    for f in ("X", "R", "P", "iters", "rnorm"):
        assert torch.equal(getattr(state, f), getattr(mono, f)), f


def test_batch_block_jacobi_matches_jax():
    stack = _stack(6, 13, seed=8)
    Je, Pe = jbatch.batch_ell_from_dense(stack), tb.batch_ell_from_dense(
        stack, device="cpu")
    Jc, Pc = jbatch.batch_csr_from_dense(stack), tb.batch_csr_from_dense(
        stack, device="cpu")
    V = np.random.default_rng(1).standard_normal((6, 13)).astype(np.float32)
    ex, jex = make_executor("torch"), jax_make_executor("xla")
    for J, P in ((Je, Pe), (Jc, Pc)):
        pj = jbj.batch_block_jacobi_pattern(J, 4)
        pt = tbj.batch_block_jacobi_pattern(P, 4)
        np.testing.assert_array_equal(_np(pt.slot_table), pj.slot_table)
        np.testing.assert_array_equal(_np(pt.gather_idx), np.asarray(pj.gather_idx))
        np.testing.assert_array_equal(
            _np(tbj.batch_block_jacobi_blocks(P.values, pt)),
            np.asarray(jbj.batch_block_jacobi_blocks(J.values, pj)))
        np.testing.assert_allclose(
            _np(tbj.batch_block_jacobi_factors(P.values, pt)),
            np.asarray(jbj.batch_block_jacobi_factors(J.values, pj)),
            rtol=1e-5, atol=1e-5)
        for adaptive in (False, True, "bfloat16"):
            Mj = jbj.batch_block_jacobi(J, 4, adaptive=adaptive)
            Mt = tbj.batch_block_jacobi(P, 4, adaptive=adaptive, executor=ex)
            assert Mt.precision_counts == tuple(
                (d.removeprefix("torch."), c) for d, c in Mj.precision_counts)
            np.testing.assert_array_equal(_np(Mt.perm), np.asarray(Mj.perm))
            np.testing.assert_allclose(
                _np(Mt.apply(torch.from_numpy(V))),
                np.asarray(Mj.apply(jnp.asarray(V), executor=jex)),
                rtol=1e-5, atol=1e-5)
        assert Mt.storage_bytes > 0 and Mt.num_batch == 6 and Mt.shape == (13, 13)


def test_build_batch_matches_jax():
    for fmt in ("ell", "csr"):
        for nonsym, (nb, n) in ((False, (10, 17)), (True, (3, 6)), (False, (2, 1)),
                                (False, (3, 2))):
            Aj, Bj, xj = jax_batch_solve.build_batch(nb, n, fmt=fmt,
                                                     nonsym=nonsym, seed=3)
            At, Bt, xt = batch_solve.build_batch(nb, n, fmt=fmt, nonsym=nonsym,
                                                 seed=3, device="cpu")
            fields = ("col_idx", "values") if fmt == "ell" else (
                "indptr", "indices", "values")
            for f in fields:
                want, got = np.asarray(getattr(Aj, f)), _np(getattr(At, f))
                assert got.dtype == want.dtype, f
                np.testing.assert_array_equal(got, want, err_msg=f)
            np.testing.assert_array_equal(xt, xj)
            np.testing.assert_allclose(_np(Bt), np.asarray(Bj), rtol=1e-6,
                                       atol=1e-6)
    with pytest.raises(ValueError, match="unknown batched format"):
        batch_solve.build_batch(2, 4, fmt="coo", device="cpu")


def test_batch_solve_main_runs_on_the_cpu(capsys, tmp_path):
    assert batch_solve.main(["--smoke", "--device", "cpu", "--executor",
                             "torch"]) == 0
    out = capsys.readouterr().out
    assert "converged 64/64" in out
    path = tmp_path / "trace.json"
    assert batch_solve.main(["--batch", "4", "--n", "8", "--device", "cpu",
                             "--executor", "torch", "--trace", str(path)]) == 0
    events = json.loads(path.read_text())["traceEvents"]
    assert {"spmv_batch_ell", "axpy_norm"} <= {e["name"] for e in events}
    assert all(e["ph"] == "X" and e["dur"] >= 0 for e in events)
    assert get_tracer() is None
    r = batch_solve.run(["--batch", "8", "--n", "12", "--device", "cpu",
                         "--executor", "reference", "--solver", "bicgstab",
                         "--format", "csr", "--precond", "jacobi"])
    assert r.ok and r.error < 1e-3 and r.launches == {k: 0 for k in r.launches}
    with pytest.raises(SystemExit):
        batch_solve.main(["--device", "cpu", "--executor", "cuda"])
