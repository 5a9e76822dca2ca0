"""The port's ParILU, iterative refinement, ``convection_diffusion_2d`` and
``MatrixLinOp.astype`` against the JAX package's.

* ``convection_diffusion_2d``: host arrays equal to the JAX package's (both
  schemes, a negative velocity component).
* ``parilu_setup``: every table equal to the JAX package's (its loops; the
  port's setup is vectorised).  ``parilu_factorize``: the factors within
  2e-5 relative of the JAX package's (the row sums of the sweeps run in
  another order).  The cases of the JAX package's ``test_parilu``, its
  ParILU rows of ``test_convergence_regression`` (iterations equal to the
  JAX solve's, x within 1e-3 relative) and a repeat of a ParILU apply bit
  for bit.
* IR: the cases of the JAX package's ``test_ir``, whose f64 values come
  from ``with jax.enable_x64(True)`` inside each test (the JAX tests' own
  ``jax.experimental.enable_x64`` is gone from the installed jax): outer
  sweeps equal to the JAX solve's, x within 1e-8 of x*.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import solvers as jsolvers
from repro import sparse as jsparse
from repro.solvers.parilu import batch_parilu_apply as jax_batch_parilu_apply
from repro.solvers.parilu import parilu_factorize as jax_parilu_factorize
from repro.solvers.parilu import parilu_setup as jax_parilu_setup
from repro.sparse import gallery as jgallery
from repro_torch.core import LinOp, make_executor
from repro_torch.precond import block_jacobi, make_preconditioner, unit_roundoff
from repro_torch.solvers import (CgSolver, IrSolver, ParILU, Stop, bicgstab,
                                 cg, cgs, fcg, gmres, ir,
                                 jacobi_preconditioner, mixed_precision_ir,
                                 parilu_factorize, parilu_preconditioner,
                                 parilu_setup)
from repro_torch.solvers.parilu import batch_parilu_apply
from repro_torch.sparse import formats as F
from repro_torch.sparse import gallery

TORCH = make_executor("torch")
#: ParILU factors against the JAX package's (relative to max |value|)
FACTOR_RTOL = 2e-5
X_RTOL = 1e-3


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _dense(host):
    ip, ix, v, shape = host
    a = np.zeros(shape, v.dtype)
    a[np.repeat(np.arange(shape[0]), np.diff(ip)), ix] = v
    return a


def _banded(n, off, w, dtype=np.float32):
    a = np.zeros((n, n), dtype)
    for i in range(n):
        a[i, i] = 4.0
        if i > 0:
            a[i, i - 1] = a[i - 1, i] = -1.0
        if i > off - 1:
            a[i, i - off] = a[i - off, i] = w
    return a


def _tridiag_nonsym(n=80):
    a = np.zeros((n, n), np.float32)
    for i in range(n):
        a[i, i] = 5.0
        if i > 0:
            a[i, i - 1] = -1.4
        if i < n - 1:
            a[i, i + 1] = -0.6
    return a


def _close(x, x_ref, rtol):
    x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return np.linalg.norm(x - x_ref) <= rtol * np.linalg.norm(x_ref)


# -- convection_diffusion_2d ---------------------------------------------------------


@pytest.mark.parametrize("n_side,kw", [
    (16, dict(peclet=0.5, scheme="centered")),
    (48, dict(peclet=5.0, scheme="upwind")),
    (10, dict(peclet=5.0)),
    (7, dict(peclet=2.0, scheme="upwind", velocity=(-1.0, 0.3))),
    (9, dict(peclet=3.0, scheme="centered", velocity=(0.2, -1.0))),
])
def test_convection_diffusion_2d_equals_jax(n_side, kw):
    got = gallery.convection_diffusion_2d(n_side, **kw)
    want = jgallery.convection_diffusion_2d(n_side, **kw)
    assert got[3] == want[3]
    for g, w in zip(got[:3], want[:3]):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_convection_diffusion_2d_guards():
    with pytest.raises(ValueError, match="scheme"):
        gallery.convection_diffusion_2d(4, scheme="downwind")
    with pytest.raises(ValueError, match="velocity"):
        gallery.convection_diffusion_2d(4, velocity=(0.0, 0.0))


# -- MatrixLinOp.astype --------------------------------------------------------------


@pytest.mark.parametrize("fmt", ["dense", "coo", "csr", "ell", "sellp"])
def test_astype_casts_values_keeps_structure(fmt):
    a = _banded(20, 3, -0.5)
    A = (F.Dense(torch.from_numpy(a)) if fmt == "dense"
         else getattr(F, f"{fmt}_from_dense")(a, device="cpu"))
    B = A.astype(torch.float64)
    assert type(B) is type(A) and B.shape == A.shape
    assert B.dtype == torch.float64 and A.dtype == torch.float32
    for name in ("indptr", "indices", "row_idx", "col_idx", "slice_sets"):
        if hasattr(A, name):
            assert getattr(B, name) is getattr(A, name)
    assert torch.equal(B.values, A.values.double())
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(20))
    np.testing.assert_allclose(B.apply(x, executor=TORCH).numpy(), a @ x.numpy(),
                               rtol=1e-12)


# -- ParILU setup: tables equal to the JAX package's -------------------------------


@functools.lru_cache(maxsize=None)
def _setup_matrix(name):
    if name == "banded64":
        return _banded(64, 5, -0.7)
    if name == "dense12":
        rng = np.random.default_rng(0)
        a = rng.normal(size=(12, 12)).astype(np.float32)
        return a @ a.T + 12 * np.eye(12, dtype=np.float32)
    if name == "tridiag_nonsym":
        return _tridiag_nonsym()
    if name == "convdiff16":
        return _dense(gallery.convection_diffusion_2d(16, peclet=2.0))
    if name == "powerlaw256":
        return _dense(gallery.power_law_laplacian(256, seed=4)).astype(np.float32)
    if name == "random_nonsym":
        rng = np.random.default_rng(3)
        a = (rng.standard_normal((40, 40)) * (rng.random((40, 40)) < 0.15))
        return (a + 40 * np.eye(40)).astype(np.float32)
    raise KeyError(name)


SETUP_MATRICES = ["banded64", "dense12", "tridiag_nonsym", "convdiff16",
                  "powerlaw256", "random_nonsym"]
TABLES = ("l_rows", "l_cols", "u_rows", "u_cols", "a_rows", "a_cols",
          "is_lower", "slot", "dep_l", "dep_u", "u_diag_slot")


@pytest.mark.parametrize("name", SETUP_MATRICES)
def test_parilu_setup_tables_equal_jax(name):
    a = _setup_matrix(name)
    got = parilu_setup(F.csr_from_dense(a, device="cpu"))
    want = jax_parilu_setup(jsparse.csr_from_dense(a))
    assert got.n == want.n
    for field in TABLES:
        g, w = getattr(got, field), getattr(want, field)
        assert g.dtype == w.dtype, field
        np.testing.assert_array_equal(g, w, err_msg=field)


@pytest.mark.parametrize("name", SETUP_MATRICES)
def test_parilu_factors_match_jax(name):
    a = _setup_matrix(name)
    l_t, u_t, _ = parilu_factorize(F.csr_from_dense(a, device="cpu"), sweeps=5)
    l_j, u_j, _ = jax_parilu_factorize(jsparse.csr_from_dense(a), sweeps=5)
    for got, want in ((l_t, l_j), (u_t, u_j)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=FACTOR_RTOL * np.abs(want).max())


def test_parilu_needs_csr_and_a_full_diagonal():
    a = _banded(8, 3, -0.5)
    with pytest.raises(TypeError, match="CSR"):
        parilu_setup(F.ell_from_dense(a, device="cpu"))
    a[3, 3] = 0.0
    with pytest.raises(KeyError):
        parilu_setup(F.csr_from_dense(a, device="cpu"))


# -- ParILU: the JAX package's test_parilu cases ------------------------------------


def _factors_dense(l_vals, u_vals, st, n):
    L = np.eye(n, dtype=np.float32)
    U = np.zeros((n, n), np.float32)
    L[st.l_rows, st.l_cols] = l_vals.numpy()
    U[st.u_rows, st.u_cols] = u_vals.numpy()
    return L, U


def test_full_pattern_converges_to_exact_lu():
    a = _setup_matrix("dense12")
    l_vals, u_vals, st = parilu_factorize(F.csr_from_dense(a, device="cpu"),
                                          sweeps=40)
    L, U = _factors_dense(l_vals, u_vals, st, 12)
    assert np.abs(L @ U - a).max() / np.abs(a).max() < 1e-4


def test_sparse_pattern_residual_decreases():
    a = _setup_matrix("banded64")
    A = F.csr_from_dense(a, device="cpu")

    def pattern_residual(sweeps):
        L, U = _factors_dense(*parilu_factorize(A, sweeps=sweeps), 64)
        return np.abs((L @ U - a) * (a != 0)).max()

    r1, r3, r6 = pattern_residual(1), pattern_residual(3), pattern_residual(6)
    assert r6 <= r3 + 1e-6 and r6 < r1


@pytest.mark.parametrize("case", ["cg_banded120", "bicgstab_tridiag80"])
def test_parilu_preconditioned_solves_match_jax(case):
    rng = np.random.default_rng(0)
    a = _banded(120, 5, -0.8) if case.startswith("cg") else _tridiag_nonsym()
    xstar = rng.normal(size=a.shape[0]).astype(np.float32)
    b = (a @ xstar).astype(np.float32)
    jfn, fn = ((jsolvers.cg, cg) if case.startswith("cg")
               else (jsolvers.bicgstab, bicgstab))
    stop = (500, 1e-6) if case.startswith("cg") else (400, 1e-6)
    Aj = jsparse.csr_from_dense(a)
    want = jfn(Aj, jnp.asarray(b), stop=jsolvers.Stop(*stop),
               M=jsolvers.parilu_preconditioner(Aj))
    A = F.csr_from_dense(a, device="cpu")
    M = parilu_preconditioner(A, factor_sweeps=5, solve_sweeps=8)
    res = fn(A, torch.from_numpy(b), stop=Stop(*stop), M=M, executor=TORCH)
    assert res.converged and res.iterations == int(want.iterations)
    assert _close(res.x, np.asarray(want.x), X_RTOL)
    np.testing.assert_allclose(res.x.numpy(), xstar, atol=1e-3)
    if case.startswith("cg"):
        plain = cg(A, torch.from_numpy(b), stop=Stop(*stop), executor=TORCH)
        assert res.iterations < plain.iterations // 2


def test_parilu_apply_matches_jax_and_repeats_bitwise():
    a = _setup_matrix("convdiff16")
    A = F.csr_from_dense(a, device="cpu")
    M = make_preconditioner(A, "parilu", solve_sweeps=6)
    assert isinstance(M, ParILU) and M.shape == A.shape
    assert M.storage_bytes == 4 * a.astype(bool).sum()
    Aj = jsparse.csr_from_dense(a)
    Mj = jsolvers.parilu_preconditioner(Aj, solve_sweeps=6)
    v = np.random.default_rng(1).standard_normal(a.shape[0]).astype(np.float32)
    got = M.apply(torch.from_numpy(v), executor=TORCH)
    want = np.asarray(Mj.apply(jnp.asarray(v)))
    assert _close(got, want, 1e-5)
    assert torch.equal(M.apply(torch.from_numpy(v), executor=TORCH), got)


def test_batch_parilu_apply_matches_solo_and_jax():
    a = _setup_matrix("random_nonsym")
    A = F.csr_from_dense(a, device="cpu")
    rng = np.random.default_rng(2)
    st = parilu_setup(A)
    ls, us = [], []
    for s in range(3):  # per-system values on the shared pattern
        As = F.Csr(A.indptr, A.indices, A.values * (1.0 + 0.1 * s), A.shape)
        l_vals, u_vals, _ = parilu_factorize(As, st)
        ls.append(l_vals)
        us.append(u_vals)
    L, U = torch.stack(ls), torch.stack(us)
    B = torch.from_numpy(rng.standard_normal((3, 40)).astype(np.float32))
    got = batch_parilu_apply(st, L, U, B, sweeps=5)
    jst = jax_parilu_setup(jsparse.csr_from_dense(a))
    want = np.asarray(jax_batch_parilu_apply(jst, jnp.asarray(L.numpy()),
                                             jnp.asarray(U.numpy()),
                                             jnp.asarray(B.numpy()), sweeps=5))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    for s in range(3):
        solo = ParILU(st, ls[s], us[s], 5, torch.float32)
        np.testing.assert_allclose(got[s].numpy(),
                                   solo.apply(B[s], executor=TORCH).numpy(),
                                   rtol=1e-6, atol=1e-7)


#: the JAX package's recorded iterations with ParILU (test_convergence_regression)
PARILU_RECORDED = {"cg": 6, "fcg": 6, "bicgstab": 3, "cgs": 3, "gmres": 30}


def _regression_system(solver):
    rng = np.random.default_rng(3 if solver in ("cg", "fcg") else 4)
    a = _banded(96, 3, -0.5)
    x = rng.normal(size=96).astype(np.float32)
    if solver not in ("cg", "fcg"):
        a = a + np.triu(rng.normal(size=(96, 96)).astype(np.float32) * 0.05, 1)
    return a, x, (a @ x).astype(np.float32)


@pytest.mark.parametrize("solver", sorted(PARILU_RECORDED))
def test_parilu_convergence_regression_matches_jax(solver):
    a, xstar, b = _regression_system(solver)
    Aj = jsparse.csr_from_dense(a)
    want = getattr(jsolvers, solver)(Aj, jnp.asarray(b),
                                     stop=jsolvers.Stop(500, 1e-6),
                                     M=jsolvers.parilu_preconditioner(Aj))
    A = F.csr_from_dense(a, device="cpu")
    fn = {"cg": cg, "fcg": fcg, "bicgstab": bicgstab, "cgs": cgs,
          "gmres": gmres}[solver]
    res = fn(A, torch.from_numpy(b), stop=Stop(500, 1e-6), M="parilu",
             executor=TORCH)
    assert res.converged and bool(want.converged)
    assert res.iterations == int(want.iterations)
    assert int(want.iterations) <= int(np.ceil(PARILU_RECORDED[solver] * 1.15))
    assert _close(res.x, np.asarray(want.x), X_RTOL)


def test_preconditioner_ordering_invariants():
    """parilu <= block_jacobi <= jacobi <= identity (CG iterations)."""
    a, _, b = _regression_system("cg")
    A = F.csr_from_dense(a, device="cpu")
    iters = {name: cg(A, torch.from_numpy(b), stop=Stop(500, 1e-6), M=M,
                      executor=TORCH).iterations
             for name, M in (("identity", None),
                             ("jacobi", jacobi_preconditioner(A, TORCH)),
                             ("block_jacobi", block_jacobi(A, 4, executor=TORCH)),
                             ("parilu", "parilu"))}
    assert (iters["parilu"] <= iters["block_jacobi"] <= iters["jacobi"]
            <= iters["identity"]), iters


def test_factory_names_parilu():
    with pytest.raises(KeyError, match="parilu"):
        make_preconditioner(None, "ilut")


# -- iterative refinement: the JAX package's test_ir cases --------------------------

F64_STOP = dict(max_iters=100, reduction_factor=1e-12)


def spd_dense(n=96, dtype=np.float64):
    return _banded(n, 3, -0.5, dtype)


def blocked_spd_dense(n=128, bs=8, dtype=np.float64):
    rng = np.random.default_rng(7)
    a = np.zeros((n, n), dtype)
    for s in range(0, n, bs):
        blk = rng.normal(size=(bs, bs))
        a[s:s + bs, s:s + bs] = blk @ blk.T + 4 * np.eye(bs)
    for i in range(n - bs):
        a[i, i + bs] = a[i + bs, i] = 0.05
    return a


def _jax_mpir(a, b):
    with jax.enable_x64(True):
        A = jsparse.csr_from_dense(a)
        assert A.dtype == jnp.float64
        res = jsolvers.mixed_precision_ir(A, jnp.asarray(b),
                                          stop=jsolvers.Stop(**F64_STOP))
        return int(res.iterations), np.asarray(res.x), float(res.residual_norm)


@pytest.mark.parametrize("fixture", [spd_dense, blocked_spd_dense])
def test_mixed_precision_ir_reaches_f64_tolerance(fixture):
    """f32 inner CG under an f64 outer residual reaches the f64 tolerance,
    far below a pure-f32 CG; outer sweeps equal the JAX solve's."""
    a = fixture()
    n = a.shape[0]
    xstar = np.random.default_rng(0).normal(size=n)
    b = a @ xstar
    k_j, x_j, _ = _jax_mpir(a, b)
    A = F.csr_from_dense(a, device="cpu")
    assert A.dtype == torch.float64
    bt = torch.from_numpy(b)
    res = mixed_precision_ir(A, bt, stop=Stop(**F64_STOP), executor=TORCH)
    pure32 = cg(A.astype(torch.float32), bt.float(),
                stop=Stop(2000, 1e-12), executor=TORCH)
    assert res.converged and res.x.dtype == torch.float64
    assert float(res.residual_norm) < 1e-9
    assert float(res.residual_norm) < 0.1 * float(pure32.residual_norm)
    assert res.iterations == k_j
    np.testing.assert_allclose(res.x.numpy(), xstar, atol=1e-8)
    np.testing.assert_allclose(res.x.numpy(), x_j, atol=1e-9)


def test_mixed_precision_ir_outer_sweeps_are_few():
    a = spd_dense()
    b = a @ np.ones(a.shape[0])
    res = mixed_precision_ir(F.csr_from_dense(a, device="cpu"),
                             torch.from_numpy(b), stop=Stop(**F64_STOP),
                             executor=TORCH)
    assert res.converged and res.iterations <= 8
    assert res.iterations == _jax_mpir(a, b)[0]


@pytest.mark.parametrize("space", ["reference", "torch"])
@pytest.mark.parametrize("fmt", ["csr", "ell"])
def test_mixed_precision_ir_cross_executor(space, fmt):
    a = spd_dense(48)
    xstar = np.random.default_rng(1).normal(size=48)
    A = getattr(F, f"{fmt}_from_dense")(a, device="cpu")
    res = mixed_precision_ir(A, torch.from_numpy(a @ xstar),
                             stop=Stop(**F64_STOP), executor=make_executor(space))
    assert res.converged
    np.testing.assert_allclose(res.x.numpy(), xstar, atol=1e-8)


def test_mixed_precision_ir_inner_budget_and_solver():
    """The inner CG runs in f32 to sqrt(u_f32) within 200 iterations; inner
    options (here block-Jacobi) reach the generated inner solver."""
    a = blocked_spd_dense()
    b = torch.from_numpy(a @ np.ones(128))
    seen = []

    class Spy(CgSolver):
        def solve(self, r, x0=None, *, executor=None):
            out = super().solve(r, x0, executor=executor)
            seen.append((r.dtype, self.stop, out.iterations))
            return out

    res = mixed_precision_ir(F.csr_from_dense(a, device="cpu"), b,
                             stop=Stop(**F64_STOP), executor=TORCH,
                             inner_solver=Spy,
                             inner_opts={"M": "block_jacobi",
                                         "precond_opts": {"block_size": 8}})
    assert res.converged and len(seen) == res.iterations
    assert all(d == torch.float32 for d, _, _ in seen)
    assert seen[0][1] == Stop(200, unit_roundoff(torch.float32) ** 0.5)


def test_plain_richardson():
    a = spd_dense(64, dtype=np.float32)
    xstar = np.random.default_rng(2).normal(size=64).astype(np.float32)
    b = (a @ xstar).astype(np.float32)
    Aj = jsparse.csr_from_dense(a)
    want = jsolvers.ir(Aj, jnp.asarray(b), relaxation=0.2,
                       stop=jsolvers.Stop(500, 1e-5))
    res = ir(F.csr_from_dense(a, device="cpu"), torch.from_numpy(b),
             relaxation=0.2, stop=Stop(500, 1e-5), executor=TORCH)
    assert res.converged and res.iterations == int(want.iterations)
    np.testing.assert_allclose(res.x.numpy(), xstar, atol=1e-3)


def test_ir_with_preconditioner_inner():
    a = blocked_spd_dense(64, 8, dtype=np.float32)
    xstar = np.random.default_rng(4).normal(size=64).astype(np.float32)
    b = (a @ xstar).astype(np.float32)
    A = F.csr_from_dense(a, device="cpu")
    res = ir(A, torch.from_numpy(b), inner=block_jacobi(A, 8, executor=TORCH),
             stop=Stop(500, 1e-5), executor=TORCH)
    assert res.converged
    np.testing.assert_allclose(res.x.numpy(), xstar, atol=1e-3)


def test_ir_respects_max_iters():
    a = spd_dense(32, dtype=np.float32)
    b = torch.from_numpy((a @ np.ones(32)).astype(np.float32))
    res = ir(F.csr_from_dense(a, device="cpu"), b, relaxation=0.01,
             stop=Stop(3, 1e-10), executor=TORCH, history=True)
    assert res.iterations == 3 and not res.converged
    assert res.history.shape == (3,)


def test_ir_solver_factory_is_linop():
    """IrSolver composes like any operator: here it preconditions CG."""
    a = spd_dense(48, dtype=np.float32)
    xstar = np.random.default_rng(5).normal(size=48).astype(np.float32)
    b = torch.from_numpy((a @ xstar).astype(np.float32))
    A = F.csr_from_dense(a, device="cpu")
    S = IrSolver(A, inner=jacobi_preconditioner(A, TORCH),
                 stop=Stop(20, 1e-2))
    assert S.shape == A.shape and S.dtype == torch.float32
    res = cg(A, b, M=S, stop=Stop(200, 1e-5), executor=TORCH)
    assert res.converged
    np.testing.assert_allclose(res.x.numpy(), xstar, atol=1e-3)
    assert torch.equal(S.apply(b, executor=TORCH), S.solve(b, executor=TORCH).x)


def test_unit_roundoff_table():
    assert unit_roundoff(torch.float16) == 2.0 ** -11
    assert unit_roundoff(torch.bfloat16) == 2.0 ** -8
    assert unit_roundoff(torch.float32) == 2.0 ** -24
    assert unit_roundoff(torch.float64) == 2.0 ** -53


def test_mixed_precision_ir_requires_astype():
    with pytest.raises(TypeError, match="astype"):
        mixed_precision_ir(lambda v: v, torch.ones(4))


def test_ir_threads_executor_into_inner_operator():
    seen = []

    class Probe(LinOp):
        def _apply(self, v, executor):
            seen.append(executor)
            return v

    a = spd_dense(16, dtype=np.float32)
    b = torch.from_numpy((a @ np.ones(16)).astype(np.float32))
    ir(F.csr_from_dense(a, device="cpu"), b, inner=Probe(),
       stop=Stop(2, 1e-10), executor=TORCH)
    assert seen and all(e is TORCH for e in seen)
