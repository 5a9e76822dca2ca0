"""The port's CG against the JAX package's, and the port's own pins.

* On ``poisson_2d(32)`` and an ``spd_banded`` matrix, as ELL, with M ``None``,
  ``"jacobi"`` and ``"block_jacobi"``, fused and unfused: iterations within
  ±1 of the JAX solve (f32 dots summed in another order), x within 1e-4
  relative (2-norm).
* In the torch and reference spaces the fused and unfused loops give
  bitwise-equal results (the fused ops are the literal composition there).
* From the port's dispatch log, with identity M: the fused loop body does its
  reduction work in 2 launches, the unfused body takes 7 (the pins of the
  JAX package's benchmark).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import sparse as jsparse
from repro import solvers as jsolvers
from repro.core import make_executor as jax_make_executor
from repro_torch.core import MatrixFreeOp, make_executor
from repro_torch.solvers import CgSolver, Stop, cg, jacobi_preconditioner
from repro_torch.sparse import formats as F
from repro_torch.sparse import gallery
from repro_torch.sparse import ops as blas

STOP_KW = dict(max_iters=500, reduction_factor=1e-6)


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@functools.lru_cache(maxsize=None)
def _problem(name):
    if name == "poisson_2d":
        ip, ix, v, shape = gallery.poisson_2d(32)
    else:
        ip, ix, v, shape = gallery.spd_banded(
            600, (1, 2, 4), 0.05, np.random.default_rng(11))
    b = np.random.default_rng(5).standard_normal(shape[0]).astype(np.float32)
    return ip, ix, v, shape, b


@functools.lru_cache(maxsize=None)
def _jax_solve(name, M):
    ip, ix, v, shape, b = _problem(name)
    A = jsparse.ell_from_csr_host(ip, ix, v, shape)
    res = jsolvers.cg(A, jnp.asarray(b), M=M, stop=jsolvers.Stop(**STOP_KW),
                      executor=jax_make_executor("xla"))
    return int(res.iterations), np.asarray(res.x), bool(res.converged)


def _port_A(name):
    ip, ix, v, shape, b = _problem(name)
    return F.ell_from_csr_host(ip, ix, v, shape, device="cpu"), torch.from_numpy(b)


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("M", [None, "jacobi", "block_jacobi"])
@pytest.mark.parametrize("name", ["poisson_2d", "spd_banded"])
def test_cg_matches_jax(name, M, fused):
    k_j, x_j, conv_j = _jax_solve(name, M)
    A, b = _port_A(name)
    res = cg(A, b, M=M, stop=Stop(**STOP_KW), executor=make_executor("torch"),
             fused=fused)
    assert conv_j and res.converged
    assert abs(res.iterations - k_j) <= 1, (res.iterations, k_j)
    x = res.x.numpy()
    assert np.linalg.norm(x - x_j) <= 1e-4 * np.linalg.norm(x_j)
    assert res.x.dtype == torch.float32 and res.residual_norm.ndim == 0


@pytest.mark.parametrize("space", ["torch", "reference"])
@pytest.mark.parametrize("M", [None, "jacobi", "block_jacobi"])
def test_fused_unfused_bitwise(space, M):
    A, b = _port_A("spd_banded")
    ex = make_executor(space)
    on = cg(A, b, M=M, stop=Stop(**STOP_KW), executor=ex, fused=True)
    off = cg(A, b, M=M, stop=Stop(**STOP_KW), executor=ex, fused=False)
    assert on.iterations == off.iterations
    assert torch.equal(on.x, off.x)
    assert torch.equal(on.residual_norm, off.residual_norm)


def test_loop_body_launch_pins():
    A, b = _port_A("poisson_2d")
    ex = make_executor("torch")
    res = cg(A, b, stop=Stop(**STOP_KW), executor=ex, fused=True)
    k, log = res.iterations, dict(ex.dispatch_log)
    # init: spmv_ell (b - A x0), blas_dot (r·z), 2 blas_norm2 (b and r)
    assert (log["spmv_ell"], log["blas_dot"], log["blas_norm2"]) == (1, 1, 2)
    assert log["spmv_dot_ell"] == k and log["axpy_norm"] == k
    fused_body = (log["spmv_dot_ell"] + log["axpy_norm"]) / k
    assert fused_body == 2

    ex.dispatch_log.clear()
    res = cg(A, b, stop=Stop(**STOP_KW), executor=ex, fused=False)
    k, log = res.iterations, dict(ex.dispatch_log)
    unfused_body = ((log["spmv_ell"] - 1) + (log["blas_dot"] - 1)
                    + (log["blas_norm2"] - 2) + log["blas_axpy"]) / k
    assert unfused_body == 7


def test_history_ring_buffer():
    A, b = _port_A("poisson_2d")
    ex = make_executor("torch")
    res = cg(A, b, stop=Stop(**STOP_KW), executor=ex, history=True)
    h = res.history.numpy()
    assert h.shape == (STOP_KW["max_iters"],)
    assert np.isfinite(h[:res.iterations]).all()
    assert np.isnan(h[res.iterations:]).all()
    assert h[res.iterations - 1] == float(res.residual_norm)
    small = cg(A, b, stop=Stop(**STOP_KW), executor=ex, history=4)
    assert small.history.shape == (4,)
    assert cg(A, b, stop=Stop(**STOP_KW), executor=ex).history is None


def test_solver_factory_and_guards():
    A, b = _port_A("spd_banded")
    ex = make_executor("torch")
    direct = cg(A, b, M="block_jacobi", stop=Stop(**STOP_KW), executor=ex)
    solver = CgSolver(A, M="block_jacobi", stop=Stop(**STOP_KW), executor=ex)
    assert torch.equal(solver.apply(b), direct.x)
    assert cg(A, b, stop=Stop(**STOP_KW), executor=ex, pipeline=True).converged
    with pytest.raises(ValueError, match="degenerate"):
        cg(A, b, executor=ex, stop=Stop(reduction_factor=0.0))
    a = np.triu(np.ones((6, 6), np.float32)) + 6 * np.eye(6, dtype=np.float32)
    N = F.ell_from_dense(a, device="cpu")
    with pytest.raises(ValueError, match="symmetric"):
        cg(N, torch.ones(6), executor=ex)
    cg(N, torch.ones(6), executor=ex, strict=False)  # the escape hatch


def test_matrix_free_operator_takes_unfused_loop():
    A, b = _port_A("poisson_2d")
    ex = make_executor("torch")
    free = MatrixFreeOp(lambda v: blas.apply(A, v, executor=ex), shape=A.shape,
                        dtype=A.dtype)
    assert not blas.has_fused_ops(free, executor=ex)
    got = cg(free, b, stop=Stop(**STOP_KW), executor=ex, fused=True)
    want = cg(A, b, stop=Stop(**STOP_KW), executor=ex, fused=False)
    assert got.iterations == want.iterations
    assert torch.equal(got.x, want.x)


@pytest.mark.parametrize("adaptive", [False, True, "bfloat16"])
def test_scalar_jacobi_storage_matches_jax(adaptive):
    ip, ix, v, shape, b = _problem("spd_banded")
    Aj = jsparse.ell_from_csr_host(ip, ix, v, shape)
    Mj = jsolvers.jacobi_preconditioner(Aj, jax_make_executor("xla"),
                                        adaptive=adaptive)
    A, bt = _port_A("spd_banded")
    Mt = jacobi_preconditioner(A, make_executor("torch"), adaptive=adaptive)
    assert str(Mt.dtype).removeprefix("torch.") == str(Mj.dtype)
    assert Mt.storage_bytes == Mj.storage_bytes
    np.testing.assert_array_equal(Mt.inv_diag.float().numpy(),
                                  np.asarray(Mj.inv_diag, np.float32))
    want = np.asarray(Mj.apply(jnp.asarray(b)))
    np.testing.assert_allclose(Mt.apply(bt).numpy(), want, rtol=1e-6)
