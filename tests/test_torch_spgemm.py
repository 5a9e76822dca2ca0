"""The port's SpGEMM, sparse transpose and densify against the JAX package's.

* The two kernels' plain versions (reached through the wrappers, as a CPU
  caller reaches them) against the Pallas ``spgemm_expand`` / ``csr_permute``
  in interpret mode, ragged T and K included: bitwise, since each output is
  one f32 multiply or one copy.
* ``spgemm`` / ``sptranspose`` in the port's ``reference`` and ``torch``
  spaces against the JAX package's ``reference`` and ``xla`` /
  ``pallas_interpret`` spaces: identical structure (the structure passes,
  on the host there and on the tensors' device here, give the same
  integers) and bitwise values (the products are single multiplies and the
  per-entry sums run in the same order in the same numpy routine).
* Semantics against a dense numpy oracle (1e-5 relative: f32 sums of a few
  terms): empty rows, zero nnz, zero dimensions, a rectangular chain,
  structural zeros kept, and the transpose algebra.
* The ``cuda`` space resolves to its kernels and raises on CPU tensors
  instead of falling back.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import sparse as jsparse
from repro.core import make_executor as jax_make_executor
from repro.kernels.spgemm.kernel import csr_permute as jax_csr_permute
from repro.kernels.spgemm.kernel import spgemm_expand as jax_spgemm_expand
from repro_torch import kernels as K
from repro_torch.core import CudaExecutor, make_executor, registry
from repro_torch.sparse import formats as F
from repro_torch.sparse import ops

#: port space -> the JAX package's spaces it is held bitwise against
SPACES = [("reference", "reference"), ("torch", "xla"),
          ("torch", "pallas_interpret")]


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _rand_sparse(m, n, density, seed):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(m, n)).astype(np.float32)
    return np.where(rng.random((m, n)) < density, a, 0.0).astype(np.float32)


def _pair(a):
    """The same matrix as a JAX Csr and a port Csr on the CPU."""
    return jsparse.csr_from_dense(a), F.csr_from_dense(a, device="cpu")


def _dense(C) -> np.ndarray:
    return ops.to_dense(C, executor=make_executor("reference")).numpy()


def _assert_same_csr(got, want):
    """Port Csr against JAX Csr: shape, structure and values bit for bit."""
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_array_equal(got.indptr.numpy(), np.asarray(want.indptr))
    np.testing.assert_array_equal(got.indices.numpy(), np.asarray(want.indices))
    np.testing.assert_array_equal(got.values.numpy(), np.asarray(want.values))


def _assert_sorted_rows(C):
    indptr, indices = C.indptr.numpy(), C.indices.numpy()
    assert indptr[0] == 0 and indptr[-1] == indices.size
    for i in range(C.shape[0]):
        assert np.all(np.diff(indices[indptr[i]:indptr[i + 1]]) > 0)


# -- the kernels' plain versions against the Pallas kernels ---------------------


@pytest.mark.parametrize("t,k,nnzb", [(37, 5, 40), (256, 3, 300), (1, 1, 1),
                                      (130, 33, 64)])
def test_spgemm_expand_plain_matches_pallas_bitwise(t, k, nnzb):
    rng = np.random.default_rng(t * 100 + k)
    a = rng.standard_normal(t).astype(np.float32)
    b_pad = np.concatenate([[0.0], rng.standard_normal(nnzb)]).astype(np.float32)
    idx = rng.integers(0, nnzb + 1, size=(t, k)).astype(np.int32)
    idx[:, k // 2:][rng.random((t, k - k // 2)) < 0.3] = 0  # padding slots
    want = jax_spgemm_expand(jnp.asarray(a), jnp.asarray(idx), jnp.asarray(b_pad),
                             block_t=8, block_k=4, interpret=True)
    before = K.spgemm_expand.launches
    got = K.spgemm_expand(torch.from_numpy(a), torch.from_numpy(idx),
                          torch.from_numpy(b_pad))
    assert K.spgemm_expand.launches == before  # the CPU path launches nothing
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.numpy()[idx == 0] == 0).all()


@pytest.mark.parametrize("nnz", [1, 37, 300])
def test_csr_permute_plain_matches_pallas_bitwise(nnz):
    rng = np.random.default_rng(nnz)
    values = rng.standard_normal(nnz).astype(np.float32)
    order = rng.permutation(nnz).astype(np.int32)
    want = jax_csr_permute(jnp.asarray(values), jnp.asarray(order), block_t=8,
                           interpret=True)
    before = K.csr_permute.launches
    got = K.csr_permute(torch.from_numpy(values), torch.from_numpy(order))
    assert K.csr_permute.launches == before
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("nnz", [41, 43, 1001, 1003])
def test_csr_permute_ragged_and_f64_match_pallas(nnz, dtype):
    """Counts of 4 k + 1 and 4 k + 3 (the kernel's scalar tail after its
    packs of 4) in f32 and f64, and an order offset by one entry (the
    kernel's scalar route): bitwise against the Pallas kernel."""
    rng = np.random.default_rng(nnz)
    values = rng.standard_normal(nnz + 1).astype(dtype)
    order = rng.permutation(nnz + 1).astype(np.int32)
    with jax.enable_x64(dtype == np.float64):
        want = np.asarray(jax_csr_permute(jnp.asarray(values),
                                          jnp.asarray(order[1:]), block_t=64,
                                          interpret=True))
    assert want.dtype == dtype and want.shape == (nnz,)
    got = K.csr_permute(torch.from_numpy(values), torch.from_numpy(order)[1:])
    np.testing.assert_array_equal(got.numpy(), want)


def test_kernel_wrappers_check_arguments():
    a = torch.ones(4)
    with pytest.raises(ValueError, match="int32"):
        K.spgemm_expand(a, torch.zeros((4, 2), dtype=torch.int64), torch.ones(3))
    with pytest.raises(ValueError, match=r"\(T,\) / \(T, K\)"):
        K.spgemm_expand(a, torch.zeros((3, 2), dtype=torch.int32), torch.ones(3))
    with pytest.raises(ValueError, match="dtype"):
        K.csr_permute(torch.ones(3, dtype=torch.int32),
                      torch.zeros(3, dtype=torch.int32))


# -- spgemm / sptranspose against the JAX package's spaces -------------------------


@pytest.mark.parametrize("port_space,jax_space", SPACES)
@pytest.mark.parametrize("m,k,n,density", [(17, 23, 11, 0.3), (5, 31, 13, 0.4),
                                           (24, 24, 24, 0.15)])
def test_spgemm_matches_jax_space(port_space, jax_space, m, k, n, density):
    a = _rand_sparse(m, k, density, m)
    b = _rand_sparse(k, n, density, m + 1)
    (Aj, At), (Bj, Bt) = _pair(a), _pair(b)
    want = jsparse.spgemm(Aj, Bj, executor=jax_make_executor(jax_space))
    got = ops.spgemm(At, Bt, executor=make_executor(port_space))
    _assert_same_csr(got, want)
    _assert_sorted_rows(got)
    np.testing.assert_allclose(_dense(got), a @ b, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("port_space,jax_space", SPACES)
@pytest.mark.parametrize("m,n,density", [(13, 7, 0.4), (30, 30, 0.1)])
def test_sptranspose_matches_jax_space(port_space, jax_space, m, n, density):
    a = _rand_sparse(m, n, density, m * n)
    Aj, At = _pair(a)
    want = jsparse.sptranspose(Aj, executor=jax_make_executor(jax_space))
    got = ops.sptranspose(At, executor=make_executor(port_space))
    _assert_same_csr(got, want)
    np.testing.assert_array_equal(_dense(got), a.T)


@pytest.mark.parametrize("space", ["reference", "torch"])
def test_to_dense_matches_jax(space):
    a = _rand_sparse(9, 6, 0.4, 3)
    ex = make_executor(space)
    jdense = np.asarray(jsparse.to_dense(jsparse.csr_from_dense(a)))
    for A in (F.csr_from_dense(a, device="cpu"), F.ell_from_dense(a, device="cpu"),
              F.Dense(torch.from_numpy(a))):
        np.testing.assert_array_equal(ops.to_dense(A, executor=ex).numpy(), jdense)
    empty = F.csr_from_arrays([0], [], np.zeros(0, np.float32), (0, 4), device="cpu")
    assert ops.to_dense(empty, executor=ex).shape == (0, 4)


# -- semantics and degenerates ---------------------------------------------------


@pytest.mark.parametrize("space", ["reference", "torch"])
def test_spgemm_empty_rows(space):
    a = _rand_sparse(9, 9, 0.5, 4)
    a[[0, 4, 8]] = 0.0
    b = _rand_sparse(9, 9, 0.5, 5)
    b[:, 2] = 0.0
    C = ops.spgemm(F.csr_from_dense(a, device="cpu"),
                   F.csr_from_dense(b, device="cpu"), executor=make_executor(space))
    indptr = C.indptr.numpy()
    for i in (0, 4, 8):
        assert indptr[i] == indptr[i + 1]
    _assert_sorted_rows(C)
    np.testing.assert_allclose(_dense(C), a @ b, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("space", ["reference", "torch"])
def test_spgemm_rectangular_chain(space):
    """(m,k)·(k,n)·(n,p) with all extents distinct."""
    ex = make_executor(space)
    a, b, c = (_rand_sparse(5, 31, 0.4, 2), _rand_sparse(31, 13, 0.4, 3),
               _rand_sparse(13, 7, 0.4, 4))
    A, B, Cm = (F.csr_from_dense(x, device="cpu") for x in (a, b, c))
    D = ops.spgemm(ops.spgemm(A, B, executor=ex), Cm, executor=ex)
    assert D.shape == (5, 7)
    np.testing.assert_allclose(_dense(D), a @ b @ c, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("space", ["reference", "torch"])
def test_spgemm_structural_zeros_kept(space):
    """Products that cancel stay in the pattern: a pure function of the
    operand patterns."""
    A = F.csr_from_arrays([0, 2], [0, 1], np.float32([1.0, -1.0]), (1, 2),
                          device="cpu")
    B = F.csr_from_arrays([0, 1, 2], [0, 0], np.float32([3.0, 3.0]), (2, 1),
                          device="cpu")
    C = ops.spgemm(A, B, executor=make_executor(space))
    assert C.nnz == 1
    assert C.values.numpy().tolist() == [0.0]


@pytest.mark.parametrize("space", ["reference", "torch"])
def test_spgemm_zero_nnz_and_zero_dim(space):
    ex = make_executor(space)
    b = F.csr_from_dense(_rand_sparse(3, 4, 0.5, 6), device="cpu")
    empty = F.csr_from_arrays([0, 0, 0], [], np.zeros(0, np.float32), (2, 3),
                              device="cpu")
    C = ops.spgemm(empty, b, executor=ex)
    assert C.shape == (2, 4) and C.nnz == 0 and C.indptr.tolist() == [0, 0, 0]
    none = F.csr_from_arrays([0], [], np.zeros(0, np.float32), (0, 3), device="cpu")
    C0 = ops.spgemm(none, b, executor=ex)
    assert C0.shape == (0, 4) and C0.nnz == 0
    # B's rows that A reaches are all empty: width K = 0
    a = F.csr_from_arrays([0, 1], [2], np.float32([1.0]), (1, 3), device="cpu")
    bz = F.csr_from_arrays([0, 1, 1, 1], [0], np.float32([2.0]), (3, 2), device="cpu")
    C1 = ops.spgemm(a, bz, executor=ex)
    assert C1.shape == (1, 2) and C1.nnz == 0
    T = ops.sptranspose(empty, executor=ex)
    assert T.shape == (3, 2) and T.nnz == 0
    assert ex.dispatch_log["sptranspose"] == 0  # degenerate: nothing dispatched


def test_spgemm_type_and_shape_errors():
    a = F.csr_from_dense(_rand_sparse(4, 4, 0.5, 7), device="cpu")
    with pytest.raises(TypeError):
        ops.spgemm(a, F.ell_from_dense(np.eye(4, dtype=np.float32), device="cpu"))
    with pytest.raises(ValueError, match="shape mismatch"):
        ops.spgemm(a, F.csr_from_dense(_rand_sparse(5, 4, 0.5, 8), device="cpu"))
    with pytest.raises(TypeError):
        ops.sptranspose(F.Dense(torch.eye(3)))


@pytest.mark.parametrize("space", ["reference", "torch"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_transpose_algebra(space, seed):
    """``(Aᵀ)ᵀ == A`` bitwise and ``(AᵀB)ᵀ == BᵀA`` in structure — the algebra
    the Galerkin product R·A·P leans on (R = Pᵀ)."""
    ex = make_executor(space)
    rng = np.random.default_rng(seed)
    m, k, n = rng.integers(1, 20, size=3)
    a = _rand_sparse(k, m, 0.3, seed)
    b = _rand_sparse(k, n, 0.3, seed + 10)
    A, B = F.csr_from_dense(a, device="cpu"), F.csr_from_dense(b, device="cpu")
    TT = ops.sptranspose(ops.sptranspose(A, executor=ex), executor=ex)
    for f in ("indptr", "indices", "values"):
        assert torch.equal(getattr(TT, f), getattr(A, f))
    lhs = ops.sptranspose(ops.spgemm(ops.sptranspose(A, executor=ex), B,
                                     executor=ex), executor=ex)
    rhs = ops.spgemm(ops.sptranspose(B, executor=ex), A, executor=ex)
    assert torch.equal(lhs.indptr, rhs.indptr)
    assert torch.equal(lhs.indices, rhs.indices)
    np.testing.assert_allclose(_dense(lhs), (a.T @ b).T, rtol=1e-4, atol=1e-4)


# -- the cuda space -----------------------------------------------------------------


def test_cuda_space_resolves_kernels_and_refuses_cpu_tensors():
    ex = CudaExecutor(device="cpu")
    for name in ("spgemm", "sptranspose"):
        assert registry.operation(name).space_used(ex) == "cuda"
    A = F.csr_from_dense(_rand_sparse(6, 6, 0.5, 9), device="cpu")
    with pytest.raises(ValueError, match="cuda kernel space needs CUDA tensors"):
        ops.spgemm(A, A, executor=ex)
    with pytest.raises(ValueError, match="cuda kernel space needs CUDA tensors"):
        ops.sptranspose(A, executor=ex)
    assert K.spgemm_expand.launches == 0 and K.csr_permute.launches == 0
