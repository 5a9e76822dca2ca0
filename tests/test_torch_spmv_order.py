"""The torch space's row sums in a fixed order (no atomics) against the JAX
package and against the scatter-add they replaced.

On a CUDA tensor ``index_add_`` adds with atomics in no fixed order, so the
torch space's COO, CSR, SELL-P and ``BatchCsr`` SpMVs sum each row as one
segment (``torch.segment_reduce``) instead.  Here, on the CPU:

* each equals the JAX package's xla space (a sorted ``segment_sum``) on
  seeded inputs with empty rows, one and three right-hand sides: f32 sums,
  1e-5 relative to the sum of the terms' magnitudes (about 100 eps32);
* each is bitwise equal to the ``index_add_`` formulation it replaced (both
  add a row's terms one by one in entry order from 0);
* no torch-space SpMV's source calls ``index_add_``.
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import batch as jbatch
from repro.core import make_executor as jax_make_executor
from repro.sparse import formats as JF
from repro.sparse import ops as JO
from repro_torch import kernels as K
from repro_torch.batch import formats as TBF
from repro_torch.batch import ops as BO
from repro_torch.core import make_executor
from repro_torch.kernels.spmv_sellp.kernel import sellp_slice_of_column
from repro_torch.sparse import formats as F
from repro_torch.sparse import ops as O

RTOL = 1e-5
FORMATS = ["coo", "csr", "sellp", "batch_csr"]


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _dense(m, n, seed, density=0.3):
    """Random matrix with empty rows (2, 3 and the last) and one wide row."""
    rng = np.random.default_rng(seed)
    a = (rng.standard_normal((m, n)) * (rng.random((m, n)) < density)
         ).astype(np.float32)
    a[[2, 3, m - 1]] = 0.0
    a[1, : n // 2 + 1] = 1.0 + rng.random(n // 2 + 1).astype(np.float32)
    return a


def _case(fmt, rhs, seed=0):
    """(JAX object, port object, x as numpy, dense magnitude scale)."""
    m, n, nb = 37, 29, 4
    rng = np.random.default_rng(seed + 100)
    if fmt == "batch_csr":
        stack = np.stack([_dense(m, n, seed + b) for b in range(nb)])
        x = rng.standard_normal((nb, n)).astype(np.float32)
        scale = float(np.einsum("bij,bj->bi", np.abs(stack), np.abs(x)).max())
        return (jbatch.batch_csr_from_dense(stack),
                TBF.batch_csr_from_dense(stack, device="cpu"), x, scale)
    a = _dense(m, n, seed)
    shape = (n,) if rhs == 1 else (n, rhs)
    x = rng.standard_normal(shape).astype(np.float32)
    scale = float((np.abs(a) @ np.abs(x)).max())
    if fmt == "coo":
        return JF.coo_from_dense(a), F.coo_from_dense(a, device="cpu"), x, scale
    if fmt == "csr":
        return JF.csr_from_dense(a), F.csr_from_dense(a, device="cpu"), x, scale
    return (JF.sellp_from_dense(a, slice_size=8, stride_factor=2),
            F.sellp_from_dense(a, slice_size=8, stride_factor=2, device="cpu"),
            x, scale)


def _torch_space(fmt, A, x):
    ex = make_executor("torch")
    if fmt == "batch_csr":
        return BO.apply_batch(A, x, executor=ex)
    return O.apply(A, x, executor=ex)


def _scatter_add(fmt, A, x):
    """The torch space's former formulation: ``index_add_`` of every term
    into its row."""
    if fmt == "sellp":
        C = A.slice_size
        slice_of = sellp_slice_of_column(A.slice_sets, A.values.numel() // C)
        contrib = (A.values * x[A.col_idx]).view(-1, C)
        y = torch.zeros((A.num_slices, C), dtype=contrib.dtype)
        return y.index_add_(0, slice_of, contrib).view(-1)[:A.shape[0]]
    if fmt == "coo":
        rows, cols = A.row_idx.long(), A.col_idx
    else:
        counts = (A.indptr[1:] - A.indptr[:-1]).long()
        rows = torch.repeat_interleave(torch.arange(A.shape[0]), counts)
        cols = A.indices
    if fmt == "batch_csr":
        y = torch.zeros((x.shape[0], A.shape[0]), dtype=torch.float32)
        return y.index_add_(1, rows, A.values * x[:, cols])
    vals = A.values[:, None] if x.ndim == 2 else A.values
    y = torch.zeros((A.shape[0],) + tuple(x.shape[1:]), dtype=torch.float32)
    return y.index_add_(0, rows, vals * x[cols])


def _cases():
    for fmt in FORMATS:
        for rhs in ((1,) if fmt in ("sellp", "batch_csr") else (1, 3)):
            yield fmt, rhs


CASES = list(_cases())
CASE_IDS = [f"{f}-rhs{r}" for f, r in CASES]


@pytest.mark.parametrize("fmt,rhs", CASES, ids=CASE_IDS)
def test_torch_space_spmv_matches_jax(fmt, rhs):
    J, P, x, scale = _case(fmt, rhs)
    jex = jax_make_executor("xla")
    if fmt == "batch_csr":
        want = np.asarray(jbatch.apply_batch(J, jnp.asarray(x), executor=jex))
    else:
        want = np.asarray(JO.apply(J, jnp.asarray(x), executor=jex))
    got = _torch_space(fmt, P, torch.from_numpy(x))
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL,
                               atol=RTOL * max(scale, 1.0))
    assert torch.equal(got, _torch_space(fmt, P, torch.from_numpy(x)))


@pytest.mark.parametrize("fmt,rhs", CASES, ids=CASE_IDS)
def test_torch_space_spmv_bitwise_equals_scatter_add(fmt, rhs):
    _, P, x, _ = _case(fmt, rhs, seed=3)
    xt = torch.from_numpy(x)
    got = _torch_space(fmt, P, xt)
    assert torch.equal(got, _scatter_add(fmt, P, xt))


def test_sellp_plain_bitwise_equals_scatter_add():
    """The kernel's plain version (the SELL-P torch space, and what the CUDA
    kernel is held against) at C = 3 and 16 too."""
    for C in (3, 8, 16):
        a = _dense(45, 31, seed=C)
        P = F.sellp_from_dense(a, slice_size=C, stride_factor=1, device="cpu")
        x = torch.from_numpy(np.random.default_rng(C).standard_normal(31)
                             .astype(np.float32))
        y = K.spmv_sellp_plain(P.col_idx, P.values, P.slice_sets, x, 45, C)
        assert torch.equal(y, _scatter_add("sellp", P, x))


@pytest.mark.parametrize("op,fmt", [
    (O.spmv_coo, "coo"), (O.spmv_csr, "csr"), (O.spmv_sellp, "sellp"),
    (BO.spmv_batch_csr, "batch_csr"), (O.spmv_dot_csr_op, "csr")],
    ids=["coo", "csr", "sellp", "batch_csr", "spmv_dot_csr"])
def test_torch_space_spmv_has_no_index_add(op, fmt):
    space, impl = op.resolve(make_executor("torch"))
    assert space == "torch"
    sources = [inspect.getsource(impl)]
    for cell in impl.__closure__ or ():  # the fused op wraps the SpMV
        if callable(cell.cell_contents):
            sources.append(inspect.getsource(cell.cell_contents))
    sources.append(inspect.getsource(O.segment_spmv))
    sources.append(inspect.getsource(K.spmv_sellp_plain))
    assert not any("index_add" in src for src in sources), fmt
