"""SpMV with several right-hand sides: the port's reference and torch spaces
against the JAX package's xla space (``tests/sparse/test_formats.py``'s
``test_multi_rhs_spmv``), and the ELL plain version column by column against
its own one-right-hand-side call."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import sparse as jsparse
from repro.core import XlaExecutor, use_executor as jax_use_executor
from repro_torch import sparse
from repro_torch.core import make_executor
from repro_torch.sparse import formats as F

FORMATS = ("coo", "csr", "ell")
SPACES = ("reference", "torch")


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _problem(seed: int = 0, m: int = 20, n: int = 15, r: int = 3):
    """``test_formats.random_sparse(rng, 20, 15)`` and X (15, 3) drawn as
    the JAX test draws them."""
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(m, n)).astype(np.float32)
    mask = rng.random((m, n)) < 0.15
    a = np.where(mask, a, 0.0).astype(np.float32)
    X = rng.normal(size=(n, r)).astype(np.float32)
    return a, X


_BUILD = {"coo": (F.coo_from_dense, jsparse.coo_from_dense),
          "csr": (F.csr_from_dense, jsparse.csr_from_dense),
          "ell": (F.ell_from_dense, jsparse.ell_from_dense)}


@pytest.mark.parametrize("space", SPACES)
@pytest.mark.parametrize("fmt", FORMATS)
def test_multi_rhs_matches_the_jax_xla_space(fmt, space):
    a, X = _problem()
    with jax_use_executor(XlaExecutor()):
        want = np.asarray(jsparse.apply(_BUILD[fmt][1](a), jnp.asarray(X)))
    np.testing.assert_allclose(want, a @ X, rtol=1e-4, atol=1e-4)
    A = _BUILD[fmt][0](a, device="cpu")
    got = sparse.apply(A, torch.from_numpy(X), executor=make_executor(space))
    assert tuple(got.shape) == (20, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("space", SPACES)
@pytest.mark.parametrize("seed,m,n,r", [(0, 20, 15, 3), (1, 64, 40, 5),
                                        (2, 33, 70, 2)])
def test_ell_columns_are_the_one_rhs_call_bit_for_bit(space, seed, m, n, r):
    a, X = _problem(seed, m, n, r)
    A = F.ell_from_dense(a, device="cpu")
    ex = make_executor(space)
    Xt = torch.from_numpy(X)
    Y = sparse.apply(A, Xt, executor=ex)
    for j in range(r):
        y = sparse.apply(A, Xt[:, j].contiguous(), executor=ex)
        assert torch.equal(Y[:, j], y), j


def test_ell_multi_rhs_on_an_empty_row():
    a, X = _problem()
    a[3] = 0.0
    A = F.ell_from_dense(a, device="cpu")
    Y = sparse.apply(A, torch.from_numpy(X), executor=make_executor("torch"))
    assert torch.equal(Y[3], torch.zeros(3))
    np.testing.assert_allclose(Y.numpy(), a @ X, rtol=1e-4, atol=1e-4)


def test_cuda_space_ell_keeps_one_right_hand_side():
    """The cuda ELL kernel takes one right-hand side (as the JAX package's
    Pallas path does): a 2-D x raises there, and is never sent on to the
    torch space."""
    a, X = _problem()
    A = F.ell_from_dense(a, device="cpu")
    with pytest.raises(ValueError):
        sparse.apply(A, torch.from_numpy(X), executor=make_executor("cuda"))
