"""The port's block-Jacobi generation against the JAX package's.

* Block discovery and extraction are vectorised in the port; block pointers
  and block tensors must be identical to the JAX package's loops.
* Gauss–Jordan inverses agree within 1e-5 (f32, the same elimination order;
  only fused multiply-adds may differ), and the identity fallback of a
  rank-deficient block is identical.
* Adaptive storage selection gives equal ``precision_counts`` and
  ``storage_bytes``.  Stored inverses and applies are compared per storage
  class: within 1e-5 for f32 blocks, within one unit in the last place
  (the dtype's eps, relative) for bf16/fp16 copies of two such inverses.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import sparse as jsparse
from repro.core import make_executor as jax_make_executor
from repro.precond import block_jacobi as jax_block_jacobi
from repro.precond import invert_blocks as jax_invert_blocks
from repro.precond import natural_blocks as jax_natural_blocks
from repro.precond.block_jacobi import _extract_blocks_host as jax_extract
from repro_torch.core import make_executor
from repro_torch.precond import (
    block_jacobi,
    extract_blocks,
    invert_blocks,
    make_preconditioner,
    natural_blocks,
    uniform_block_ptrs,
)
from repro_torch.sparse import formats as F
from repro_torch.sparse import gallery


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def block_spd(n, bs, coupling=0.0, seed=8):
    """Block-structured SPD matrix whose blocks span every storage class:
    well conditioned (fp16), tiny-valued with a huge inverse (bf16), and
    stretched to a large condition number (f32)."""
    rng = np.random.default_rng(seed)
    a = np.zeros((n, n), np.float32)
    for bi, s in enumerate(range(0, n, bs)):
        e = min(s + bs, n)
        w = e - s
        blk = rng.normal(size=(w, w)).astype(np.float32)
        blk = blk @ blk.T / w + 4 * np.eye(w, dtype=np.float32)
        if bi % 3 == 1:
            blk = np.float32(1e-6) * np.eye(w, dtype=np.float32)
        elif bi % 3 == 2:
            scale = np.linspace(1.0, 40.0, w).astype(np.float32)
            blk = blk * np.sqrt(scale[:, None] * scale[None, :])
        a[s:e, s:e] = blk
    for i in range(n - bs):
        a[i, i + bs] = a[i + bs, i] = coupling
    return a


#: relative tolerance of a stored inverse, by storage dtype
STORE_RTOL = {"float32": 1e-5,
              "bfloat16": torch.finfo(torch.bfloat16).eps,
              "float16": torch.finfo(torch.float16).eps}


def _pair(a):
    """The same matrix as a JAX Ell and a port Ell (CPU)."""
    return jsparse.ell_from_dense(a), F.ell_from_dense(a, device="cpu")


def _matrices():
    ip, ix, v, shape = gallery.poisson_2d(12)
    a = np.zeros(shape, np.float32)
    a[np.repeat(np.arange(shape[0]), np.diff(ip)), ix] = v
    yield "poisson_2d", a
    yield "block_spd", block_spd(60, 8, coupling=0.01)
    a = block_spd(45, 5)  # n not a multiple of the block size
    a[7, :] = 0.0
    a[:, 7] = 0.0  # an empty row and column inside a block
    yield "empty_row", a
    rng = np.random.default_rng(3)
    s = (rng.random((70, 70)) < 0.04).astype(np.float32)
    yield "random_pattern", s + s.T + 5 * np.eye(70, dtype=np.float32)


MATRICES = list(_matrices())
IDS = [m[0] for m in MATRICES]


@pytest.mark.parametrize("name,a", MATRICES, ids=IDS)
@pytest.mark.parametrize("max_bs", [4, 8])
def test_natural_blocks_identical(name, a, max_bs):
    Aj, At = _pair(a)
    np.testing.assert_array_equal(natural_blocks(At, max_bs),
                                  jax_natural_blocks(Aj, max_bs))


@pytest.mark.parametrize("name,a", MATRICES, ids=IDS)
def test_extract_blocks_identical(name, a):
    Aj, At = _pair(a)
    for ptrs in (uniform_block_ptrs(a.shape[0], 8), jax_natural_blocks(Aj, 6)):
        bj, sj = jax_extract(Aj, ptrs)
        bt, st = extract_blocks(At, ptrs)
        np.testing.assert_array_equal(bt, bj)
        np.testing.assert_array_equal(st, sj)


def test_invert_blocks_match_and_identity_fallback():
    rng = np.random.default_rng(0)
    blocks = rng.standard_normal((40, 8, 8)).astype(np.float32)
    blocks += 6 * np.eye(8, dtype=np.float32)
    blocks[3, :, 0] = 0.0  # zero first column: pivoting must swap rows
    blocks[3, 0, 0] = 0.0
    blocks[3, 1, 0] = 2.0
    blocks[5, 4, :] = 0.0  # rank deficient
    blocks[6] = 0.0  # all zero
    blocks[7, :, 3] = 0.0  # zero column
    want = np.asarray(jax_invert_blocks(jnp.asarray(blocks)))
    got = invert_blocks(torch.from_numpy(blocks)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    eye = np.eye(8, dtype=np.float32)
    for b in (5, 6, 7):
        np.testing.assert_array_equal(got[b], eye)
        np.testing.assert_array_equal(want[b], eye)
    np.testing.assert_allclose(got[3] @ blocks[3], eye, atol=1e-5)


@pytest.mark.parametrize("name,a", MATRICES, ids=IDS)
@pytest.mark.parametrize("adaptive", [False, True, "bfloat16"])
def test_block_jacobi_storage_matches(name, a, adaptive):
    Aj, At = _pair(a)
    Pj = jax_block_jacobi(Aj, 8, adaptive=adaptive)
    Pt = block_jacobi(At, 8, adaptive=adaptive)
    assert Pt.precision_counts == Pj.precision_counts
    assert Pt.storage_bytes == Pj.storage_bytes
    assert (Pt.n, Pt.block_size, Pt.num_blocks) == (Pj.n, Pj.block_size,
                                                    Pj.num_blocks)
    np.testing.assert_array_equal(Pt.gather_idx.numpy(), np.asarray(Pj.gather_idx))
    np.testing.assert_array_equal(Pt.scatter_idx.numpy(), np.asarray(Pj.scatter_idx))
    rtols = [STORE_RTOL[d] for d, _ in Pt.precision_counts]
    for tj, tt, rtol in zip(Pj.inv_blocks, Pt.inv_blocks, rtols):
        want_inv = np.asarray(tj, np.float32)
        np.testing.assert_allclose(tt.float().numpy(), want_inv, rtol=rtol,
                                   atol=1e-5 * float(np.abs(want_inv).max()))
    # each row's tolerance is its class's, relative to sum_j |inv_ij v_j|
    r = np.random.default_rng(2).standard_normal(a.shape[0]).astype(np.float32)
    counts = np.array([c for _, c in Pt.precision_counts])
    row_class = np.searchsorted(np.cumsum(counts),
                                Pt.scatter_idx.numpy() // Pt.block_size,
                                side="right")
    P_abs = dataclasses.replace(Pt, inv_blocks=tuple(t.abs() for t in Pt.inv_blocks))
    scale = P_abs.apply(torch.from_numpy(np.abs(r)),
                        executor=make_executor("reference")).numpy()
    tol = np.asarray(rtols)[row_class] * scale + 1e-30
    want = np.asarray(Pj.apply(jnp.asarray(r), executor=jax_make_executor("xla")))
    for space in ("reference", "torch"):
        got = Pt.apply(torch.from_numpy(r), executor=make_executor(space)).numpy()
        bad = np.abs(got - want) > tol
        assert not bad.any(), (space, np.flatnonzero(bad)[:5],
                               (np.abs(got - want) / tol).max())


def test_adaptive_mixes_all_classes():
    """The fixture exercises every storage class (so the test above does)."""
    _, At = _pair(block_spd(60, 8))
    P = block_jacobi(At, 8, adaptive=True)
    assert {d for d, _ in P.precision_counts} == {"float32", "bfloat16", "float16"}


def test_natural_blocks_drive_block_jacobi():
    a = block_spd(45, 5)
    Aj, At = _pair(a)
    ptrs = natural_blocks(At, 8)
    Pj = jax_block_jacobi(Aj, blocks=jax_natural_blocks(Aj, 8))
    Pt = block_jacobi(At, blocks=ptrs)
    assert Pt.precision_counts == Pj.precision_counts
    np.testing.assert_array_equal(Pt.scatter_idx.numpy(), np.asarray(Pj.scatter_idx))


def test_default_block_size_and_factory():
    _, At = _pair(block_spd(24, 8))
    P = make_preconditioner(At, "block_jacobi", executor=make_executor("torch"))
    assert P.block_size == 8  # the executor's subgroup width
    with pytest.raises(TypeError, match="CSR"):  # ParILU takes CSR, as in JAX
        make_preconditioner(At, "parilu")
    # AMG takes this ELL operand too (the JAX package's takes CSR only); at
    # 24 rows it is not coarsened: the dense coarse solve alone
    M = make_preconditioner(At, "amg", executor=make_executor("torch"))
    assert M.num_levels == 1 and M.shape == At.shape
    with pytest.raises(ValueError, match="block pointers"):
        block_jacobi(At, blocks=[0, 5, 3, 24])
    with pytest.raises(ValueError, match="adaptive"):
        block_jacobi(At, 8, adaptive="int8")
