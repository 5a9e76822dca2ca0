"""The port's COO and SELL-P formats, transposes, ``convert`` and SELL-P SpMV
against the JAX package's, and Jacobi-CG on a power-law matrix as SELL-P.

* Host layouts are integer/array bookkeeping in numpy on both sides, so the
  SELL-P and COO buffers, the CSR readback, the transposes and every
  ``convert`` target must be identical, not merely close — at ``m % C != 0``,
  with empty rows, all-zero rows and several slice sizes and stride factors.
* ``spmv_sellp_plain`` (through the kernel's wrapper, as a CPU caller reaches
  it) and the reference/torch spaces are held against the Pallas
  ``spmv_sellp`` in interpret mode at ragged m: f32 sums in another order,
  so 1e-5 relative to the sum of the terms' magnitudes (about 100 eps32).
* Jacobi-CG on ``power_law_laplacian(512, seed=4)`` as SELL-P: iterations
  within ±1 of the JAX solve, x within 1e-4 relative (2-norm).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import solvers as jsolvers
from repro.core import make_executor as jax_make_executor
from repro.core.linop import Transpose as JTranspose
from repro.kernels.spmv_sellp.kernel import spmv_sellp as jax_spmv_sellp
from repro.solvers.common import extract_diag_op as jax_extract_diag
from repro.sparse import formats as JF
from repro.sparse import gallery as jgallery
from repro.sparse import ops as JO
from repro_torch import convert
from repro_torch import kernels as K
from repro_torch.core import (
    Composition,
    MatrixFreeOp,
    Sum,
    Transpose,
    make_executor,
)
from repro_torch.solvers import Stop, cg
from repro_torch.solvers.common import extract_diag_op
from repro_torch.sparse import formats as F
from repro_torch.sparse import gallery as tgallery
from repro_torch.sparse import ops as O

RTOL = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _dense(m, n, seed, density=0.3):
    """Random dense matrix with empty rows, an all-zero last row and (where
    m allows) a wide row, so slice widths differ."""
    rng = np.random.default_rng(seed)
    a = (rng.standard_normal((m, n)) * (rng.random((m, n)) < density)
         ).astype(np.float32)
    if m > 3:
        a[2] = 0.0
        a[m - 1] = 0.0
        a[1, : n // 2 + 1] = 1.0 + rng.random(n // 2 + 1).astype(np.float32)
    return a


#: (m, n, slice_size, stride_factor): ragged m, tiny, single-row, empty,
#: other slice sizes and strides
SHAPES = [(37, 29, 8, 8), (29, 23, 4, 2), (5, 9, 8, 8), (1, 3, 8, 8),
          (0, 4, 8, 8), (17, 17, 3, 5), (26, 20, 16, 1)]
SHAPE_IDS = [f"{m}x{n}-C{c}-s{s}" for m, n, c, s in SHAPES]


def _pair(a, C, sf):
    return (JF.sellp_from_dense(a, slice_size=C, stride_factor=sf),
            F.sellp_from_dense(a, slice_size=C, stride_factor=sf, device="cpu"))


def _same_arrays(jax_obj, port_obj, fields):
    for f in fields:
        want = np.asarray(getattr(jax_obj, f))
        got = getattr(port_obj, f).numpy()
        assert got.dtype == want.dtype, f
        np.testing.assert_array_equal(got, want, err_msg=f)


SELLP_FIELDS = ("col_idx", "values", "slice_sets", "slice_cols")


@pytest.mark.parametrize("m,n,C,sf", SHAPES, ids=SHAPE_IDS)
def test_sellp_layout_identical(m, n, C, sf):
    J, P = _pair(_dense(m, n, seed=m + n), C, sf)
    _same_arrays(J, P, SELLP_FIELDS)
    assert (P.max_slice_cols, P.slice_size, P.stride_factor, P.shape) == (
        J.max_slice_cols, J.slice_size, J.stride_factor, tuple(J.shape))
    assert P.nnz == J.nnz and P.memory_bytes == J.memory_bytes
    for want, got in zip(JF.csr_host_arrays(J), F.csr_host_arrays(P)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("m,n,C,sf", SHAPES, ids=SHAPE_IDS)
def test_sellp_from_csr_keeps_stored_zeros_as_jax(m, n, C, sf):
    """A CSR entry stored as 0 stays in the SELL-P buffers (both packages)
    and is dropped by the CSR readback."""
    a = _dense(m, n, seed=3 * m + 1)
    r, c = np.nonzero(a)
    v = a[r, c].copy()
    v[::3] = 0.0
    indptr = np.zeros(m + 1, np.int64)
    indptr[1:] = np.cumsum(np.bincount(r, minlength=m))
    J = JF.sellp_from_csr_host(indptr, c, v, (m, n), slice_size=C,
                               stride_factor=sf)
    P = F.sellp_from_csr_host(indptr, c, v, (m, n), slice_size=C,
                              stride_factor=sf, device="cpu")
    _same_arrays(J, P, SELLP_FIELDS)
    for want, got in zip(JF.csr_host_arrays(J), F.csr_host_arrays(P)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("m,n,C,sf", SHAPES, ids=SHAPE_IDS)
def test_transposes_identical(m, n, C, sf):
    a = _dense(m, n, seed=2 * m + 5)
    J, P = _pair(a, C, sf)
    _same_arrays(J.transpose(), P.transpose(), SELLP_FIELDS)
    assert P.transpose().slice_size == C
    _same_arrays(JF.coo_from_dense(a).transpose(),
                 F.coo_from_dense(a, device="cpu").transpose(),
                 ("row_idx", "col_idx", "values"))
    _same_arrays(JF.csr_from_dense(a).transpose(),
                 F.csr_from_dense(a, device="cpu").transpose(),
                 ("indptr", "indices", "values"))
    _same_arrays(JF.ell_from_dense(a).transpose(),
                 F.ell_from_dense(a, device="cpu").transpose(),
                 ("col_idx", "values"))
    np.testing.assert_array_equal(
        F.Dense(torch.from_numpy(a)).transpose().values.numpy(), a.T)


CONVERT_FIELDS = {
    "coo": ("row_idx", "col_idx", "values"),
    "csr": ("indptr", "indices", "values"),
    "ell": ("col_idx", "values"),
    "sellp": SELLP_FIELDS,
    "dense": ("values",),
}


@pytest.mark.parametrize("target", sorted(CONVERT_FIELDS))
@pytest.mark.parametrize("source", ["coo", "csr", "ell", "sellp", "dense"])
def test_convert_identical(source, target):
    a = _dense(21, 13, seed=7)
    J = JF.convert(JF.Dense(jnp.asarray(a)), source)
    P = F.convert(F.Dense(torch.from_numpy(a)), source)
    kw = {"slice_size": 4, "stride_factor": 2} if target == "sellp" else {}
    Jt, Pt = JF.convert(J, target, **kw), F.convert(P, target, **kw)
    assert type(Pt).__name__ == type(Jt).__name__
    _same_arrays(Jt, Pt, CONVERT_FIELDS[target])
    assert F.convert(P, type(P)) is P
    with pytest.raises(KeyError, match="unknown format"):
        F.convert(P, "hyb")


def test_convert_carries_jax_objects():
    a = _dense(19, 11, seed=9)
    J = JF.sellp_from_dense(a)
    P = convert.sellp(J.col_idx, J.values, J.slice_sets, J.slice_cols, J.shape,
                      J.slice_size, J.stride_factor, J.max_slice_cols,
                      device="cpu")
    _same_arrays(J, P, SELLP_FIELDS)
    Jc = JF.coo_from_dense(a)
    Pc = convert.coo(Jc.row_idx, Jc.col_idx, Jc.values, Jc.shape, device="cpu")
    _same_arrays(Jc, Pc, ("row_idx", "col_idx", "values"))


@pytest.mark.parametrize("m,n,C,sf", [s for s in SHAPES if s[0] and s[1]],
                         ids=[i for s, i in zip(SHAPES, SHAPE_IDS)
                              if s[0] and s[1]])
def test_spmv_sellp_matches_pallas(m, n, C, sf):
    J, P = _pair(_dense(m, n, seed=m * 7 + n), C, sf)
    x = np.random.default_rng(m).standard_normal(n).astype(np.float32)
    want = np.asarray(jax_spmv_sellp(
        J.col_idx, J.values, J.slice_sets, jnp.asarray(x), m=m, slice_size=C,
        block_cols=sf, max_slice_cols=J.max_slice_cols, interpret=True))
    xt = torch.from_numpy(x)
    scale = float((np.abs(np.asarray(JO.to_dense(J))) @ np.abs(x)).max())
    got = [K.spmv_sellp(P.col_idx, P.values, P.slice_sets, xt, m, C)]
    for space in ("reference", "torch"):
        got.append(O.apply(P, xt, executor=make_executor(space)))
    for y in got:
        assert y.shape == (m,) and y.dtype == torch.float32
        np.testing.assert_allclose(y.numpy(), want, rtol=RTOL,
                                   atol=RTOL * max(scale, 1.0))


def test_spmv_coo_and_to_dense_match_jax():
    a = _dense(23, 17, seed=11)
    x = np.random.default_rng(1).standard_normal(17).astype(np.float32)
    Jc, Pc = JF.coo_from_dense(a), F.coo_from_dense(a, device="cpu")
    want = np.asarray(JO.apply(Jc, jnp.asarray(x)))
    for space in ("reference", "torch"):
        ex = make_executor(space)
        np.testing.assert_allclose(
            O.apply(Pc, torch.from_numpy(x), executor=ex).numpy(), want,
            rtol=RTOL, atol=RTOL * float(np.abs(a).sum()))
        for P in (Pc, F.sellp_from_dense(a, device="cpu")):
            np.testing.assert_array_equal(O.to_dense(P, executor=ex).numpy(), a)
    assert O.to_dense(F.sellp_from_dense(np.zeros((0, 3), np.float32),
                                         device="cpu")).shape == (0, 3)


@pytest.mark.parametrize("fmt", ["coo", "sellp"])
def test_extract_diagonal_matches_jax(fmt):
    """SELL-P's diagonal is read from the slice layout; the JAX package
    densifies.  The values must be equal."""
    a = _dense(26, 26, seed=13)
    np.fill_diagonal(a, np.arange(1, 27, dtype=np.float32))
    a[5, 5] = 0.0
    J = JF.convert(JF.Dense(jnp.asarray(a)), fmt)
    P = F.convert(F.Dense(torch.from_numpy(a)), fmt)
    want = np.asarray(jax_extract_diag(J, executor=jax_make_executor("xla")))
    for space in ("reference", "torch"):
        got = extract_diag_op(P, executor=make_executor(space)).numpy()
        np.testing.assert_array_equal(got, want)


def test_transpose_linop():
    a = _dense(12, 9, seed=17)
    P = F.sellp_from_dense(a, device="cpu")
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(12)
                         .astype(np.float32))
    ex = make_executor("torch")
    T = Transpose(P)
    assert T.shape == (9, 12) and T.dtype == torch.float32
    np.testing.assert_allclose(T.apply(x, executor=ex).numpy(), a.T @ x.numpy(),
                               rtol=RTOL, atol=RTOL * float(np.abs(a).sum()))
    assert Transpose(T)._t is P
    C = F.coo_from_dense(a.T.copy(), device="cpu")  # 9 x 12
    comp = Transpose(Composition(P, C))  # (P C)^T = C^T P^T, 12 x 12
    y = torch.from_numpy(np.random.default_rng(3).standard_normal(12)
                         .astype(np.float32))
    np.testing.assert_allclose(comp.apply(y, executor=ex).numpy(),
                               (a @ a.T).T @ y.numpy(), rtol=1e-4, atol=1e-4)
    s = Transpose(Sum(P, P))
    np.testing.assert_allclose(s.apply(x, executor=ex).numpy(),
                               2 * a.T @ x.numpy(), rtol=1e-4, atol=1e-4)
    with pytest.raises(NotImplementedError, match="not transposable"):
        Transpose(MatrixFreeOp(lambda v: v, shape=(3, 3)))
    # the JAX package's Transpose agrees on the same operator
    Jt = JTranspose(JF.sellp_from_dense(a))
    np.testing.assert_allclose(np.asarray(Jt.apply(jnp.asarray(x.numpy()))),
                               T.apply(x, executor=ex).numpy(), rtol=RTOL,
                               atol=RTOL * float(np.abs(a).sum()))


def test_power_law_gallery_identical():
    for seed in (0, 4):
        want = jgallery.power_law_laplacian(700, seed=seed)
        got = tgallery.power_law_laplacian(700, seed=seed)
        for w, g in zip(want[:3], got[:3]):
            assert w.dtype == g.dtype
            np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError, match="at least 2"):
        tgallery.power_law_laplacian(1)


@functools.lru_cache(maxsize=None)
def _power_law_problem():
    ip, ix, v, shape = tgallery.power_law_laplacian(512, seed=4)
    b = np.random.default_rng(0).standard_normal(shape[0]).astype(np.float32)
    J = JF.sellp_from_csr_host(ip, ix, v, shape)
    # the JAX package's SELL-P diagonal densifies through its reference
    # SpMV (a minute here); its CSR twin's Jacobi has the same values
    M = jsolvers.jacobi_preconditioner(JF.convert(J, "csr"))
    res = jsolvers.cg(J, jnp.asarray(b), M=M,
                      stop=jsolvers.Stop(max_iters=500, reduction_factor=1e-6),
                      executor=jax_make_executor("xla"))
    return (ip, ix, v, shape, b), (int(res.iterations), np.asarray(res.x),
                                   bool(res.converged))


@pytest.mark.parametrize("space", ["reference", "torch"])
def test_jacobi_cg_on_power_law_sellp_matches_jax(space):
    (ip, ix, v, shape, b), (k_j, x_j, conv_j) = _power_law_problem()
    P = F.sellp_from_csr_host(ip, ix, v, shape, device="cpu")
    assert not O.has_fused_ops(P, executor=make_executor(space))
    res = cg(P, torch.from_numpy(b), M="jacobi",
             stop=Stop(max_iters=500, reduction_factor=1e-6),
             executor=make_executor(space))
    assert conv_j and res.converged
    assert abs(res.iterations - k_j) <= 1, (res.iterations, k_j)
    assert np.linalg.norm(res.x.numpy() - x_j) <= 1e-4 * np.linalg.norm(x_j)


def test_cuda_space_and_wrapper_checks():
    P = F.sellp_from_dense(_dense(10, 10, seed=1), device="cpu")
    x = torch.ones(10)
    with pytest.raises(ValueError, match="CUDA tensors"):
        O.apply(P, x, executor=make_executor("cuda"))
    assert O.spmv_sellp.space_used(make_executor("cuda")) == "cuda"
    with pytest.raises(ValueError, match="int32"):
        K.spmv_sellp(P.col_idx.long(), P.values, P.slice_sets, x, 10, 8)
    with pytest.raises(ValueError, match="slice_sets"):
        K.spmv_sellp(P.col_idx, P.values, P.slice_sets, x, 17, 8)
    with pytest.raises(ValueError, match="whole columns"):
        K.spmv_sellp(P.col_idx[:-1], P.values[:-1], P.slice_sets, x, 10, 8)
    with pytest.raises(ValueError, match="dtype"):
        K.spmv_sellp(P.col_idx, P.values, P.slice_sets, x.double(), 10, 8)


def test_sellp_geometry_for_h100():
    """The H100 geometry: a wide slice's partials (one per thread of the
    block's column groups) are the kernel's shared memory; a slice wider
    than the block is walked per row and needs none."""
    from repro_torch.core import tuning

    hw = make_executor("h100").hw
    cfg = tuning.resolve("spmv_sellp", {"m": 2_097_152, "slice_size": 8,
                                        "itemsize": 4}, hw)
    assert cfg["block_threads"] == 256 and cfg["wide_cols"] == 64
    assert cfg.smem_bytes == 256 * 4
    cfg = tuning.resolve("spmv_sellp", {"m": 100, "slice_size": 3,
                                        "itemsize": 8}, hw)
    assert cfg.smem_bytes == (256 // 3) * 3 * 8
    assert tuning.resolve("spmv_sellp", {"m": 100, "slice_size": 512,
                                         "itemsize": 4}, hw).smem_bytes == 0


def test_sellp_probe_needs_a_card(monkeypatch):
    from repro_torch.kernels import sellp_probe

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert sellp_probe.main(["--n", "64"]) == 2
