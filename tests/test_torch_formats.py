"""The port's gallery, formats and host conversions against the JAX package's.

Host conversions are integer/array bookkeeping in numpy on both sides, so the
arrays must be identical, not merely close.  ``convert`` carries JAX objects
across (bfloat16 included) and must round-trip bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import sparse as jsparse
from repro.precond import block_jacobi as jax_block_jacobi
from repro.sparse import gallery as jgallery
from repro_torch import convert
from repro_torch.sparse import formats as F
from repro_torch.sparse import gallery as tgallery


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _matrices():
    rng_a, rng_b = np.random.default_rng(4), np.random.default_rng(4)
    yield "poisson_2d", jgallery.poisson_2d(9), tgallery.poisson_2d(9)
    yield "poisson_3d", jgallery.poisson_3d(5), tgallery.poisson_3d(5)
    yield ("spd_banded", jgallery.spd_banded(150, (1, 3), 0.5, rng_a),
           tgallery.spd_banded(150, (1, 3), 0.5, rng_b))


MATRICES = list(_matrices())


def _with_empty_row(hc):
    """The CSR quadruple with row 2's entries removed (an empty row)."""
    ip, ix, v, shape = hc
    lo, hi = int(ip[2]), int(ip[3])
    keep = np.r_[0:lo, hi:len(ix)]
    ip2 = ip.copy()
    ip2[3:] -= hi - lo
    return ip2, ix[keep], v[keep], shape


@pytest.mark.parametrize("name,jax_hc,torch_hc", MATRICES,
                         ids=[m[0] for m in MATRICES])
def test_gallery_arrays_identical(name, jax_hc, torch_hc):
    for a, b in zip(jax_hc[:3], torch_hc[:3]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert tuple(jax_hc[3]) == tuple(torch_hc[3])


@pytest.mark.parametrize("name,jax_hc,torch_hc", MATRICES,
                         ids=[m[0] for m in MATRICES])
@pytest.mark.parametrize("max_nnz", [None, 9])
def test_ell_from_csr_host_identical(name, jax_hc, torch_hc, max_nnz):
    ip, ix, v, shape = _with_empty_row(jax_hc)
    Aj = jsparse.ell_from_csr_host(ip, ix, v, shape, max_nnz=max_nnz)
    At = F.ell_from_csr_host(ip, ix, v, shape, max_nnz=max_nnz, device="cpu")
    np.testing.assert_array_equal(np.asarray(Aj.col_idx), At.col_idx.numpy())
    np.testing.assert_array_equal(np.asarray(Aj.values), At.values.numpy())
    assert At.col_idx.dtype == torch.int32 and At.shape == Aj.shape
    # csr_host_arrays: identical triplets for ELL (padding dropped) and CSR
    for a, b in zip(jsparse.csr_host_arrays(Aj), F.csr_host_arrays(At)):
        np.testing.assert_array_equal(a, b)
    Cj = jsparse.csr_from_arrays(ip, ix, v, shape)
    Ct = F.csr_from_arrays(ip, ix, v, shape, device="cpu")
    for a, b in zip(jsparse.csr_host_arrays(Cj), F.csr_host_arrays(Ct)):
        np.testing.assert_array_equal(a, b)


def test_ell_rejects_too_narrow_max_nnz():
    ip, ix, v, shape = tgallery.poisson_2d(4)
    with pytest.raises(ValueError, match="max_nnz"):
        F.ell_from_csr_host(ip, ix, v, shape, max_nnz=2, device="cpu")


def test_from_dense_and_dense_triplet_identical():
    rng = np.random.default_rng(0)
    a = (rng.standard_normal((20, 17)) * (rng.random((20, 17)) < 0.3)).astype(
        np.float32)
    for fj, ft in ((jsparse.csr_from_dense, F.csr_from_dense),
                   (jsparse.ell_from_dense, F.ell_from_dense)):
        for x, y in zip(jsparse.csr_host_arrays(fj(a)),
                        F.csr_host_arrays(ft(a, device="cpu"))):
            np.testing.assert_array_equal(x, y)
    for x, y in zip(jsparse.csr_host_arrays(jsparse.formats.Dense(jnp.asarray(a))),
                    F.csr_host_arrays(F.Dense(torch.from_numpy(a)))):
        np.testing.assert_array_equal(x, y)


def test_convert_formats_round_trip():
    ip, ix, v, shape = jgallery.poisson_2d(6)
    Cj = jsparse.csr_from_arrays(ip, ix, v, shape)
    Ct = convert.csr(np.asarray(Cj.indptr), np.asarray(Cj.indices),
                     np.asarray(Cj.values), Cj.shape, device="cpu")
    for a, b in zip(jsparse.csr_host_arrays(Cj), F.csr_host_arrays(Ct)):
        np.testing.assert_array_equal(a, b)
    Ej = jsparse.ell_from_csr_host(ip, ix, v, shape)
    Et = convert.ell(np.asarray(Ej.col_idx), np.asarray(Ej.values), Ej.shape,
                     device="cpu")
    np.testing.assert_array_equal(convert.host_array(Et.col_idx),
                                  np.asarray(Ej.col_idx))
    np.testing.assert_array_equal(convert.host_array(Et.values),
                                  np.asarray(Ej.values))


@pytest.mark.parametrize("adaptive", ["bfloat16", True, False])
def test_convert_block_jacobi_round_trip(adaptive):
    """A JAX BlockJacobi crosses over bit for bit, bf16 storage included, and
    applies like the original."""
    from repro.core import make_executor as jax_make_executor
    from repro_torch.core import make_executor

    ip, ix, v, shape = jgallery.poisson_2d(8)
    Aj = jsparse.ell_from_csr_host(ip, ix, v, shape)
    Pj = jax_block_jacobi(Aj, 8, adaptive=adaptive)
    Pt = convert.block_jacobi(
        [np.asarray(t) for t in Pj.inv_blocks], np.asarray(Pj.gather_idx),
        np.asarray(Pj.scatter_idx), Pj.n, Pj.block_size, Pj.num_blocks,
        device="cpu")
    assert Pt.precision_counts == Pj.precision_counts
    for tj, tt in zip(Pj.inv_blocks, Pt.inv_blocks):
        a = np.asarray(tj)
        bits = a.view(np.uint16) if a.dtype.itemsize == 2 else a
        np.testing.assert_array_equal(convert.host_array(tt).view(bits.dtype), bits)
    r = np.random.default_rng(1).standard_normal(shape[0]).astype(np.float32)
    want = np.asarray(Pj.apply(jnp.asarray(r), executor=jax_make_executor("xla")))
    got = Pt.apply(torch.from_numpy(r), executor=make_executor("torch")).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_default_device_is_the_card():
    """Without a device argument a constructor places tensors on the card,
    and raises where there is none."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    ip, ix, v, shape = tgallery.poisson_2d(3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        F.ell_from_csr_host(ip, ix, v, shape)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.tensor(np.zeros(3))
