"""The stencil generator gives the port's gallery arrays bit for bit; the
Graph 500 generator gives the spec's Octave generator's graph, transcribed
to NumPy, from the same draws."""

import numpy as np
import pytest
import torch

from portbench import spec
from portbench.generators import graph500_laplacian, poisson3d_7pt
from repro_torch.sparse import gallery


def _same(a, b):
    assert a[3] == b[3]
    for x, y in zip(a[:3], b[:3]):
        assert x.dtype == y.dtype
        assert np.array_equal(x, y)


@pytest.mark.parametrize("n_side", [1, 2, 3, 7, 16])
def test_poisson3d_equals_gallery(n_side):
    _same(gallery.poisson_3d(n_side),
          poisson3d_7pt.generate({"n_side": n_side}, device="cpu"))


def _graph500_numpy(scale, edgefactor, a, b, c, shift, seed):
    """The spec's Octave ``kronecker_generator`` in NumPy, fed the draws the
    generator takes from a CPU ``torch.Generator``, then the Laplacian by
    ``np.unique`` and ``np.lexsort`` as ``gallery.power_law_laplacian``
    builds it."""
    n = 2 ** scale
    m = edgefactor * n
    g = torch.Generator().manual_seed(seed)
    ab = a + b
    c_norm, a_norm = c / (1 - ab), a / ab
    ij = np.zeros((2, m), np.int64)
    for ib in range(scale):
        ii_bit = torch.rand(m, generator=g, dtype=torch.float64).numpy() > ab
        jj_bit = torch.rand(m, generator=g, dtype=torch.float64).numpy() > (
            c_norm * ii_bit + a_norm * ~ii_bit)
        ij += 2 ** ib * np.stack([ii_bit, jj_bit])
    p = torch.randperm(n, generator=g).numpy()
    i, j = p[ij]
    keep = i != j
    lo, hi = np.minimum(i, j)[keep], np.maximum(i, j)[keep]
    e = np.unique(lo * n + hi)
    lo, hi = e // n, e % n
    deg = np.bincount(np.concatenate([lo, hi]), minlength=n)
    rows = np.concatenate([lo, hi, np.arange(n)])
    cols = np.concatenate([hi, lo, np.arange(n)])
    vals = np.concatenate([-np.ones(2 * lo.size), deg + shift])
    order = np.lexsort((cols, rows))
    indptr = np.zeros(n + 1, np.int64)
    indptr[1:] = np.cumsum(np.bincount(rows, minlength=n))
    return (indptr, cols[order].astype(np.int32), vals[order].astype(np.float32),
            (n, n))


@pytest.mark.parametrize("scale,edgefactor,seed", [(1, 1, 0), (4, 16, 1), (10, 16, 7),
                                                   (12, 8, 2 ** 31 + 3)])
def test_graph500_equals_the_spec_in_numpy(scale, edgefactor, seed):
    params = {"scale": scale, "edgefactor": edgefactor, "A": 0.57, "B": 0.19,
              "C": 0.19, "shift": 0.01, "graph_seed": seed}
    _same(_graph500_numpy(scale, edgefactor, 0.57, 0.19, 0.19, 0.01, seed),
          graph500_laplacian.generate(params, device="cpu"))


def test_graph500_other_initiator_equals_the_spec_in_numpy():
    params = {"scale": 9, "edgefactor": 4, "A": 0.45, "B": 0.15, "C": 0.15,
              "shift": 0.5, "graph_seed": 11}
    _same(_graph500_numpy(9, 4, 0.45, 0.15, 0.15, 0.5, 11),
          graph500_laplacian.generate(params, device="cpu"))


def test_graph500_skews_degrees_as_the_spec():
    # the initiator puts most edges in the low quadrant: before the label
    # permutation vertex 0 takes (A + B)^scale of the row draws
    params = {"scale": 12, "edgefactor": 16, "A": 0.57, "B": 0.19, "C": 0.19,
              "graph_seed": 3}
    i, j, n = graph500_laplacian.kronecker_edges(params, device="cpu")
    assert n == 4096 and i.numel() == 16 * 4096
    deg = torch.bincount(torch.cat([i, j]), minlength=n)
    assert deg.max() > 50 * deg.float().mean()


def _stencil_configs():
    out = []
    for c in spec.load()["configs"]:
        cfg = spec.read_json(spec.ROOT / c["file"])
        if cfg["problem"]["generator"] == "poisson3d_7pt":
            out.append(pytest.param(cfg, id=c["name"]))
    return out


@pytest.mark.parametrize("cfg", _stencil_configs())
def test_stencil_nonzeros_stated_in_config(cfg):
    s = cfg["problem"]["params"]["n_side"]
    # 7 a row, less one for each missing neighbour on the six faces
    assert cfg["sizes"] == {"rows": s ** 3, "nonzeros": 7 * s ** 3 - 6 * s * s}
