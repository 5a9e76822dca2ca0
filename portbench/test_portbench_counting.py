"""The counting functions against hand counts on tiny stencils and graphs."""

import numpy as np
import pytest
import torch

from portbench import counting
from portbench.generators import poisson3d_7pt
from portbench.reference import block_jacobi, jacobi

H100 = "NVIDIA H100 80GB HBM3"


def _problem(host, M, s):
    return {"n": host[3][0], "nnz": host[1].size, "s": s,
            "precond_storage_bytes": M.storage_bytes, "precond_flops": M.flops}


def _bj(host, working=torch.float32):
    return block_jacobi.build(host, {"block_size": 8, "adaptive": True, "tau": 0.01},
                              working=working, compute_dtype=torch.float64,
                              device="cpu")


def test_cube_of_two():
    # 8 rows, each the diagonal and 3 neighbours: 32 nonzeros, one 8x8 block
    host = poisson3d_7pt.generate({"n_side": 2}, device="cpu")
    M = _bj(host)
    assert host[1].size == 32
    assert M.class_counts == {"float16": 1}
    assert (M.storage_bytes, M.flops) == (8 * 8 * 2, 2 * 64)
    p = _problem(host, M, 4)
    assert counting.spmv_bytes(p) == 32 * (4 + 4) + 2 * 8 * 4
    assert counting.spmv_flops(p) == 64
    assert counting.precond_bytes(p) == 128 + 2 * 8 * 4
    assert counting.iteration_bytes(p) == 32 * 8 + 128 + 10 * 8 * 4
    assert counting.iteration_flops(p) == 64 + 128 + 12 * 8
    assert counting.solve_bytes(p, 5) == 5 * 704 + 8 * 4
    assert counting.solve_flops(p, 5) == 5 * 288


def test_partial_last_block_counts_true_rows():
    # 27 rows in blocks of 8, 8, 8 and 3
    host = poisson3d_7pt.generate({"n_side": 3}, device="cpu")
    M = _bj(host)
    assert host[1].size == 7 * 27 - 6 * 9
    assert M.flops == 2 * (3 * 64 + 9)
    assert sum(M.class_counts.values()) == 4
    assert M.storage_bytes == 2 * (3 * 64 + 9)  # every block fits fp16


def test_f64_vectors():
    host = poisson3d_7pt.generate({"n_side": 2}, device="cpu")
    host = (*host[:2], host[2].astype("float64"), host[3])
    M = _bj(host, torch.float64)
    p = _problem(host, M, 8)
    assert counting.spmv_bytes(p) == 32 * 12 + 2 * 8 * 8
    assert counting.iteration_bytes(p) == 32 * 12 + 128 + 10 * 8 * 8


def test_two_vertex_graph_with_scalar_jacobi():
    # one edge: L + 0.01 I has 4 entries
    host = (np.array([0, 2, 4]), np.array([0, 1, 0, 1], np.int32),
            np.array([1.01, -1.0, -1.0, 1.01], np.float32), (2, 2))
    M = jacobi.build(host, {}, working=torch.float32, compute_dtype=torch.float64,
                     device="cpu")
    p = _problem(host, M, 4)
    assert (M.storage_bytes, M.flops) == (2 * 4, 2)
    assert counting.spmv_bytes(p) == 4 * 8 + 2 * 2 * 4
    assert counting.iteration_bytes(p) == 32 + 8 + 10 * 2 * 4


def test_least_seconds_takes_the_binding_rate():
    # bytes bind: 3.35e12 bytes take one second whatever the operations
    assert counting.least_seconds(3.35e12, 1e9, "float32", H100) == pytest.approx(1.0)
    # operations bind: 67e12 f32 operations take one second
    assert counting.least_seconds(1.0, 67e12, "float32", H100) == pytest.approx(1.0)
    with pytest.raises(KeyError):
        counting.least_seconds(1.0, 1.0, "float32", "some other card")


@pytest.mark.parametrize("slice_size,stride_factor", [(8, 8), (64, 1), (3, 2)])
def test_graph_seed_counts_the_slots_sellp_stores(slice_size, stride_factor):
    from portbench import graph_seed
    from portbench.generators import graph500_laplacian
    from repro_torch.sparse import sellp_from_csr_host

    host = graph500_laplacian.generate(
        {"scale": 9, "edgefactor": 16, "A": 0.57, "B": 0.19, "C": 0.19, "shift": 0.01,
         "graph_seed": 2}, device="cpu")
    A = sellp_from_csr_host(*host, slice_size=slice_size, stride_factor=stride_factor,
                            device="cpu")
    assert graph_seed.sellp_slots(np.diff(host[0]), slice_size,
                                  stride_factor) == A.values.numel()
