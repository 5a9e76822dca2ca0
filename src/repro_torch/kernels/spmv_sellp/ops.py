"""Registry binding: the CUDA SELL-P SpMV serves operation ``spmv_sellp`` in
the ``cuda`` space.

The reference/torch spaces live in :mod:`repro_torch.sparse.ops`.  The
threads per block come from the tuning table; the range size follows from
them and the matrix (``kernel.range_cols``).  Unlike the JAX package's
binding, nothing falls back to another space: the kernel has no size limit.
"""

from __future__ import annotations

from repro_torch.core import registry, tuning
from repro_torch.kernels._check import require_cuda
from repro_torch.kernels.spmv_sellp.kernel import (BLOCK_THREADS,
                                                   MAX_BLOCK_THREADS,
                                                   sellp_geometry, spmv_sellp)


def _constrain(hw, shapes, block):
    bt = min(max(int(block["block_threads"]), hw.warp_size), MAX_BLOCK_THREADS)
    return {**block, "block_threads": bt - bt % hw.warp_size}


def _smem(shapes, block):
    """The warps' rings of the stream and tiles of row partials."""
    itemsize = shapes.get("itemsize", 4)
    geo = sellp_geometry(max(int(shapes.get("slice_size", 1)), 1),
                         itemsize=itemsize)
    return block["block_threads"] * geo["smem_per_thread"]


SELLP_SPEC = tuning.register_spec(
    tuning.TuningSpec(
        op="spmv_sellp",
        params=("block_threads",),
        seed=lambda hw: {"block_threads": BLOCK_THREADS},
        smem_bytes=_smem,
        constrain=_constrain,
    )
)


@registry.register("spmv_sellp", "cuda")
def _spmv_sellp_cuda(ex, A, x):
    require_cuda("spmv_sellp", A.col_idx, A.values, A.slice_sets, x)
    if x.ndim != 1:
        raise NotImplementedError("the cuda SELL-P spmv takes one right-hand side")
    cfg = ex.launch_config("spmv_sellp", {"m": A.shape[0],
                                          "slice_size": A.slice_size,
                                          "itemsize": A.values.element_size()})
    return spmv_sellp(A.col_idx, A.values, A.slice_sets, x, A.shape[0],
                      A.slice_size, block_threads=cfg["block_threads"])
