"""Registry binding: the CUDA batched ELL SpMV serves ``spmv_batch_ell`` in
the ``cuda`` space.

The reference/torch spaces live in :mod:`repro_torch.batch.ops`.  The route
is a function of the row length and the value type, never of the batch
size: rows of at most ROWS_WALK_K entries take the narrow route (one thread
a row, ``subgroup`` 1), longer rows the wide route with ``wide_lanes``
lanes a row.  The JAX package's binding fell back to XLA when a system's x
missed VMEM; this kernel stages x in shared memory where it fits and
gathers it through L2 where it does not, so nothing falls back.
"""

from __future__ import annotations

from repro_torch.core import registry, tuning
from repro_torch.kernels._check import require_cuda
from repro_torch.kernels.spmv_batch_ell.kernel import (WIDE_THREADS,
                                                       spmv_batch_ell,
                                                       wide_lanes)
from repro_torch.kernels.spmv_ell.kernel import ROWS_WALK_THREADS

#: rows of at most this many entries take the narrow route (spmv_ell's
#: ROWS_WALK_K); the band 16 < k <= 32, which the narrow walk could take
#: too, goes to the wide route
ROWS_WALK_K = 16

#: x of one system is staged in shared memory (two buffers) up to this many
#: bytes, as the kernel's kWideXBytes
WIDE_X_BYTES = 48 * 1024


def _constrain(hw, shapes, block):
    bt = min(max(int(block["block_threads"]), hw.warp_size), 1024)
    bt -= bt % hw.warp_size
    k = max(int(shapes.get("k", 1)), 1)
    if k <= ROWS_WALK_K:
        return {"block_threads": min(bt, ROWS_WALK_THREADS), "subgroup": 1}
    return {"block_threads": min(bt, WIDE_THREADS),
            "subgroup": wide_lanes(k, int(shapes.get("itemsize", 4)))}


def _smem_bytes(shapes, block) -> int:
    """The wide route stages x (two buffers) where it fits; the narrow route
    keeps nothing in shared memory."""
    if block["subgroup"] == 1:
        return 0
    x_bytes = 2 * int(shapes.get("n", 0)) * int(shapes.get("itemsize", 4))
    return x_bytes if x_bytes <= WIDE_X_BYTES else 0


BATCH_ELL_SPEC = tuning.register_spec(
    tuning.TuningSpec(
        op="spmv_batch_ell",
        params=("block_threads",),
        seed=lambda hw: {"block_threads": 8 * hw.warp_size},
        smem_bytes=_smem_bytes,
        constrain=_constrain,
    )
)


@registry.register("spmv_batch_ell", "cuda")
def _spmv_batch_ell_cuda(ex, A, X):
    require_cuda("spmv_batch_ell", A.col_idx, A.values, X)
    if X.ndim != 2:
        raise NotImplementedError("the cuda batched ELL spmv takes (nb, n) X")
    _, m, k = A.values.shape
    cfg = ex.launch_config("spmv_batch_ell", {
        "m": m, "k": k, "n": X.shape[1], "itemsize": A.values.element_size()})
    return spmv_batch_ell(A.col_idx, A.values, X,
                          block_threads=cfg["block_threads"],
                          subgroup=cfg["subgroup"])
