"""Registry binding: the CUDA ELL SpMV serves operation ``spmv_ell`` in the
``cuda`` space.

The reference/torch spaces live in :mod:`repro_torch.sparse.ops`.  The launch
geometry (threads per block, lanes per row) comes from the tuning table; the
subgroup shrinks to the power of two that covers ``k``; rows of at most
ROWS_WALK_K entries take the thread-per-row walk (``subgroup = 1``), rows of
more than WIDE_K a whole warp.
"""

from __future__ import annotations

from repro_torch.core import registry, tuning
from repro_torch.kernels._check import require_cuda
from repro_torch.kernels.spmv_ell.kernel import (ROWS_WALK_MAX_K,
                                                ROWS_WALK_THREADS, spmv_ell)

#: rows of at most this many entries take the thread-per-row walk; rows of
#: more than WIDE_K take a whole warp (32 lanes); the rows between, the
#: seed's subgroup (set from per-operator times on the card: PERF.md)
ROWS_WALK_K = 16
WIDE_K = 32
assert ROWS_WALK_K <= ROWS_WALK_MAX_K


def constrain_rows(hw, shapes, block):
    """Threads a multiple of the warp in [warp, 1024]; the subgroup a power of
    two no wider than the warp or than ``k`` needs."""
    bt = min(max(int(block["block_threads"]), hw.warp_size), 1024)
    bt -= bt % hw.warp_size
    sg = tuning.prev_pow2(max(int(block["subgroup"]), 1))
    sg = min(sg, hw.warp_size, tuning.next_pow2(shapes.get("k", sg)))
    return {**block, "block_threads": bt, "subgroup": sg}


def constrain_ell(hw, shapes, block):
    """``constrain_rows``; then the walk is a function of ``k``: one thread a
    row up to ROWS_WALK_K (at most ROWS_WALK_THREADS a block), a whole warp
    a row past WIDE_K."""
    block = constrain_rows(hw, shapes, block)
    k = shapes.get("k")
    if k is None:
        return block
    if k <= ROWS_WALK_K:
        return {"block_threads": min(block["block_threads"], ROWS_WALK_THREADS),
                "subgroup": 1}
    if k > WIDE_K:
        return {**block, "subgroup": hw.warp_size}
    return block


def ell_smem_bytes(shapes, block) -> int:
    # the thread-per-row walk stages each row's entries at an odd stride
    if block["subgroup"] != 1:
        return 0
    return block["block_threads"] * (shapes.get("k", 0) | 1) * (
        4 + shapes.get("itemsize", 4))


ELL_SPEC = tuning.register_spec(
    tuning.TuningSpec(
        op="spmv_ell",
        params=("block_threads", "subgroup"),
        seed=lambda hw: {"block_threads": 8 * hw.warp_size,
                         "subgroup": hw.subgroup_size},
        smem_bytes=ell_smem_bytes,
        constrain=constrain_ell,
    )
)


@registry.register("spmv_ell", "cuda")
def _spmv_ell_cuda(ex, A, x):
    require_cuda("spmv_ell", A.col_idx, A.values, x)
    if x.ndim != 1:
        raise NotImplementedError("the cuda ELL spmv takes one right-hand side")
    cfg = ex.launch_config("spmv_ell", {"m": A.values.shape[0],
                                        "k": A.values.shape[1],
                                        "itemsize": A.values.element_size()})
    return spmv_ell(A.col_idx, A.values, x, block_threads=cfg["block_threads"],
                    subgroup=cfg["subgroup"])
