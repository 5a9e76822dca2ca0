"""Registry binding: the CUDA ELL SpMV serves operation ``spmv_ell`` in the
``cuda`` space.

The reference/torch spaces live in :mod:`repro_torch.sparse.ops`.  The launch
geometry (threads per block, lanes per row) comes from the tuning table; the
subgroup shrinks to the power of two that covers ``k``.
"""

from __future__ import annotations

from repro_torch.core import registry, tuning
from repro_torch.kernels._check import require_cuda
from repro_torch.kernels.spmv_ell.kernel import spmv_ell


def constrain_rows(hw, shapes, block):
    """Threads a multiple of the warp in [warp, 1024]; the subgroup a power of
    two no wider than the warp or than ``k`` needs."""
    bt = min(max(int(block["block_threads"]), hw.warp_size), 1024)
    bt -= bt % hw.warp_size
    sg = tuning.prev_pow2(max(int(block["subgroup"]), 1))
    sg = min(sg, hw.warp_size, tuning.next_pow2(shapes.get("k", sg)))
    return {**block, "block_threads": bt, "subgroup": sg}


ELL_SPEC = tuning.register_spec(
    tuning.TuningSpec(
        op="spmv_ell",
        params=("block_threads", "subgroup"),
        seed=lambda hw: {"block_threads": 8 * hw.warp_size,
                         "subgroup": hw.subgroup_size},
        constrain=constrain_rows,
    )
)


@registry.register("spmv_ell", "cuda")
def _spmv_ell_cuda(ex, A, x):
    require_cuda("spmv_ell", A.col_idx, A.values, x)
    if x.ndim != 1:
        raise NotImplementedError("the cuda ELL spmv takes one right-hand side")
    cfg = ex.launch_config("spmv_ell", {"m": A.values.shape[0],
                                        "k": A.values.shape[1]})
    return spmv_ell(A.col_idx, A.values, x, block_threads=cfg["block_threads"],
                    subgroup=cfg["subgroup"])
