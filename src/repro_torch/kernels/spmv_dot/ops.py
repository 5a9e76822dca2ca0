"""Registry binding: the fused CUDA ELL SpMV + dot serves ``spmv_dot_ell`` in
the ``cuda`` space.

The reference/torch spaces live in :mod:`repro_torch.sparse.ops` (the literal
unfused composition).  ``spmv_dot_csr`` has no cuda kernel, as it has no
Pallas kernel in the JAX package: a CUDA executor reaches its torch form
through the permissive chain.
"""

from __future__ import annotations

from repro_torch.core import registry, tuning
from repro_torch.kernels._check import require_cuda
from repro_torch.kernels.spmv_dot.kernel import spmv_dot_ell
from repro_torch.kernels.spmv_ell.ops import constrain_ell, ell_smem_bytes


def _constrain(hw, shapes, block):
    """The walk as ``spmv_ell``'s (``constrain_ell``): one thread a row up to
    ROWS_WALK_K, the seed's subgroup up to WIDE_K, a warp beyond."""
    return {**block, **constrain_ell(hw, shapes, block)}


def _smem_bytes(shapes, block) -> int:
    # the thread-per-row walk's staged spans, then block_sum's 32 partials
    return ell_smem_bytes(shapes, block) + 32 * shapes.get("itemsize", 4)


SPMV_DOT_SPEC = tuning.register_spec(
    tuning.TuningSpec(
        op="spmv_dot",
        params=("block_threads", "subgroup"),
        seed=lambda hw: {"block_threads": 8 * hw.warp_size,
                         "subgroup": hw.subgroup_size},
        smem_bytes=_smem_bytes,
        constrain=_constrain,
    )
)


@registry.register("spmv_dot_ell", "cuda")
def _spmv_dot_ell_cuda(ex, A, x, w):
    require_cuda("spmv_dot_ell", A.col_idx, A.values, x, w)
    if x.ndim != 1:
        raise NotImplementedError("the cuda fused ELL spmv_dot takes one "
                                  "right-hand side")
    cfg = ex.launch_config("spmv_dot", {"m": A.values.shape[0],
                                        "k": A.values.shape[1],
                                        "itemsize": x.element_size()})
    return spmv_dot_ell(A.col_idx, A.values, x, w,
                        block_threads=cfg["block_threads"],
                        subgroup=cfg["subgroup"])
