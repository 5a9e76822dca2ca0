"""Registry binding: the fused CUDA axpy + norm serves ``axpy_norm`` in the
``cuda`` space.

The reference/torch spaces live in :mod:`repro_torch.sparse.ops`.  A 1-D
operand goes to the vector kernel, a batched ``(nb, n)`` one to its
row-batched form (the JAX package sends those to its XLA formulation).
"""

from __future__ import annotations

from repro_torch.core import registry, tuning
from repro_torch.kernels._check import require_cuda
from repro_torch.kernels.axpy_norm.kernel import axpy_norm, axpy_norm_rows


def _constrain(hw, shapes, block):
    bt = min(max(int(block["block_threads"]), hw.warp_size), 1024)
    return {**block, "block_threads": bt - bt % hw.warp_size}


AXPY_NORM_SPEC = tuning.register_spec(
    tuning.TuningSpec(
        op="axpy_norm",
        params=("block_threads", "grid_blocks"),
        seed=lambda hw: {
            "block_threads": 8 * hw.warp_size,
            "grid_blocks": (hw.sm_count or 1) * (2048 // (8 * hw.warp_size)),
        },
        smem_bytes=lambda shapes, block: 32 * shapes.get("itemsize", 4),
        constrain=_constrain,
    )
)


def _constrain_rows(hw, shapes, block):
    """As the vector form, with no more threads than a row has elements
    (rounded up to the warp)."""
    block = _constrain(hw, shapes, block)
    n = max(int(shapes.get("n", 1)), 1)
    fit = -(-n // hw.warp_size) * hw.warp_size
    return {**block, "block_threads": min(block["block_threads"], fit)}


AXPY_NORM_ROWS_SPEC = tuning.register_spec(
    tuning.TuningSpec(
        op="axpy_norm_rows",
        params=("block_threads", "grid_blocks"),
        seed=AXPY_NORM_SPEC.seed,
        smem_bytes=AXPY_NORM_SPEC.smem_bytes,
        constrain=_constrain_rows,
    )
)


@registry.register("axpy_norm", "cuda")
def _axpy_norm_cuda(ex, alpha, x, y):
    require_cuda("axpy_norm", x, y)
    if x.ndim == 2:
        cfg = ex.launch_config("axpy_norm_rows", {
            "nb": x.shape[0], "n": x.shape[1], "itemsize": x.element_size()})
        return axpy_norm_rows(alpha, x, y, block_threads=cfg["block_threads"],
                              grid_blocks=cfg["grid_blocks"])
    if x.ndim != 1:
        raise NotImplementedError(
            f"axpy_norm takes 1-D vectors or (nb, n) batches, got {x.ndim}-D")
    cfg = ex.launch_config("axpy_norm", {"n": x.shape[0],
                                         "itemsize": x.element_size()})
    return axpy_norm(alpha, x, y, block_threads=cfg["block_threads"],
                     grid_blocks=cfg["grid_blocks"])
