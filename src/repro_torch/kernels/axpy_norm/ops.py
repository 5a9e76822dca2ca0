"""Registry binding: the fused CUDA axpy + norm serves ``axpy_norm`` in the
``cuda`` space.

The reference/torch spaces live in :mod:`repro_torch.sparse.ops`.  The kernel
is 1-D; a batched ``(nb, n)`` operand raises ``NotImplementedError`` here
(the JAX package sends it to its XLA form; the batched solvers are not
ported yet).
"""

from __future__ import annotations

from repro_torch.core import registry, tuning
from repro_torch.kernels._check import require_cuda
from repro_torch.kernels.axpy_norm.kernel import axpy_norm


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


@registry.register("axpy_norm", "cuda")
def _axpy_norm_cuda(ex, alpha, x, y):
    require_cuda("axpy_norm", x, y)
    if x.ndim != 1:
        raise NotImplementedError(
            "the cuda axpy_norm kernel is 1-D; batched (nb, n) operands are "
            "not served by the cuda space"
        )
    cfg = ex.launch_config("axpy_norm", {"n": x.shape[0],
                                         "itemsize": x.element_size()})
    return axpy_norm(alpha, x, y, block_threads=cfg["block_threads"],
                     grid_blocks=cfg["grid_blocks"])
