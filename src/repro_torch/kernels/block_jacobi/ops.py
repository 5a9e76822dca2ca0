"""Registry binding: the block-Jacobi apply serves ``block_jacobi_apply``.

* ``reference`` / ``torch`` — the plain version (:func:`block_jacobi_apply_plain`);
* ``cuda`` — the CUDA kernel, threads per block from the tuning table.
"""

from __future__ import annotations

from repro_torch.core import registry, tuning
from repro_torch.kernels._check import require_cuda
from repro_torch.kernels.block_jacobi.kernel import (
    block_jacobi_apply,
    block_jacobi_apply_plain,
)


def _constrain(hw, shapes, block):
    bt = min(max(int(block["block_threads"]), hw.warp_size), 1024)
    return {"block_threads": bt - bt % hw.warp_size}


BLOCK_JACOBI_SPEC = tuning.register_spec(
    tuning.TuningSpec(
        op="block_jacobi",
        params=("block_threads",),
        seed=lambda hw: {"block_threads": 8 * hw.warp_size},
        constrain=_constrain,
    )
)

op = registry.operation(
    "block_jacobi_apply", "batched small-matvec y[b] = inv_blocks[b] @ v[b]"
)


@op.register("reference")
def _bj_reference(ex, inv_blocks, vp):
    return block_jacobi_apply_plain(inv_blocks, vp)


@op.register("torch")
def _bj_torch(ex, inv_blocks, vp):
    return block_jacobi_apply_plain(inv_blocks, vp)


@op.register("cuda")
def _bj_cuda(ex, inv_blocks, vp):
    require_cuda("block_jacobi_apply", inv_blocks, vp)
    cfg = ex.launch_config("block_jacobi", {"nb": inv_blocks.shape[0],
                                            "bs": inv_blocks.shape[1]})
    return block_jacobi_apply(inv_blocks, vp, block_threads=cfg["block_threads"])
