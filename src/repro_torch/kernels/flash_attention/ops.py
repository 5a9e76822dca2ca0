"""Registry bindings for attention (operation ``nn_attention``).

The ``reference`` and ``torch`` spaces compute the dense plain version (the
JAX package's reference and XLA spaces share ``mha_ref``); the ``cuda``
space launches the flash kernel (TMA and wgmma for bf16 / fp16, CUDA cores
for f32), its tiles checked against the block's shared memory.  The ``cuda`` registration is
unconditional: a failed build or launch raises and is never re-dispatched.
"""

from __future__ import annotations

from typing import Optional

from repro_torch.core import registry, tuning
from repro_torch.kernels._check import require_cuda
from repro_torch.kernels.flash_attention.kernel import (
    flash_attention,
    flash_attention_plain,
    flash_block_kv,
    flash_smem_bytes,
)

ATTENTION_SPEC = tuning.register_spec(
    tuning.TuningSpec(
        op="nn_attention",
        params=("block_kv",),
        seed=lambda hw: {"block_kv": 64},
        # the source compiles one kv tile per kernel: 64 rows on the tensor
        # cores (2-byte inputs: 128 queries a block, K / V in a ring of
        # three stages of 64-column slabs, two when D > 192), 32 in f32 (two
        # f32 blocks an SM at D = 160)
        constrain=lambda hw, shapes, block: {
            "block_kv": flash_block_kv(shapes.get("itemsize", 2))},
        smem_bytes=lambda shapes, block: flash_smem_bytes(
            shapes.get("D", 128), shapes.get("itemsize", 2)),
    )
)


def _plain(ex, q, k, v, causal: bool = True, scale: Optional[float] = None):
    return flash_attention_plain(q, k, v, causal=causal, scale=scale)


registry.register("nn_attention", "reference")(_plain)
registry.register("nn_attention", "torch")(_plain)


@registry.register("nn_attention", "cuda")
def _attention_cuda(ex, q, k, v, causal: bool = True,
                    scale: Optional[float] = None):
    require_cuda("nn_attention", q, k, v)
    # the tiles are compiled; resolving checks the block's shared memory
    ex.launch_config("nn_attention", {"S": q.shape[2], "Skv": k.shape[2],
                                      "D": q.shape[-1],
                                      "itemsize": q.element_size()})
    return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                           causal=causal, scale=scale)
