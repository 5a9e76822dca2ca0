"""Registry bindings for attention (operation ``nn_attention``) and the
chunked attention's tuning spec (``nn_attention_chunked``).

The ``reference`` and ``torch`` spaces compute the dense plain version (the
JAX package's reference and XLA spaces share ``mha_ref``); the ``cuda``
space launches the flash kernel (TMA and wgmma for bf16 / fp16, CUDA cores
for f32), its tiles checked against the block's shared memory.  The ``cuda`` registration is
unconditional: a failed build or launch raises and is never re-dispatched.
When q, k or v needs a gradient the kernel runs inside
:func:`repro_torch.kernels._autograd.kernel_call`: backward recomputes the
dense plain version, one call's (B, H, S, Skv) scores at a time.
"""

from __future__ import annotations

import functools
from typing import Optional

from repro_torch.core import registry, tuning
from repro_torch.kernels._autograd import kernel_call
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


# kv-chunk length of the chunked attention (repro_torch.nn.attention.
# attention_chunked, taken by the reference and torch spaces when
# cfg.attn_impl == "chunked" and cfg.attn_chunk is None): the JAX package's
# spec, whose seed at a TPU's 128 lanes is 512 rows, the seed on every
# target here; a multiple of 128 rows, at least 128.  The loop is plain
# PyTorch: it takes no shared memory.
CHUNKED_ATTENTION_SPEC = tuning.register_spec(
    tuning.TuningSpec(
        op="nn_attention_chunked",
        params=("chunk",),
        seed=lambda hw: {"chunk": 512},
        constrain=lambda hw, shapes, block: {
            "chunk": max(int(block["chunk"]) - int(block["chunk"]) % 128, 128)},
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
    return kernel_call(
        functools.partial(flash_attention, causal=causal, scale=scale),
        functools.partial(flash_attention_plain, causal=causal, scale=scale),
        q.contiguous(), k.contiguous(), v.contiguous())
