"""Registry binding: the CUDA numeric passes serve ``spgemm`` and
``sptranspose`` in the ``cuda`` space.

Both share the structure passes of :mod:`repro_torch.sparse.ops` with the
torch space, on the operands' device (the expansion maps and the sort of the
coalesce; the transpose's stable argsort), and run the numeric passes as
kernels: ``spgemm_expand`` for the expansion products, ``spgemm_merge`` for
the sums of equal coordinates, ``csr_permute`` for the transpose's value
shuffle.  The registration is unconditional and nothing falls back to
another space (the TPU binding fell back to XLA when its working set missed
VMEM; these kernels keep no tile in shared memory, so nothing can miss).
Threads per block come from the ``spgemm`` tuning spec, one spec for the
three kernels (``csr_permute`` sizes its grid itself, one wave, and ran
level 0's transpose within 3 % at 128 to 1,024 threads a block on the H100).
"""

from __future__ import annotations

import functools

from repro_torch.core import registry, tuning
from repro_torch.kernels._check import require_cuda
from repro_torch.kernels.spgemm.kernel import (
    csr_permute,
    spgemm_expand,
    spgemm_merge,
)


def _constrain(hw, shapes, block):
    bt = min(max(int(block["block_threads"]), hw.warp_size), 1024)
    return {"block_threads": bt - bt % hw.warp_size}


SPGEMM_SPEC = tuning.register_spec(
    tuning.TuningSpec(
        op="spgemm",
        params=("block_threads",),
        seed=lambda hw: {"block_threads": 8 * hw.warp_size},
        constrain=_constrain,
    )
)


@registry.register("spgemm", "cuda")
def _spgemm_cuda(ex, A, B):
    from repro_torch.sparse.ops import _spgemm_skeleton

    require_cuda("spgemm", A.values, B.values)
    cfg = ex.launch_config("spgemm", {"nnz_a": A.nnz, "nnz_b": B.nnz})
    bt = cfg["block_threads"]
    return _spgemm_skeleton(
        ex, A, B, expand=functools.partial(spgemm_expand, block_threads=bt),
        merge=functools.partial(spgemm_merge, block_threads=bt))


@registry.register("sptranspose", "cuda")
def _sptranspose_cuda(ex, A):
    from repro_torch.sparse.ops import (
        _sptranspose_skeleton,
        _transpose_structure_device,
    )

    require_cuda("sptranspose", A.values)
    cfg = ex.launch_config("spgemm", {"nnz_a": A.nnz})
    return _sptranspose_skeleton(
        ex, A, structure=_transpose_structure_device,
        permute=functools.partial(csr_permute,
                                  block_threads=cfg["block_threads"]))
