"""Registry binding: the CUDA batched ELL SpMV serves ``spmv_batch_ell`` in
the ``cuda`` space.

The reference/torch spaces live in :mod:`repro_torch.batch.ops`.  The launch
geometry: threads per block as for the single-system ELL kernel, and a
subgroup just wide enough that no lane takes more than ``entries_per_lane``
of a row's ``k`` entries (one thread per row for narrow k).  The JAX
package's binding fell back to XLA when a system's x missed VMEM; this
kernel gathers x through L2 and has no such limit, so nothing falls back.
"""

from __future__ import annotations

from repro_torch.core import registry, tuning
from repro_torch.kernels._check import require_cuda
from repro_torch.kernels.spmv_batch_ell.kernel import spmv_batch_ell


def _constrain(hw, shapes, block):
    bt = min(max(int(block["block_threads"]), hw.warp_size), 1024)
    per_lane = max(int(block["entries_per_lane"]), 1)
    lanes = -(-max(int(shapes.get("k", 1)), 1) // per_lane)
    return {**block, "block_threads": bt - bt % hw.warp_size,
            "subgroup": min(tuning.next_pow2(lanes), hw.warp_size)}


BATCH_ELL_SPEC = tuning.register_spec(
    tuning.TuningSpec(
        op="spmv_batch_ell",
        params=("block_threads", "entries_per_lane"),
        seed=lambda hw: {"block_threads": 8 * hw.warp_size,
                         "entries_per_lane": 8},
        constrain=_constrain,
    )
)


@registry.register("spmv_batch_ell", "cuda")
def _spmv_batch_ell_cuda(ex, A, X):
    require_cuda("spmv_batch_ell", A.col_idx, A.values, X)
    if X.ndim != 2:
        raise NotImplementedError("the cuda batched ELL spmv takes (nb, n) X")
    nb, m, k = A.values.shape
    cfg = ex.launch_config("spmv_batch_ell", {"nb": nb, "m": m, "k": k})
    return spmv_batch_ell(A.col_idx, A.values, X,
                          block_threads=cfg["block_threads"],
                          subgroup=cfg["subgroup"])
