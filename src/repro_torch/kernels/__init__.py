"""repro_torch.kernels — hand-written CUDA kernels for Hopper (the Pallas slot).

Layout: ``csrc/`` holds the CUDA C++ sources (built by :mod:`._build` at
first use); one directory per kernel family holds

* ``kernel.py`` — the wrapper (checks, launch, launch count) and the plain
  PyTorch version it is held against;
* ``ops.py``    — the registry binding for the ``cuda`` space and the
  family's tuning spec (for the LM kernels ``rmsnorm``, ``flash_attention``,
  ``ssd`` and ``rwkv6``, also their ``reference`` and ``torch`` spaces).

Importing this package registers the ``cuda`` implementations.
"""

from repro_torch.kernels.axpy_norm.kernel import (
    axpy_norm,
    axpy_norm_plain,
    axpy_norm_rows,
)
from repro_torch.kernels.block_jacobi.kernel import (
    block_jacobi_apply,
    block_jacobi_apply_plain,
)
from repro_torch.kernels.flash_attention.kernel import (
    flash_attention,
    flash_attention_plain,
)
from repro_torch.kernels.rmsnorm.kernel import rmsnorm, rmsnorm_plain
from repro_torch.kernels.rwkv6.kernel import (
    rwkv6_scan,
    rwkv6_scan_log,
    rwkv6_scan_plain,
)
from repro_torch.kernels.spgemm.kernel import (
    csr_permute,
    csr_permute_plain,
    spgemm_expand,
    spgemm_expand_plain,
    spgemm_merge,
    spgemm_merge_plain,
)
from repro_torch.kernels.spmv_dot.kernel import spmv_dot_ell, spmv_dot_ell_plain
from repro_torch.kernels.spmv_batch_ell.kernel import (
    spmv_batch_ell,
    spmv_batch_ell_plain,
)
from repro_torch.kernels.spmv_ell.kernel import spmv_ell, spmv_ell_plain
from repro_torch.kernels.spmv_sellp.kernel import spmv_sellp, spmv_sellp_plain
from repro_torch.kernels.ssd.kernel import ssd_scan, ssd_scan_plain

import repro_torch.kernels.axpy_norm.ops  # noqa: E402,F401
import repro_torch.kernels.block_jacobi.ops  # noqa: E402,F401
import repro_torch.kernels.flash_attention.ops  # noqa: E402,F401
import repro_torch.kernels.rmsnorm.ops  # noqa: E402,F401
import repro_torch.kernels.rwkv6.ops  # noqa: E402,F401
import repro_torch.kernels.spgemm.ops  # noqa: E402,F401
import repro_torch.kernels.spmv_dot.ops  # noqa: E402,F401
import repro_torch.kernels.spmv_batch_ell.ops  # noqa: E402,F401
import repro_torch.kernels.spmv_ell.ops  # noqa: E402,F401
import repro_torch.kernels.spmv_sellp.ops  # noqa: E402,F401
import repro_torch.kernels.ssd.ops  # noqa: E402,F401

#: kernel name -> wrapper; each wrapper counts its launches in ``.launches``
KERNELS = {
    "spmv_ell": spmv_ell,
    "spmv_dot_ell": spmv_dot_ell,
    "axpy_norm": axpy_norm,
    "axpy_norm_rows": axpy_norm_rows,
    "block_jacobi_apply": block_jacobi_apply,
    "spgemm_expand": spgemm_expand,
    "csr_permute": csr_permute,
    "spgemm_merge": spgemm_merge,
    "spmv_sellp": spmv_sellp,
    "spmv_batch_ell": spmv_batch_ell,
    "rmsnorm": rmsnorm,
    "flash_attention": flash_attention,
    "ssd_scan": ssd_scan,
    "rwkv6_scan_log": rwkv6_scan_log,
}


def launch_counts() -> dict:
    """Kernel launches counted by each wrapper since the last reset."""
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
    block_jacobi_apply.launches_by_storage = {}
    spmv_ell.launches_by_dtype = {}


__all__ = [
    "KERNELS",
    "launch_counts",
    "reset_launch_counts",
    "axpy_norm",
    "axpy_norm_plain",
    "axpy_norm_rows",
    "block_jacobi_apply",
    "block_jacobi_apply_plain",
    "csr_permute",
    "csr_permute_plain",
    "flash_attention",
    "flash_attention_plain",
    "rmsnorm",
    "rmsnorm_plain",
    "rwkv6_scan",
    "rwkv6_scan_log",
    "rwkv6_scan_plain",
    "spgemm_expand",
    "spgemm_expand_plain",
    "spgemm_merge",
    "spgemm_merge_plain",
    "spmv_batch_ell",
    "spmv_batch_ell_plain",
    "spmv_dot_ell",
    "spmv_dot_ell_plain",
    "spmv_ell",
    "spmv_ell_plain",
    "spmv_sellp",
    "spmv_sellp_plain",
    "ssd_scan",
    "ssd_scan_plain",
]
