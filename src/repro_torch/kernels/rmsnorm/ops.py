"""Registry bindings for RMSNorm (operation ``nn_rmsnorm``).

The ``reference`` and ``torch`` spaces compute the plain version (the JAX
package's reference and XLA spaces share one formula too); the ``cuda``
space launches the kernel, with the rows per block (when a row takes one
warp) from the tuning table; the rest of the geometry is
``rmsnorm_geometry``'s, from the row's width.  The ``cuda`` registration is
unconditional: a failed build or launch raises and is never re-dispatched.
When ``x`` or the weight needs a gradient the kernel runs inside
:func:`repro_torch.kernels._autograd.kernel_call`: backward recomputes the
plain version (x keeps its row stride, MLA's latent columns included).
"""

from __future__ import annotations

import functools

from repro_torch.core import registry, tuning
from repro_torch.kernels._autograd import kernel_call
from repro_torch.kernels._check import require_cuda
from repro_torch.kernels.rmsnorm.kernel import (MAX_THREADS, rmsnorm,
                                               rmsnorm_plain)


def _constrain(hw, shapes, block):
    return {"rows_per_block": min(max(int(block["rows_per_block"]), 1),
                                  MAX_THREADS // hw.warp_size)}


RMSNORM_SPEC = tuning.register_spec(
    tuning.TuningSpec(
        op="nn_rmsnorm",
        params=("rows_per_block",),
        seed=lambda hw: {"rows_per_block": 4},
        # two sets of the (up to 32) warp partials of a one-row block
        # (static shared memory)
        smem_bytes=lambda shapes, block: 2 * 32 * 4,
        constrain=_constrain,
    )
)


def _plain(ex, x, weight, eps: float = 1e-6):
    return rmsnorm_plain(x, weight, eps)


registry.register("nn_rmsnorm", "reference")(_plain)
registry.register("nn_rmsnorm", "torch")(_plain)


@registry.register("nn_rmsnorm", "cuda")
def _rmsnorm_cuda(ex, x, weight, eps: float = 1e-6):
    require_cuda("nn_rmsnorm", x, weight)
    cfg = ex.launch_config("nn_rmsnorm", {"rows": x.numel() // x.shape[-1],
                                          "d": x.shape[-1],
                                          "itemsize": x.element_size()})
    kernel = functools.partial(rmsnorm, eps=eps,
                               rows_per_block=cfg["rows_per_block"])
    return kernel_call(kernel, functools.partial(rmsnorm_plain, eps=eps),
                       x, weight)
