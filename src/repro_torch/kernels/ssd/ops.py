"""Registry bindings for the Mamba2 SSD scan (operation ``nn_ssd_scan``).

``reference`` runs the sequential recurrence (``ref.ssd_ref``), ``torch`` the
chunked formulation in batched products (the kernel's plain version, at the
kernel's chunk), ``cuda`` the kernel.  The ``cuda`` registration is
unconditional: a failed build or launch raises and is never re-dispatched.
When an input needs a gradient the kernel runs inside
:func:`repro_torch.kernels._autograd.kernel_call`: backward recomputes the
torch space's chunked plain version (``ssd_scan_plain``, not the sequential
``ref.py``), on the same strided x, B and C.
"""

from __future__ import annotations

import torch

from repro_torch.core import registry, tuning
from repro_torch.kernels._autograd import kernel_call
from repro_torch.kernels._check import require_cuda
from repro_torch.kernels.ssd.kernel import (
    CHUNK,
    ssd_scan,
    ssd_scan_plain,
    ssd_smem_bytes,
    ssd_tensor_cores,
)
from repro_torch.kernels.ssd.ref import ssd_ref


def _constrain(hw, shapes, block):
    # the source compiles one chunk length
    return {"chunk": CHUNK}


SSD_SPEC = tuning.register_spec(
    tuning.TuningSpec(
        op="nn_ssd_scan",
        params=("chunk",),
        seed=lambda hw: {"chunk": CHUNK},
        # "tensor_cores": 0 for the inputs the CUDA-core kernel takes
        # (ssd_tensor_cores, as the wrapper decides)
        smem_bytes=lambda shapes, block: ssd_smem_bytes(
            bool(shapes.get("tensor_cores", 1))),
        constrain=_constrain,
    )
)


@registry.register("nn_ssd_scan", "reference")
def _ssd_reference(ex, x, dt, A, B_mat, C):
    return ssd_ref(x, dt, A, B_mat, C)


@registry.register("nn_ssd_scan", "torch")
def _ssd_torch(ex, x, dt, A, B_mat, C):
    return ssd_scan_plain(x, dt, A, B_mat, C, chunk=CHUNK)


@registry.register("nn_ssd_scan", "cuda")
def _ssd_cuda(ex, x, dt, A, B_mat, C):
    require_cuda("nn_ssd_scan", x, dt, A, B_mat, C)
    # the chunk is compiled; resolving checks the block's shared memory
    ex.launch_config("nn_ssd_scan", {
        "S": x.shape[1], "N": B_mat.shape[-1], "P": x.shape[-1],
        "tensor_cores": int(ssd_tensor_cores(x, B_mat, C))})
    # x, B and C go as they are (the kernel reads strided rows)
    return kernel_call(ssd_scan, ssd_scan_plain, x, dt.contiguous(),
                       A.contiguous(), B_mat, C)
