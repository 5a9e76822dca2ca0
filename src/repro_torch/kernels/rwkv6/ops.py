"""Registry bindings for the RWKV6 WKV scan (operation ``nn_rwkv6_scan``).

``reference`` runs the sequential recurrence on exp(logw)
(``ref.rwkv6_ref``), ``torch`` the chunked formulation in batched products
(the kernel's plain version, at the kernel's chunk), ``cuda`` the kernel.
The ``cuda`` registration is unconditional: a failed build or launch raises
and is never re-dispatched.  When an input needs a gradient the kernel runs
inside :func:`repro_torch.kernels._autograd.kernel_call`: backward
recomputes the torch space's chunked plain version (``rwkv6_scan_plain``).
"""

from __future__ import annotations

import torch

from repro_torch.core import registry, tuning
from repro_torch.kernels._autograd import kernel_call
from repro_torch.kernels._check import require_cuda
from repro_torch.kernels.rwkv6.kernel import (
    CHUNK,
    rwkv6_scan_log,
    rwkv6_scan_plain,
    rwkv6_smem_bytes,
    rwkv6_tensor_cores,
)
from repro_torch.kernels.rwkv6.ref import rwkv6_ref


def _constrain(hw, shapes, block):
    # the source compiles one chunk length
    return {"chunk": CHUNK}


RWKV6_SPEC = tuning.register_spec(
    tuning.TuningSpec(
        op="nn_rwkv6_scan",
        params=("chunk",),
        seed=lambda hw: {"chunk": CHUNK},
        # "tensor_cores": 0 for the inputs the CUDA-core kernel takes
        # (rwkv6_tensor_cores, as the wrapper decides)
        smem_bytes=lambda shapes, block: rwkv6_smem_bytes(
            bool(shapes.get("tensor_cores", 1))),
        constrain=_constrain,
    )
)


@registry.register("nn_rwkv6_scan", "reference")
def _rwkv6_reference(ex, r, k, v, logw, u):
    return rwkv6_ref(r, k, v, torch.exp(logw.to(torch.float32)), u)


@registry.register("nn_rwkv6_scan", "torch")
def _rwkv6_torch(ex, r, k, v, logw, u):
    return rwkv6_scan_plain(r, k, v, logw, u, chunk=CHUNK)


@registry.register("nn_rwkv6_scan", "cuda")
def _rwkv6_cuda(ex, r, k, v, logw, u):
    require_cuda("nn_rwkv6_scan", r, k, v, logw, u)
    # the chunk is compiled; resolving checks the block's shared memory
    r, k, v, u = (t.contiguous() for t in (r, k, v, u))
    logw = logw.to(torch.float32).contiguous()
    ex.launch_config("nn_rwkv6_scan", {
        "S": r.shape[1], "K": r.shape[-1], "V": v.shape[-1],
        "tensor_cores": int(rwkv6_tensor_cores(r, k, v, logw))})
    return kernel_call(rwkv6_scan_log, rwkv6_scan_plain, r, k, v, logw, u)
