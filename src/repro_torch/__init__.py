"""repro_torch — the PyTorch/CUDA port of the Ginkgo reproduction.

The package beside ``repro`` (the JAX/Pallas reference, which it never
imports).  Module names match the JAX package's, so each module's counterpart
is easy to find.  It covers preconditioned CG on the stored formats (COO,
CSR, ELL, SELL-P, dense), block-Jacobi and smoothed-aggregation AMG, and the
batched solvers (:mod:`repro_torch.batch`), and serving of the hybrid
language-model family (Zamba2: :mod:`repro_torch.models.lm`,
``python -m repro_torch.launch.serve``); the JAX package's Pallas kernels on
those paths are hand-written in CUDA C++ for Hopper (``sm_90a``).

Entry points run on the card: :func:`repro_torch.core.default_executor` is
the CUDA executor and the format constructors place tensors on the current
CUDA device.  The CPU is used only when asked for (``device="cpu"`` and
``make_executor("torch")`` or ``make_executor("reference")``).
"""

from repro_torch import (  # noqa: F401
    batch,
    configs,
    core,
    models,
    nn,
    precond,
    solvers,
    sparse,
)

__all__ = ["batch", "configs", "core", "models", "nn", "precond", "solvers",
           "sparse"]
