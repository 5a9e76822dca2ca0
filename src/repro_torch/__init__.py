"""repro_torch — the PyTorch/CUDA port of the Ginkgo reproduction.

The package beside ``repro`` (the JAX/Pallas reference, which it never
imports).  Module names match the JAX package's, so each module's counterpart
is easy to find.  This slice covers the main path: block-Jacobi
preconditioned CG on an ELL matrix, with its four kernels
(``spmv_ell``, ``spmv_dot_ell``, ``axpy_norm``, ``block_jacobi_apply``)
hand-written in CUDA C++ for Hopper (``sm_90a``).

Entry points run on the card: :func:`repro_torch.core.default_executor` is
the CUDA executor and the format constructors place tensors on the current
CUDA device.  The CPU is used only when asked for (``device="cpu"`` and
``make_executor("torch")`` or ``make_executor("reference")``).
"""

from repro_torch import core, precond, solvers, sparse  # noqa: F401

__all__ = ["core", "precond", "solvers", "sparse"]
