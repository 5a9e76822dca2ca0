"""repro_torch.core — hardware tables, registry, tuning, executors, LinOps,
cooperative groups."""

from repro_torch.core import coop

from repro_torch.core.executor import (
    CudaExecutor,
    Executor,
    ReferenceExecutor,
    TorchExecutor,
    current_executor,
    default_device,
    default_executor,
    make_executor,
    reset_default_executor,
    synchronize,
    use_executor,
)
from repro_torch.core.linop import (
    Composition,
    Identity,
    LinOp,
    MatrixFreeOp,
    ScaledIdentity,
    Sum,
    Transpose,
    as_linop,
)
from repro_torch.core.params import H100, HardwareParams, TARGETS, get_target
from repro_torch.core.registry import (
    NotCompiledError,
    all_operations,
    operation,
    register,
    registered_spaces,
)

__all__ = [
    "coop",
    "CudaExecutor",
    "Executor",
    "ReferenceExecutor",
    "TorchExecutor",
    "current_executor",
    "default_device",
    "default_executor",
    "make_executor",
    "reset_default_executor",
    "synchronize",
    "use_executor",
    "Composition",
    "Identity",
    "LinOp",
    "MatrixFreeOp",
    "ScaledIdentity",
    "Sum",
    "Transpose",
    "as_linop",
    "H100",
    "HardwareParams",
    "TARGETS",
    "get_target",
    "NotCompiledError",
    "all_operations",
    "operation",
    "register",
    "registered_spaces",
]
