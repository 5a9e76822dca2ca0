"""repro_torch.core — hardware tables, registry, tuning, executors, LinOps,
cooperative groups."""

from repro_torch.core import coop, tuning

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
from repro_torch.core.params import (
    CPU_REFERENCE,
    H100,
    HardwareParams,
    TARGETS,
    get_target,
)
from repro_torch.core.registry import (
    NotCompiledError,
    Operation,
    all_operations,
    instantiate_common,
    operation,
    register,
    registered_spaces,
)
from repro_torch.core.tuning import LaunchConfig, TuningSpec

__all__ = [
    "coop",
    "tuning",
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
    "CPU_REFERENCE",
    "HardwareParams",
    "TARGETS",
    "get_target",
    "NotCompiledError",
    "Operation",
    "all_operations",
    "instantiate_common",
    "operation",
    "register",
    "registered_spaces",
    "LaunchConfig",
    "TuningSpec",
]
