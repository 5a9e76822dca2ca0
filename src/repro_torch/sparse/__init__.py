"""repro_torch.sparse — formats, gallery, executor-dispatched sparse ops."""

from repro_torch.sparse import gallery, ops
from repro_torch.sparse.formats import (
    Csr,
    Dense,
    Ell,
    csr_from_arrays,
    csr_from_dense,
    csr_host_arrays,
    ell_from_csr_host,
    ell_from_dense,
)

__all__ = [
    "gallery",
    "ops",
    "Csr",
    "Dense",
    "Ell",
    "csr_from_arrays",
    "csr_from_dense",
    "csr_host_arrays",
    "ell_from_csr_host",
    "ell_from_dense",
]
