"""repro_torch.sparse — formats, gallery, executor-dispatched sparse ops."""

from repro_torch.sparse import gallery, ops
from repro_torch.sparse.formats import (
    Coo,
    Csr,
    Dense,
    Ell,
    Sellp,
    convert,
    coo_from_dense,
    csr_from_arrays,
    csr_from_dense,
    csr_host_arrays,
    csr_slice_rows_host,
    ell_from_csr_host,
    ell_from_dense,
    sellp_from_csr_host,
    sellp_from_dense,
)

__all__ = [
    "gallery",
    "ops",
    "Coo",
    "Csr",
    "Dense",
    "Ell",
    "Sellp",
    "convert",
    "coo_from_dense",
    "csr_from_arrays",
    "csr_from_dense",
    "csr_host_arrays",
    "csr_slice_rows_host",
    "ell_from_csr_host",
    "ell_from_dense",
    "sellp_from_csr_host",
    "sellp_from_dense",
]
