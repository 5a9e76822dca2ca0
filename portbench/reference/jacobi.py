"""Plain scalar Jacobi (Ginkgo's ``preconditioner::Jacobi`` with block size
1): ``z = r / diag(A)``, the inverse diagonal worked out in float64 from the
host CSR arrays (a zero diagonal entry gives 1) and stored in the working
precision.  Independent of ``repro_torch``."""

from __future__ import annotations

import numpy as np
import torch


class Jacobi:
    def __init__(self, csr, *, working: torch.dtype, compute_dtype: torch.dtype,
                 device):
        indptr, indices, values, shape = csr
        n = int(shape[0])
        rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
        hit = rows == indices
        d = np.zeros(n, np.float64)
        np.add.at(d, rows[hit], values[hit].astype(np.float64))
        inv = np.where(d != 0, 1.0 / np.where(d != 0, d, 1.0), 1.0)
        self.inv = torch.as_tensor(inv, device=device).to(working).to(compute_dtype)
        self.compute_dtype = compute_dtype
        self.class_counts = {str(working).removeprefix("torch."): n}
        self.storage_bytes = n * torch.finfo(working).bits // 8
        self.flops = n

    def apply(self, r: torch.Tensor) -> torch.Tensor:
        return self.inv * r.to(self.compute_dtype)


def build(csr, opts: dict, *, working: torch.dtype, compute_dtype: torch.dtype,
          device) -> Jacobi:
    if opts.get("adaptive"):
        raise ValueError("the reference Jacobi stores the working precision only")
    return Jacobi(csr, working=working, compute_dtype=compute_dtype, device=device)
