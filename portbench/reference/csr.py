"""Plain CSR operator: ``y = A x`` as a gather, a product and a scatter-add.

Independent of ``repro_torch``: built from the benchmark's own host CSR
arrays, in any dtype (f64 for the reference, bf16 or f32 for a control).
"""

from __future__ import annotations

import numpy as np
import torch


class CsrOperator:
    def __init__(self, indptr: np.ndarray, indices: np.ndarray,
                 values: np.ndarray, shape, *, dtype: torch.dtype, device):
        self.n = int(shape[0])
        self.dtype = dtype
        dev = torch.device(device)
        counts = torch.as_tensor(np.diff(indptr), device=dev)
        self.rows = torch.repeat_interleave(
            torch.arange(self.n, device=dev), counts)
        self.cols = torch.as_tensor(indices, device=dev).long()
        self.vals = torch.as_tensor(values, device=dev).to(dtype)

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.zeros(self.n, dtype=self.dtype, device=x.device)
        return y.index_add_(0, self.rows, self.vals * x.to(self.dtype)[self.cols])


def build(csr, *, dtype: torch.dtype, device) -> CsrOperator:
    indptr, indices, values, shape = csr
    return CsrOperator(indptr, indices, values, shape, dtype=dtype, device=device)
