"""Carry the JAX package's state across: numpy arrays in, the port's objects out.

Each function takes plain numpy arrays — what ``np.asarray`` gives from a JAX
``Csr``/``Ell``/``BlockJacobi`` field — and builds the port's object on
``device`` (the card unless ``device="cpu"`` is asked for).  Nothing here
imports JAX.

A JAX bfloat16 array arrives as an ``ml_dtypes`` numpy array, which
``torch.from_numpy`` refuses; :func:`tensor` moves it through its ``uint16``
bit pattern and reinterprets that as ``torch.bfloat16``.  The way back,
:func:`repro_torch.sparse.formats.host_array`, gives bfloat16 as those
``uint16`` bits.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from repro_torch.precond.block_jacobi import BlockJacobi
from repro_torch.sparse.formats import Csr, Ell, _device, host_array

__all__ = ["tensor", "csr", "ell", "block_jacobi", "host_array"]


def tensor(a, *, device=None, dtype=None) -> torch.Tensor:
    """A numpy array (bfloat16 included) as a tensor on ``device``."""
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:  # a JAX array's numpy view is read-only
        a = a.copy()
    dev = _device(device)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device=dev, dtype=dtype or t.dtype)


def csr(indptr, indices, values, shape: Tuple[int, int], *, device=None) -> Csr:
    return Csr(
        indptr=tensor(indptr, device=device, dtype=torch.int32),
        indices=tensor(indices, device=device, dtype=torch.int32),
        values=tensor(values, device=device),
        shape=tuple(int(s) for s in shape),
    )


def ell(col_idx, values, shape: Tuple[int, int], *, device=None) -> Ell:
    return Ell(
        col_idx=tensor(col_idx, device=device, dtype=torch.int32),
        values=tensor(values, device=device),
        shape=tuple(int(s) for s in shape),
    )


def block_jacobi(inv_blocks: Sequence, gather_idx, scatter_idx, n: int,
                 block_size: int, num_blocks: int, *, device=None,
                 executor=None) -> BlockJacobi:
    """A :class:`BlockJacobi` from the JAX package's generated arrays (one
    inverted-block array per storage class, bf16 included)."""
    return BlockJacobi(
        inv_blocks=tuple(tensor(t, device=device) for t in inv_blocks),
        gather_idx=tensor(gather_idx, device=device, dtype=torch.int64),
        scatter_idx=tensor(scatter_idx, device=device, dtype=torch.int64),
        n=int(n),
        block_size=int(block_size),
        num_blocks=int(num_blocks),
        executor=executor,
    )
