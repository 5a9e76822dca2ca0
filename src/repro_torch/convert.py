"""Carry the JAX package's state across: numpy arrays in, the port's objects out.

Each function takes plain numpy arrays — what ``np.asarray`` gives from a JAX
``Coo``/``Csr``/``Ell``/``Sellp``/``BatchCsr``/``BatchEll``/``BlockJacobi``/
``BatchBlockJacobi``/``Multigrid`` field — and builds the port's object on
``device`` (the card unless ``device="cpu"`` is asked for).
Nothing here imports JAX.

A JAX bfloat16 array arrives as an ``ml_dtypes`` numpy array, which
``torch.from_numpy`` refuses; :func:`tensor` moves it through its ``uint16``
bit pattern and reinterprets that as ``torch.bfloat16``.  The way back,
:func:`repro_torch.sparse.formats.host_array`, gives bfloat16 as those
``uint16`` bits.
"""

from __future__ import annotations

from typing import Mapping, Sequence, Tuple

import numpy as np
import torch

from repro_torch.batch.formats import BatchCsr, BatchEll
from repro_torch.precond.amg import AmgLevel, Multigrid
from repro_torch.precond.block_jacobi import BatchBlockJacobi, BlockJacobi
from repro_torch.sparse.formats import Coo, Csr, Ell, Sellp, _device, host_array

__all__ = ["tensor", "coo", "csr", "ell", "sellp", "batch_csr", "batch_ell",
           "block_jacobi", "batch_block_jacobi", "multigrid", "host_array"]


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


def coo(row_idx, col_idx, values, shape: Tuple[int, int], *, device=None) -> Coo:
    return Coo(
        row_idx=tensor(row_idx, device=device, dtype=torch.int32),
        col_idx=tensor(col_idx, device=device, dtype=torch.int32),
        values=tensor(values, device=device),
        shape=tuple(int(s) for s in shape),
    )


def sellp(col_idx, values, slice_sets, slice_cols, shape: Tuple[int, int],
          slice_size: int, stride_factor: int, max_slice_cols: int, *,
          device=None) -> Sellp:
    return Sellp(
        col_idx=tensor(col_idx, device=device, dtype=torch.int32),
        values=tensor(values, device=device),
        slice_sets=tensor(slice_sets, device=device, dtype=torch.int32),
        slice_cols=tensor(slice_cols, device=device, dtype=torch.int32),
        shape=tuple(int(s) for s in shape),
        slice_size=int(slice_size),
        stride_factor=int(stride_factor),
        max_slice_cols=int(max_slice_cols),
    )


def batch_csr(indptr, indices, values, shape: Tuple[int, int], *,
              device=None) -> BatchCsr:
    return BatchCsr(
        indptr=tensor(indptr, device=device, dtype=torch.int32),
        indices=tensor(indices, device=device, dtype=torch.int32),
        values=tensor(values, device=device),
        shape=tuple(int(s) for s in shape),
    )


def batch_ell(col_idx, values, shape: Tuple[int, int], *, device=None) -> BatchEll:
    return BatchEll(
        col_idx=tensor(col_idx, device=device, dtype=torch.int32),
        values=tensor(values, device=device),
        shape=tuple(int(s) for s in shape),
    )


def batch_block_jacobi(inv_blocks: Sequence, perm, inv_perm, gather_idx, n: int,
                       num_blocks: int, block_size: int, *, device=None,
                       executor=None) -> BatchBlockJacobi:
    """A :class:`BatchBlockJacobi` from the JAX package's generated arrays."""
    return BatchBlockJacobi(
        inv_blocks=tuple(tensor(t, device=device) for t in inv_blocks),
        perm=tensor(perm, device=device, dtype=torch.int64),
        inv_perm=tensor(inv_perm, device=device, dtype=torch.int64),
        gather_idx=tensor(gather_idx, device=device, dtype=torch.int64),
        n=int(n),
        num_blocks=int(num_blocks),
        block_size=int(block_size),
        executor=executor,
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


def multigrid(levels: Sequence[Mapping], coarse_A, coarse_inv, *,
              cycle: str = "v", omega: float = 2.0 / 3.0, pre_sweeps: int = 1,
              post_sweeps: int = 1, device=None, executor=None) -> Multigrid:
    """A :class:`Multigrid` over the JAX package's hierarchy, with no setup.

    Each level is a mapping with ``"A"``, ``"P"``, ``"R"`` as CSR
    ``(indptr, indices, values, shape)``, their ELL mirrors ``"A_op"``,
    ``"P_op"``, ``"R_op"`` as ``(col_idx, values, shape)``, and
    ``"inv_diag"``; ``coarse_A`` is a CSR quadruple and ``coarse_inv`` the
    dense coarse inverse.  Weighted-Jacobi smoothing, dense coarse solve.
    """
    built = [
        AmgLevel(
            A=csr(*L["A"], device=device),
            P=csr(*L["P"], device=device),
            R=csr(*L["R"], device=device),
            A_op=ell(*L["A_op"], device=device),
            P_op=ell(*L["P_op"], device=device),
            R_op=ell(*L["R_op"], device=device),
            inv_diag=tensor(L["inv_diag"], device=device),
        )
        for L in levels
    ]
    return Multigrid.from_levels(
        built, csr(*coarse_A, device=device),
        tensor(coarse_inv, device=device), cycle=cycle, omega=omega,
        pre_sweeps=pre_sweeps, post_sweeps=post_sweeps, executor=executor,
    )
