"""AMG's greedy aggregation compiled into the port's library
(``csrc/amg_aggregate.cu``, host code): the wrapper of
``repro_amg_aggregate``.

:func:`aggregate_compiled` gives what
:func:`repro_torch.precond.amg.aggregate` gives, bit for bit, without the
Python passes (0.6 s at 64³ rows and ≈40 s at 256³ in the interpreter).
The hierarchy calls it for a matrix on a card, where the library is built
anyway; the Python passes stay for the CPU.  The arrays are checked here
(sizes, the columns' range) before the C code indexes them.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np

from repro_torch.kernels import _build
from repro_torch.kernels._check import require

__all__ = ["aggregate_compiled"]

_P = ctypes.c_void_p
_ARGS = (_P, _P, _P, ctypes.c_int64, _P, _P)


def aggregate_compiled(indptr, indices, strong, n: int) -> Tuple[np.ndarray, int]:
    """``(agg, n_agg)`` of the three greedy passes over the CSR pattern
    ``(indptr, indices)`` and the strength mask ``strong`` (one entry per
    stored entry), computed by the library's host code."""
    name = "amg_aggregate"
    ip = np.ascontiguousarray(indptr, dtype=np.int64)
    ix = np.ascontiguousarray(indices, dtype=np.int64)
    st = np.ascontiguousarray(strong, dtype=np.bool_)
    n = int(n)
    require(ip.shape == (n + 1,), name, f"indptr has {ip.shape[0]} entries, "
            f"not n + 1 = {n + 1}")
    nnz = int(ip[-1]) if n else 0
    require(ip[0] == 0 and nnz == ix.shape[0] == st.shape[0], name,
            f"indptr spans [{int(ip[0])}, {nnz}); indices {ix.shape[0]}, "
            f"strong {st.shape[0]}")
    require(bool(np.all(np.diff(ip) >= 0)), name, "indptr must not decrease")
    require(nnz == 0 or (int(ix.min()) >= 0 and int(ix.max()) < n), name,
            f"a column lies outside [0, {n})")
    agg = np.empty(n, np.int64)
    n_agg = ctypes.c_int64(0)
    fn = _build.function("repro_amg_aggregate", _ARGS)
    _build.check(name, fn(ip.ctypes.data, ix.ctypes.data, st.ctypes.data, n,
                          agg.ctypes.data, ctypes.addressof(n_agg)))
    return agg, int(n_agg.value)
