"""The least bytes and operations of a preconditioned CG solve, worked out
from the problem alone: rows ``n``, true nonzeros ``nnz``, the vectors'
element size ``s`` and the preconditioner's stored inverses (true block
sizes, each block in its storage precision, from the reference's own
selection).  Never from a format's padded storage or a kernel's access
pattern, so any implementation of the same solve reads as the same work.

Each input is read once and each output written once:

* ``y = A x``: the values and int32 column indices once, x read, y written
  — ``nnz (s + 4) + 2 n s`` bytes, ``2 nnz`` operations (a fused dot
  against x reads nothing more);
* ``z = M⁻¹ r``: the stored inverses once, r read, z written —
  ``storage + 2 n s`` bytes, ``2 Σ b_i²`` operations (``n`` for scalar
  Jacobi);
* one CG iteration: A and the inverses once, and each recurrence vector
  (x, r, z, p, A·p) read once and written once — ``nnz (s + 4) + storage
  + 10 n s`` bytes; ``2 nnz + precond + 12 n`` operations (three axpys,
  three dots);
* a solve of k iterations: k iterations and b read once.
"""

from __future__ import annotations

import json
from pathlib import Path

PEAKS = json.loads((Path(__file__).resolve().parent / "peaks.json").read_text())
INDEX_BYTES = 4


def spmv_bytes(p: dict) -> float:
    return p["nnz"] * (p["s"] + INDEX_BYTES) + 2 * p["n"] * p["s"]


def spmv_flops(p: dict) -> float:
    return 2.0 * p["nnz"]


def precond_bytes(p: dict) -> float:
    return p["precond_storage_bytes"] + 2 * p["n"] * p["s"]


def precond_flops(p: dict) -> float:
    return float(p["precond_flops"])


def iteration_bytes(p: dict) -> float:
    return (p["nnz"] * (p["s"] + INDEX_BYTES) + p["precond_storage_bytes"]
            + 10 * p["n"] * p["s"])


def iteration_flops(p: dict) -> float:
    return 2.0 * p["nnz"] + p["precond_flops"] + 12.0 * p["n"]


def solve_bytes(p: dict, iterations: float, solves: int = 1) -> float:
    return iterations * iteration_bytes(p) + solves * p["n"] * p["s"]


def solve_flops(p: dict, iterations: float) -> float:
    return iterations * iteration_flops(p)


def least_seconds(nbytes: float, flops: float, dtype: str, device_kind: str) -> float:
    """The larger of bytes at the HBM rate and operations at the dtype's
    rate: the least time the card could take (a KeyError for a card
    ``peaks.json`` lacks)."""
    pk = PEAKS[device_kind]
    return max(nbytes / pk["hbm_bytes_per_s"], flops / pk["flops_per_s"][dtype])
