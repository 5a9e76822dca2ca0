"""Pattern-keyed setup cache — Ginkgo's generate/apply separation as a cache.

Ginkgo splits every preconditioner or solver factory into an expensive
``generate`` (analyse the matrix, build factors) and a cheap ``apply``.  In a
serving loop the same sparsity patterns recur, so the generate products are
cached in two tiers:

* **pattern tier** — everything derived from the sparsity structure alone:
  block pointers, value-slot tables, the ELL layout map, the ParILU or AMG
  structure, and (through the engine) the lane's refresh/advance closures.
  Keyed by :func:`pattern_key`, a SHA-1 over ``(indptr, indices, shape,
  config)`` — the JAX package's digest, computed on the host from int64
  copies of the index arrays, so both packages key a pattern alike.
* **values tier** — the numeric factors of one value set, keyed inside its
  pattern entry by :func:`values_fingerprint`: inverted block-Jacobi blocks,
  the ParILU sweep factors ``[L | U]``, or the AMG two-level row
  ``[inv_diag | A_c⁻¹]``.

Generation runs through registered operations (``serve_generate_pattern``,
``serve_generate_factors``), registered in the reference space only: they
have no kernel in either package, and every executor's chain ends in the
reference space.  So the executor's dispatch log shows a cache-hit request
launching **zero** generate operations.

Both tiers are LRU, with hit/miss/eviction counters in the metrics registry
(``serve_cache_{hits,misses,evictions}`` labelled by ``tier``).
"""

from __future__ import annotations

import dataclasses
import hashlib
from collections import OrderedDict
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.batch.formats import BatchCsr, BatchEll
from repro_torch.core import registry
from repro_torch.observability import metrics
from repro_torch.precond import (
    BatchBlockJacobiPattern,
    batch_block_jacobi_factors,
    batch_block_jacobi_pattern,
)
from repro_torch.precond.amg import (
    AmgServePattern,
    amg_serve_factors,
    amg_serve_pattern,
)
from repro_torch.solvers.parilu import (
    ParILUStructure,
    parilu_factorize,
    parilu_setup,
)
from repro_torch.sparse.formats import Csr, csr_from_arrays

__all__ = [
    "PatternSetup",
    "SetupCache",
    "cache_stats",
    "pattern_key",
    "values_fingerprint",
    "serve_generate_pattern_op",
    "serve_generate_factors_op",
]


def pattern_key(indptr: np.ndarray, indices: np.ndarray,
                shape: Tuple[int, int], config: str = "") -> str:
    """Hash of the sparsity pattern and the lane configuration.

    Two requests share setup products iff their CSR index structure, matrix
    shape and lane config (format, preconditioner, block size) agree.
    """
    h = hashlib.sha1()
    h.update(np.ascontiguousarray(np.asarray(indptr, np.int64)).tobytes())
    h.update(np.ascontiguousarray(np.asarray(indices, np.int64)).tobytes())
    h.update(f"{tuple(shape)}|{config}".encode())
    return h.hexdigest()


def values_fingerprint(values: np.ndarray) -> str:
    """Hash of one concrete value set (the values-tier key)."""
    a = np.ascontiguousarray(np.asarray(values))
    return hashlib.sha1(a.tobytes() + str(a.dtype).encode()).hexdigest()


@dataclasses.dataclass(eq=False)
class PatternSetup:
    """Pattern-tier generate products for one (pattern, config) key."""

    key: str
    indptr: np.ndarray
    indices: np.ndarray
    shape: Tuple[int, int]
    fmt: str  # "csr" | "ell"
    #: ELL column block (m, k) on the lane's device and the CSR-slot ->
    #: ELL-slot value map, for ELL lanes; None for CSR lanes
    col_idx: Optional[torch.Tensor] = None
    ell_map: Optional[np.ndarray] = None
    #: block-Jacobi pattern tier; None unless the lane uses block-Jacobi
    jacobi: Optional[BatchBlockJacobiPattern] = None
    #: ParILU sparsity analysis; None unless the lane uses ``parilu``
    parilu: Optional[ParILUStructure] = None
    #: AMG two-level hierarchy; None unless the lane uses ``amg``
    amg: Optional[AmgServePattern] = None
    #: engine-owned: the (refresh, advance) pair per closure key
    closures: Dict[Any, Any] = dataclasses.field(default_factory=dict)
    #: values-tier LRU: values_fingerprint -> factors
    factors: "OrderedDict[str, torch.Tensor]" = dataclasses.field(
        default_factory=OrderedDict)

    @property
    def n(self) -> int:
        return int(self.shape[0])

    @property
    def nnz(self) -> int:
        return int(np.asarray(self.indices).size)

    @property
    def flat_value_len(self) -> int:
        """Length of one system's flat value row in lane storage."""
        if self.fmt == "ell":
            m, k = self.col_idx.shape
            return int(m * k)
        return self.nnz

    def lane_values(self, values: np.ndarray) -> np.ndarray:
        """CSR request values -> the lane's flat value layout (host)."""
        if self.fmt == "ell":
            out = np.zeros(self.flat_value_len, np.asarray(values).dtype)
            out[self.ell_map] = np.asarray(values)
            return out
        return np.asarray(values)

    def csr_values(self, flat: torch.Tensor) -> torch.Tensor:
        """The lane's flat value row -> CSR-order values."""
        if self.fmt == "ell":
            return flat[torch.as_tensor(self.ell_map, device=flat.device)]
        return flat

    @property
    def has_factors(self) -> bool:
        return (self.jacobi is not None or self.parilu is not None
                or self.amg is not None)

    @property
    def flat_factor_len(self) -> Optional[int]:
        """Per-system factor-row length of the ParILU and AMG lanes; None
        for block-Jacobi ((nblocks, bs, bs) stacks) and unpreconditioned
        lanes."""
        if self.parilu is not None:
            return int(self.parilu.l_rows.size + self.parilu.u_rows.size)
        if self.amg is not None:
            return int(self.amg.flat_len)
        return None


# =============================================================================
# Generation as registered operations (visible in the dispatch log)
# =============================================================================

serve_generate_pattern_op = registry.operation(
    "serve_generate_pattern",
    "pattern-tier setup: block discovery, slot tables, layout maps",
)

serve_generate_factors_op = registry.operation(
    "serve_generate_factors",
    "values-tier setup: block gather + batched Gauss-Jordan inversion",
)


@serve_generate_pattern_op.register("reference")
def _generate_pattern_ref(ex, indptr: np.ndarray, indices: np.ndarray,
                          shape: Tuple[int, int], *, fmt: str = "csr",
                          precond: str = "block_jacobi",
                          block_size: int = 4) -> PatternSetup:
    """The pattern tier on ``ex.device``: ELL layout (CSR column order per
    row, padded with (column 0, value 0) at the tail), then the
    preconditioner's structure."""
    indptr = np.asarray(indptr, np.int64)
    indices = np.asarray(indices, np.int64)
    m = int(shape[0])
    dev = ex.device
    col_idx = ell_map = None
    if fmt == "ell":
        row_nnz = np.diff(indptr)
        k = max(int(row_nnz.max()) if m else 1, 1)
        rows = np.repeat(np.arange(m, dtype=np.int64), row_nnz)
        q = np.arange(indices.size, dtype=np.int64) - indptr[rows]
        cols = np.zeros((m, k), np.int32)
        cols[rows, q] = indices
        col_idx = torch.as_tensor(cols, device=dev)
        ell_map = rows * k + q
        proto = BatchEll(col_idx=col_idx,
                         values=torch.zeros((1, m, k), device=dev),
                         shape=tuple(shape))
    elif fmt == "csr":
        proto = BatchCsr(
            indptr=torch.as_tensor(indptr.astype(np.int32), device=dev),
            indices=torch.as_tensor(indices.astype(np.int32), device=dev),
            values=torch.zeros((1, indices.size), device=dev),
            shape=tuple(shape))
    else:
        raise ValueError(f"unknown lane format {fmt!r} (csr | ell)")

    jacobi = parilu = amg = None
    if precond == "block_jacobi":
        jacobi = batch_block_jacobi_pattern(proto, block_size, executor=ex)
    elif precond == "parilu":
        parilu = parilu_setup(csr_from_arrays(
            indptr, indices, np.zeros(indices.size, np.float32), shape,
            device="cpu"))
    elif precond == "amg":
        amg = amg_serve_pattern(indptr, indices, m)
    elif precond != "none":
        raise ValueError(f"unknown serve preconditioner {precond!r} "
                         "(none | block_jacobi | parilu | amg)")
    return PatternSetup(key="", indptr=indptr, indices=indices,
                        shape=tuple(shape), fmt=fmt, col_idx=col_idx,
                        ell_map=ell_map, jacobi=jacobi, parilu=parilu, amg=amg)


@serve_generate_factors_op.register("reference")
def _generate_factors_ref(ex, values: torch.Tensor, setup: PatternSetup):
    """Values-tier factors of one system's flat lane-layout value row.

    * block-Jacobi: inverted blocks ``(nblocks, bs, bs)``, through the same
      gather and Gauss–Jordan as :func:`repro_torch.precond.batch_block_jacobi`;
    * parilu: the Chow–Patel sweep factors, flattened to ``[L | U]``;
    * amg: the two-level row ``[inv_diag | A_c⁻¹]``.
    """
    if setup.jacobi is not None:
        return batch_block_jacobi_factors(values[None, :], setup.jacobi)
    csr_vals = setup.csr_values(values)
    if setup.parilu is not None:
        A = Csr(torch.as_tensor(setup.indptr.astype(np.int32), device=values.device),
                torch.as_tensor(setup.indices.astype(np.int32), device=values.device),
                csr_vals, tuple(setup.shape))
        l_vals, u_vals, _ = parilu_factorize(A, setup.parilu)
        return torch.cat([l_vals, u_vals])
    if setup.amg is not None:
        return amg_serve_factors(setup.amg, csr_vals)
    raise ValueError("lane has no preconditioner: no factors to generate")


# =============================================================================
# The two-tier LRU
# =============================================================================


class SetupCache:
    """LRU of :class:`PatternSetup` entries, each with a nested factor LRU.

    ``capacity`` bounds the pattern entries (evicting one drops its factors
    and closures); ``factors_capacity`` bounds each pattern's values tier.
    Hits, misses and evictions are ``serve_cache_*`` counters with a
    ``tier`` label in the metrics registry.
    """

    def __init__(self, capacity: int = 32, factors_capacity: int = 8):
        if capacity <= 0 or factors_capacity <= 0:
            raise ValueError("cache capacities must be positive")
        self.capacity = capacity
        self.factors_capacity = factors_capacity
        self._entries: "OrderedDict[str, PatternSetup]" = OrderedDict()

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key: str) -> bool:
        return key in self._entries

    @property
    def keys(self):
        """Pattern keys, LRU -> MRU order."""
        return tuple(self._entries)

    @staticmethod
    def _count(name: str, tier: str):
        return metrics.counter(name, tier=tier)

    def setup(self, key: str, build: Callable[[], PatternSetup]
              ) -> Tuple[PatternSetup, bool]:
        """Pattern-tier lookup, ``(entry, hit)``; ``build`` runs on a miss."""
        entry = self._entries.get(key)
        if entry is not None:
            self._entries.move_to_end(key)
            self._count("serve_cache_hits", "pattern").inc()
            return entry, True
        self._count("serve_cache_misses", "pattern").inc()
        entry = build()
        entry.key = key
        self._entries[key] = entry
        while len(self._entries) > self.capacity:
            self._entries.popitem(last=False)
            self._count("serve_cache_evictions", "pattern").inc()
        return entry, False

    def factors(self, entry: PatternSetup, fingerprint: str,
                build: Callable[[], torch.Tensor]) -> Tuple[torch.Tensor, bool]:
        """Values-tier lookup inside ``entry``, ``(factors, hit)``."""
        inv = entry.factors.get(fingerprint)
        if inv is not None:
            entry.factors.move_to_end(fingerprint)
            self._count("serve_cache_hits", "values").inc()
            return inv, True
        self._count("serve_cache_misses", "values").inc()
        inv = build()
        entry.factors[fingerprint] = inv
        while len(entry.factors) > self.factors_capacity:
            entry.factors.popitem(last=False)
            self._count("serve_cache_evictions", "values").inc()
        return inv, False

    def stats(self) -> Dict[str, float]:
        return cache_stats()


def cache_stats() -> Dict[str, float]:
    """The ``serve_cache_*`` counters by tier (zeros for series never
    touched), as ``{"serve_cache_hits_pattern": ..., ...}``."""
    return {f"{name}_{tier}": metrics.counter(name, tier=tier).value
            for name in ("serve_cache_hits", "serve_cache_misses",
                         "serve_cache_evictions")
            for tier in ("pattern", "values")}
