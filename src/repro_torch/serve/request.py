"""Request/response records for the solve service.

A copy of the JAX package's records (numpy only).  A request carries one
sparse system in host CSR arrays (the wire format a service boundary would
deserialize into) plus its right-hand side; the response carries the
per-system slice of the batched solve outcome together with serving
telemetry (cache-hit flags, admission/retire timestamps).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

__all__ = ["SolveRequest", "SolveResponse"]


@dataclasses.dataclass
class SolveRequest:
    """One sparse linear system ``A x = b`` submitted to the service.

    ``indptr``/``indices``/``shape`` define the sparsity pattern (the setup
    cache key); ``values`` the per-request numerics; ``b`` the right-hand
    side.  Timestamps are ``time.perf_counter()`` seconds, filled in as the
    request moves through the pipeline.
    """

    indptr: np.ndarray
    indices: np.ndarray
    values: np.ndarray
    b: np.ndarray
    shape: Tuple[int, int]
    request_id: Optional[int] = None
    #: set by the submitter (the service or the caller) at enqueue time
    submitted_s: Optional[float] = None
    #: set by the engine when the request enters a batch slot
    admitted_s: Optional[float] = None

    @property
    def n(self) -> int:
        return int(self.shape[0])

    @property
    def nnz(self) -> int:
        return int(np.asarray(self.values).size)

    @classmethod
    def from_csr(cls, A, b, **kw) -> "SolveRequest":
        """Build from a single-system
        :class:`repro_torch.sparse.formats.Csr` (copied to the host)."""
        def host(t):
            return t.detach().cpu().numpy() if hasattr(t, "detach") else np.asarray(t)

        return cls(
            indptr=host(A.indptr),
            indices=host(A.indices),
            values=host(A.values),
            b=host(b),
            shape=tuple(A.shape),
            **kw,
        )


@dataclasses.dataclass
class SolveResponse:
    """Outcome of one served solve — the per-request slice of a batch."""

    request_id: int
    x: np.ndarray
    iterations: int
    residual_norm: float
    converged: bool
    #: True when the sparsity pattern's setup products were already cached
    pattern_hit: bool = False
    #: True when the inverted preconditioner factors for this exact value
    #: set were already cached (implies no values-tier generation either)
    factors_hit: bool = False
    #: end-to-end latency (submit -> retire), perf_counter seconds
    latency_s: Optional[float] = None
    retired_s: Optional[float] = None
