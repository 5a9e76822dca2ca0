"""repro_torch.serve — persistent solve service (the library meets traffic).

A long-running service that gathers many small incoming systems into batched
masked-Krylov launches with **continuous batching** (new systems are
admitted into slots as converged ones retire —
:mod:`repro_torch.serve.engine`), backed by a **pattern-keyed setup cache**
on Ginkgo's generate/apply split (:mod:`repro_torch.serve.cache`):
generation (block discovery, slot tables, block-Jacobi inversion, the
lane's closures) is keyed by the sparsity pattern's hash, so a repeated
pattern pays only for its values and a repeated matrix for neither.

:mod:`repro_torch.serve.service` runs the engine on a worker thread behind a
request queue; :mod:`repro_torch.serve.traffic` generates synthetic Poisson
traffic over a pattern gallery.
"""

from repro_torch.serve.cache import (
    PatternSetup,
    SetupCache,
    pattern_key,
    values_fingerprint,
)
from repro_torch.serve.engine import ContinuousBatchEngine, PatternLane, ServeConfig
from repro_torch.serve.request import SolveRequest, SolveResponse
from repro_torch.serve.service import SolveService
from repro_torch.serve.traffic import TrafficConfig, generate_traffic, pattern_gallery

__all__ = [
    "ContinuousBatchEngine",
    "PatternLane",
    "PatternSetup",
    "ServeConfig",
    "SetupCache",
    "SolveRequest",
    "SolveResponse",
    "SolveService",
    "TrafficConfig",
    "generate_traffic",
    "pattern_gallery",
    "pattern_key",
    "values_fingerprint",
]
