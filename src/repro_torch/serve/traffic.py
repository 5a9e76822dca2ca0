"""Synthetic solve traffic: Poisson arrivals over a pattern gallery.

Models the workload the setup cache exists for — a service receiving many
small systems where sparsity patterns recur heavily (device simulation
batches, time-stepping with fixed meshes): exponential inter-arrival gaps at
``rate_hz``, patterns drawn from a gallery of ``gallery_size`` distinct SPD
stencils, and ``repeat_ratio`` controlling how often a request reuses a
previously issued (pattern, values) pair — with a fresh right-hand side, so
repeats are real solves, not memoizable no-ops.

A copy of the JAX package's generator: the same numpy draws in the same
order, so one config gives both packages the same arrays.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from repro_torch.serve.request import SolveRequest
from repro_torch.sparse.gallery import (
    BANDED_OFFSETS,
    convection_diffusion_2d,
    spd_banded,
)

__all__ = ["TrafficConfig", "pattern_gallery", "nonsym_gallery", "generate_traffic"]


@dataclasses.dataclass(frozen=True)
class TrafficConfig:
    num_requests: int = 64
    rate_hz: float = 500.0
    gallery_size: int = 4
    #: probability a request reuses a previously issued (pattern, values)
    #: pair — these hit both cache tiers; non-repeats draw a gallery pattern
    #: with fresh values (pattern-tier hit once the pattern has been seen)
    repeat_ratio: float = 0.6
    n: int = 24
    seed: int = 0
    #: probability a non-repeat request draws a nonsymmetric convection-
    #: diffusion pattern instead of an SPD stencil; requires ``n`` to be a
    #: perfect square and an engine solver that tolerates nonsymmetric A
    #: (``ServeConfig(solver="bicgstab")``)
    nonsym_ratio: float = 0.0


def pattern_gallery(cfg: TrafficConfig):
    """``gallery_size`` distinct (indptr, indices) patterns with a values
    generator per pattern (draws of
    :func:`repro_torch.sparse.gallery.spd_banded`).
    """
    if cfg.gallery_size > len(BANDED_OFFSETS):
        raise ValueError(
            f"gallery_size {cfg.gallery_size} exceeds the "
            f"{len(BANDED_OFFSETS)} available distinct stencils"
        )
    rng = np.random.default_rng(cfg.seed)
    gallery = []
    for g in range(cfg.gallery_size):
        offsets = BANDED_OFFSETS[g]
        shift = 3.0 + g

        def make_values(offsets=offsets, shift=shift):
            return spd_banded(cfg.n, offsets, shift, rng)[:3]

        indptr, indices, _, _ = spd_banded(cfg.n, offsets, shift,
                                           np.random.default_rng(0))
        gallery.append((indptr, indices, make_values))
    return gallery


def nonsym_gallery(cfg: TrafficConfig):
    """Nonsymmetric convection-diffusion patterns (one per Péclet regime).

    Fresh values multiply the stencil by a small random field, so repeats of
    a pattern still exercise the values-tier cache miss path.
    """
    side = int(round(cfg.n ** 0.5))
    if side * side != cfg.n:
        raise ValueError(
            f"nonsym traffic needs a square grid: n={cfg.n} is not a square"
        )
    rng = np.random.default_rng(cfg.seed + 17)
    gallery = []
    for peclet in (0.5, 5.0):
        indptr, indices, base, _ = convection_diffusion_2d(side, peclet=peclet)

        def make_values(base=base):
            return base * (1.0 + 0.05 * rng.random(len(base))).astype(np.float32)

        gallery.append((indptr, indices, make_values))
    return gallery


def generate_traffic(
    cfg: TrafficConfig,
) -> List[Tuple[float, SolveRequest]]:
    """``[(inter_arrival_gap_s, request), ...]`` — a Poisson request stream.

    Deterministic for a given seed.  Right-hand sides are always fresh;
    matrices repeat according to ``repeat_ratio``.
    """
    rng = np.random.default_rng(cfg.seed + 1)
    gallery = pattern_gallery(cfg)
    ns_gallery = nonsym_gallery(cfg) if cfg.nonsym_ratio > 0.0 else []
    seen: List[Tuple[np.ndarray, np.ndarray, np.ndarray]] = []
    out: List[Tuple[float, SolveRequest]] = []
    for _ in range(cfg.num_requests):
        gap = float(rng.exponential(1.0 / cfg.rate_hz))
        if seen and rng.random() < cfg.repeat_ratio:
            indptr, indices, values = seen[rng.integers(len(seen))]
        else:
            if ns_gallery and rng.random() < cfg.nonsym_ratio:
                g = int(rng.integers(len(ns_gallery)))
                indptr, indices = ns_gallery[g][0], ns_gallery[g][1]
                values = ns_gallery[g][2]()
            else:
                g = int(rng.integers(len(gallery)))
                indptr, indices = gallery[g][0], gallery[g][1]
                _, _, values = gallery[g][2]()
            seen.append((indptr, indices, values))
        b = rng.normal(size=cfg.n).astype(np.float32)
        out.append((gap, SolveRequest(
            indptr=indptr, indices=indices, values=values, b=b,
            shape=(cfg.n, cfg.n),
        )))
    return out
