"""Convergence history: a fixed-capacity residual-norm ring buffer on the device.

The scheme of the JAX package, kept so ``SolveResult.history`` means the same
thing in both:

* ``cap = capacity(history, stop)`` maps ``history=`` (``None``/``False`` -> 0,
  ``True`` -> ``stop.max_iters``, ``int`` -> that many slots) to a size;
* ``hist = init(cap, ...)`` is a NaN-filled ``(cap,)`` tensor;
* ``push(hist, k, rnorm)`` writes slot ``k % cap`` in place (no host read:
  ``k`` is a Python int and ``rnorm`` stays on the device); a no-op at cap 0;
* ``finalize(hist)`` maps the size-0 buffer to ``None``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

__all__ = ["capacity", "init", "push", "finalize", "trim"]


def capacity(history, stop) -> int:
    """Buffer size for a ``history=`` option against a Stop rule."""
    if history is None or history is False:
        return 0
    if history is True:
        return int(stop.max_iters)
    cap = int(history)
    if cap < 0:
        raise ValueError(f"history capacity must be >= 0, got {cap}")
    return cap


def init(cap: int, *, dtype=torch.float32, device=None) -> torch.Tensor:
    """NaN-filled ``(cap,)`` ring buffer."""
    return torch.full((cap,), float("nan"), dtype=dtype, device=device)


def push(hist: torch.Tensor, k: int, value) -> torch.Tensor:
    """Record ``value`` at iteration ``k`` (in place); no-op when disabled."""
    cap = hist.shape[0]
    if cap:
        hist[k % cap] = value
    return hist


def finalize(hist: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """Ring buffer -> ``SolveResult.history`` (``None`` when disabled)."""
    if hist is None or hist.shape[0] == 0:
        return None
    return hist


def trim(history, iterations: Optional[int] = None):
    """Drop unfilled (NaN) slots; returns a host numpy array."""
    if history is None:
        return None
    h = history.detach().cpu().numpy()
    if iterations is not None:
        return h[: min(int(iterations), h.shape[0])]
    return h[~np.isnan(h)]
