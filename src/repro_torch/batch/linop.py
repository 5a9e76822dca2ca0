"""BatchLinOp — the batched face of the LinOp hierarchy.

gko::batch::BatchLinOp: one operator whose apply maps a whole batch
``X (nb, n)`` at once, every system independent.  ``shape`` stays the
per-system ``(m, n)`` and ``num_batch`` reports the batch extent where one is
known.  The core combinators' apply is already shape-agnostic (compose right
to left, sum termwise, scale elementwise), so the batch variants inherit it
and add the type marker the batched solvers accept.
"""

from __future__ import annotations

from typing import Optional

from repro_torch.core.linop import (
    Composition,
    Identity,
    LinOp,
    MatrixFreeOp,
    ScaledIdentity,
    Sum,
)

__all__ = [
    "BatchLinOp",
    "BatchComposition",
    "BatchSum",
    "BatchScaledIdentity",
    "BatchMatrixFreeOp",
    "BatchIdentity",
]


class BatchLinOp(LinOp):
    """Marker and interface base: ``apply(X)`` takes and returns ``(nb, n)``
    batches; ``shape`` is the per-system ``(m, n)``."""

    @property
    def num_batch(self) -> Optional[int]:
        return None


def _first_num_batch(ops) -> Optional[int]:
    for op in ops:
        nb = getattr(op, "num_batch", None)
        if nb is not None:
            return nb
    return None


class BatchComposition(Composition, BatchLinOp):
    """``(A o B o ...) X`` applied right to left, per system."""

    @property
    def num_batch(self) -> Optional[int]:
        return _first_num_batch(self.ops)


class BatchSum(Sum, BatchLinOp):
    """``(A + B + ...) X`` termwise, per system."""

    @property
    def num_batch(self) -> Optional[int]:
        return _first_num_batch(self.ops)


class BatchScaledIdentity(ScaledIdentity, BatchLinOp):
    """``sigma * I`` on every system."""


class BatchMatrixFreeOp(MatrixFreeOp, BatchLinOp):
    """A user-supplied batched apply ``X (nb, n) -> Y (nb, m)``."""

    def __init__(self, matvec, shape=None, dtype=None, num_batch=None,
                 executor=None):
        super().__init__(matvec, shape=shape, dtype=dtype, executor=executor)
        self._num_batch = num_batch

    @property
    def num_batch(self) -> Optional[int]:
        return self._num_batch


class BatchIdentity(Identity, BatchLinOp):
    """The batched identity — also the batched identity preconditioner
    (``storage_bytes == 0``)."""
