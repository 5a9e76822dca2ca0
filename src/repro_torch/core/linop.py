"""The LinOp hierarchy — gko::LinOp for the port.

Every matrix format, preconditioner and solver is a :class:`LinOp` composing
through one ``apply``.  This module imports nothing from the format or kernel
layers, so every layer can build on it.

Executor threading (as in the JAX package): an ``executor=`` passed to
``apply`` overrides everything below it in the operator tree; otherwise an
operator's own ``executor`` attribute applies to its subtree; otherwise
dispatch falls to the ambient executor at the registry level.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

__all__ = [
    "LinOp",
    "Composition",
    "Sum",
    "ScaledIdentity",
    "MatrixFreeOp",
    "Identity",
    "Transpose",
    "as_linop",
]


class LinOp:
    """Base linear operator: subclasses give ``shape``, ``dtype`` and
    ``_apply(b, executor)``."""

    #: executor this operator prefers; ``None`` defers to the caller/ambient
    executor = None

    #: the distributed apply protocol (gko::experimental::distributed):
    #: operators whose rows are split over the ranks of a process group set
    #: this True and implement :meth:`local_operator`; the solvers then hand
    #: the whole solve to :func:`repro_torch.distributed.dist_solve`
    is_distributed = False

    def _apply(self, b: torch.Tensor, executor) -> torch.Tensor:
        raise NotImplementedError(
            f"{type(self).__name__} does not implement _apply"
        )

    def local_operator(self, executor=None) -> "LinOp":
        """This rank's operator on its padded local vectors (halo exchange
        and collectives inside).  Only meaningful when ``is_distributed``."""
        raise NotImplementedError(
            f"{type(self).__name__} is not a distributed operator "
            "(is_distributed is False)"
        )

    def apply(self, *args, executor=None) -> torch.Tensor:
        """``apply(b) -> A @ b`` or ``apply(alpha, b, beta, x) -> alpha*A@b + beta*x``."""
        ex = executor if executor is not None else self.executor
        if len(args) == 1:
            return self._apply(args[0], ex)
        if len(args) == 4:
            alpha, b, beta, x = args
            return alpha * self._apply(b, ex) + beta * x
        raise TypeError(
            f"apply takes (b) or (alpha, b, beta, x); got {len(args)} arguments"
        )

    def __call__(self, b: torch.Tensor) -> torch.Tensor:
        return self.apply(b)

    @property
    def storage_bytes(self) -> int:
        """Bytes of operator-owned generated storage (0 unless overridden)."""
        return 0


def _shape_of(op) -> Optional[Tuple[int, int]]:
    return getattr(op, "shape", None)


def _combined_dtype(ops):
    dtypes = [d for d in (getattr(o, "dtype", None) for o in ops) if d is not None]
    if not dtypes:
        return None
    out = dtypes[0]
    for d in dtypes[1:]:
        out = torch.promote_types(out, d)
    return out


def _child_apply(op, b, executor):
    if isinstance(op, LinOp):
        return op.apply(b, executor=executor)
    return op(b)  # a bare callable has no executor to thread


class Composition(LinOp):
    """``Composition(A, B, ...) v = A(B(... v))`` — gko::Composition."""

    def __init__(self, *ops, executor=None):
        if not ops:
            raise ValueError("Composition needs at least one operand")
        for left, right in zip(ops, ops[1:]):
            ls, rs = _shape_of(left), _shape_of(right)
            if ls is not None and rs is not None and ls[1] != rs[0]:
                raise ValueError(
                    f"composition shape mismatch: {ls} cannot follow {rs}"
                )
        self.ops = tuple(ops)
        self.executor = executor

    @property
    def shape(self) -> Tuple[int, int]:
        first, last = _shape_of(self.ops[0]), _shape_of(self.ops[-1])
        if first is None or last is None:
            raise AttributeError("composition over shapeless operands")
        return (first[0], last[1])

    @property
    def dtype(self):
        return _combined_dtype(self.ops)

    def _apply(self, b, executor):
        for op in reversed(self.ops):
            b = _child_apply(op, b, executor)
        return b


class Sum(LinOp):
    """``Sum(A, B, ...) v = A v + B v + ...`` — gko::Combination."""

    def __init__(self, *ops, executor=None):
        if not ops:
            raise ValueError("Sum needs at least one operand")
        shapes = [s for s in map(_shape_of, ops) if s is not None]
        if shapes and any(s != shapes[0] for s in shapes[1:]):
            raise ValueError(f"sum over mismatched shapes {shapes}")
        self.ops = tuple(ops)
        self.executor = executor

    @property
    def shape(self) -> Tuple[int, int]:
        for op in self.ops:
            s = _shape_of(op)
            if s is not None:
                return s
        raise AttributeError("sum over shapeless operands")

    @property
    def dtype(self):
        return _combined_dtype(self.ops)

    def _apply(self, b, executor):
        acc = _child_apply(self.ops[0], b, executor)
        for op in self.ops[1:]:
            acc = acc + _child_apply(op, b, executor)
        return acc


class ScaledIdentity(LinOp):
    """``sigma * I`` on an ``n``-vector — the shifted-system building block."""

    def __init__(self, scale, n: int, dtype=None, executor=None):
        self.scale = scale
        self.n = int(n)
        self._dtype = dtype
        self.executor = executor

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.n, self.n)

    @property
    def dtype(self):
        if self._dtype is not None:
            return self._dtype
        return torch.as_tensor(self.scale).dtype

    def _apply(self, b, executor):
        return torch.as_tensor(self.scale, dtype=b.dtype, device=b.device) * b


class Identity(LinOp):
    """The identity operator — also the identity preconditioner."""

    def __init__(self, n: Optional[int] = None, dtype=None):
        self.n = n
        self._dtype = dtype

    @property
    def shape(self) -> Optional[Tuple[int, int]]:
        return None if self.n is None else (self.n, self.n)

    @property
    def dtype(self):
        return self._dtype

    def _apply(self, b, executor):
        return b


class Transpose(LinOp):
    """Lazy transpose of an operator whose concrete type supports it.

    The wrapped operator must expose ``transpose()`` (every sparse format
    does, at setup time on the host); compositions and sums distribute over
    their operands.  Operators without a transpose (matrix-free, solvers)
    raise ``NotImplementedError`` — Ginkgo's ``Transposable`` contract.
    With no ``executor=`` the wrap inherits the wrapped operator's, so the
    forward and transposed applies dispatch in the same kernel space.
    """

    def __init__(self, op, executor=None):
        self.op = op
        self.executor = (
            executor if executor is not None else getattr(op, "executor", None)
        )
        self._t = _transpose(op)

    @property
    def shape(self) -> Tuple[int, int]:
        m, n = self.op.shape
        return (n, m)

    @property
    def dtype(self):
        return getattr(self.op, "dtype", None)

    def _apply(self, b, executor):
        return _child_apply(self._t, b, executor)


def _transpose(op):
    if isinstance(op, Transpose):
        return op.op
    if isinstance(op, (ScaledIdentity, Identity)):
        return op
    if isinstance(op, Composition):
        return Composition(
            *[Transpose(o) for o in reversed(op.ops)], executor=op.executor
        )
    if isinstance(op, Sum):
        return Sum(*[Transpose(o) for o in op.ops], executor=op.executor)
    t = getattr(op, "transpose", None)
    if callable(t):
        return t()
    raise NotImplementedError(
        f"{type(op).__name__} is not transposable (no transpose() support)"
    )


class MatrixFreeOp(LinOp):
    """A user-supplied ``v -> A v`` with declared shape/dtype."""

    def __init__(
        self,
        matvec: Callable[[torch.Tensor], torch.Tensor],
        shape: Optional[Tuple[int, int]] = None,
        dtype=None,
        executor=None,
    ):
        self.matvec = matvec
        self.shape = tuple(shape) if shape is not None else None
        self.dtype = dtype
        self.executor = executor

    def _apply(self, b, executor):
        return self.matvec(b)


def as_linop(A, *, shape=None, dtype=None, executor=None) -> LinOp:
    """LinOps pass through; bare callables wrap into :class:`MatrixFreeOp`."""
    if isinstance(A, LinOp):
        return A
    if callable(A):
        return MatrixFreeOp(A, shape=shape, dtype=dtype, executor=executor)
    raise TypeError(
        f"cannot interpret {type(A).__name__} as a linear operator; expected "
        "a LinOp or a callable v -> A @ v"
    )
