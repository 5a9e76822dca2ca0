"""Launch configuration — per-target kernel geometry, checked against shared memory.

Every CUDA kernel family registers a :class:`TuningSpec`: its parameters, how
to seed them from a :class:`HardwareParams`, how to clamp them to the target's
rules, and a model of the shared memory one block uses.  Bindings ask the
executor instead of hard-coding block sizes::

    cfg = executor.launch_config("spmv_ell", {"m": m, "k": k})
    spmv_ell(..., block_threads=cfg["block_threads"], subgroup=cfg["subgroup"])

``resolve`` takes an explicit per-``(op, target)`` table entry when one is
set, else the spec's seed; constrains it; and checks the block's shared
memory against ``smem_per_block_bytes``, raising if it does not fit.  The
autotune sweep that would fill the table is not ported yet.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Callable, Dict, Mapping, Optional, Tuple

from repro_torch.core.params import HardwareParams

__all__ = [
    "LaunchConfig",
    "TuningSpec",
    "register_spec",
    "get_spec",
    "resolve",
    "set_table_entry",
    "table_entry",
    "next_pow2",
    "prev_pow2",
]

Shapes = Mapping[str, int]
Block = Dict[str, int]


def next_pow2(n: int) -> int:
    """Smallest power of two >= n."""
    n = int(n)
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


def prev_pow2(n: int) -> int:
    """Largest power of two <= n."""
    n = int(n)
    return 1 if n <= 1 else 1 << (n.bit_length() - 1)


@dataclasses.dataclass(frozen=True)
class LaunchConfig:
    """Resolved launch geometry for one (op, target, shapes); ``source`` is
    ``"table"`` or ``"seed"``."""

    op: str
    target: str
    block: Mapping[str, int]
    smem_bytes: int
    source: str

    def __getitem__(self, key: str) -> int:
        return self.block[key]


def _no_smem(shapes: Shapes, block: Block) -> int:
    return 0


@dataclasses.dataclass(frozen=True)
class TuningSpec:
    """What the resolver knows about one kernel family.

    * ``seed(hw)`` — default geometry from the hardware table;
    * ``smem_bytes(shapes, block)`` — shared memory of one block;
    * ``constrain(hw, shapes, block)`` — clamp/align a proposed geometry.
    """

    op: str
    params: Tuple[str, ...]
    seed: Callable[[HardwareParams], Block]
    smem_bytes: Callable[[Shapes, Block], int] = _no_smem
    constrain: Optional[Callable[[HardwareParams, Shapes, Block], Block]] = None


_LOCK = threading.Lock()
_SPECS: Dict[str, TuningSpec] = {}
_TABLE: Dict[Tuple[str, str], Block] = {}


def register_spec(spec: TuningSpec) -> TuningSpec:
    with _LOCK:
        existing = _SPECS.get(spec.op)
        if existing is not None and existing is not spec:
            raise ValueError(f"tuning spec for {spec.op!r} already registered")
        _SPECS[spec.op] = spec
    return spec


def get_spec(op: str) -> TuningSpec:
    if op not in _SPECS:
        import repro_torch.kernels  # noqa: F401  (the families register here)
    try:
        return _SPECS[op]
    except KeyError:
        raise KeyError(
            f"no tuning spec registered for op {op!r}; known: {sorted(_SPECS)}"
        ) from None


def set_table_entry(op: str, target: str, block: Mapping[str, int]) -> None:
    """Pin an explicit geometry for (op, target)."""
    with _LOCK:
        _TABLE[(op, target)] = dict(block)


def table_entry(op: str, target: str) -> Optional[Block]:
    entry = _TABLE.get((op, target))
    return dict(entry) if entry is not None else None


def resolve(op: str, shapes: Shapes, hw: HardwareParams) -> LaunchConfig:
    """Table entry, else seed; constrained; checked against shared memory."""
    spec = get_spec(op)
    shapes = dict(shapes)
    override = _TABLE.get((op, hw.name))
    if override is not None and set(spec.params) <= set(override):
        block, source = dict(override), "table"
    else:
        block, source = spec.seed(hw), "seed"
    if spec.constrain is not None:
        block = spec.constrain(hw, shapes, block)
    smem = int(spec.smem_bytes(shapes, block))
    if smem > hw.smem_per_block_bytes:
        raise ValueError(
            f"{op}: geometry {block} needs {smem} bytes of shared memory, "
            f"{hw.name} gives a block {hw.smem_per_block_bytes}"
        )
    return LaunchConfig(op=op, target=hw.name, block=block, smem_bytes=smem,
                        source=source)
