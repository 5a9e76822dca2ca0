"""Launch configuration — per-target kernel geometry, checked against shared memory.

Every CUDA kernel family registers a :class:`TuningSpec`: its parameters, how
to seed them from a :class:`HardwareParams`, how to clamp them to the target's
rules, and a model of the shared memory one block uses.  Bindings ask the
executor instead of hard-coding block sizes::

    cfg = executor.launch_config("spmv_ell", {"m": m, "k": k})
    spmv_ell(..., block_threads=cfg["block_threads"], subgroup=cfg["subgroup"])

``resolve`` takes, in this order, the shape-bucketed **autotune cache**
entry (a measured winner for ``(op, target, bucket_shapes(shapes))``), the
explicit per-``(op, target)`` **table** entry, or the spec's **seed**; an
entry that lacks one of the spec's parameters is skipped.  It then
constrains the geometry and checks the block's shared memory against
``smem_per_block_bytes``, raising if it does not fit: no entry is shrunk or
re-dispatched to another space.

The autotune cache persists as JSON, ``{"version": 1, "entries": [{"op",
"target", "bucket", "block"}, ...]}`` (:func:`save_table`,
:func:`load_table`), the JAX package's schema.  A table named by the
environment variable ``REPRO_TORCH_TUNING_PATH`` is loaded at the first
``resolve``.  The port reads its own variable, never the JAX package's
``REPRO_TUNING_PATH``, whose tables hold TPU geometries.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import warnings
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

from repro_torch.core.params import TARGETS, HardwareParams

__all__ = [
    "LaunchConfig",
    "TuningSpec",
    "TUNING_PATH_ENV",
    "register_spec",
    "get_spec",
    "all_specs",
    "resolve",
    "set_table_entry",
    "table_entry",
    "default_table",
    "record_autotuned",
    "autotune_entries",
    "clear_autotune_cache",
    "save_table",
    "load_table",
    "bucket_shapes",
    "next_pow2",
    "prev_pow2",
]

Shapes = Mapping[str, int]
Block = Dict[str, int]

#: environment variable naming a persisted tuning table (JSON) to preload
TUNING_PATH_ENV = "REPRO_TORCH_TUNING_PATH"


def next_pow2(n: int) -> int:
    """Smallest power of two >= n."""
    n = int(n)
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


def prev_pow2(n: int) -> int:
    """Largest power of two <= n."""
    n = int(n)
    return 1 if n <= 1 else 1 << (n.bit_length() - 1)


def bucket_shapes(shapes: Shapes) -> Tuple[Tuple[str, int], ...]:
    """Canonical shape bucket: sizes rounded up to powers of two, except
    ``itemsize``, kept exact (4 against 8 bytes is a real boundary)."""
    return tuple(sorted(
        (k, int(v) if k == "itemsize" else next_pow2(v))
        for k, v in shapes.items()
    ))


@dataclasses.dataclass(frozen=True)
class LaunchConfig:
    """Resolved launch geometry for one (op, target, shapes); ``source`` is
    ``"autotuned"``, ``"table"`` or ``"seed"``."""

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
#: explicit per-(op, target) geometry
_TABLE: Dict[Tuple[str, str], Block] = {}
#: measured winners: (op, target, bucket) -> block
_AUTOTUNED: Dict[Tuple[str, str, Tuple[Tuple[str, int], ...]], Block] = {}
_ENV_LOADED = False


def register_spec(spec: TuningSpec) -> TuningSpec:
    with _LOCK:
        existing = _SPECS.get(spec.op)
        if existing is not None and existing is not spec:
            raise ValueError(f"tuning spec for {spec.op!r} already registered")
        _SPECS[spec.op] = spec
    return spec


def _ensure_specs_loaded() -> None:
    import repro_torch.kernels  # noqa: F401  (the families register here)


def get_spec(op: str) -> TuningSpec:
    if op not in _SPECS:
        _ensure_specs_loaded()
    try:
        return _SPECS[op]
    except KeyError:
        raise KeyError(
            f"no tuning spec registered for op {op!r}; known: {sorted(_SPECS)}"
        ) from None


def all_specs() -> Dict[str, TuningSpec]:
    _ensure_specs_loaded()
    return dict(_SPECS)


# -- tables -------------------------------------------------------------------


def set_table_entry(op: str, target: str, block: Mapping[str, int]) -> None:
    """Pin an explicit geometry for (op, target)."""
    with _LOCK:
        _TABLE[(op, target)] = dict(block)


def table_entry(op: str, target: str) -> Optional[Block]:
    entry = _TABLE.get((op, target))
    return dict(entry) if entry is not None else None


def default_table() -> Dict[Tuple[str, str], Block]:
    """Every registered op x every known target: the table entry where one is
    set, else the seed — the starting point of a new target's table."""
    out: Dict[Tuple[str, str], Block] = {}
    for op, spec in all_specs().items():
        for name, hw in TARGETS.items():
            entry = _TABLE.get((op, name))
            out[(op, name)] = dict(entry) if entry is not None else spec.seed(hw)
    return out


# -- autotune cache -----------------------------------------------------------


def record_autotuned(op: str, target: str, shapes: Shapes,
                     block: Mapping[str, int]) -> None:
    """Store a measured winner for (op, target, bucket_shapes(shapes))."""
    with _LOCK:
        _AUTOTUNED[(op, target, bucket_shapes(shapes))] = dict(block)


def autotune_entries() -> List[Dict[str, Any]]:
    """The cache as JSON-ready records (the persistence format)."""
    with _LOCK:
        return [
            {"op": op, "target": target, "bucket": [list(kv) for kv in bucket],
             "block": dict(block)}
            for (op, target, bucket), block in sorted(_AUTOTUNED.items())
        ]


def clear_autotune_cache() -> None:
    with _LOCK:
        _AUTOTUNED.clear()


def save_table(path: str, *, target: Optional[str] = None) -> int:
    """Write the autotune cache (one target's entries, with ``target``) as
    JSON; returns the number of entries written."""
    entries = [e for e in autotune_entries()
               if target is None or e["target"] == target]
    dirname = os.path.dirname(os.path.abspath(path))
    os.makedirs(dirname, exist_ok=True)
    with open(path, "w") as f:
        json.dump({"version": 1, "entries": entries}, f, indent=2,
                  sort_keys=True)
        f.write("\n")
    return len(entries)


def load_table(path: str) -> int:
    """Load a persisted table into the autotune cache; returns its size."""
    with open(path) as f:
        payload = json.load(f)
    entries = payload.get("entries", [])
    with _LOCK:
        for e in entries:
            bucket = tuple((str(k), int(v)) for k, v in e["bucket"])
            _AUTOTUNED[(e["op"], e["target"], bucket)] = {
                k: int(v) for k, v in e["block"].items()}
    return len(entries)


def _maybe_load_env_table() -> None:
    global _ENV_LOADED
    if _ENV_LOADED:
        return
    _ENV_LOADED = True
    path = os.environ.get(TUNING_PATH_ENV)
    if path and os.path.exists(path):
        try:
            load_table(path)
        except (OSError, ValueError, KeyError, TypeError) as e:
            # an unreadable file leaves the tables and seeds in force
            warnings.warn(f"ignoring unreadable tuning table {path!r} "
                          f"({TUNING_PATH_ENV}): {e}")


# -- resolution ---------------------------------------------------------------


def _usable(spec: TuningSpec, block: Optional[Block]) -> bool:
    """An entry missing one of the spec's parameters is ignored."""
    return block is not None and set(spec.params) <= set(block)


def resolve(op: str, shapes: Shapes, hw: HardwareParams) -> LaunchConfig:
    """Autotuned entry, else table entry, else seed; constrained; checked
    against shared memory."""
    _maybe_load_env_table()
    spec = get_spec(op)
    shapes = dict(shapes)
    tuned = _AUTOTUNED.get((op, hw.name, bucket_shapes(shapes)))
    override = _TABLE.get((op, hw.name))
    if _usable(spec, tuned):
        block, source = dict(tuned), "autotuned"
    elif _usable(spec, override):
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
