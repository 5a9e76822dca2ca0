"""Padded-shard reduction hygiene and the logical-axis sharding rules: the
port of ``repro/distributed/sharding.py``.

Distributed vectors are padded to one per-rank length (``Lmax``); the padding
slots must stay out of every cross-rank reduction, or a ragged partition
counts whatever sits in them (the padded-shard bug).  The distributed BLAS
(:func:`repro_torch.sparse.ops.distributed_blas`) passes every reduction
operand through :func:`zero_shard_padding`, so a reduction is right even
when a padding slot holds garbage.

The training half maps logical axes (``model_axes`` / ``cache_axes`` of
``repro_torch.models.lm``) onto mesh axes, rule for rule as the JAX package:

* tensor-parallel (the ``"model"`` axis): experts, mlp hidden, heads, kv
  heads, the kv sequence, vocab — the first annotated dim that divides
  evenly, in that priority;
* data-parallel: a ``"batch"`` dim shards over ``("pod", "data")``;
* ZeRO-1 (moments) and FSDP (``zero="fsdp"``, parameters): one more large
  dim over the data axes.

A spec is a tuple with one entry a dimension: a mesh-axis name, a tuple of
them, or None (what ``PartitionSpec`` holds); ``()`` is replicated.  The
rules read only ``mesh.shape``.  :func:`shard_local` cuts a rank's shard of
a tensor by its spec, which is what ``device_put`` does for each process.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import tree as tree_lib

__all__ = ["axis_size", "shard_pad_mask", "zero_shard_padding", "MODEL_AXES",
           "ZERO_AXES", "data_axes", "spec_for_leaf", "param_shardings",
           "moment_shardings", "cache_shardings", "batch_spec",
           "batch_shardings", "replicated", "tree_replicated", "shard_local"]

# logical axes eligible for the tensor-parallel mesh axis, in priority order;
# "kv_seq" is the sequence-parallel fallback for KV caches whose head count
# does not divide the model axis (e.g. granite kv=8 on a 16-wide axis)
MODEL_AXES = ("expert", "mlp", "heads", "kv_heads", "kv_seq", "vocab")
# logical axes eligible for ZeRO sharding of moments / FSDP of params
ZERO_AXES = ("embed", "expert_mlp", "mlp", "heads", "vocab")

Spec = Tuple


def axis_size(group=None) -> int:
    """Ranks of ``group`` (the default group when None): the counterpart of
    ``jax.lax.axis_size`` over the data axis.  1 without a process group."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        return 1
    return dist.get_world_size(group)


def shard_pad_mask(part_sizes: Sequence[int], max_size: int) -> np.ndarray:
    """(P, max_size) bool mask — True on real slots, False on padding."""
    sizes = np.asarray(part_sizes, np.int64)
    if max_size < (int(sizes.max()) if sizes.size else 0):
        raise ValueError(
            f"max_size {max_size} smaller than largest part {sizes.max()}"
        )
    return np.arange(max_size, dtype=np.int64)[None, :] < sizes[:, None]


def zero_shard_padding(x: torch.Tensor,
                       mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Zero the padding slots of a padded shard; ``mask`` is this rank's row
    of :func:`shard_pad_mask` as a bool tensor, ``None`` for a shard without
    padding (``x`` is returned as it is)."""
    if mask is None:
        return x
    return torch.where(mask, x, torch.zeros((), dtype=x.dtype, device=x.device))


# -- the training half: logical axes -> mesh axes ----------------------------------


def _is_axes_leaf(x) -> bool:
    return x is None or (
        isinstance(x, tuple) and all(e is None or isinstance(e, str) for e in x))


def _mesh_axis_size(mesh, names) -> int:
    if isinstance(names, str):
        names = (names,)
    size = 1
    for n in names:
        size *= mesh.shape[n]
    return size


def data_axes(mesh) -> Tuple[str, ...]:
    """The data-parallel mesh axes ("pod", "data") or ("data",)."""
    return tuple(n for n in ("pod", "data") if n in mesh.shape)


def spec_for_leaf(shape: Sequence[int], axes, mesh, *,
                  zero: str = "none") -> Spec:
    """The spec of one leaf of ``shape`` with logical ``axes``; ``zero`` is
    "none" | "zero1" | "fsdp"."""
    if axes is None:
        return ()
    if len(axes) != len(shape):
        raise ValueError(f"axes {axes} rank != shape {tuple(shape)}")
    assign: list = [None] * len(shape)

    daxes = data_axes(mesh)
    dsize = _mesh_axis_size(mesh, daxes) if daxes else 1
    model_size = mesh.shape.get("model", 1)
    model_used = False
    data_used = False

    # 0) batch dims -> data axes
    for i, ax in enumerate(axes):
        if ax == "batch" and dsize > 1 and shape[i] % dsize == 0:
            assign[i] = daxes if len(daxes) > 1 else daxes[0]
            data_used = True
            break

    # 1) tensor parallel: highest-priority eligible divisible dim
    if model_size > 1:
        for logical in MODEL_AXES:
            if model_used:
                break
            for i, ax in enumerate(axes):
                if ax == logical and assign[i] is None and shape[i] % model_size == 0:
                    assign[i] = "model"
                    model_used = True
                    break

    # 2) ZeRO / FSDP: shard one more big dim over the data axes
    if zero in ("zero1", "fsdp") and dsize > 1 and not data_used:
        for logical in ZERO_AXES:
            placed = False
            for i, ax in enumerate(axes):
                if ax == logical and assign[i] is None and shape[i] % dsize == 0:
                    assign[i] = daxes if len(daxes) > 1 else daxes[0]
                    placed = True
                    break
            if placed:
                break
    return tuple(assign)


def _walk(mesh, shapes, axes_tree, *, zero: str):
    """Specs for a tree of tensors (or anything with ``.shape``) beside its
    axes tree."""
    return tree_lib.tree_map(
        lambda a, t: spec_for_leaf(tuple(t.shape), a, mesh, zero=zero),
        axes_tree, shapes, is_leaf=_is_axes_leaf)


def param_shardings(mesh, shapes, axes_tree, *, zero: str = "none"):
    """``shapes``: the parameter tree (``init_model(cfg, device="meta")``);
    ``axes_tree``: ``model_axes(cfg)``."""
    return _walk(mesh, shapes, axes_tree, zero=zero)


def moment_shardings(mesh, shapes, axes_tree, *, zero: str = "zero1"):
    """Optimizer-moment specs (ZeRO-1 by default)."""
    return _walk(mesh, shapes, axes_tree, zero=zero)


def cache_shardings(mesh, shapes, axes_tree):
    return _walk(mesh, shapes, axes_tree, zero="none")


def batch_spec(mesh, batch_size: int, extra_dims: int = 1) -> Spec:
    """Shard the leading batch dim over as many data axes as divide it."""
    daxes = data_axes(mesh)
    full = _mesh_axis_size(mesh, daxes) if daxes else 1
    if daxes and full > 1 and batch_size % full == 0:
        lead = daxes if len(daxes) > 1 else daxes[0]
        return (lead,) + (None,) * extra_dims
    if ("data" in mesh.shape and mesh.shape["data"] > 1
            and batch_size % mesh.shape["data"] == 0):
        return ("data",) + (None,) * extra_dims
    return (None,) * (extra_dims + 1)


def batch_shardings(mesh, batch: Mapping) -> Dict:
    """Specs for a data batch ({tokens | embeds, labels})."""
    return {k: batch_spec(mesh, v.shape[0], len(v.shape) - 1)
            for k, v in batch.items()}


def replicated(mesh) -> Spec:
    del mesh
    return ()


def tree_replicated(mesh, tree):
    return tree_lib.tree_map(lambda _: replicated(mesh), tree)


def shard_local(t: torch.Tensor, spec: Spec, mesh,
                coords: Optional[Mapping[str, int]] = None) -> torch.Tensor:
    """The block of ``t`` that the rank at ``coords`` (this rank's when None)
    holds under ``spec``: each dimension named by mesh axes is cut into
    their size's equal parts and the rank's part (row-major over a tuple
    of axes) kept; a view."""
    coords = dict(mesh.coords if coords is None else coords)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        names = (entry,) if isinstance(entry, str) else tuple(entry)
        parts, idx = 1, 0
        for n in names:
            parts *= mesh.shape[n]
            idx = idx * mesh.shape[n] + coords[n]
        if t.shape[dim] % parts:
            raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split "
                             f"into {parts} parts")
        n = t.shape[dim] // parts
        t = t.narrow(dim, idx * n, n)
    return t
