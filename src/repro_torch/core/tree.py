"""Trees of tensors: what ``jax.tree_util`` does for the JAX package.

The port's trees are a :class:`~repro_torch.nn.common.ParamTree` (and its
``nn.ModuleList`` layer lists), mappings, lists and tuples, and dataclasses
(``AdamWState``, ``KVCache``); anything else is a leaf.  A leaf's path is
the tuple of keys that reaches it (mapping keys, list indices, dataclass
field names), in the tree's own order; :func:`flat` joins them with ``/``,
the key the checkpoint files use.

:func:`tree_map` rebuilds the tree's kind: a ``ParamTree`` maps to a
``ParamTree`` (frozen leaves) when every mapped leaf is a tensor, else to
nested dicts and lists, as a list of layers does.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Iterator, List, Mapping, Tuple

import torch
from torch import nn

__all__ = ["items", "leaves", "flat", "tree_map", "tree_map_with_path",
           "zeros_like_tree"]

Path = Tuple[str, ...]


def _children(node, is_leaf=None) -> Tuple[str, Any, List[Tuple[str, Any]]]:
    """(kind, node, [(key, child), ...]) of an inner node; kind "leaf" for a
    leaf (and for whatever ``is_leaf`` accepts)."""
    from repro_torch.nn.common import ParamTree

    if is_leaf is not None and is_leaf(node):
        return "leaf", node, []
    if isinstance(node, ParamTree):
        return "params", node, list(node.items())
    if isinstance(node, nn.ModuleList):
        return "list", node, [(str(i), c) for i, c in enumerate(node)]
    if isinstance(node, Mapping):
        return "dict", node, [(str(k), v) for k, v in node.items()]
    if isinstance(node, list):
        return "list", node, [(str(i), c) for i, c in enumerate(node)]
    if isinstance(node, tuple) and not hasattr(node, "_fields"):
        return "tuple", node, [(str(i), c) for i, c in enumerate(node)]
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return "dataclass", node, [(f.name, getattr(node, f.name))
                                   for f in dataclasses.fields(node)]
    return "leaf", node, []


def items(tree, prefix: Path = (), *, is_leaf=None) -> Iterator[Tuple[Path, Any]]:
    """(path, leaf) pairs in the tree's order."""
    kind, _, children = _children(tree, is_leaf)
    if kind == "leaf":
        yield prefix, tree
        return
    for key, child in children:
        yield from items(child, prefix + (key,), is_leaf=is_leaf)


def leaves(tree, *, is_leaf=None) -> List[Any]:
    return [leaf for _, leaf in items(tree, is_leaf=is_leaf)]


def flat(tree, sep: str = "/", *, is_leaf=None) -> Dict[str, Any]:
    """{"blocks/0/attn/wq": leaf, ...}: the leaves keyed by joined path."""
    return {sep.join(path): leaf
            for path, leaf in items(tree, is_leaf=is_leaf)}


def tree_map_with_path(fn: Callable, tree, *rest, is_leaf=None,
                       _prefix: Path = ()):
    """``fn(path, leaf, *others)`` over ``tree``'s leaves, the ``rest`` trees
    walked alongside (their structure must match ``tree``'s; their nodes at
    ``tree``'s leaves are passed whole)."""
    from repro_torch.nn.common import ParamTree

    kind, node, children = _children(tree, is_leaf)
    if kind == "leaf":
        return fn(_prefix, tree, *rest)
    others = [dict(_children(r)[2]) for r in rest]
    out = []
    for key, child in children:
        try:
            sub = [o[key] for o in others]
        except KeyError:
            raise ValueError(f"trees differ at {'/'.join(_prefix + (key,))}")
        out.append((key, tree_map_with_path(fn, child, *sub, is_leaf=is_leaf,
                                            _prefix=_prefix + (key,))))
    if kind == "params":
        mapped = dict(out)
        if all(isinstance(v, torch.Tensor) for _, v in items(mapped)):
            return ParamTree(mapped)
        return mapped
    if kind == "dict":
        return {k: v for k, v in out}
    if kind == "list":
        return [v for _, v in out]
    if kind == "tuple":
        return tuple(v for _, v in out)
    return type(node)(**dict(out))


def tree_map(fn: Callable, tree, *rest, is_leaf=None):
    """``fn(leaf, *others)`` over the leaves; the same tree kind out."""
    return tree_map_with_path(lambda _p, leaf, *o: fn(leaf, *o), tree, *rest,
                              is_leaf=is_leaf)


def zeros_like_tree(tree, dtype: torch.dtype = torch.float32):
    """Zeros of every leaf's shape in ``dtype`` on the leaf's device."""
    return tree_map(lambda t: torch.zeros(t.shape, dtype=dtype,
                                          device=t.device), tree)
