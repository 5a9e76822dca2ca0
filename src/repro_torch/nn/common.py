"""Parameter trees and the init rules of the JAX package's ``ParamBuilder``.

The JAX package keeps parameters as nested dicts of arrays.  The port keeps
the same tree as an ``nn.Module``: :class:`ParamTree` holds each leaf as a
(frozen) ``nn.Parameter`` and each sub-tree as a child module, and is read
like the dict (``p["attn"]["wq"]``), so the layer code mirrors the JAX
package's line for line, and ``.parameters()``, ``.to()`` and
``state_dict()`` work as for any module.  A list of layers is an
``nn.ModuleList`` — what ``lax.scan`` walked as a stacked axis.

The init rules are the JAX package's (``repro/nn/common.py``): a truncated
normal at +-2 sigma scaled by ``std``, zeros and ones, drawn from an explicit
``torch.Generator`` on the target device.  The numbers differ from JAX's
for the same seed; the distributions do not.  Each ``param`` call names its
leaf's logical axes as the JAX package's ``ParamBuilder.param`` does
(``("embed", "mlp")``); :class:`AxesRecorder` runs the same init code and
returns those annotations in place of tensors, which is how the sharding
rules (``repro_torch.distributed.sharding``) see the tree.

A :class:`ParamTree`'s leaves are frozen when it is built, so serving
records no autograd graph; training makes them trainable with
:func:`trainable` (``requires_grad_``).
"""

from __future__ import annotations

from typing import Any, Iterator, Mapping, Optional, Sequence, Tuple

import torch
from torch import nn

__all__ = ["ParamTree", "Initializer", "AxesRecorder", "trainable",
           "truncated_normal", "zeros", "ones"]


class ParamTree(nn.Module):
    """A nested mapping of frozen tensors, read like the JAX package's dicts.

    ``tree`` maps names to tensors, mappings (sub-trees) or sequences of
    mappings (a layer list, an ``nn.ModuleList``)."""

    def __init__(self, tree: Mapping[str, Any]):
        super().__init__()
        self._keys = []
        for name, value in tree.items():
            if isinstance(value, torch.Tensor):
                self.register_parameter(
                    name, nn.Parameter(value, requires_grad=False))
            else:
                self.add_module(name, _as_tree(value))
            self._keys.append(name)

    def __getitem__(self, name: str):
        if name not in self._keys:
            raise KeyError(name)
        return getattr(self, name)

    def __contains__(self, name: object) -> bool:
        return name in self._keys

    def keys(self):
        return list(self._keys)

    def items(self) -> Iterator[Tuple[str, Any]]:
        return ((k, getattr(self, k)) for k in self._keys)


def _as_tree(v):
    if isinstance(v, nn.Module):  # a ParamTree or layer list already built
        return v
    if isinstance(v, Mapping):
        return ParamTree(v)
    if isinstance(v, Sequence) and not isinstance(v, str):
        return nn.ModuleList(_as_tree(x) for x in v)
    raise TypeError(f"a parameter tree holds tensors, mappings and lists, not "
                    f"{type(v).__name__}")


# -- init rules ---------------------------------------------------------------------


def truncated_normal(gen: torch.Generator, shape, std: float, dtype,
                     device) -> torch.Tensor:
    """std * (a standard normal truncated to [-2, 2]), drawn in f32."""
    t = torch.empty(shape, dtype=torch.float32, device=device)
    nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return t.mul_(std).to(dtype)


def zeros(gen, shape, std, dtype, device) -> torch.Tensor:
    del gen, std
    return torch.zeros(shape, dtype=dtype, device=device)


def ones(gen, shape, std, dtype, device) -> torch.Tensor:
    del gen, std
    return torch.ones(shape, dtype=dtype, device=device)


class Initializer:
    """What ``ParamBuilder`` does, without keys: ``param`` draws one tensor
    with the JAX package's default std 0.02 and rule, from one generator."""

    def __init__(self, gen: torch.Generator, dtype: torch.dtype, device):
        self.gen = gen
        self.dtype = dtype
        self.device = torch.device(device)

    def param(self, shape, axes: Optional[Tuple[Optional[str], ...]] = None,
              *, std: Optional[float] = None, init=truncated_normal,
              dtype: Optional[torch.dtype] = None):
        del axes  # read by AxesRecorder
        return init(self.gen, tuple(shape), 0.02 if std is None else std,
                    dtype or self.dtype, self.device)


class AxesRecorder(Initializer):
    """The init code's logical-axes annotations: ``param`` returns its
    ``axes`` tuple (None for a leaf that names none) instead of a tensor,
    so an init function returns the tree's axes."""

    def __init__(self, dtype: torch.dtype = torch.float32):
        super().__init__(None, dtype, "meta")

    def param(self, shape, axes=None, *, std=None, init=None, dtype=None):
        if axes is not None and len(axes) != len(shape):
            raise ValueError(f"axes {axes} rank != shape {tuple(shape)}")
        return None if axes is None else tuple(axes)


def trainable(params: nn.Module, flag: bool = True) -> nn.Module:
    """Make every leaf of a parameter tree need a gradient (``flag``) or
    freeze it again; returns the tree."""
    return params.requires_grad_(flag)
