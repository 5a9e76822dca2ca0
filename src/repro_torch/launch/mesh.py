"""Named device meshes over a ``torch.distributed`` world: the part of
``repro/launch/mesh.py`` the training path needs.

The JAX package runs one program over a mesh of devices; the port runs one
process a mesh position.  A :class:`Mesh` names its axes and their sizes
(``{"data": 2, "model": 2}``), lays the world's ranks over them row-major
(the last axis fastest, as ``jax.make_mesh`` lays out devices), and holds
this rank's coordinates and a process group along every set of axes
(``mesh.group("model")``, ``mesh.group(("pod", "data"))``).  A mesh built
without a process group has its shape only: what the sharding rules read.

:func:`use_mesh` makes a mesh the ambient one (``current_mesh``), as
``jax.set_mesh`` does; the expert-parallel MoE dispatch reads it.
"""

from __future__ import annotations

import contextlib
import contextvars
import itertools
from typing import Dict, Iterable, Mapping, Optional, Tuple, Union

__all__ = ["Mesh", "make_mesh", "make_host_mesh", "make_census_mesh",
           "use_mesh", "current_mesh"]

Names = Union[str, Iterable[str]]


def _names(names: Names) -> Tuple[str, ...]:
    return (names,) if isinstance(names, str) else tuple(names)


class Mesh:
    """Axis sizes, this rank's coordinates and the axes' process groups."""

    def __init__(self, shape: Mapping[str, int], *, rank: int = 0,
                 groups: Optional[Dict[Tuple[str, ...], object]] = None):
        self.shape: Dict[str, int] = {k: int(v) for k, v in shape.items()}
        self.axis_names = tuple(self.shape)
        self.rank = rank
        self._groups = groups or {}

    @property
    def size(self) -> int:
        n = 1
        for s in self.shape.values():
            n *= s
        return n

    @property
    def coords(self) -> Dict[str, int]:
        """This rank's index along each axis (row-major layout)."""
        out, r = {}, self.rank
        for name in reversed(self.axis_names):
            out[name] = r % self.shape[name]
            r //= self.shape[name]
        return {n: out[n] for n in self.axis_names}

    def index(self, names: Names) -> int:
        """This rank's position along the axes ``names`` taken together
        (row-major over them)."""
        i = 0
        for n in _names(names):
            i = i * self.shape[n] + self.coords[n]
        return i

    def axis_size(self, names: Names) -> int:
        n = 1
        for a in _names(names):
            n *= self.shape[a]
        return n

    def group(self, names: Names):
        """The process group of the ranks that share this rank's coordinates
        off ``names``; None in a mesh without a world (every axis of size
        1, or shapes only)."""
        return self._groups.get(tuple(sorted(_names(names))))

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank})"


def make_mesh(shape: Mapping[str, int]) -> Mesh:
    """A mesh over the initialised world (its size must be the mesh's), with
    a group along every non-empty set of axes; a world of one without a
    process group when every axis has size 1."""
    import torch.distributed as dist

    mesh = Mesh(shape)
    if not (dist.is_available() and dist.is_initialized()):
        if mesh.size != 1:
            raise ValueError(f"mesh {mesh.shape} needs a world of {mesh.size} "
                             "ranks; no process group is initialised")
        return mesh
    if dist.get_world_size() != mesh.size:
        raise ValueError(f"mesh {mesh.shape} needs {mesh.size} ranks, the "
                         f"world has {dist.get_world_size()}")
    names = mesh.axis_names
    sizes = [mesh.shape[n] for n in names]
    positions = list(itertools.product(*[range(s) for s in sizes]))

    def rank_of(pos):
        r = 0
        for p, s in zip(pos, sizes):
            r = r * s + p
        return r

    groups = {}
    me = dist.get_rank()
    # every rank creates every group, in one order (new_group is collective)
    for k in range(1, len(names) + 1):
        for subset in itertools.combinations(range(len(names)), k):
            key = tuple(sorted(names[i] for i in subset))
            seen = {}
            for pos in positions:
                rest = tuple(p for i, p in enumerate(pos) if i not in subset)
                seen.setdefault(rest, []).append(rank_of(pos))
            for ranks in seen.values():
                g = dist.new_group(ranks)
                if me in ranks:
                    groups[key] = g
    return Mesh(shape, rank=me, groups=groups)


def make_census_mesh(shape: Mapping[str, int]) -> Mesh:
    """Rank 0 of a mesh of ``shape`` with no world: every group along a set
    of axes is a :class:`~repro_torch.distributed.comm.CensusGroup` of
    their size, so a step run on it counts its collectives and moves
    nothing (the dry run)."""
    from repro_torch.distributed.comm import CensusGroup

    mesh = Mesh(shape)
    names = mesh.axis_names
    groups = {}
    for k in range(1, len(names) + 1):
        for subset in itertools.combinations(names, k):
            groups[tuple(sorted(subset))] = CensusGroup(mesh.axis_size(subset))
    return Mesh(shape, groups=groups)


def make_host_mesh(data: int = 1, model: int = 1) -> Mesh:
    """``("data", "model")`` mesh over the world (tests, examples)."""
    return make_mesh({"data": data, "model": model})


_CURRENT: contextvars.ContextVar[Optional[Mesh]] = contextvars.ContextVar(
    "repro_torch_current_mesh", default=None)


@contextlib.contextmanager
def use_mesh(mesh: Mesh):
    token = _CURRENT.set(mesh)
    try:
        yield mesh
    finally:
        _CURRENT.reset(token)


def current_mesh() -> Optional[Mesh]:
    return _CURRENT.get()
