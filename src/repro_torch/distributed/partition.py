"""Row partitions — gko::experimental::distributed::Partition for the port.

A :class:`Partition` splits the global row range ``[0, n)`` into one
contiguous range per part, part ``p`` owning ``[offsets[p], offsets[p+1])``;
part ``p`` is rank ``p`` of the process group.  It is host-side setup
metadata: a frozen, hashable tuple of offsets.

Padded shard layout, as in the JAX package: every part is padded to
``max_part_size`` (``Lmax``), so every rank's vectors have one shape and the
halo exchange is one all-gather of equal-sized shards.  ``pad_index`` /
``unpad_index`` are the gather maps between the global ``(n,)`` vector and
the padded ``(P, Lmax)`` stack, and ``pad_mask`` marks the real slots; all
three are the JAX package's arrays.  Padding slots hold zeros and are masked
out of every cross-rank reduction (:func:`~.sharding.zero_shard_padding`).
"""

from __future__ import annotations

import dataclasses
from functools import cached_property
from typing import Sequence, Tuple

import numpy as np
import torch

from repro_torch.distributed.sharding import shard_pad_mask

__all__ = ["Partition"]


@dataclasses.dataclass(frozen=True)
class Partition:
    """Contiguous row ranges per part: part ``p`` owns ``[offsets[p], offsets[p+1])``."""

    offsets: Tuple[int, ...]  # (P+1,) non-decreasing, offsets[0] == 0

    def __post_init__(self):
        offs = tuple(int(o) for o in self.offsets)
        object.__setattr__(self, "offsets", offs)
        if len(offs) < 2:
            raise ValueError(f"partition needs at least one part, got {offs}")
        if offs[0] != 0:
            raise ValueError(f"partition offsets must start at 0, got {offs}")
        if any(b < a for a, b in zip(offs, offs[1:])):
            raise ValueError(f"partition offsets must be non-decreasing: {offs}")

    # -- construction ----------------------------------------------------------
    @classmethod
    def uniform(cls, n: int, num_parts: int) -> "Partition":
        """Balanced contiguous split: the first ``n % num_parts`` parts get one
        extra row."""
        if num_parts < 1:
            raise ValueError(f"num_parts must be >= 1, got {num_parts}")
        base, rem = divmod(int(n), num_parts)
        return cls.from_part_sizes(
            [base + (1 if p < rem else 0) for p in range(num_parts)])

    @classmethod
    def from_part_sizes(cls, sizes: Sequence[int]) -> "Partition":
        offs = [0]
        for s in sizes:
            if s < 0:
                raise ValueError(f"part sizes must be >= 0, got {tuple(sizes)}")
            offs.append(offs[-1] + int(s))
        return cls(tuple(offs))

    # -- shape queries ---------------------------------------------------------
    @property
    def num_parts(self) -> int:
        return len(self.offsets) - 1

    @property
    def global_size(self) -> int:
        return self.offsets[-1]

    @property
    def part_sizes(self) -> Tuple[int, ...]:
        return tuple(b - a for a, b in zip(self.offsets, self.offsets[1:]))

    @property
    def max_part_size(self) -> int:
        """``Lmax`` — the padded per-rank length."""
        return max(self.part_sizes)

    def range_of(self, part: int) -> Tuple[int, int]:
        return (self.offsets[part], self.offsets[part + 1])

    def is_padded(self, part: int) -> bool:
        """Whether ``part``'s shard carries padding slots."""
        return self.part_sizes[part] < self.max_part_size

    # -- index maps (host numpy) -----------------------------------------------
    @cached_property
    def _offsets_np(self) -> np.ndarray:
        return np.asarray(self.offsets, np.int64)

    def part_of(self, rows) -> np.ndarray:
        """Owning part of each global row (empty parts own nothing)."""
        rows = np.asarray(rows)
        if rows.size and (rows.min() < 0 or rows.max() >= self.global_size):
            raise IndexError(f"rows out of range [0, {self.global_size})")
        return (np.searchsorted(self._offsets_np, rows, side="right")
                .astype(np.int64) - 1)

    def to_local(self, rows) -> Tuple[np.ndarray, np.ndarray]:
        """Global rows -> (part, local index within the part)."""
        p = self.part_of(rows)
        return p, np.asarray(rows) - self._offsets_np[p]

    def padded_index(self, rows) -> np.ndarray:
        """Global rows -> flat index into the padded ``(P*Lmax,)`` layout:
        the coordinates the halo maps gather from after an all-gather of the
        padded shards."""
        p, l = self.to_local(rows)
        return p * self.max_part_size + l

    @cached_property
    def pad_mask(self) -> np.ndarray:
        """(P, Lmax) bool — True on real slots, False on padding."""
        return shard_pad_mask(self.part_sizes, self.max_part_size)

    @cached_property
    def pad_index(self) -> np.ndarray:
        """(P, Lmax) int — global row of each slot; padding -> n (the zero
        slot appended by :meth:`pad`)."""
        n, L = self.global_size, self.max_part_size
        idx = self._offsets_np[:-1, None] + np.arange(L, dtype=np.int64)[None, :]
        return np.where(self.pad_mask, idx, n)

    @cached_property
    def unpad_index(self) -> np.ndarray:
        """(n,) int — padded flat slot of each global row."""
        return self.padded_index(np.arange(self.global_size, dtype=np.int64))

    # -- padded shards <-> global vectors (tensors) ----------------------------
    @cached_property
    def _on_device(self) -> dict:
        return {}

    def _index(self, name: str, device) -> torch.Tensor:
        """``pad_index`` / ``unpad_index`` on ``device``, copied there once."""
        key = (name, str(device))
        if key not in self._on_device:
            self._on_device[key] = torch.as_tensor(getattr(self, name),
                                                   device=device)
        return self._on_device[key]

    def pad(self, x: torch.Tensor) -> torch.Tensor:
        """Global ``(n, ...)`` -> padded ``(P, Lmax, ...)``, padding zeroed."""
        zero = torch.zeros((1,) + tuple(x.shape[1:]), dtype=x.dtype,
                           device=x.device)
        return torch.cat([x, zero])[self._index("pad_index", x.device)]

    def pad_part(self, x: torch.Tensor, part: int) -> torch.Tensor:
        """Global ``(n, ...)`` -> part ``part``'s padded ``(Lmax, ...)`` shard."""
        lo, hi = self.range_of(part)
        out = x.new_zeros((self.max_part_size,) + tuple(x.shape[1:]))
        out[: hi - lo] = x[lo:hi]
        return out

    def unpad(self, xp: torch.Tensor) -> torch.Tensor:
        """Padded ``(P, Lmax, ...)`` -> global ``(n, ...)``."""
        return self.unpad_flat(xp.reshape(
            (self.num_parts * self.max_part_size,) + tuple(xp.shape[2:])))

    def unpad_flat(self, flat: torch.Tensor) -> torch.Tensor:
        """The flat ``(P*Lmax, ...)`` all-gather of the padded shards ->
        global ``(n, ...)``."""
        return flat[self._index("unpad_index", flat.device)]
