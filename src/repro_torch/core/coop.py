"""Cooperative groups: the port of ``repro/core/coop.py``.

The paper implements subwarp-granularity ``shfl_xor`` / ``ballot`` / ``any`` /
``all`` on top of full-warp primitives with computed masks::

    Size       = given subwarp size
    Rank       = tid % Size
    LaneOffset = floor(tid % warpsize / Size) * Size
    Mask       = ~0 >> (warpsize - Size) << LaneOffset

    subwarp.shfl_xor(data, bm) = warp.shfl_xor(data, bm, Size)
    subwarp.ballot(pred)       = (warp.ballot(pred) & Mask) >> LaneOffset
    subwarp.any(pred)          = (warp.ballot(pred) & Mask) != 0
    subwarp.all(pred)          = (warp.ballot(pred) & Mask) == Mask

As in the JAX package, a "warp" is a contiguous segment of ``warp_size``
lanes of a tensor's last axis and a subgroup a ``size``-lane segment inside
it; every op is plain PyTorch on that axis, on whatever device the tensor
lives.  It is not a kernel: the CUDA kernels of this package use the warp
intrinsics themselves (``__shfl_xor_sync``, ``__ballot_sync``).

Lane masks are ``torch.uint32`` for warps of up to 32 lanes and
``torch.uint64`` up to 64 (no x64 switch is needed).  PyTorch has few
operations on unsigned types, so the mask arithmetic runs in ``int64`` and
the result is handed back as the unsigned type: by a value cast for 32-bit
masks, by ``.view`` for 64-bit ones (bit 63 is ``int64``'s sign bit).
"""

from __future__ import annotations

from typing import Callable

import torch

__all__ = [
    "lane_mask_type",
    "lane_mask_bits",
    "popcnt",
    "subgroup",
    "SubgroupView",
]

_POPCNT_TYPES = (torch.uint32, torch.uint64, torch.int32, torch.int64)


def lane_mask_type(warp_size: int) -> torch.dtype:
    """Paper: architecture-agnostic (unsigned) integer type for a lane mask.

    32-bit warps (CUDA) -> uint32; 64-bit wavefronts (AMD) -> uint64.
    """
    if warp_size <= 32:
        return torch.uint32
    if warp_size <= 64:
        return torch.uint64
    raise ValueError(f"warp_size {warp_size} exceeds 64-bit lane masks")


def lane_mask_bits(warp_size: int) -> int:
    return 32 if warp_size <= 32 else 64


def _as_int64(x: torch.Tensor) -> torch.Tensor:
    """The bits of a 32/64-bit integer tensor as int64 (a uint64 by view)."""
    if x.dtype == torch.uint64:
        return x.view(torch.int64)
    if x.dtype == torch.int32:  # the 32 bits, not the sign-extended value
        return x.to(torch.int64) & 0xFFFFFFFF
    return x.to(torch.int64)


def popcnt(x: torch.Tensor) -> torch.Tensor:
    """Paper: single ``popcnt`` with overloads for 32- and 64-bit integers;
    the count in x's dtype, bit 63 of a 64-bit value included."""
    if x.dtype not in _POPCNT_TYPES:
        raise TypeError(f"popcnt expects a 32/64-bit integer tensor, got {x.dtype}")
    bits = 32 if x.dtype in (torch.uint32, torch.int32) else 64
    v = _as_int64(x)
    count = torch.zeros_like(v)
    for i in range(bits):  # an arithmetic shift still puts bit i at bit 0
        count += (v >> i) & 1
    return count.to(x.dtype)


def _segment(x: torch.Tensor, size: int) -> torch.Tensor:
    """Reshape the last axis (..., L) -> (..., L//size, size)."""
    L = x.shape[-1]
    if L % size:
        raise ValueError(f"last axis {L} not divisible by subgroup size {size}")
    return x.reshape(*x.shape[:-1], L // size, size)


def _unsegment(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(*x.shape[:-2], x.shape[-2] * x.shape[-1])


def _lane_iota(shape, device) -> torch.Tensor:
    """int32 iota along the last axis, broadcast to ``shape``."""
    return torch.arange(shape[-1], dtype=torch.int32,
                        device=device).expand(*shape)


def _take_last(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """take_along_axis over the last axis (idx broadcast to x's shape)."""
    return torch.take_along_dim(x, idx.to(torch.int64).expand(x.shape), dim=-1)


class SubgroupView:
    """A subgroup-of-the-lane-axis view of a tensor —
    ``gko::group::tiled_partition``.

    ``x`` has its last axis interpreted as lanes; the view partitions those
    lanes into contiguous subgroups of ``size``.  All ops return tensors of
    x's full shape, with the subgroup-collective result broadcast to every
    member lane — the shuffle-based semantics where every thread ends up
    holding the value.
    """

    def __init__(self, x: torch.Tensor, size: int, warp_size: int = 32):
        if size & (size - 1):
            raise ValueError(f"subgroup size must be a power of two, got {size}")
        # shuffle / reduce subgroups may exceed the warp (they are lane
        # segments); the ballot ops require size <= warp (checked there)
        if warp_size % size and size % warp_size:
            raise ValueError(
                f"subgroup size {size} incompatible with warp_size {warp_size}"
            )
        self.data = x
        self.size = size
        self.warp_size = warp_size

    # -- identity (paper: thread_rank / size) ----------------------------------
    def thread_rank(self) -> torch.Tensor:
        """Rank = tid % Size, broadcast over x's shape."""
        return _lane_iota(self.data.shape, self.data.device) % self.size

    # -- shuffles ---------------------------------------------------------------
    def shfl_xor(self, bitmask: int) -> torch.Tensor:
        """subwarp.shfl_xor(data, bm): lane r receives data from lane r ^ bm."""
        if not 0 <= bitmask < self.size:
            raise ValueError(f"bitmask {bitmask} out of range for size {self.size}")
        seg = _segment(self.data, self.size)
        idx = _lane_iota(seg.shape, seg.device) ^ bitmask
        return _unsegment(_take_last(seg, idx))

    def shfl(self, src_lane: int) -> torch.Tensor:
        """subwarp.shfl(data, lane): every lane receives lane ``src_lane``'s value."""
        seg = _segment(self.data, self.size)
        idx = torch.full(seg.shape, src_lane, dtype=torch.int64,
                         device=seg.device)
        return _unsegment(_take_last(seg, idx))

    def shfl_down(self, delta: int) -> torch.Tensor:
        """Lane r receives from lane r+delta; out-of-range lanes keep their own
        value (CUDA semantics)."""
        seg = _segment(self.data, self.size)
        lane = _lane_iota(seg.shape, seg.device)
        idx = torch.where(lane + delta >= self.size, lane, lane + delta)
        return _unsegment(_take_last(seg, idx))

    # -- reductions (built from shfl_xor like the paper's Listing 2) ------------
    def reduce(self, op: Callable = torch.add) -> torch.Tensor:
        """Butterfly all-reduce within the subgroup; every lane gets the
        result (the log2(size) shfl_xor steps of the paper's Listing 2)."""
        out = self.data
        bitmask = 1
        while bitmask < self.size:
            seg = _segment(out, self.size)
            idx = _lane_iota(seg.shape, seg.device) ^ bitmask
            out = _unsegment(op(seg, _take_last(seg, idx)))
            bitmask <<= 1
        return out

    def sum(self) -> torch.Tensor:
        return self.reduce(torch.add)

    def max(self) -> torch.Tensor:
        return self.reduce(torch.maximum)

    def min(self) -> torch.Tensor:
        return self.reduce(torch.minimum)

    def inclusive_scan(self, op: Callable = torch.add) -> torch.Tensor:
        """Hillis-Steele inclusive scan within each subgroup (shfl_up based)."""
        seg = _segment(self.data, self.size)
        out = seg
        lane = _lane_iota(seg.shape, seg.device)
        delta = 1
        while delta < self.size:
            src = torch.clamp(lane - delta, min=0)
            shifted = _take_last(out, src)
            out = torch.where(lane >= delta, op(out, shifted), out)
            delta <<= 1
        return _unsegment(out)

    # -- ballots (paper's mask arithmetic, bit for bit) --------------------------
    def _warp_segment(self, x: torch.Tensor) -> torch.Tensor:
        """Reshape lanes into (..., warps, warp_size)."""
        L = x.shape[-1]
        if L % self.warp_size:
            raise ValueError(
                f"last axis {L} not divisible by warp_size {self.warp_size}"
            )
        return x.reshape(*x.shape[:-1], L // self.warp_size, self.warp_size)

    def _full_warp_ballot(self, pred: torch.Tensor) -> torch.Tensor:
        """warp.ballot: warp_size predicate bits packed into one int64 per
        warp, broadcast back to every lane of the warp.  Bit 63 is int64's
        sign bit: the lanes' powers of two are disjoint, so their sum is the
        bit pattern, wrapped into the signed range."""
        w = self._warp_segment(pred).to(torch.int64)
        weights = torch.ones((), dtype=torch.int64, device=w.device) << \
            _lane_iota(w.shape, w.device).to(torch.int64)
        packed = torch.sum(w * weights, dim=-1, keepdim=True)
        return _unsegment(packed.expand(w.shape))

    def _mask_and_offset(self, shape, device):
        """Paper: LaneOffset = floor(tid % warpsize / Size) * Size;
        Mask = ~0 >> (warpsize - Size) << LaneOffset — in int64, with the
        logical shift written as the Size low bits."""
        if self.size > self.warp_size:
            raise ValueError(
                f"ballot ops need subgroup size ({self.size}) <= warp_size "
                f"({self.warp_size}) — the paper's masks live inside one warp"
            )
        lane_mask_type(self.warp_size)  # raises past 64 lanes
        tid = _lane_iota(shape, device).to(torch.int64) % self.warp_size
        lane_offset = (tid // self.size) * self.size
        low = -1 if self.size == 64 else (1 << self.size) - 1
        mask = torch.full((), low, dtype=torch.int64, device=device) << lane_offset
        return mask, lane_offset, low

    def _as_mask_type(self, v: torch.Tensor) -> torch.Tensor:
        mt = lane_mask_type(self.warp_size)
        return v.view(mt) if mt == torch.uint64 else v.to(mt)

    def ballot(self, pred: torch.Tensor) -> torch.Tensor:
        """subwarp.ballot(pred) = (warp.ballot(pred) & Mask) >> LaneOffset,
        in the lane mask type."""
        mask, lane_offset, low = self._mask_and_offset(pred.shape, pred.device)
        warp = self._full_warp_ballot(pred)
        # an arithmetic shift drags bit 63 down: keep the Size low bits
        return self._as_mask_type(((warp & mask) >> lane_offset) & low)

    def any(self, pred: torch.Tensor) -> torch.Tensor:
        """subwarp.any(pred) = (warp.ballot(pred) & Mask) != 0."""
        mask, _, _ = self._mask_and_offset(pred.shape, pred.device)
        warp = self._full_warp_ballot(pred)
        return (warp & mask) != 0

    def all(self, pred: torch.Tensor) -> torch.Tensor:
        """subwarp.all(pred) = (warp.ballot(pred) & Mask) == Mask."""
        mask, _, _ = self._mask_and_offset(pred.shape, pred.device)
        warp = self._full_warp_ballot(pred)
        return (warp & mask) == mask

    def count(self, pred: torch.Tensor) -> torch.Tensor:
        """popcnt(subwarp.ballot(pred)) — the paper's ballot+popcount idiom."""
        return popcnt(self.ballot(pred))


def subgroup(x: torch.Tensor, size: int, warp_size: int = 32) -> SubgroupView:
    """``gko::group::tiled_partition<size>(warp)`` analogue."""
    return SubgroupView(x, size, warp_size)
