"""Process groups for the distributed layer: the world, its collectives and
a runner that starts one.

The JAX package runs one program over a device mesh (``make_shard_mesh`` +
``shard_map``, ``repro.launch.mesh``).  The port runs one process per part
under ``torch.distributed``: rank ``p`` holds part ``p`` of the partition and
runs the unchanged solver source on it.  This module is what that needs:

* :func:`init_world` / :func:`close_world` / :func:`world` — the default
  process group, always with a finite timeout, so a rank that takes another
  branch raises instead of waiting forever;
* :func:`sum_fixed` — the cross-rank sum every reduction goes through: an
  all-gather of the ranks' partials, then a left fold in rank order on every
  rank.  Every rank gets the same bits, and a repeat is bitwise equal (the
  port's fixed-order rule), so every rank takes the same stopping branch;
* :func:`all_gather_shards` — the halo exchange: one all-gather of the
  padded shards, optionally asynchronous so the interior SpMV runs while it
  is in flight;
* a collective counter (:func:`collective_counts`): ``reduction`` (one a
  :func:`sum_fixed`), ``halo`` (one an exchange of a SpMV) and ``gather``
  (assembling a global vector);
* :func:`all_reduce`, :func:`all_to_all`, :func:`all_gather` and
  :func:`ring_shift` over a group — the collectives of the training path
  (gradient compression, expert parallelism, the ring matmuls), counted
  as ``all-reduce``, ``all-to-all``, ``all-gather`` and
  ``collective-permute`` with their result's bytes
  (:func:`collective_bytes`) when they cross ranks;
* :class:`CensusGroup` — a stand-in group of ``size`` ranks that moves
  nothing: a collective over it is counted and returns this rank's result
  shaped (zeros, or its input), so the dry run counts a step's collectives
  on ``meta`` tensors without a world;
* :func:`run_world` — spawn a world of P processes, run one function on
  every rank and return the results in rank order.

NCCL refuses two ranks on one card, so ranks that share a card use gloo.
gloo's collectives here run on host tensors: a CUDA tensor under gloo is
copied to the host, gathered there and copied back, in this module and
nowhere else.  The fold of a staged sum runs on the host; IEEE addition
rounds the same there as on the card.  A process without a process group is
a world of one, whose collectives return their input.
"""

from __future__ import annotations

import datetime
import os
import queue
import shutil
import tempfile
import time
import traceback
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

__all__ = [
    "DEFAULT_TIMEOUT_S",
    "init_world",
    "close_world",
    "world",
    "sum_fixed",
    "all_gather_shards",
    "collective_counts",
    "collective_bytes",
    "reset_collective_counts",
    "CensusGroup",
    "all_reduce",
    "all_to_all",
    "all_gather",
    "ring_shift",
    "run_world",
]

#: seconds a collective may wait for the other ranks before it raises
DEFAULT_TIMEOUT_S = 120.0

#: the training path's collectives, by the names of the JAX package's census
TRAIN_KINDS = ("all-reduce", "all-gather", "all-to-all", "collective-permute")
_COUNTS: Dict[str, int] = {"reduction": 0, "halo": 0, "gather": 0,
                           **{k: 0 for k in TRAIN_KINDS}}
_BYTES: Dict[str, int] = {k: 0 for k in TRAIN_KINDS}


def collective_counts() -> Dict[str, int]:
    """Collectives issued since the last reset, by kind."""
    return dict(_COUNTS)


def collective_bytes() -> Dict[str, int]:
    """Bytes of the training collectives' results since the last reset, by
    kind (an all-gather's whole gathered result, an all-reduce's or an
    all-to-all's own size)."""
    return dict(_BYTES)


def reset_collective_counts() -> None:
    for k in _COUNTS:
        _COUNTS[k] = 0
    for k in _BYTES:
        _BYTES[k] = 0


class CensusGroup:
    """A group of ``size`` ranks in name only (see the module docstring)."""

    def __init__(self, size: int):
        self.size = int(size)

    def __repr__(self) -> str:
        return f"CensusGroup({self.size})"


def _count(kind: str, out: torch.Tensor) -> None:
    _COUNTS[kind] += 1
    _BYTES[kind] += out.numel() * out.element_size()


def _dist():
    import torch.distributed as dist

    return dist


def _initialized() -> bool:
    dist = _dist()
    return dist.is_available() and dist.is_initialized()


def init_world(rank: int, world_size: int, init_method: str, *,
               backend: str = "gloo",
               timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """Join the default process group as ``rank`` of ``world_size``.

    ``init_method`` is a rendezvous URL (``file://...`` or
    ``tcp://localhost:PORT``).  NCCL takes one card a rank: rank ``r`` binds
    card ``r`` of the visible ones.
    """
    if backend == "nccl":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    _dist().init_process_group(
        backend=backend, init_method=init_method, world_size=world_size,
        rank=rank, timeout=datetime.timedelta(seconds=timeout_s))


def close_world() -> None:
    if _initialized():
        _dist().destroy_process_group()


def world() -> Tuple[int, int]:
    """``(rank, world size)`` of the default group; ``(0, 1)`` without one."""
    if not _initialized():
        return 0, 1
    dist = _dist()
    return dist.get_rank(), dist.get_world_size()


def _staged(t: torch.Tensor) -> bool:
    # gloo gathers host tensors; a CUDA tensor goes through host memory
    return t.is_cuda and str(_dist().get_backend()) == "gloo"


def sum_fixed(partials: torch.Tensor) -> torch.Tensor:
    """The sum over ranks of this rank's ``partials`` (any shape), in rank
    order and bitwise equal on every rank: one all-gather, then
    ``((p0 + p1) + p2) + ...``."""
    _COUNTS["reduction"] += 1
    if not _initialized():
        return partials
    size = _dist().get_world_size()
    flat = partials.reshape(-1)
    staged = _staged(flat)
    buf = flat.cpu() if staged else flat.contiguous()
    parts = [torch.empty_like(buf) for _ in range(size)]
    _dist().all_gather(parts, buf)
    total = parts[0]
    for p in parts[1:]:
        total = total + p
    if staged:
        total = total.to(partials.device)
    return total.reshape(partials.shape)


class _Gathered:
    """A pending all-gather of padded shards into ``flat`` (one row a rank);
    :meth:`wait` gives the flat ``(P * Lmax, ...)`` concatenation in rank
    order, on ``device``."""

    def __init__(self, work, flat: torch.Tensor, device, staged: bool):
        self._work = work
        self._flat = flat
        self._device = device
        self._staged = staged

    def wait(self) -> torch.Tensor:
        if self._work is not None:
            self._work.wait()
        flat = self._flat.reshape((-1,) + tuple(self._flat.shape[2:]))
        # a staged gather lands in pinned host memory: one asynchronous copy up
        return flat.to(self._device, non_blocking=True) if self._staged else flat


def all_gather_shards(x: torch.Tensor, *, async_op: bool = False,
                      kind: str = "halo"):
    """All-gather every rank's padded shard ``x`` (equal shapes on every
    rank).  Returns the flat concatenation, or with ``async_op`` a handle
    whose ``wait()`` returns it.  ``kind`` is the counter it adds to
    (``halo`` or ``gather``).  The ranks' shards land as the rows of one
    buffer (pinned host memory when staged), so no concatenation follows."""
    _COUNTS[kind] += 1
    if not _initialized():
        done = _Gathered(None, x[None], x.device, False)
        return done if async_op else done.wait()
    size = _dist().get_world_size()
    staged = _staged(x)
    buf = x.cpu() if staged else x.contiguous()
    flat = torch.empty((size,) + tuple(buf.shape), dtype=buf.dtype,
                       device=buf.device, pin_memory=staged)
    work = _dist().all_gather(list(flat.unbind(0)), buf, async_op=async_op)
    out = _Gathered(work, flat, x.device, staged)
    return out if async_op else out.wait()


def _group_staged(t: torch.Tensor, group) -> bool:
    return t.is_cuda and str(_dist().get_backend(group)) == "gloo"


def all_reduce(t: torch.Tensor, op: str = "sum", group=None) -> torch.Tensor:
    """A new tensor: ``t`` reduced over ``group`` (the default group when
    None) with ``op`` ("sum" or "max"); ``t`` itself when no process group
    is initialised (a world of one)."""
    if isinstance(group, CensusGroup):
        _count("all-reduce", t)
        return t.clone()
    if not _initialized():
        return t
    dist = _dist()
    staged = _group_staged(t, group)
    buf = t.cpu() if staged else t.clone()
    dist.all_reduce(buf, op={"sum": dist.ReduceOp.SUM,
                             "max": dist.ReduceOp.MAX}[op], group=group)
    _count("all-reduce", buf)
    return buf.to(t.device) if staged else buf


def all_to_all(t: torch.Tensor, group=None) -> torch.Tensor:
    """Row block ``j`` of ``t`` (leading axis: one block a rank of
    ``group``) goes to rank ``j``; the result's block ``i`` came from rank
    ``i`` (``jax.lax.all_to_all`` with split and concat axis 0, untiled)."""
    if isinstance(group, CensusGroup):
        _count("all-to-all", t)
        return t.clone()
    if not _initialized():
        return t
    dist = _dist()
    staged = _group_staged(t, group)
    src = t.cpu().contiguous() if staged else t.contiguous()
    out = torch.empty_like(src)
    dist.all_to_all(list(out.unbind(0)), list(src.unbind(0)), group=group)
    _count("all-to-all", out)
    return out.to(t.device) if staged else out


def all_gather(t: torch.Tensor, group=None) -> torch.Tensor:
    """``(size, *t.shape)``: every rank's ``t`` in ``group`` rank order."""
    if isinstance(group, CensusGroup):
        out = t.new_zeros((group.size,) + tuple(t.shape))
        _count("all-gather", out)
        return out
    if not _initialized():
        return t[None]
    dist = _dist()
    staged = _group_staged(t, group)
    src = t.cpu().contiguous() if staged else t.contiguous()
    out = torch.empty((dist.get_world_size(group),) + tuple(src.shape),
                      dtype=src.dtype, device=src.device)
    dist.all_gather(list(out.unbind(0)), src, group=group)
    _count("all-gather", out)
    return out.to(t.device) if staged else out


def ring_shift(t: torch.Tensor, group=None) -> torch.Tensor:
    """Send ``t`` to the next rank of ``group`` and return what the previous
    one sent (``jax.lax.ppermute`` with ``i -> i + 1 mod size``): one
    ``batch_isend_irecv`` pair."""
    if isinstance(group, CensusGroup):
        if group.size > 1:
            _count("collective-permute", t)
        return t.clone()
    if not _initialized():
        return t
    dist = _dist()
    ranks = dist.get_process_group_ranks(group) if group is not None else \
        list(range(dist.get_world_size()))
    me = ranks.index(dist.get_rank())
    size = len(ranks)
    if size == 1:
        return t
    staged = _group_staged(t, group)
    src = t.cpu().contiguous() if staged else t.contiguous()
    out = torch.empty_like(src)
    ops = [dist.P2POp(dist.isend, src, ranks[(me + 1) % size], group=group),
           dist.P2POp(dist.irecv, out, ranks[(me - 1) % size], group=group)]
    for w in dist.batch_isend_irecv(ops):
        w.wait()
    _count("collective-permute", out)
    return out.to(t.device) if staged else out


# -- the world runner -----------------------------------------------------------


def _rank_entry(fn, rank, world_size, init_method, backend_name, timeout_s,
                threads, args, results) -> None:
    try:
        if threads:
            torch.set_num_threads(threads)
        init_world(rank, world_size, init_method, backend=backend_name,
                   timeout_s=timeout_s)
        try:
            out = fn(*args)
        finally:
            close_world()
        results.put((rank, True, out))
    except Exception:  # the parent raises it with the traceback
        results.put((rank, False, traceback.format_exc()))


def _stop(procs) -> None:
    for p in procs:
        if p.is_alive():
            p.kill()
    for p in procs:
        p.join(timeout=10)


def run_world(fn: Callable, world_size: int, args: Sequence = (), *,
              backend: str = "gloo", timeout_s: float = DEFAULT_TIMEOUT_S,
              join_timeout_s: float = 600.0, threads: Optional[int] = None,
              rendezvous_dir: Optional[str] = None,
              in_process: bool = False) -> list:
    """Run ``fn(*args)`` on every rank of a new world of ``world_size``
    processes; return their results in rank order.

    ``fn`` must be importable by module and name (the ranks are spawned), and
    its result picklable.  The ranks meet at a ``file://`` rendezvous in a
    fresh directory under ``rendezvous_dir`` (the temporary directory when
    None).  Each collective waits at most ``timeout_s``; if the world has not
    returned after ``join_timeout_s``, or a rank raises, every rank is
    stopped and this raises with the rank's traceback.  ``in_process`` with
    ``world_size == 1`` runs the one rank in this process (a group of one
    joined and left around the call).  ``threads`` sets each rank's torch
    thread count.
    """
    tmp = tempfile.mkdtemp(prefix="repro_torch_world_", dir=rendezvous_dir)
    init_method = "file://" + os.path.join(tmp, "rendezvous")
    try:
        if in_process:
            if world_size != 1:
                raise ValueError("in_process runs a world of one rank")
            init_world(0, 1, init_method, backend=backend, timeout_s=timeout_s)
            try:
                return [fn(*args)]
            finally:
                close_world()
        return _spawn(fn, world_size, tuple(args), backend, timeout_s,
                      join_timeout_s, threads, init_method)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _spawn(fn, world_size, args, backend_name, timeout_s, join_timeout_s,
           threads, init_method) -> list:
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_entry,
                         args=(fn, r, world_size, init_method, backend_name,
                               timeout_s, threads, args, results))
             for r in range(world_size)]
    for p in procs:
        p.start()
    got = {}
    deadline = time.monotonic() + join_timeout_s
    try:
        while len(got) < world_size:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(
                    f"world of {world_size} ranks did not return within "
                    f"{join_timeout_s} s (ranks back: {sorted(got)})")
            try:
                rank, ok, payload = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in got and p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(
                        f"rank {dead[0]} exited with code "
                        f"{procs[dead[0]].exitcode} and no result")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {world_size} failed:\n"
                                   f"{payload}")
            got[rank] = payload
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 1.0))
    finally:
        _stop(procs)
    return [got[r] for r in range(world_size)]
