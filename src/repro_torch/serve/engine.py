"""Continuous-batching solve engine — slots, admit/advance/retire.

One *lane* per sparsity pattern holds a fixed number of batch **slots**;
each slot carries one in-flight system through the masked batched Krylov
loop.  The engine's tick cycle is:

* **admit** — pending requests are written into free slots (values,
  right-hand side, cached preconditioner factors: in place, into the
  lane-owned buffers), then one ``refresh`` recomputes the solver's initial
  state and stopping threshold and takes them for exactly the newly seeded
  rows (``torch.where`` on the admission mask: the other rows' state is
  carried over bit for bit);
* **advance** — one call of
  :func:`repro_torch.batch.solvers.batch_cg_advance` /
  :func:`~repro_torch.batch.solvers.batch_bicgstab_advance` runs up to
  ``chunk_sweeps`` masked sweeps, then yields to the host, which is where
  new work is admitted (the continuous-batching seam);
* **retire** — converged (or iteration-capped) slots are read back, their
  responses emitted, and the slot freed by setting its threshold to +inf (a
  frozen row: every batched op is row-independent, so it costs one row of
  work and changes nothing else, even when the frozen row holds NaN).

Because every batched operation reduces row by row, a slot's iterates are
bitwise those of the same request served alone in a lane of the same
configuration (the same slot count: the cuda ``axpy_norm_rows`` cuts rows
into a number of pieces that depends on it).

Every call on the engine's path takes the engine's executor explicitly, so
it serves the same kernel space from any thread (the executor context of
:func:`repro_torch.core.use_executor` is not inherited by a new thread).
Each tick reads the lane's norms, thresholds and counts back to the host.
"""

from __future__ import annotations

import dataclasses
import itertools
import time
from collections import deque
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.batch import ops
from repro_torch.batch.formats import BatchCsr, BatchEll
from repro_torch.batch.solvers import (
    BatchBicgstabState,
    BatchCgState,
    batch_bicgstab_advance,
    batch_bicgstab_init,
    batch_cg_advance,
    batch_cg_init,
)
from repro_torch.observability import convergence, metrics, trace
from repro_torch.precond import batch_block_jacobi_from_factors
from repro_torch.precond.amg import batch_amg_apply
from repro_torch.serve.cache import (
    PatternSetup,
    SetupCache,
    pattern_key,
    serve_generate_factors_op,
    serve_generate_pattern_op,
    values_fingerprint,
)
from repro_torch.serve.request import SolveRequest, SolveResponse
from repro_torch.solvers.common import Stop
from repro_torch.solvers.parilu import batch_parilu_apply

__all__ = ["ServeConfig", "PatternLane", "ContinuousBatchEngine"]

#: sweep cap handed to the chunked advance: per-request iteration limits are
#: enforced on the host at retire; ``num_sweeps`` bounds each chunk instead
_UNBOUNDED_ITERS = (1 << 31) - 1


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Engine configuration (fixed per engine)."""

    slots: int = 8
    chunk_sweeps: int = 8
    solver: str = "cg"  # cg | bicgstab
    fmt: str = "csr"  # csr | ell
    precond: str = "block_jacobi"  # block_jacobi | parilu | amg | none
    block_size: int = 4
    stop: Stop = Stop(max_iters=500, reduction_factor=1e-5)
    cache_patterns: int = 32
    cache_factors: int = 8

    def pattern_config(self) -> str:
        """The config part of the pattern-cache key: what changes the
        generated tables (solver and stop live in the closure key)."""
        return f"{self.fmt}|{self.precond}|bs{self.block_size}"

    def closure_key(self):
        return (self.slots, self.solver, self.chunk_sweeps, self.stop)


def _zero_state(solver: str, S: int, n: int, dtype, device):
    """All-frozen state for a fresh lane (no dispatch)."""
    z2 = torch.zeros((S, n), dtype=dtype, device=device)
    z1 = torch.zeros((S,), dtype=dtype, device=device)
    it = torch.zeros((S,), dtype=torch.int32, device=device)
    hist = convergence.init(0, batch=S, dtype=dtype, device=device)
    if solver == "cg":
        return BatchCgState(z2, z2, z2, z2, z1, it, 0, z1, hist)
    if solver == "bicgstab":
        return BatchBicgstabState(z2, z2, z2, z2, z1, it, 0, z1, hist)
    raise ValueError(f"unknown serve solver {solver!r} (cg | bicgstab)")


def _build_closures(setup: PatternSetup, config: ServeConfig, ex):
    """The (refresh, advance) pair of one (pattern, config), kept in the
    pattern's cache entry with the tables it closes over."""
    run_stop = dataclasses.replace(config.stop, max_iters=_UNBOUNDED_ITERS)
    shape = setup.shape

    if setup.fmt == "csr":
        dev = ex.device
        indptr = torch.as_tensor(setup.indptr.astype(np.int32), device=dev)
        indices = torch.as_tensor(setup.indices.astype(np.int32), device=dev)

        def mk_A(values):
            return BatchCsr(indptr, indices, values, shape)
    else:
        col_idx = setup.col_idx
        m, kk = col_idx.shape

        def mk_A(values):
            return BatchEll(col_idx, values.reshape(-1, m, kk), shape)

    def mk_M(inv, S):
        if setup.jacobi is not None:
            return batch_block_jacobi_from_factors(inv, S, setup.jacobi,
                                                   executor=ex)
        if setup.parilu is not None:
            st = setup.parilu
            nl = int(st.l_rows.size)
            return lambda R: batch_parilu_apply(st, inv[:, :nl], inv[:, nl:], R)
        if setup.amg is not None:
            return lambda R: batch_amg_apply(setup.amg, inv, R)
        return None

    cg = config.solver == "cg"

    def refresh(values, inv, B, state, thresh, newly):
        """Initial state and threshold, taken for the ``newly`` rows only."""
        A = mk_A(values)
        bnorm = ops.batch_norm2(B, executor=ex)
        fresh_thresh = config.stop.threshold(bnorm)
        n2 = newly[:, None]
        if cg:
            init = batch_cg_init(A, B, torch.zeros_like(B),
                                 M=mk_M(inv, values.shape[0]), executor=ex)
            state = BatchCgState(
                X=torch.where(n2, init.X, state.X),
                R=torch.where(n2, init.R, state.R),
                Z=torch.where(n2, init.Z, state.Z),
                P=torch.where(n2, init.P, state.P),
                rz=torch.where(newly, init.rz, state.rz),
                iters=torch.where(newly, init.iters, state.iters),
                k=state.k,
                rnorm=torch.where(newly, init.rnorm, state.rnorm),
                hist=state.hist,
            )
        else:
            init = batch_bicgstab_init(A, B, torch.zeros_like(B), executor=ex)
            state = BatchBicgstabState(
                X=torch.where(n2, init.X, state.X),
                R=torch.where(n2, init.R, state.R),
                R_hat=torch.where(n2, init.R_hat, state.R_hat),
                P=torch.where(n2, init.P, state.P),
                rho=torch.where(newly, init.rho, state.rho),
                iters=torch.where(newly, init.iters, state.iters),
                k=state.k,
                rnorm=torch.where(newly, init.rnorm, state.rnorm),
                hist=state.hist,
            )
        return state, torch.where(newly, fresh_thresh, thresh)

    def advance(values, inv, state, thresh):
        step = batch_cg_advance if cg else batch_bicgstab_advance
        return step(mk_A(values), state, thresh, stop=run_stop,
                    M=mk_M(inv, values.shape[0]),
                    num_sweeps=config.chunk_sweeps, executor=ex)

    return refresh, advance


class PatternLane:
    """Batch slots and solver state of one sparsity pattern.  ``values``,
    ``B``, ``inv`` and ``thresh`` are owned by the lane and written in place
    on admit and retire; the solver state is replaced, never written."""

    def __init__(self, setup: PatternSetup, config: ServeConfig, executor):
        S = config.slots
        n = setup.n
        dtype = torch.float32
        dev = executor.device
        self.setup = setup
        self.config = config
        self.executor = executor
        self.values = torch.zeros((S, setup.flat_value_len), dtype=dtype,
                                  device=dev)
        self.B = torch.zeros((S, n), dtype=dtype, device=dev)
        if setup.jacobi is not None:
            nbl, bs = setup.jacobi.num_blocks, setup.jacobi.block_size
            self.inv = torch.zeros((S * nbl, bs, bs), dtype=dtype, device=dev)
        elif setup.flat_factor_len is not None:
            # parilu / amg lanes store one flat factor row per slot
            self.inv = torch.zeros((S, setup.flat_factor_len), dtype=dtype,
                                   device=dev)
        else:
            self.inv = torch.zeros((0, 1, 1), dtype=dtype, device=dev)
        self.thresh = torch.full((S,), float("inf"), dtype=dtype, device=dev)
        self.state = _zero_state(config.solver, S, n, dtype, dev)
        self.requests: List[Optional[SolveRequest]] = [None] * S
        self.pending: "deque[SolveRequest]" = deque()
        self.bind(setup)

    def bind(self, setup: PatternSetup) -> None:
        """Take ``setup``'s closures (built once per closure key)."""
        self.setup = setup
        ckey = self.config.closure_key()
        if ckey not in setup.closures:
            setup.closures[ckey] = _build_closures(setup, self.config,
                                                   self.executor)
        self.refresh_fn, self.advance_fn = setup.closures[ckey]

    @property
    def occupied(self) -> int:
        return sum(r is not None for r in self.requests)

    @property
    def has_work(self) -> bool:
        return bool(self.pending) or self.occupied > 0


class ContinuousBatchEngine:
    """Deterministic host loop: ``submit()`` requests, ``tick()`` the lanes.

    Single-threaded by design: the async boundary is
    :class:`repro_torch.serve.service.SolveService`.  ``executor`` defaults
    to the current executor of the constructing thread (the CUDA executor
    unless one is active).
    """

    def __init__(self, config: ServeConfig = ServeConfig(), *, executor=None,
                 cache: Optional[SetupCache] = None):
        if executor is None:
            from repro_torch.core.executor import current_executor

            executor = current_executor()
        # fail fast on a degenerate stopping criterion
        config.stop.threshold(torch.zeros(0))
        self.config = config
        self.executor = executor
        self.cache = cache if cache is not None else SetupCache(
            config.cache_patterns, config.cache_factors)
        self.lanes: Dict[str, PatternLane] = {}
        self._ids = itertools.count()
        #: request_id -> [pattern_hit, factors_hit]
        self._flags: Dict[int, List[bool]] = {}

    # -- intake ---------------------------------------------------------------
    def submit(self, req: SolveRequest) -> int:
        if req.request_id is None:
            req.request_id = next(self._ids)
        if req.submitted_s is None:
            req.submitted_s = time.perf_counter()
        key = pattern_key(req.indptr, req.indices, req.shape,
                          self.config.pattern_config())
        setup, hit = self.cache.setup(
            key,
            build=lambda: serve_generate_pattern_op(
                req.indptr, req.indices, req.shape,
                fmt=self.config.fmt,
                precond=self.config.precond,
                block_size=self.config.block_size,
                executor=self.executor,
            ),
        )
        lane = self.lanes.get(key)
        if lane is None:
            lane = self.lanes[key] = PatternLane(setup, self.config,
                                                 self.executor)
        elif lane.setup is not setup:
            # the pattern was evicted and generated again since this lane
            # was built: rebind so closures and factors stay consistent
            lane.bind(setup)
        self._flags[req.request_id] = [hit, False]
        lane.pending.append(req)
        metrics.counter("serve_requests").inc()
        return req.request_id

    # -- the tick cycle -------------------------------------------------------
    def tick(self) -> List[SolveResponse]:
        """One admit -> advance -> retire cycle over every lane."""
        responses: List[SolveResponse] = []
        for lane in self.lanes.values():
            self._admit(lane)
        for lane in self.lanes.values():
            if lane.occupied:
                lane.state = lane.advance_fn(lane.values, lane.inv,
                                             lane.state, lane.thresh)
        for lane in self.lanes.values():
            responses.extend(self._retire(lane))
        metrics.gauge("serve_slots_occupied").set(
            sum(lane.occupied for lane in self.lanes.values()))
        return responses

    @property
    def has_work(self) -> bool:
        return any(lane.has_work for lane in self.lanes.values())

    def drain(self, max_ticks: int = 100_000) -> List[SolveResponse]:
        """Tick until every submitted request has retired."""
        out: List[SolveResponse] = []
        for _ in range(max_ticks):
            if not self.has_work:
                return out
            out.extend(self.tick())
        raise RuntimeError(f"serve engine failed to drain within {max_ticks} ticks")

    # -- internals ------------------------------------------------------------
    def _admit(self, lane: PatternLane) -> None:
        if not lane.pending:
            return
        S = self.config.slots
        newly = np.zeros(S, bool)
        for s in range(S):
            if lane.requests[s] is not None or not lane.pending:
                continue
            req = lane.pending.popleft()
            vals = lane.setup.lane_values(req.values)
            lane.values[s] = torch.as_tensor(vals, dtype=lane.values.dtype)
            lane.B[s] = torch.as_tensor(req.b, dtype=lane.B.dtype)
            if lane.setup.has_factors:
                inv_rows, fhit = self.cache.factors(
                    lane.setup, values_fingerprint(vals),
                    build=lambda s=s: serve_generate_factors_op(
                        lane.values[s].clone(), lane.setup,
                        executor=self.executor),
                )
                if lane.setup.jacobi is not None:
                    nbl = lane.setup.jacobi.num_blocks
                    lane.inv[s * nbl:(s + 1) * nbl] = inv_rows
                else:
                    lane.inv[s] = inv_rows
                self._flags[req.request_id][1] = fhit
            req.admitted_s = time.perf_counter()
            lane.requests[s] = req
            newly[s] = True
            trace.instant("serve.admit", slot=s, request=req.request_id,
                          pattern=lane.setup.key[:12])
        if newly.any():
            lane.state, lane.thresh = lane.refresh_fn(
                lane.values, lane.inv, lane.B, lane.state, lane.thresh,
                torch.as_tensor(newly, device=lane.values.device))

    def _retire(self, lane: PatternLane) -> List[SolveResponse]:
        out: List[SolveResponse] = []
        if not lane.occupied:
            return out
        rnorm = lane.state.rnorm.cpu().numpy()
        th = lane.thresh.cpu().numpy()
        iters = lane.state.iters.cpu().numpy()
        max_iters = self.config.stop.max_iters
        done = [s for s, r in enumerate(lane.requests)
                if r is not None and (rnorm[s] <= th[s] or iters[s] >= max_iters)]
        if not done:
            return out
        X = lane.state.X.cpu().numpy()
        tracer = trace.get_tracer()
        now = time.perf_counter()
        for s in done:
            req = lane.requests[s]
            flags = self._flags.pop(req.request_id, [False, False])
            latency = (now - req.submitted_s
                       if req.submitted_s is not None else None)
            resp = SolveResponse(
                request_id=req.request_id,
                x=X[s].copy(),
                iterations=int(iters[s]),
                residual_norm=float(rnorm[s]),
                converged=bool(rnorm[s] <= th[s]),
                pattern_hit=flags[0],
                factors_hit=flags[1],
                latency_s=latency,
                retired_s=now,
            )
            lane.requests[s] = None
            lane.thresh[s] = float("inf")
            metrics.counter("serve_solves").inc()
            metrics.counter("serve_iterations").inc(resp.iterations)
            if not resp.converged:
                metrics.counter("serve_failures").inc()
            if latency is not None:
                metrics.histogram("serve_latency_s").observe(latency)
            if trace.TRACING and tracer is not None and req.submitted_s is not None:
                # the request's span, submit -> retire, written at retire
                # (its start on the tracer's clock: now less its latency)
                tracer.complete(
                    "serve.request",
                    tracer.rel_us(trace.now_ns() - int(latency * 1e9)),
                    latency * 1e6, cat="serve",
                    args={"request": req.request_id,
                          "iterations": resp.iterations,
                          "pattern_hit": flags[0], "factors_hit": flags[1],
                          "converged": resp.converged},
                )
            out.append(resp)
        return out
