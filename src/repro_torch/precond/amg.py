"""Algebraic multigrid — smoothed or plain (unsmoothed) aggregation.

The port of the JAX package's ``gko::multigrid`` analogue.  Setup per level:

  1. strength of connection — entry (i, j) is strong when
     ``|a_ij| ≥ θ·√(a_ii·a_jj)``;
  2. greedy aggregation — three sequential host passes (seed, attach,
     singletons), the same ``agg`` as the JAX package's: :func:`aggregate` in
     Python for a hierarchy on the CPU, the same passes compiled into the
     port's library (``kernels/csrc/amg_aggregate.cu``) for one on a card;
  3. tentative prolongator ``T`` (one unit entry per row), smoothed into
     ``P = (I − ω·D⁻¹A)·T`` by one SpGEMM (the default), or left as is,
     ``P = T`` (``smooth_prolongator=False``: ``gko::multigrid::Pgm``'s
     piecewise-constant transfer);
  4. Galerkin product ``A_c = R·(A·P)`` with ``R = Pᵀ`` — two SpGEMMs and one
     transpose.

All sparse-sparse composition goes through the registered ``spgemm`` /
``sptranspose`` ops (so it runs in whichever kernel space the executor
selects, on A's device): a coarsened level costs three ``spgemm`` and one
``sptranspose`` dispatches (two ``spgemm`` without the smoothed
prolongator).

The operand is a CSR or, for the hierarchy's first level, an ELL matrix:
an ``Ell`` A is its own level-0 ``A_op`` (no second copy of the fine
operator), and its stored zeros (the padding) are not entries.  The cycle
(V or W) runs weighted-Jacobi or block-Jacobi smoothers and a dense-inverse
(default) or CG coarse solve; every level applies A, P and R through their
ELL mirrors (``spmv_ell``).  With one pre- and one post-sweep a V-cycle
makes 4 ELL SpMVs per coarsened level: the residual before restriction, R,
P, and A·x in the post-sweep.  The pre-sweep starts from x = 0, whose
residual is r itself, so it applies no A (the JAX package applies A to the
zero guess, which gives the same x but for the sign of a zero).

Setup emits ``amg.setup`` / ``amg.aggregate`` / ``amg.level`` /
``amg.coarse_solver`` trace spans (:func:`repro_torch.observability.trace.span`)
and the gauges ``amg_level_rows``, ``amg_level_nnz`` and
``amg_operator_complexity``.  Each apply's work below the finest level, from
the restricted residual to the coarse correction, is one ``amg.coarse``
span, timed on the residual's device while tracing or a profiler records.

The serve path's two-level half (``amg_serve_pattern``,
``amg_serve_factors``, ``batch_amg_apply``) splits the hierarchy as the
serve cache does: aggregation and the Galerkin maps from the pattern alone,
the factors from the values.  Its sums (coarse values, restriction) are
fixed-order segment sums, so a slot's apply repeats bit for bit on the card
whatever the other slots hold.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core.linop import LinOp
from repro_torch.observability import metrics
from repro_torch.observability.trace import span
from repro_torch.sparse.formats import (
    Csr,
    Ell,
    csr_from_arrays,
    csr_host_arrays,
)
from repro_torch.sparse.ops import (
    _coalesce_host,
    apply as sp_apply,
    spgemm,
    sptranspose,
    to_dense,
)

__all__ = [
    "AmgLevel",
    "AmgServePattern",
    "Multigrid",
    "aggregate",
    "amg_preconditioner",
    "amg_serve_factors",
    "amg_serve_pattern",
    "batch_amg_apply",
    "strength_mask",
    "tentative_prolongator",
]


# =============================================================================
# Setup: strength, aggregation, prolongators, Galerkin product
# =============================================================================


def strength_mask(
    indptr: np.ndarray,
    indices: np.ndarray,
    values: np.ndarray,
    theta: float = 0.08,
) -> np.ndarray:
    """Boolean mask over nnz: ``|a_ij| ≥ θ·√(a_ii·a_jj)``, diagonal excluded."""
    n = indptr.shape[0] - 1
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    cols = np.asarray(indices, dtype=np.int64)
    diag = np.ones(n, np.float64)
    dmask = rows == cols
    diag[rows[dmask]] = np.abs(values[dmask].astype(np.float64))
    ref = theta * np.sqrt(diag[rows] * diag[cols])
    return (~dmask) & (np.abs(values.astype(np.float64)) >= ref)


def aggregate(
    indptr: np.ndarray,
    indices: np.ndarray,
    strong: np.ndarray,
    n: int,
) -> Tuple[np.ndarray, int]:
    """Greedy aggregation: ``(agg, n_agg)`` with ``agg[i]`` the aggregate of
    row i.  Three sequential passes (seed / attach / singleton sweep)."""
    ip = np.asarray(indptr).tolist()
    ix = np.asarray(indices).tolist()
    st = np.asarray(strong).tolist()
    agg = [-1] * n
    n_agg = 0
    # pass 1: rows whose strong neighbourhood is entirely unaggregated seed a
    # new aggregate of themselves and that neighbourhood
    for i in range(n):
        if agg[i] != -1:
            continue
        nbrs = [ix[t] for t in range(ip[i], ip[i + 1]) if st[t]]
        if any(agg[j] != -1 for j in nbrs):
            continue
        agg[i] = n_agg
        for j in nbrs:
            agg[j] = n_agg
        n_agg += 1
    # pass 2: attach leftovers to any strongly connected aggregate
    for i in range(n):
        if agg[i] != -1:
            continue
        for t in range(ip[i], ip[i + 1]):
            if st[t] and agg[ix[t]] != -1:
                agg[i] = agg[ix[t]]
                break
    # pass 3: whatever remains (isolated rows) becomes a singleton aggregate
    for i in range(n):
        if agg[i] == -1:
            agg[i] = n_agg
            n_agg += 1
    return np.asarray(agg, np.int64), n_agg


def tentative_prolongator(agg: np.ndarray, n_agg: int, *, device=None,
                          dtype=np.float32) -> Csr:
    """``T``: (n, n_agg) CSR with one unit entry per row, float32 as in the
    JAX package unless ``dtype`` says otherwise."""
    n = agg.shape[0]
    return csr_from_arrays(
        np.arange(n + 1, dtype=np.int64),
        agg.astype(np.int32),
        np.ones(n, dtype),
        (n, n_agg),
        device=device,
    )


def _csr_diag(indptr, indices, values, n) -> np.ndarray:
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    diag = np.zeros(n, values.dtype)
    m = rows == indices
    diag[rows[m]] = values[m]
    return diag


def _ell_of(A: Csr) -> Ell:
    """A's ELL mirror, built on A's device in
    :func:`repro_torch.sparse.formats.ell_from_csr_host`'s
    layout: row i's entries in its first slots in CSR order, the rest column
    0 and value 0, as wide as the longest row (at least 1)."""
    m = A.shape[0]
    dev = A.values.device
    counts = (A.indptr[1:] - A.indptr[:-1]).long()
    k = max(int(counts.max()) if m else 0, 1)
    rows = torch.repeat_interleave(torch.arange(m, device=dev), counts)
    pos = torch.arange(rows.shape[0], device=dev) - A.indptr[:-1].long()[rows]
    cols = torch.zeros((m, k), dtype=torch.int32, device=dev)
    vals = torch.zeros((m, k), dtype=A.values.dtype, device=dev)
    cols[rows, pos] = A.indices.to(torch.int32)
    vals[rows, pos] = A.values
    return Ell(cols, vals, A.shape)


def _aggregate_for(device: torch.device, indptr, indices, strong, n):
    """:func:`aggregate`'s ``(agg, n_agg)``: the compiled passes for a
    hierarchy on a card (the port's library is loaded there), the Python
    ones elsewhere.  Both give the same array."""
    if device.type == "cuda":
        from repro_torch.kernels.amg_aggregate import aggregate_compiled

        return aggregate_compiled(indptr, indices, strong, n)
    return aggregate(indptr, indices, strong, n)


def _as_csr(A) -> Csr:
    """A itself if CSR; an ELL matrix's entries as a CSR on its device (for
    the SpGEMMs of set-up), without its padding."""
    if isinstance(A, Csr):
        return A
    r, slot = torch.nonzero(A.values, as_tuple=True)
    indptr = torch.zeros(A.shape[0] + 1, dtype=torch.int32,
                         device=A.values.device)
    indptr[1:] = torch.cumsum(torch.bincount(r, minlength=A.shape[0]), 0)
    return Csr(indptr=indptr, indices=A.col_idx[r, slot],
               values=A.values[r, slot], shape=tuple(A.shape))


def _csr_sub_scaled(Tm: Csr, S: Csr, row_scale: np.ndarray) -> Csr:
    """Host sparse combination ``T − diag(row_scale)·S`` (same shape)."""
    ti, tc, tv = csr_host_arrays(Tm)
    si, sc, sv = csr_host_arrays(S)
    m, n = Tm.shape
    t_rows = np.repeat(np.arange(m, dtype=np.int64), np.diff(ti))
    s_rows = np.repeat(np.arange(m, dtype=np.int64), np.diff(si))
    rows = np.concatenate([t_rows, s_rows])
    cols = np.concatenate([tc.astype(np.int64), sc.astype(np.int64)])
    vals = np.concatenate([tv, -row_scale[s_rows] * sv])
    indptr, out_c, out_v = _coalesce_host(rows, cols, vals, m)
    return csr_from_arrays(indptr, out_c, out_v, (m, n),
                           device=Tm.values.device)


@dataclasses.dataclass(frozen=True, eq=False)
class AmgLevel:
    """One level: its operator, the transfer pair, the smoother's data.

    The CSR forms are what the Galerkin composition produced (level 0's
    ``A`` is the operand as given, CSR or ELL); the ``*_op`` ELL mirrors are
    what the cycle applies (an ELL operand is its own ``A_op``).
    ``smoother`` is a block-Jacobi LinOp when the hierarchy was built with
    ``smoother="block_jacobi"``, else None (weighted Jacobi with
    ``inv_diag``).
    """

    A: Union[Csr, Ell]
    P: Csr  # prolongation: coarse -> fine
    R: Csr  # restriction: fine -> coarse (Pᵀ)
    A_op: Ell
    P_op: Ell
    R_op: Ell
    inv_diag: torch.Tensor
    smoother: Optional[LinOp] = None


class Multigrid(LinOp):
    """AMG V/W-cycle as a LinOp (gko::solver::Multigrid).

    The default transfer is smoothed aggregation (``P = (I − ω·D⁻¹A)·T``);
    ``smooth_prolongator=False`` is ``gko::multigrid::Pgm``'s unsmoothed,
    piecewise-constant transfer ``P = T`` and coarse operator ``Tᵀ·A·T``
    (the aggregates are this module's greedy ones, not Pgm's matched pairs).
    The unsmoothed P and R hold their unit entries in A's dtype (the JAX
    package's T is float32), so the cycle applies them to A's vectors in
    their own precision; for a float32 A the two are the same.
    ``A`` is a CSR or an ELL matrix.  ``apply(r)`` runs one cycle from a
    zero initial guess: the preconditioner application ``M⁻¹ r``.  With
    symmetric smoothing (weighted Jacobi, equal pre/post sweep counts) the
    V-cycle is SPD, safe as CG's ``M``.  The hierarchy lives on A's device.
    """

    def __init__(
        self,
        A: Union[Csr, Ell],
        *,
        theta: float = 0.08,
        omega: float = 2.0 / 3.0,
        smooth_prolongator: bool = True,
        cycle: str = "v",
        pre_sweeps: int = 1,
        post_sweeps: int = 1,
        max_levels: int = 10,
        coarse_size: int = 64,
        coarse_solver: str = "dense",
        smoother: str = "jacobi",
        smoother_opts: Optional[dict] = None,
        executor=None,
    ):
        if cycle not in ("v", "w"):
            raise ValueError(f"cycle must be 'v' or 'w', got {cycle!r}")
        if coarse_solver not in ("dense", "cg"):
            raise ValueError(
                f"coarse_solver must be 'dense' or 'cg', got {coarse_solver!r}"
            )
        if smoother not in ("jacobi", "block_jacobi"):
            raise ValueError(
                f"smoother must be 'jacobi' or 'block_jacobi', got {smoother!r}"
            )
        self.executor = executor
        self.cycle = cycle
        self.omega = float(omega)
        self.pre_sweeps = int(pre_sweeps)
        self.post_sweeps = int(post_sweeps)
        self._shape = A.shape
        self._dtype = A.values.dtype
        self.levels: List[AmgLevel] = []
        dev = A.values.device

        level_nnz: List[int] = []
        with span("amg.setup", cat="amg", n=A.shape[0], nnz=A.nnz,
                  theta=theta, cycle=cycle):
            level = 0
            while A.shape[0] > coarse_size and level < max_levels:
                indptr, indices, values = csr_host_arrays(A)
                n = A.shape[0]
                with span("amg.aggregate", cat="amg", level=level, rows=n):
                    strong = strength_mask(indptr, indices, values, theta)
                    agg, n_agg = _aggregate_for(dev, indptr, indices, strong, n)
                if n_agg >= n:
                    break  # coarsening stalled: stop descending
                diag = _csr_diag(indptr, indices, values, n)
                inv_d = np.where(diag != 0, 1.0 / diag, 0.0).astype(values.dtype)
                nnz = int(indptr[-1])
                del indptr, indices, values, strong, diag
                with span("amg.level", cat="amg", level=level, rows=n,
                          nnz=nnz, coarse_rows=n_agg):
                    A_csr = _as_csr(A)  # for this level's SpGEMMs only
                    if smooth_prolongator:
                        T = tentative_prolongator(agg, n_agg, device=dev)
                        AT = spgemm(A_csr, T, executor=executor)
                        P = _csr_sub_scaled(T, AT, self.omega * inv_d)
                        del AT
                    else:
                        # in A's dtype: the cycle applies P and R to A's
                        # vectors (float32 A: the JAX package's T)
                        P = tentative_prolongator(agg, n_agg, device=dev,
                                                  dtype=inv_d.dtype)
                    R = sptranspose(P, executor=executor)
                    A_c = spgemm(R, spgemm(A_csr, P, executor=executor),
                                 executor=executor)
                    del A_csr
                    A_op = A if isinstance(A, Ell) else _ell_of(A)
                    P_op, R_op = _ell_of(P), _ell_of(R)
                sm = None
                if smoother == "block_jacobi":
                    from repro_torch.precond.block_jacobi import block_jacobi

                    sm = block_jacobi(A, executor=executor,
                                      **(smoother_opts or {}))
                self.levels.append(AmgLevel(
                    A=A, P=P, R=R, A_op=A_op, P_op=P_op, R_op=R_op,
                    inv_diag=torch.as_tensor(inv_d, device=dev),
                    smoother=sm,
                ))
                metrics.gauge("amg_level_rows", level=level).set(n)
                metrics.gauge("amg_level_nnz", level=level).set(nnz)
                level_nnz.append(nnz)
                A = A_c
                level += 1

            A = self.coarse_A = _as_csr(A)  # an ELL operand never coarsened
            metrics.gauge("amg_level_rows", level=level).set(A.shape[0])
            metrics.gauge("amg_level_nnz", level=level).set(A.nnz)
            fine_nnz = level_nnz[0] if level_nnz else A.nnz
            self.operator_complexity = (sum(level_nnz) + A.nnz) / max(fine_nnz, 1)
            metrics.gauge("amg_operator_complexity").set(
                self.operator_complexity
            )
            with span("amg.coarse_solver", cat="amg", kind=coarse_solver,
                      rows=A.shape[0]):
                if coarse_solver == "dense":
                    dense = to_dense(A, executor=executor)
                    # f32 outside any kernel, as the JAX package's jnp.linalg.inv
                    self._coarse_inv = torch.linalg.inv(
                        dense.to(torch.float32)).to(self._dtype)
                    self._coarse_solver = None
                else:
                    from repro_torch.solvers.common import Stop
                    from repro_torch.solvers.krylov import CgSolver

                    self._coarse_inv = None
                    self._coarse_solver = CgSolver(
                        A,
                        stop=Stop(max_iters=50, reduction_factor=1e-8),
                        executor=executor,
                    )
        self._weights = [self.omega * L.inv_diag for L in self.levels]

    @classmethod
    def from_levels(
        cls,
        levels: Sequence[AmgLevel],
        coarse_A: Csr,
        coarse_inv: torch.Tensor,
        *,
        cycle: str = "v",
        omega: float = 2.0 / 3.0,
        pre_sweeps: int = 1,
        post_sweeps: int = 1,
        executor=None,
    ) -> "Multigrid":
        """A Multigrid over a given hierarchy (dense coarse solve), with no
        setup run: what :func:`repro_torch.convert.multigrid` builds."""
        if cycle not in ("v", "w"):
            raise ValueError(f"cycle must be 'v' or 'w', got {cycle!r}")
        self = cls.__new__(cls)
        self.executor = executor
        self.cycle = cycle
        self.omega = float(omega)
        self.pre_sweeps = int(pre_sweeps)
        self.post_sweeps = int(post_sweeps)
        self.levels = list(levels)
        fine = self.levels[0].A if self.levels else coarse_A
        self._shape = fine.shape
        self._dtype = fine.values.dtype
        self.coarse_A = coarse_A
        self.operator_complexity = (
            (sum(l.A.nnz for l in self.levels) + coarse_A.nnz)
            / max(fine.nnz, 1)
        )
        self._coarse_inv = coarse_inv
        self._coarse_solver = None
        self._weights = [self.omega * L.inv_diag for L in self.levels]
        return self

    @property
    def shape(self):
        return self._shape

    @property
    def dtype(self):
        return self._dtype

    @property
    def num_levels(self) -> int:
        """Levels counting the coarse grid, as gko::solver::Multigrid does."""
        return len(self.levels) + 1

    # -- the cycle -------------------------------------------------------------

    def _smooth(self, lvl: int, x, r, sweeps: int, executor):
        """``sweeps`` smoothing sweeps on level ``lvl`` from ``x``; ``x`` None
        is the zero guess, whose first sweep takes ``r`` as its residual
        (``r − A·0`` is ``r``) and its update as the new ``x``.  Weighted
        Jacobi scales by ``ω·D⁻¹``, formed once in set-up."""
        L = self.levels[lvl]
        for _ in range(sweeps):
            res = r if x is None else r - sp_apply(L.A_op, x, executor=executor)
            if L.smoother is not None:
                dx = L.smoother.apply(res, executor=executor)
            else:
                dx = self._weights[lvl] * res
            x = dx if x is None else x + dx
        return x

    def _coarse_solve(self, r, executor):
        if self._coarse_inv is not None:
            return self._coarse_inv @ r
        return self._coarse_solver.apply(r, executor=executor)

    def _coarse_correction(self, lvl: int, rc, executor):
        """The cycle's visits to level ``lvl + 1`` for the restricted
        residual ``rc``: one (V) or two (W)."""
        xc = self._cycle(lvl + 1, rc, executor)
        if self.cycle == "w" and lvl + 1 < len(self.levels):
            # second recursive visit (γ = 2), corrected with the updated
            # coarse residual; the coarsest visit is exact, so not repeated
            rc2 = rc - sp_apply(self.levels[lvl + 1].A_op, xc,
                                executor=executor)
            xc = xc + self._cycle(lvl + 1, rc2, executor)
        return xc

    def _cycle(self, lvl: int, r, executor):
        if lvl == len(self.levels):
            return self._coarse_solve(r, executor)
        L = self.levels[lvl]
        x = self._smooth(lvl, None, r, self.pre_sweeps, executor)
        if x is None:  # no pre-sweep: the residual of x = 0 is r
            x = torch.zeros_like(r)
        rc = sp_apply(L.R_op, r - sp_apply(L.A_op, x, executor=executor),
                      executor=executor)
        with (span("amg.coarse", cat="amg", device_of=rc) if lvl == 0
              else contextlib.nullcontext()):
            xc = self._coarse_correction(lvl, rc, executor)
        x = x + sp_apply(L.P_op, xc, executor=executor)
        return self._smooth(lvl, x, r, self.post_sweeps, executor)

    def _apply(self, r: torch.Tensor, executor) -> torch.Tensor:
        ex = executor if executor is not None else self.executor
        if not self.levels:
            return self._coarse_solve(r, ex)
        return self._cycle(0, r, ex)


def amg_preconditioner(A: Union[Csr, Ell], *, executor=None,
                       **opts) -> Multigrid:
    """``M="amg"`` factory — one V(1,1)-cycle of smoothed aggregation by
    default, over a CSR or an ELL operand."""
    if not isinstance(A, (Csr, Ell)):
        raise TypeError(
            f"amg preconditioner needs a CSR or ELL operand, got {type(A).__name__}"
        )
    return Multigrid(A, executor=executor, **opts)


# =============================================================================
# Serve-path AMG: pattern-tier hierarchy + values-tier refresh
# =============================================================================
#
# The serve engine caches per *pattern* and refreshes per *values*, so the
# hierarchy splits the same way: aggregation from the pattern alone (every
# off-diagonal strong), the unsmoothed unit prolongator (values-free), and
# Galerkin coarse values that are segment sums of the fine values over a
# pattern-derived map.  The cycle is the additive two-level correction
# M⁻¹ r = ω·D⁻¹ r + P·A_c⁻¹·Pᵀ r, batched over a lane's slots, from the flat
# factor row ``[inv_diag | A_c⁻¹.flatten()]`` the values tier stores.


@dataclasses.dataclass(frozen=True, eq=False)
class AmgServePattern:
    """Pattern-tier hierarchy data: values-independent, cacheable (the JAX
    package's arrays)."""

    agg: np.ndarray        # (n,)  fine row -> aggregate
    n_agg: int
    coarse_indptr: np.ndarray   # coarse pattern (n_agg + 1,)
    coarse_indices: np.ndarray  # (coarse_nnz,)
    #: fine nnz slot -> coarse nnz slot (the Galerkin product is a segment
    #: sum because P is the unit tentative prolongator)
    seg: np.ndarray
    #: fine nnz slots holding the diagonal
    diag_slots: np.ndarray
    n: int
    #: device -> the index tensors of the applies (built on first use)
    _tables: Dict[str, "_ServeTables"] = dataclasses.field(
        default_factory=dict, repr=False)

    @property
    def flat_len(self) -> int:
        return self.n + self.n_agg * self.n_agg

    def tables(self, device) -> "_ServeTables":
        key = str(device)
        tb = self._tables.get(key)
        if tb is None:
            tb = self._tables[key] = _ServeTables.of(self, device)
        return tb


def _segments(keys: np.ndarray, count: int):
    """Stable order grouping equal ``keys`` and the ``(count + 1,)`` offsets of
    each key's run in it: a fixed summation order per segment."""
    order = np.argsort(keys, kind="stable")
    offsets = np.zeros(count + 1, np.int64)
    offsets[1:] = np.cumsum(np.bincount(keys, minlength=count))
    return order, offsets


@dataclasses.dataclass(frozen=True, eq=False)
class _ServeTables:
    agg: torch.Tensor          # (n,) fine row -> aggregate
    agg_order: torch.Tensor    # fine rows grouped by aggregate
    agg_offsets: torch.Tensor  # (n_agg + 1,)
    seg_order: torch.Tensor    # fine slots grouped by coarse slot
    seg_offsets: torch.Tensor  # (coarse_nnz + 1,)
    diag_slots: torch.Tensor
    crows: torch.Tensor        # coarse slot -> (row, column)
    ccols: torch.Tensor

    @classmethod
    def of(cls, pat: AmgServePattern, device) -> "_ServeTables":
        def on(a):
            return torch.as_tensor(np.asarray(a, np.int64), device=device)

        agg_order, agg_offsets = _segments(pat.agg, pat.n_agg)
        nc_nnz = int(pat.coarse_indices.shape[0])
        seg_order, seg_offsets = _segments(pat.seg, nc_nnz)
        crows = np.repeat(np.arange(pat.n_agg, dtype=np.int64),
                          np.diff(pat.coarse_indptr))
        return cls(on(pat.agg), on(agg_order), on(agg_offsets), on(seg_order),
                   on(seg_offsets), on(pat.diag_slots), on(crows),
                   on(pat.coarse_indices))


def amg_serve_pattern(indptr: np.ndarray, indices: np.ndarray,
                      n: int) -> AmgServePattern:
    """The values-free two-level hierarchy of a sparsity pattern (host numpy,
    the JAX package's construction)."""
    indptr = np.asarray(indptr)
    indices = np.asarray(indices)
    nnz = indices.shape[0]
    strong = np.ones(nnz, bool)
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    strong[rows == indices] = False
    agg, n_agg = aggregate(indptr, indices, strong, n)
    # Galerkin pattern: fine entry (i, j) lands at coarse (agg[i], agg[j])
    crows = agg[rows]
    ccols = agg[indices]
    order = np.lexsort((ccols, crows))
    head = np.ones(nnz, bool)
    head[1:] = (crows[order][1:] != crows[order][:-1]) | (
        ccols[order][1:] != ccols[order][:-1])
    group = np.cumsum(head) - 1  # coarse slot per *sorted* fine entry
    seg = np.empty(nnz, np.int64)
    seg[order] = group
    starts = np.flatnonzero(head)
    c_indptr = np.zeros(n_agg + 1, np.int64)
    c_indptr[1:] = np.cumsum(np.bincount(crows[order][starts], minlength=n_agg))
    c_indices = ccols[order][starts].astype(np.int32)
    return AmgServePattern(
        agg=agg,
        n_agg=n_agg,
        coarse_indptr=c_indptr,
        coarse_indices=c_indices,
        seg=seg,
        diag_slots=np.flatnonzero(rows == indices),
        n=n,
    )


def amg_serve_factors(pat: AmgServePattern, values: torch.Tensor) -> torch.Tensor:
    """Values-tier refresh: the flat row ``[inv_diag | A_c⁻¹.flatten()]``.

    Gathers and one segment sum over the pattern's maps, no re-aggregation.
    Each coarse value sums its fine entries in a fixed order (the JAX
    package's ``segment_sum`` becomes ``segment_reduce``), and every coarse
    slot is a distinct (row, column), so the dense coarse matrix is a plain
    scatter: no atomic adds.
    """
    tb = pat.tables(values.device)
    diag = values[tb.diag_slots]
    inv_diag = torch.where(diag != 0, 1.0 / diag, torch.zeros_like(diag))
    c_vals = torch.segment_reduce(values[tb.seg_order][:, None], "sum",
                                  offsets=tb.seg_offsets, axis=0)[:, 0]
    dense = values.new_zeros((pat.n_agg, pat.n_agg))
    dense[tb.crows, tb.ccols] = c_vals
    c_inv = torch.linalg.inv(dense.float()).to(values.dtype)
    return torch.cat([inv_diag, c_inv.reshape(-1)])


def batch_amg_apply(pat: AmgServePattern, flat: torch.Tensor, R: torch.Tensor,
                    omega: float = 2.0 / 3.0) -> torch.Tensor:
    """Additive two-level correction over a batch, ``(nb, n) -> (nb, n)``.

    ``flat`` stacks per-system :func:`amg_serve_factors` rows, ``(nb,
    flat_len)``.  ``M⁻¹ R = ω·D⁻¹ R + P·A_c⁻¹·Pᵀ R`` with the unit P: the
    restriction sums each aggregate's rows as one fixed-order segment (the
    JAX package's scatter-add), the coarse solve is a batched dense matvec
    and the interpolation a gather.  Every op reduces row by row, so a
    slot's apply does not depend on the other slots.
    """
    n, nc = pat.n, pat.n_agg
    tb = pat.tables(R.device)
    inv_diag = flat[:, :n]
    c_inv = flat[:, n:].reshape(-1, nc, nc)
    rc = torch.segment_reduce(R[:, tb.agg_order].T, "sum",
                              offsets=tb.agg_offsets, axis=0).T
    xc = torch.bmm(c_inv, rc[:, :, None])[:, :, 0]
    return omega * inv_diag * R + xc[:, tb.agg]
