"""Plain aggregation multigrid: Ginkgo's ``solver::Multigrid`` with
``multigrid::Pgm``'s unsmoothed, piecewise-constant transfer, one V(1,1)
cycle an apply (arXiv:2006.16852).

Worked out again from the host CSR arrays, independent of ``repro_torch``:

* strength: entry (i, j), i ≠ j, is strong when ``|a_ij| >= theta
  sqrt(|a_ii| |a_jj|)`` (a row without a diagonal entry counts 1);
* aggregation: three greedy passes in plain Python — a free row whose
  strong neighbours are all free opens an aggregate of itself and them; a
  free row left joins the aggregate of its first strong neighbour that has
  one; a row still free is an aggregate of its own;
* the coarse operator ``T^T A T`` for ``T[i, agg[i]] = 1``: every fine entry
  added into (agg[i], agg[j]), in float64 (``torch.sparse_coo_tensor``'s
  ``coalesce``);
* levels while a level has more than ``coarse_size`` rows and fewer than
  ``max_levels`` are built, and the aggregation coarsens;
* the cycle: ``pre_sweeps`` of omega-Jacobi (omega 2/3) from x = 0, the
  residual restricted by summing each aggregate's rows, the coarse
  correction (the next level's cycle; at the coarsest level its dense
  inverse, computed in float32 as the port computes it, then stored in the
  working precision), prolonged by copying each aggregate's value to its
  rows, and ``post_sweeps`` of omega-Jacobi.

The operators apply as gather, product and scatter-add in
``compute_dtype``; every stored value is rounded to ``working`` first.

Set-up at 256³ takes about a minute on the host, most of it the Python
passes over level 0's 117M entries; a process that checks many seeds of
one matrix (``control.py``) keeps the float64 hierarchy of the last matrix
it was given (the same array objects and options) and builds it once.

Counts, under ``counting.py``'s rule (each stored input read once, no
padding; ``s`` the working precision's bytes, 4 an index):

* ``storage_bytes``: every level's A (``nnz (s + 4)``), P and R (``n (s +
  4)`` each: one unit entry a fine row) and inverse diagonal (``n s``), and
  the coarse inverse (``n_c² s``);
* ``flops``: the V(1,1) cycle's operations as the apply does them, ``4 nnz
  + 11 n`` a level (two A products, the pre-sweep's scaling, the residuals,
  restriction and prolongation through P's and R's unit values, the
  post-sweep's update) and ``2 n_c²`` for the coarse solve;
* ``class_counts``: rows by level, ``level0`` the finest, the last the
  coarse level.
"""

from __future__ import annotations

import numpy as np
import torch

OMEGA = 2.0 / 3.0


def strength(indptr, indices, values, theta: float) -> np.ndarray:
    n = indptr.shape[0] - 1
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    cols = np.asarray(indices, np.int64)
    a = np.abs(np.asarray(values, np.float64))
    on_diag = rows == cols
    d = np.ones(n, np.float64)
    d[rows[on_diag]] = a[on_diag]
    return ~on_diag & (a >= theta * np.sqrt(d[rows] * d[cols]))


def greedy_aggregates(indptr, indices, strong, n: int):
    """``(agg, n_agg)``: the three passes, in plain Python over each row's
    strong neighbours in CSR order."""
    keep = np.asarray(strong, bool)
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    sp = np.zeros(n + 1, np.int64)
    sp[1:] = np.cumsum(np.bincount(rows[keep], minlength=n))
    nb = np.asarray(indices)[keep].tolist()
    sp = sp.tolist()
    del rows, keep
    agg = [-1] * n
    count = 0
    for i in range(n):
        if agg[i] >= 0:
            continue
        mine = nb[sp[i]:sp[i + 1]]
        for j in mine:
            if agg[j] >= 0:
                break
        else:
            agg[i] = count
            for j in mine:
                agg[j] = count
            count += 1
    for i in range(n):
        if agg[i] < 0:
            for j in nb[sp[i]:sp[i + 1]]:
                if agg[j] >= 0:
                    agg[i] = agg[j]
                    break
    for i in range(n):
        if agg[i] < 0:
            agg[i] = count
            count += 1
    return np.asarray(agg, np.int64), count


class _Level:
    """One level in float64 on the device: its entries (row, column,
    value), inverse diagonal and aggregates."""

    def __init__(self, rows, cols, vals, n: int, agg, n_agg: int):
        self.rows, self.cols, self.vals = rows, cols, vals
        self.n, self.agg, self.n_agg = n, agg, n_agg
        d = torch.zeros(n, dtype=torch.float64, device=vals.device)
        on = rows == cols
        d.index_add_(0, rows[on], vals[on])
        self.inv_d = torch.where(d != 0, 1.0 / torch.where(d != 0, d, 1.0),
                                 torch.zeros_like(d))


def _hierarchy(csr, opts: dict, device):
    """The levels and the coarsest operator (dense), in float64."""
    indptr, indices, values, shape = csr
    dev = torch.device(device)
    n = int(shape[0])
    ip = np.asarray(indptr, np.int64)
    h_cols = np.asarray(indices, np.int64)
    h_vals = np.asarray(values, np.float64)
    rows = torch.repeat_interleave(torch.arange(n, device=dev),
                                   torch.as_tensor(np.diff(ip), device=dev))
    cols = torch.as_tensor(h_cols, device=dev)
    vals = torch.as_tensor(h_vals, device=dev)
    levels = []
    while n > int(opts["coarse_size"]) and len(levels) < int(opts["max_levels"]):
        strong = strength(ip, h_cols, h_vals, float(opts["theta"]))
        agg, n_agg = greedy_aggregates(ip, h_cols, strong, n)
        del strong
        if n_agg >= n:
            break
        agg_t = torch.as_tensor(agg, device=dev)
        levels.append(_Level(rows, cols, vals, n, agg_t, n_agg))
        # T^T A T: each fine entry added into (agg[i], agg[j])
        c = torch.sparse_coo_tensor(torch.stack([agg_t[rows], agg_t[cols]]),
                                    vals, (n_agg, n_agg),
                                    check_invariants=False).coalesce()
        rows, cols = c.indices()
        vals = c.values()
        n = n_agg
        h_cols, h_vals = cols.cpu().numpy(), vals.cpu().numpy()
        ip = np.zeros(n + 1, np.int64)
        ip[1:] = np.cumsum(np.bincount(rows.cpu().numpy(), minlength=n))
    dense = torch.zeros((n, n), dtype=torch.float64, device=dev)
    dense.index_put_((rows, cols), vals, accumulate=True)
    return levels, dense


#: the float64 hierarchy of the last matrix: (arrays, options, hierarchy)
_LAST = []


def _cached_hierarchy(csr, opts: dict, device):
    key = (tuple(sorted((k, repr(v)) for k, v in opts.items())), str(device))
    for arrays, k, h in _LAST:
        if k == key and all(a is b for a, b in zip(arrays, csr[:3])):
            return h
    h = _hierarchy(csr, opts, device)
    _LAST[:] = [(tuple(csr[:3]), key, h)]
    return h


class Multigrid:
    def __init__(self, csr, opts: dict, *, working: torch.dtype,
                 compute_dtype: torch.dtype, device):
        if (opts.get("smooth_prolongator", True) or opts.get("cycle", "v") != "v"
                or opts.get("coarse_solver", "dense") != "dense"
                or opts.get("smoother", "jacobi") != "jacobi"
                or int(opts.get("pre_sweeps", 1)) < 1):
            raise ValueError("the reference multigrid is the unsmoothed V-cycle "
                             "with Jacobi smoothing and a dense coarse solve")
        levels, dense = _cached_hierarchy(csr, opts, device)
        self.pre = int(opts.get("pre_sweeps", 1))
        self.post = int(opts.get("post_sweeps", 1))
        self.omega = float(opts.get("omega", OMEGA))
        self.compute_dtype = compute_dtype

        def stored(t):
            return t.to(working).to(compute_dtype)

        self.levels = [(L, stored(L.vals), stored(L.inv_d)) for L in levels]
        self.coarse_inv = stored(torch.linalg.inv(dense.to(torch.float32)))
        s = torch.finfo(working).bits // 8
        nnzs = [L.vals.shape[0] for L in levels]
        ns = [L.n for L in levels]
        nc = dense.shape[0]
        self.storage_bytes = int(sum(z * (s + 4) + 2 * m * (s + 4) + m * s
                                     for z, m in zip(nnzs, ns)) + nc * nc * s)
        self.flops = int(sum(4 * z + 11 * m for z, m in zip(nnzs, ns))
                         + 2 * nc * nc)
        self.class_counts = {f"level{i}": m for i, m in enumerate(ns + [nc])}

    def _spmv(self, L, vals, x):
        y = torch.zeros(L.n, dtype=self.compute_dtype, device=x.device)
        return y.index_add_(0, L.rows, vals * x[L.cols])

    def _jacobi(self, L, vals, inv_d, x, r, sweeps: int):
        for _ in range(sweeps):
            x = x + self.omega * inv_d * (r - self._spmv(L, vals, x))
        return x

    def _cycle(self, k: int, r):
        if k == len(self.levels):
            return self.coarse_inv @ r
        L, vals, inv_d = self.levels[k]
        x = self.omega * inv_d * r  # the first sweep from x = 0
        x = self._jacobi(L, vals, inv_d, x, r, self.pre - 1)
        res = r - self._spmv(L, vals, x)
        rc = torch.zeros(L.n_agg, dtype=r.dtype, device=r.device)
        rc.index_add_(0, L.agg, res)
        x = x + self._cycle(k + 1, rc)[L.agg]
        return self._jacobi(L, vals, inv_d, x, r, self.post)

    def apply(self, r: torch.Tensor) -> torch.Tensor:
        return self._cycle(0, r.to(self.compute_dtype))


def build(csr, opts: dict, *, working: torch.dtype, compute_dtype: torch.dtype,
          device) -> Multigrid:
    return Multigrid(csr, opts, working=working, compute_dtype=compute_dtype,
                     device=device)
