"""Shifted graph Laplacian ``L + shift·I`` of a Graph 500 Kronecker graph, as
host CSR arrays.

The graph is the Graph 500 specification's (its Kronecker generator, the
Octave ``kronecker_generator`` of the spec): ``edgefactor · 2^scale`` edges,
each endpoint's ``scale`` bits drawn quadrant by quadrant from the initiator
A, B, C (D = 1 - A - B - C), then the vertex labels permuted at random.  The
spec's last step, a shuffle of the edge list, changes no graph and is left
out.  The draws are ``torch.rand`` (float64, as the spec's doubles) and
``torch.randperm`` on ``device`` from a ``torch.Generator`` seeded with
``graph_seed``, in the spec's order: for each bit the row draws, then the
column draws; the permutation last.

Graph 500 defines a graph and no linear system; the Laplacian is this
benchmark's: self-loops dropped, parallel edges merged, unit weights, the
degree plus ``shift`` on the diagonal (the shift makes it SPD: a Kronecker
graph leaves many vertices isolated).  Arrays: int64 row pointers, int32
columns ascending within a row, float32 values.
"""

from __future__ import annotations

import torch


def kronecker_edges(params: dict, *, device) -> tuple:
    """``(i, j, n)``: the spec's edge list (int64, on ``device``) and the
    vertex count."""
    scale = int(params["scale"])
    n = 1 << scale
    m = int(params["edgefactor"]) * n
    a, b, c = (float(params[k]) for k in ("A", "B", "C"))
    ab = a + b
    c_norm = c / (1.0 - ab)
    a_norm = a / ab
    dev = torch.device(device)
    g = torch.Generator(device=dev).manual_seed(int(params["graph_seed"]))
    i = torch.zeros(m, dtype=torch.int64, device=dev)
    j = torch.zeros(m, dtype=torch.int64, device=dev)
    for bit in range(scale):
        ii = torch.rand(m, generator=g, dtype=torch.float64, device=dev) > ab
        jj = torch.rand(m, generator=g, dtype=torch.float64, device=dev) > torch.where(
            ii, c_norm, a_norm)
        i += ii.to(torch.int64) << bit
        j += jj.to(torch.int64) << bit
    p = torch.randperm(n, generator=g, device=dev)
    return p[i], p[j], n


def generate(params: dict, *, device) -> tuple:
    """``(indptr, indices, values, shape)``; ``params`` holds ``scale``,
    ``edgefactor``, ``A``, ``B``, ``C``, ``shift`` and ``graph_seed``."""
    i, j, n = kronecker_edges(params, device=device)
    shift = float(params["shift"])
    keep = i != j
    i, j = i[keep], j[keep]
    edges = torch.unique(torch.minimum(i, j) * n + torch.maximum(i, j))
    del i, j, keep
    lo, hi = edges // n, edges % n
    del edges
    dev = lo.device
    diag = torch.arange(n, dtype=torch.int64, device=dev)
    deg = torch.bincount(torch.cat([lo, hi]), minlength=n)
    rows = torch.cat([lo, hi, diag])
    cols = torch.cat([hi, lo, diag])
    vals = torch.cat([
        torch.full((2 * lo.numel(),), -1.0, dtype=torch.float64, device=dev),
        deg.to(torch.float64) + shift,
    ])
    del lo, hi, diag
    order = torch.sort(rows * n + cols).indices  # keys distinct: row-major
    rows, cols, vals = rows[order], cols[order], vals[order]
    indptr = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    indptr[1:] = torch.cumsum(torch.bincount(rows, minlength=n), dim=0)
    return (indptr.cpu().numpy(), cols.to(torch.int32).cpu().numpy(),
            vals.to(torch.float32).cpu().numpy(), (n, n))
