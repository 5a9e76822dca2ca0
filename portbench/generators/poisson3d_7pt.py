"""7-point 3D Laplacian on an ``n_side``³ grid, as host CSR arrays.

Frozen copy of ``repro_torch.sparse.gallery.poisson_3d``: the same arrays
(int64 row pointers, int32 columns ascending within a row, float32 values:
6 on the diagonal, -1 to each grid neighbour).  It departs in how it builds
them: each row's up to seven entries are laid out directly in column order
on ``device``, so no sort of the 117M triplets runs on the host.
"""

from __future__ import annotations

import torch


def generate(params: dict, *, device) -> tuple:
    """``(indptr, indices, values, shape)``; ``params`` holds ``n_side``."""
    s = int(params["n_side"])
    n = s ** 3
    dev = torch.device(device)
    idx = torch.arange(n, dtype=torch.int64, device=dev)
    gi, gj, gk = idx // (s * s), (idx // s) % s, idx % s
    # the seven columns of a row in ascending order, and which exist
    offs = torch.tensor([-s * s, -s, -1, 0, 1, s, s * s], dtype=torch.int64,
                        device=dev)
    ok = torch.stack([gi > 0, gj > 0, gk > 0, torch.ones_like(gi, dtype=torch.bool),
                      gk < s - 1, gj < s - 1, gi < s - 1], dim=1)
    cols = (idx[:, None] + offs[None, :])[ok]
    vals = torch.where(offs == 0, 6.0, -1.0).to(torch.float32)
    vals = vals.expand(n, 7)[ok]
    indptr = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    indptr[1:] = torch.cumsum(ok.sum(dim=1), dim=0)
    return (indptr.cpu().numpy(), cols.to(torch.int32).cpu().numpy(),
            vals.cpu().numpy(), (n, n))

