"""Plain block-Jacobi with adaptive storage precision (Ginkgo's
``preconditioner::Jacobi`` with ``storage_optimization``, arXiv:2006.16852).

Worked out again from the host CSR arrays, independent of ``repro_torch``:
the rows are cut into uniform blocks of ``block_size`` (the last one
shorter), each diagonal block is gathered densely, inverted in float64
(``torch.linalg.inv``; a singular block stays the identity), and stored in
the cheapest precision p whose unit roundoff u_p keeps ``kappa_1 * u_p <=
tau`` (``kappa_1`` the block's 1-norm condition number over its true rows
and columns; fp16 also needs every entry of the inverse below 65504, bf16
is the wide-range fallback, else the working precision).  A padding row,
and a row with no entry inside its block, get a 1 on the diagonal.

``apply`` computes ``z = blockdiag(inv) r`` in ``compute_dtype`` from the
stored blocks.
"""

from __future__ import annotations

import numpy as np
import torch

FP16_MAX = 65504.0


def unit_roundoff(dtype: torch.dtype) -> float:
    return float(torch.finfo(dtype).eps) / 2.0


def _norm1(t: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Largest column sum of |t| over each block's true corner."""
    m = t.abs() * valid[:, :, None] * valid[:, None, :]
    return m.sum(dim=1).amax(dim=1)


class BlockJacobi:
    def __init__(self, csr, *, block_size: int, adaptive: bool, tau: float,
                 working: torch.dtype, compute_dtype: torch.dtype, device):
        indptr, indices, values, shape = csr
        n = int(shape[0])
        bs = int(block_size)
        dev = torch.device(device)
        nb = (n + bs - 1) // bs
        self.n, self.bs, self.nb = n, bs, nb
        self.compute_dtype = compute_dtype
        rows = torch.repeat_interleave(
            torch.arange(n, device=dev), torch.as_tensor(np.diff(indptr), device=dev))
        cols = torch.as_tensor(indices, device=dev).long()
        vals = torch.as_tensor(values, device=dev).double()
        blk = rows // bs
        inside = (cols // bs) == blk
        blocks = torch.zeros(nb, bs, bs, dtype=torch.float64, device=dev)
        blocks[blk[inside], (rows - blk * bs)[inside], (cols - blk * bs)[inside]] = \
            vals[inside]
        del rows, cols, vals, blk, inside
        local = torch.arange(bs, device=dev)
        sizes = torch.clamp(n - torch.arange(nb, device=dev) * bs, max=bs)
        valid = local[None, :] < sizes[:, None]  # (nb, bs)
        empty = valid & ~(blocks != 0).any(dim=2)
        diag_one = (~valid | empty).double()
        blocks += torch.diag_embed(diag_one)
        inv, info = torch.linalg.inv_ex(blocks)
        bad = (info != 0) | ~torch.isfinite(inv).flatten(1).all(dim=1)
        eye = torch.eye(bs, dtype=torch.float64, device=dev)
        inv = torch.where(bad[:, None, None], eye, inv)

        classes = (working, torch.bfloat16, torch.float16)
        if adaptive:
            vf = valid.double()
            kappa = torch.clamp(_norm1(blocks, vf) * _norm1(inv, vf), min=1.0)
            maxabs = inv.abs().flatten(1).amax(dim=1)
            fp16 = (kappa * unit_roundoff(torch.float16) <= tau) & (maxabs < FP16_MAX)
            bf16 = kappa * unit_roundoff(torch.bfloat16) <= tau
            cid = torch.where(fp16, 2, torch.where(bf16, 1, 0))
        else:
            cid = torch.zeros(nb, dtype=torch.int64, device=dev)
        del blocks
        stored = torch.empty_like(inv)
        counts = {}
        for c, dt in enumerate(classes):
            sel = cid == c
            k = int(sel.sum())
            if k:
                stored[sel] = inv[sel].to(dt).double()
                counts[str(dt).removeprefix("torch.")] = k
        self.class_counts = counts
        #: bytes of the stored inverses, true rows and columns only
        sq = sizes.double() ** 2
        self.storage_bytes = int(sum(
            float(sq[cid == c].sum()) * torch.finfo(dt).bits // 8
            for c, dt in enumerate(classes)))
        self.flops = int(2 * float(sq.sum()))
        self.inv = stored.to(compute_dtype)

    def apply(self, r: torch.Tensor) -> torch.Tensor:
        pad = self.nb * self.bs - self.n
        rp = torch.cat([r.to(self.compute_dtype), r.new_zeros(pad, dtype=self.compute_dtype)])
        z = torch.bmm(self.inv, rp.view(self.nb, self.bs, 1)).view(-1)
        return z[:self.n]


def build(csr, opts: dict, *, working: torch.dtype, compute_dtype: torch.dtype,
          device) -> BlockJacobi:
    return BlockJacobi(csr, block_size=opts["block_size"],
                       adaptive=bool(opts.get("adaptive", False)),
                       tau=float(opts["tau"]), working=working,
                       compute_dtype=compute_dtype, device=device)
