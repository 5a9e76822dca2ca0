"""Carry the JAX package's state across: numpy arrays in, the port's objects out.

Each function takes plain numpy arrays — what ``np.asarray`` gives from a JAX
``Coo``/``Csr``/``Ell``/``Sellp``/``BatchCsr``/``BatchEll``/``BlockJacobi``/
``BatchBlockJacobi``/``Multigrid`` field, or a language model's parameter
tree — and builds the port's object on ``device`` (the card unless
``device="cpu"`` is asked for).
Nothing here imports JAX.

A JAX bfloat16 array arrives as an ``ml_dtypes`` numpy array, which
``torch.from_numpy`` refuses; :func:`tensor` moves it through its ``uint16``
bit pattern and reinterprets that as ``torch.bfloat16``.  The way back,
:func:`repro_torch.sparse.formats.host_array`, gives bfloat16 as those
``uint16`` bits.
"""

from __future__ import annotations

from typing import Mapping, Sequence, Tuple

import numpy as np
import torch

from repro_torch.batch.formats import BatchCsr, BatchEll
from repro_torch.precond.amg import AmgLevel, Multigrid
from repro_torch.precond.block_jacobi import BatchBlockJacobi, BlockJacobi
from repro_torch.sparse.formats import Coo, Csr, Ell, Sellp, _device, host_array

__all__ = ["tensor", "coo", "csr", "ell", "sellp", "batch_csr", "batch_ell",
           "block_jacobi", "batch_block_jacobi", "multigrid", "host_array",
           "lm_params", "deq_params_from_jax", "dist_csr", "dist_ell"]


def tensor(a, *, device=None, dtype=None) -> torch.Tensor:
    """A numpy array (bfloat16 included) as a tensor on ``device``."""
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:  # a JAX array's numpy view is read-only
        a = a.copy()
    dev = _device(device)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device=dev, dtype=dtype or t.dtype)


def csr(indptr, indices, values, shape: Tuple[int, int], *, device=None) -> Csr:
    return Csr(
        indptr=tensor(indptr, device=device, dtype=torch.int32),
        indices=tensor(indices, device=device, dtype=torch.int32),
        values=tensor(values, device=device),
        shape=tuple(int(s) for s in shape),
    )


def ell(col_idx, values, shape: Tuple[int, int], *, device=None) -> Ell:
    return Ell(
        col_idx=tensor(col_idx, device=device, dtype=torch.int32),
        values=tensor(values, device=device),
        shape=tuple(int(s) for s in shape),
    )


def coo(row_idx, col_idx, values, shape: Tuple[int, int], *, device=None) -> Coo:
    return Coo(
        row_idx=tensor(row_idx, device=device, dtype=torch.int32),
        col_idx=tensor(col_idx, device=device, dtype=torch.int32),
        values=tensor(values, device=device),
        shape=tuple(int(s) for s in shape),
    )


def sellp(col_idx, values, slice_sets, slice_cols, shape: Tuple[int, int],
          slice_size: int, stride_factor: int, max_slice_cols: int, *,
          device=None) -> Sellp:
    return Sellp(
        col_idx=tensor(col_idx, device=device, dtype=torch.int32),
        values=tensor(values, device=device),
        slice_sets=tensor(slice_sets, device=device, dtype=torch.int32),
        slice_cols=tensor(slice_cols, device=device, dtype=torch.int32),
        shape=tuple(int(s) for s in shape),
        slice_size=int(slice_size),
        stride_factor=int(stride_factor),
        max_slice_cols=int(max_slice_cols),
    )


def batch_csr(indptr, indices, values, shape: Tuple[int, int], *,
              device=None) -> BatchCsr:
    return BatchCsr(
        indptr=tensor(indptr, device=device, dtype=torch.int32),
        indices=tensor(indices, device=device, dtype=torch.int32),
        values=tensor(values, device=device),
        shape=tuple(int(s) for s in shape),
    )


def batch_ell(col_idx, values, shape: Tuple[int, int], *, device=None) -> BatchEll:
    return BatchEll(
        col_idx=tensor(col_idx, device=device, dtype=torch.int32),
        values=tensor(values, device=device),
        shape=tuple(int(s) for s in shape),
    )


def batch_block_jacobi(inv_blocks: Sequence, perm, inv_perm, gather_idx, n: int,
                       num_blocks: int, block_size: int, *, device=None,
                       executor=None) -> BatchBlockJacobi:
    """A :class:`BatchBlockJacobi` from the JAX package's generated arrays."""
    return BatchBlockJacobi(
        inv_blocks=tuple(tensor(t, device=device) for t in inv_blocks),
        perm=tensor(perm, device=device, dtype=torch.int64),
        inv_perm=tensor(inv_perm, device=device, dtype=torch.int64),
        gather_idx=tensor(gather_idx, device=device, dtype=torch.int64),
        n=int(n),
        num_blocks=int(num_blocks),
        block_size=int(block_size),
        executor=executor,
    )


def block_jacobi(inv_blocks: Sequence, gather_idx, scatter_idx, n: int,
                 block_size: int, num_blocks: int, *, device=None,
                 executor=None) -> BlockJacobi:
    """A :class:`BlockJacobi` from the JAX package's generated arrays (one
    inverted-block array per storage class, bf16 included)."""
    return BlockJacobi(
        inv_blocks=tuple(tensor(t, device=device) for t in inv_blocks),
        gather_idx=tensor(gather_idx, device=device, dtype=torch.int64),
        scatter_idx=tensor(scatter_idx, device=device, dtype=torch.int64),
        n=int(n),
        block_size=int(block_size),
        num_blocks=int(num_blocks),
        executor=executor,
    )


def multigrid(levels: Sequence[Mapping], coarse_A, coarse_inv, *,
              cycle: str = "v", omega: float = 2.0 / 3.0, pre_sweeps: int = 1,
              post_sweeps: int = 1, device=None, executor=None) -> Multigrid:
    """A :class:`Multigrid` over the JAX package's hierarchy, with no setup.

    Each level is a mapping with ``"A"``, ``"P"``, ``"R"`` as CSR
    ``(indptr, indices, values, shape)``, their ELL mirrors ``"A_op"``,
    ``"P_op"``, ``"R_op"`` as ``(col_idx, values, shape)``, and
    ``"inv_diag"``; ``coarse_A`` is a CSR quadruple and ``coarse_inv`` the
    dense coarse inverse.  Weighted-Jacobi smoothing, dense coarse solve.
    """
    built = [
        AmgLevel(
            A=csr(*L["A"], device=device),
            P=csr(*L["P"], device=device),
            R=csr(*L["R"], device=device),
            A_op=ell(*L["A_op"], device=device),
            P_op=ell(*L["P_op"], device=device),
            R_op=ell(*L["R_op"], device=device),
            inv_diag=tensor(L["inv_diag"], device=device),
        )
        for L in levels
    ]
    return Multigrid.from_levels(
        built, csr(*coarse_A, device=device),
        tensor(coarse_inv, device=device), cycle=cycle, omega=omega,
        pre_sweeps=pre_sweeps, post_sweeps=post_sweeps, executor=executor,
    )


def lm_params(cfg, params: Mapping, *, device=None):
    """The JAX package's ``lm.init_model`` parameters (nested dicts of numpy
    arrays: ``jax.tree_util.tree_map(np.asarray, params)``) as the port's
    :class:`~repro_torch.nn.common.ParamTree` for ``cfg``.

    The stacked layers are unstacked: for the hybrid family ``mamba`` leaves
    ``(G, per, ...)`` become ``G`` lists of ``per`` layers and ``lora``
    leaves ``(G, ...)`` ``G`` layers; for the other families the nested
    ``blocks`` tree (RWKV6's ``ln1``, ``time_mix``, ``ln2``,
    ``channel_mix``; a transformer's ``norm1``, ``attn`` — GQA's ``wq`` ...
    or MLA's projections and norms — ``norm2`` and ``mlp`` or ``moe`` with
    its ``(E_pad, ...)`` expert stacks), whose leaves are ``(n_layers,
    ...)``, becomes ``n_layers`` layers of the same tree.  Every
    leaf's shape and dtype is checked against the port's own init for
    ``cfg``, and a missing or left-over key raises."""
    from repro_torch.models import lm
    from repro_torch.nn.common import ParamTree

    expected = lm.init_model(cfg, device="meta")
    src = dict(params)

    def take(node, j, n, where):
        """Layer ``j`` of a stacked (sub)tree whose leaves lead with ``n``."""
        if isinstance(node, Mapping):
            return {key: take(leaf, j, n, f"{where}.{key}")
                    for key, leaf in node.items()}
        a = np.asarray(node)
        if a.shape[:1] != (n,):
            raise ValueError(f"{where}: stacked shape {a.shape} does not lead "
                             f"with {n}")
        return a[j]

    def unstack(tree, dims, where):
        """Split the leading ``dims`` axes of every leaf into nested lists."""
        if not isinstance(tree, Mapping):
            raise ValueError(f"{where}: expected a mapping of stacked leaves")
        n = dims[0]
        out = []
        for j in range(n):
            layer = take(tree, j, n, where)
            out.append(unstack(layer, dims[1:], f"{where}[{j}]")
                       if len(dims) > 1 else layer)
        return out

    if cfg.family != "hybrid":
        if "blocks" in src:
            src["blocks"] = unstack(src["blocks"], (cfg.n_layers,), "blocks")
    else:
        G, per = lm._zamba_groups(cfg)
        if "mamba" in src:
            src["mamba"] = unstack(src["mamba"], (G, per), "mamba")
        if "lora" in src:
            src["lora"] = unstack(src["lora"], (G,), "lora")

    def build(node, ref, where):
        if isinstance(ref, torch.Tensor):
            if isinstance(node, (Mapping, list)):
                raise ValueError(f"{where}: expected an array")
            a = np.asarray(node)
            if tuple(a.shape) != tuple(ref.shape):
                raise ValueError(f"{where}: shape {tuple(a.shape)} != "
                                 f"{tuple(ref.shape)} of {cfg.name}")
            t = tensor(a, device=device)
            if t.dtype != ref.dtype:
                raise ValueError(f"{where}: dtype {t.dtype} != {ref.dtype}")
            return t
        if isinstance(ref, torch.nn.ModuleList):
            if not isinstance(node, list) or len(node) != len(ref):
                raise ValueError(f"{where}: expected {len(ref)} layers")
            return [build(n, r, f"{where}[{i}]")
                    for i, (n, r) in enumerate(zip(node, ref))]
        if not isinstance(node, Mapping):
            raise ValueError(f"{where}: expected a mapping")
        missing = sorted(set(ref.keys()) - set(node))
        extra = sorted(set(node) - set(ref.keys()))
        if missing or extra:
            raise ValueError(f"{where or 'params'}: missing keys {missing}, "
                             f"left-over keys {extra}")
        return {k: build(node[k], ref[k], f"{where}.{k}" if where else k)
                for k in ref.keys()}

    return ParamTree(build(src, expected, ""))


def deq_params_from_jax(params: Mapping, cfg=None, *, device=None):
    """The JAX package's ``init_deq`` parameters (``theta``, ``w_in``,
    ``w_out``, numpy arrays) as the port's parameter dict, on ``cfg``'s
    device and dtype when a :class:`~repro_torch.models.deq.DeqConfig` is
    given, else on ``device``; shapes checked against ``cfg``."""
    want = None if cfg is None else {"theta": (cfg.nnz,),
                                     "w_in": (cfg.n, cfg.d_in),
                                     "w_out": (cfg.n,)}
    if set(params) != {"theta", "w_in", "w_out"}:
        raise ValueError(f"DEQ parameters are theta, w_in and w_out, got "
                         f"{sorted(params)}")
    out = {}
    for key, a in params.items():
        a = np.asarray(a)
        if want is not None and tuple(a.shape) != want[key]:
            raise ValueError(f"{key}: shape {a.shape} != {want[key]}")
        out[key] = tensor(a, device=cfg.device if cfg is not None else device,
                          dtype=None if cfg is None else cfg.dtype)
    return out


def _dist(cls, fields: Mapping, shape, nnz: int, offsets, halo_counts, rank,
          device):
    from repro_torch.distributed import Partition

    fields = {k: np.asarray(v) for k, v in fields.items()}
    fields["halo_counts"] = tuple(halo_counts)
    return cls.from_stacked(fields, shape=tuple(shape), nnz=nnz,
                            partition=Partition(tuple(offsets)), rank=rank,
                            device=device)


def dist_csr(fields: Mapping, shape, nnz: int, offsets, halo_counts, *,
             rank=None, device=None):
    """The JAX package's ``DistCsr`` (its stacked ``(P, ...)`` fields as
    numpy arrays, keyed by field name, and its static ``shape``, ``nnz``,
    partition offsets and ``_halo_counts``) as this rank's port
    :class:`~repro_torch.distributed.DistCsr`; ``rank`` defaults to the
    process group's."""
    from repro_torch.distributed import DistCsr

    return _dist(DistCsr, fields, shape, nnz, offsets, halo_counts, rank,
                 device)


def dist_ell(fields: Mapping, shape, nnz: int, offsets, halo_counts, *,
             rank=None, device=None):
    """The JAX package's ``DistEll`` as this rank's port
    :class:`~repro_torch.distributed.DistEll` (arguments as :func:`dist_csr`)."""
    from repro_torch.distributed import DistEll

    return _dist(DistEll, fields, shape, nnz, offsets, halo_counts, rank,
                 device)
