"""Dry run on the ``meta`` device: build every (arch x shape x mesh) cell and
cost one step of it, with nothing allocated.

The port of ``repro/launch/dryrun.py``.  The JAX package lowers and compiles
each cell under 512 placeholder devices and reads the compiler's memory and
collective census; the port runs the step itself on ``meta`` tensors
(:mod:`repro_torch.launch.costmodel`).  Per cell:

1. the production mesh's shape (16 x 16, or 2 x 16 x 16 with
   ``--multi-pod``), and each leaf's split across its ranks from
   ``train_shardings`` and the cache and batch specs
   (:mod:`repro_torch.distributed.sharding`): the per-rank bytes of
   parameters, moments, cache and batch;
2. the **logical cost**: one step at the global batch in the torch space
   (the portable path, the JAX package's XLA space), whole, on one
   process; FLOPs and bytes divided by the chip count give the per-device
   terms, as in the JAX package (exact for an evenly split program);
3. the **one-card share**: one data-parallel replica with the model axis
   folded onto one card (the global batch over the data ranks, the full
   sequence, the whole model) in the cuda space, the kernels as units: its
   peak of live tensor bytes (the peak tracker), FLOPs and bytes;
   ``chip_smoke.py`` runs these shares on the card;
4. the **collective census**, from the port's own rules: the collectives
   the step's code issues on rank 0 of the mesh, counted by running the
   share on a mesh of census groups
   (:func:`repro_torch.launch.mesh.make_census_mesh`; the expert-parallel
   MoE dispatch of :mod:`repro_torch.distributed.parallel` is the port's
   only tensor-parallel code), plus, for a training step, the data-parallel
   gradient reduction the moment and parameter specs imply (one collective a
   leaf: an all-reduce, or with ZeRO-1 a reduce-scatter of the gradient and
   an all-gather of the updated parameters; FSDP adds the parameters'
   all-gathers in forward and in backward);
5. the roofline from the ``h100`` target: 989 TFLOP/s bf16, 3.35 TB/s HBM
   and NVLink's published 450 GB/s a direction.

MoE runs its expert-parallel capacity dispatch (``moe_dispatch="gather"``,
as the JAX dry run costs it): the logical cost and the share take the
fixed-capacity body at one rank (all experts, a capacity of
``capacity_factor * T * k`` rows), the census the body at rank 0 of the
model axis.  On ``meta`` its grouped GEMM splits the rows over the experts
evenly (:mod:`repro_torch.nn.moe`), so no value is read on the host.  The
dense oracle would cost every expert on every token: 15x qwen2-moe's
routed-expert work and a (tokens, experts, d_expert) intermediate in the
peak, which neither the serving route nor the capacity body has.

Every record goes to ``experiments/dryrun_torch/<arch>__<shape>.json``.

Usage:
    python -m repro_torch.launch.dryrun --arch granite-8b --shape train_4k
    python -m repro_torch.launch.dryrun --all [--multi-pod] [--zero zero1|fsdp]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs import ARCH_IDS, SHAPES, cells, get_config
from repro_torch.core import make_executor
from repro_torch.core import tree as tree_lib
from repro_torch.core.params import get_target
from repro_torch.distributed import comm
from repro_torch.distributed import sharding as shd
from repro_torch.launch import costmodel
from repro_torch.launch import steps as steps_lib
from repro_torch.launch.mesh import Mesh, make_census_mesh, use_mesh
from repro_torch.models import lm
from repro_torch.nn.common import trainable
from repro_torch.observability import trace
from repro_torch.optim import adamw, warmup_cosine_schedule

__all__ = ["OUT_DIR", "WIRE_FACTOR", "Cell", "build_cell", "run_cell",
           "run_all", "production_mesh", "spec_bytes", "dp_census",
           "census_of", "code_census", "main"]

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "experiments", "dryrun_torch")

#: bytes on the wire per result byte (ring algorithms), as the JAX package
WIRE_FACTOR = {
    "all-reduce": 2.0,  # reduce-scatter + all-gather
    "all-gather": 1.0,
    "reduce-scatter": 1.0,
    "all-to-all": 1.0,
    "collective-permute": 1.0,
}


def production_mesh(multi_pod: bool) -> Mesh:
    """The production mesh's shape (no world): 16 x 16 or 2 x 16 x 16."""
    return Mesh({"pod": 2, "data": 16, "model": 16} if multi_pod
                else {"data": 16, "model": 16})


def _folded(mesh: Mesh) -> Mesh:
    """Every axis of ``mesh`` at size 1: the model on one process."""
    return Mesh({name: 1 for name in mesh.axis_names})


def spec_bytes(t: torch.Tensor, spec, mesh: Mesh) -> float:
    """Bytes of the block of ``t`` one rank holds under ``spec``."""
    parts = 1
    for entry in spec:
        if entry is not None:
            parts *= mesh.axis_size(entry)
    return t.numel() * t.element_size() / parts


def _tree_bytes(tree, specs, mesh: Mesh) -> float:
    leaves = tree_lib.leaves(tree)
    spec_leaves = tree_lib.leaves(specs, is_leaf=_is_spec)
    return float(sum(spec_bytes(t, s, mesh)
                     for t, s in zip(leaves, spec_leaves)))


def _is_spec(x) -> bool:
    return isinstance(x, tuple) and all(
        e is None or isinstance(e, (str, tuple)) for e in x)


@dataclasses.dataclass
class Cell:
    """One (arch x shape x mesh) cell: its config, mesh shape, specs and a
    factory of the step and its ``meta`` arguments at a batch."""

    arch: str
    shape_name: str
    cfg: Any
    shape: Any
    mesh: Mesh
    zero: str
    optimizer: Any
    specs: Dict[str, Any]

    @property
    def data_ranks(self) -> int:
        return self.mesh.axis_size(shd.data_axes(self.mesh))

    @property
    def share_batch(self) -> int:
        """One data-parallel replica's share of the global batch."""
        return max(1, self.shape.global_batch // self.data_ranks)

    def step(self, executor) -> Callable:
        kind = self.shape.kind
        if kind == "train":
            return steps_lib.make_train_step(self.cfg, self.optimizer,
                                             executor=executor)
        if kind == "prefill":
            return steps_lib.make_prefill_step(self.cfg, executor=executor)
        return steps_lib.make_decode_step(self.cfg, executor=executor)

    def args(self, batch: int) -> Tuple:
        """The step's ``meta`` arguments at ``batch`` sequences."""
        cfg, S = self.cfg, self.shape.seq_len
        params = steps_lib.model_shapes_and_axes(cfg)[0]
        kind = self.shape.kind
        if kind == "train":
            params = trainable(params)
            return (params, self.optimizer.init(params),
                    steps_lib.batch_struct(cfg, batch, S))
        cache = steps_lib.cache_struct(cfg, batch, S)
        if kind == "prefill":
            b = steps_lib.batch_struct(cfg, batch, S)
            b.pop("labels")
            return params, b, cache
        b = steps_lib.batch_struct(cfg, batch, 1)
        b.pop("labels")
        return params, b, S - 1, cache


def build_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
               zero: str = "zero1", attn: str = "chunked", sp: bool = True,
               capacity: Optional[float] = None, remat: str = "block",
               moe_dispatch: str = "gather") -> Cell:
    """The cell's config, as the JAX package's ``build_cell`` sets it
    (attention, remat for training, sequence-parallel residuals, the
    expert-parallel MoE dispatch), and its specs on the production mesh."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    cfg = dataclasses.replace(cfg, attn_impl=attn)
    if shape.kind == "train":
        cfg = dataclasses.replace(cfg, remat=remat)
    batch_axes = ("pod", "data") if multi_pod else ("data",)
    if sp and shape.kind in ("train", "prefill") and shape.seq_len % 16 == 0:
        cfg = dataclasses.replace(cfg, sp_spec=(batch_axes, "model"))
    if cfg.family == "moe":
        cfg = dataclasses.replace(cfg, moe_spec=(batch_axes, "model"),
                                  moe_dispatch=moe_dispatch)
        if capacity is not None:
            cfg = dataclasses.replace(cfg, moe_capacity_factor=capacity)
    mesh = production_mesh(multi_pod)
    opt = adamw(warmup_cosine_schedule(3e-4, 2000, 100_000))
    shapes, axes, p_sh, opt_shapes, opt_sh = steps_lib.train_shardings(
        mesh, cfg, opt, zero=zero)
    specs = {"params": p_sh, "mu": opt_sh.mu, "nu": opt_sh.nu,
             "param_shapes": shapes, "opt_shapes": opt_shapes}
    B, S = shape.global_batch, shape.seq_len
    if shape.kind != "train":
        cache = steps_lib.cache_struct(cfg, B, S)
        specs["cache_shapes"] = cache
        specs["cache"] = shd.cache_shardings(mesh, cache, lm.cache_axes(cfg))
    batch = steps_lib.batch_struct(cfg, B, S if shape.kind != "decode" else 1)
    if shape.kind != "train":
        batch.pop("labels")
    specs["batch_shapes"] = batch
    specs["batch"] = shd.batch_shardings(mesh, batch)
    return Cell(arch, shape_name, cfg, shape, mesh, zero, opt, specs)


def dp_census(cell: Cell) -> Dict[str, Dict[str, float]]:
    """The data-parallel gradient reduction of one training step over the
    data axes, one collective a parameter leaf, with result bytes: an
    all-reduce of the gradient, or (the leaf's moments split over the data
    axes, ZeRO-1) a reduce-scatter of it and an all-gather of the updated
    parameters; FSDP (the parameters split over the data axes) gathers the
    parameters in forward and again in backward."""
    census: Dict[str, Dict[str, float]] = {}
    if cell.shape.kind != "train" or cell.data_ranks == 1:
        return census
    mesh, daxes = cell.mesh, set(shd.data_axes(cell.mesh))

    def add(kind, nbytes, n=1):
        e = census.setdefault(kind, {"count": 0, "bytes": 0.0})
        e["count"] += n
        e["bytes"] += n * nbytes

    def on_data(spec) -> bool:
        return any(e is not None and set((e,) if isinstance(e, str) else e)
                   & daxes for e in spec)

    leaves = tree_lib.leaves(cell.specs["param_shapes"])
    p_specs = tree_lib.leaves(cell.specs["params"], is_leaf=_is_spec)
    m_specs = tree_lib.leaves(cell.specs["mu"], is_leaf=_is_spec)
    for t, ps, ms in zip(leaves, p_specs, m_specs):
        # the parameter as the model axis splits it (gathered over data)
        full = spec_bytes(t, [e if e == "model" else None for e in ps], mesh)
        shard = spec_bytes(t, ms, mesh)
        if on_data(ps):  # FSDP
            add("all-gather", full, 2)
            add("reduce-scatter", spec_bytes(t, ps, mesh))
        elif on_data(ms):  # ZeRO-1
            add("reduce-scatter", shard)
            add("all-gather", full)
        else:
            add("all-reduce", full)
    return census


def _add_census(a: Dict, b: Dict) -> Dict:
    out = {k: dict(v) for k, v in a.items()}
    for k, v in b.items():
        e = out.setdefault(k, {"count": 0, "bytes": 0.0})
        e["count"] += v["count"]
        e["bytes"] += v["bytes"]
    return out


def _cost(cell: Cell, executor, batch: int, mesh: Mesh) -> Dict[str, Any]:
    step, args = cell.step(executor), cell.args(batch)
    with use_mesh(mesh):
        return costmodel.function_cost(step, *args)


def census_of(step: Callable, args: Tuple, mesh_shape) -> Dict[str, Dict[str, float]]:
    """The collectives ``step(*args)`` issues on rank 0 of a mesh of
    ``mesh_shape`` (census groups: nothing moves), by kind, with their
    results' bytes."""
    comm.reset_collective_counts()
    with use_mesh(make_census_mesh(mesh_shape)):
        costmodel.function_cost(step, *args)
    counts, nbytes = comm.collective_counts(), comm.collective_bytes()
    comm.reset_collective_counts()
    return {k: {"count": counts[k], "bytes": float(nbytes[k])}
            for k in comm.TRAIN_KINDS if counts[k]}


def code_census(cell: Cell) -> Dict[str, Dict[str, float]]:
    """The collectives the cell's step code issues on rank 0 of its mesh at
    the share's batch (the expert-parallel MoE dispatch; none elsewhere)."""
    if not cell.cfg.moe_spec:
        return {}
    return census_of(cell.step(make_executor("cuda", device="meta")),
                     cell.args(cell.share_batch), cell.mesh.shape)


def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
             zero: str = "zero1", attn: str = "chunked", sp: bool = True,
             capacity: Optional[float] = None, remat: str = "block",
             moe_dispatch: str = "gather", kernel_cost: bool = False,
             tag: str = "", save: bool = True, verbose: bool = True) -> Dict:
    hw = get_target("h100")
    t0 = time.perf_counter()
    cell = build_cell(arch, shape_name, multi_pod=multi_pod, zero=zero,
                      attn=attn, sp=sp, capacity=capacity, remat=remat,
                      moe_dispatch=moe_dispatch)
    n_chips, shape, mesh = cell.mesh.size, cell.shape, cell.mesh
    folded = _folded(mesh)
    logical = _cost(cell, make_executor("torch", device="meta"),
                    shape.global_batch, folded)
    share = _cost(cell, make_executor("cuda", device="meta"),
                  cell.share_batch, folded)
    logical_kernel = None
    if kernel_cost and shape.kind in ("prefill", "decode"):
        logical_kernel = _cost(cell, make_executor("cuda", device="meta"),
                               shape.global_batch, folded)
    census = _add_census(code_census(cell), dp_census(cell))
    build_s = time.perf_counter() - t0

    sp_ = cell.specs
    per_rank = {
        "params": _tree_bytes(sp_["param_shapes"], sp_["params"], mesh),
        "moments": (_tree_bytes(sp_["opt_shapes"].mu, sp_["mu"], mesh)
                    + _tree_bytes(sp_["opt_shapes"].nu, sp_["nu"], mesh))
        if shape.kind == "train" else 0.0,
        "cache": (_tree_bytes(sp_["cache_shapes"], sp_["cache"], mesh)
                  if "cache" in sp_ else 0.0),
        "batch": float(sum(spec_bytes(t, sp_["batch"][k], mesh)
                           for k, t in sp_["batch_shapes"].items())),
    }
    coll_bytes = sum(e["bytes"] * WIRE_FACTOR[op] for op, e in census.items())
    peak_flops, hbm, link = (hw.peak_flops_bf16, hw.hbm_bandwidth,
                             hw.interconnect_bandwidth)
    mflops, n_total, n_active = costmodel.model_flops(cell.cfg, shape)
    compute_t = logical["flops"] / n_chips / peak_flops
    memory_t = logical["fused_bytes"] / n_chips / hbm
    memory_t_unfused = logical["bytes"] / n_chips / hbm
    collective_t = coll_bytes / link

    share_compute, share_memory = (share["flops"] / peak_flops,
                                   share["fused_bytes"] / hbm)
    result = {
        "arch": arch,
        "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "chips": n_chips,
        "zero": zero,
        "attn": attn,
        "sp": sp,
        "tag": tag,
        "build_s": build_s,
        "per_device": {
            "logical_flops": logical["flops"] / n_chips,
            "logical_bytes_unfused": logical["bytes"] / n_chips,
            "logical_bytes_fused_est": logical["fused_bytes"] / n_chips,
            # no compiler: the port's counts are the walker's only
            "hlo_flops_raw": None,
            "hlo_bytes_raw": None,
            "collective_bytes_wire": coll_bytes,
        },
        "memory_analysis": {
            # per rank from the specs; the peak is the one-card share's
            "argument_bytes": sum(per_rank.values()),
            "output_bytes": (per_rank["params"] + per_rank["moments"]
                             if shape.kind == "train" else per_rank["cache"]),
            "temp_bytes": None,
            "peak_bytes": share["peak_bytes"],
        },
        "per_rank_bytes": per_rank,
        "collectives": census,
        "roofline": {
            "compute_s": compute_t,
            "memory_s": memory_t,
            "memory_s_unfused": memory_t_unfused,
            "collective_s": collective_t,
            "bottleneck": max(
                ("compute", compute_t), ("memory", memory_t),
                ("collective", collective_t), key=lambda kv: kv[1])[0],
        },
        "model_flops": {
            "total_params": n_total,
            "active_params": n_active,
            "model_flops_global": mflops,
            "model_flops_per_chip": mflops / n_chips,
            "useful_fraction": (mflops / logical["flops"]
                                if logical["flops"] else None),
        },
        "share": {
            "batch": cell.share_batch,
            "seq_len": shape.seq_len,
            "kind": shape.kind,
            "peak_bytes": share["peak_bytes"],
            "flops": share["flops"],
            "bytes": share["bytes"],
            "fused_bytes": share["fused_bytes"],
            "kernel_units": share["units"],
            "roofline": {"compute_s": share_compute, "memory_s": share_memory,
                         "bound_s": max(share_compute, share_memory)},
        },
    }
    if logical_kernel is not None:
        result["roofline_kernel"] = {
            "compute_s": logical_kernel["flops"] / n_chips / peak_flops,
            "memory_s": logical_kernel["fused_bytes"] / n_chips / hbm,
        }
    if verbose:
        r, pd = result["roofline"], result["per_device"]
        print(
            f"[{arch} x {shape_name} x {result['mesh']}] build {build_s:.1f}s | "
            f"per device {pd['logical_flops']:.4g} flop, "
            f"{pd['logical_bytes_fused_est']:.4g} B | compute "
            f"{r['compute_s'] * 1e3:.3f}ms memory {r['memory_s'] * 1e3:.3f}ms "
            f"collective {r['collective_s'] * 1e3:.3f}ms -> "
            f"{r['bottleneck']}-bound | useful "
            f"{result['model_flops']['useful_fraction']}", flush=True)
        print(f"  per rank {per_rank}; share (batch {cell.share_batch}) peak "
              f"{share['peak_bytes']:.6g} B, bound "
              f"{result['share']['roofline']['bound_s'] * 1e3:.3f} ms; "
              f"collectives {census}", flush=True)
    if save:
        os.makedirs(OUT_DIR, exist_ok=True)
        name = (f"{arch}__{shape_name}{'_mp' if multi_pod else ''}"
                f"{'' if zero == 'zero1' else '_' + zero}"
                f"{'' if attn == 'chunked' else '_' + attn}"
                f"{'_' + tag if tag else ''}.json")
        path = os.path.join(OUT_DIR, name)
        with open(path + ".tmp", "w") as f:  # whole or absent to a reader
            json.dump(result, f, indent=2)
        os.replace(path + ".tmp", path)
    return result


def _run_one(job):
    arch, shape_name, kw = job
    torch.set_num_threads(1)
    try:
        return run_cell(arch, shape_name, **kw)
    except Exception as e:  # noqa: BLE001 — report and continue
        print(f"[{arch} x {shape_name}] FAILED: {e!r}", flush=True)
        return repr(e)


def _cell_rank(family: str, kind: str) -> int:
    """The order ``run_all`` starts cells in: zamba2's chunked scan loops
    (prefill and train, ≈120-130 s each on one core) first, then the other
    prefills (15-25 s; their one-card shares are the longest on the card,
    and ``chip_smoke.py`` runs each share as its record lands), rwkv6's scan
    loops (≈70 s), the other train cells (15-28 s), then the rest (≈10 s)."""
    if kind in ("prefill", "train") and family in ("hybrid", "rwkv6"):
        return 0 if family == "hybrid" else 2
    return {"prefill": 1, "train": 3}.get(kind, 4)


def run_all(*, archs=ARCH_IDS, jobs: int = 1, **kw) -> Dict[Tuple, Any]:
    """Every live cell of every arch, in ``jobs`` processes; a cell that
    fails is reported and the rest run on.  Returns {(arch, shape): result
    or the error's repr}."""
    todo = [(arch, s, kw) for arch in archs for s in cells(arch)]
    todo.sort(key=lambda j: _cell_rank(get_config(j[0]).family,
                                       SHAPES[j[1]].kind))
    if jobs <= 1:
        results = [_run_one(j) for j in todo]
    else:
        import multiprocessing as mp

        with mp.get_context("spawn").Pool(jobs, maxtasksperchild=1) as pool:
            results = pool.map(_run_one, todo, chunksize=1)
    return {(a, s): r for (a, s, _), r in zip(todo, results)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun",
                                 description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--zero", default="zero1", choices=("none", "zero1", "fsdp"))
    ap.add_argument("--attn", default="chunked", choices=("dense", "chunked"))
    ap.add_argument("--no-sp", action="store_true",
                    help="disable sequence-parallel residual sharding")
    ap.add_argument("--capacity", type=float, default=None,
                    help="MoE expert-parallel capacity factor")
    ap.add_argument("--remat", default="block", choices=("none", "block", "dots"))
    ap.add_argument("--kernel-cost", action="store_true",
                    help="also cost prefill / decode in the cuda space, the "
                         "kernels as units")
    ap.add_argument("--moe-dispatch", default="gather", choices=("gather", "a2a"))
    ap.add_argument("--tag", default="", help="artifact filename suffix")
    ap.add_argument("--no-save", action="store_true",
                    help="write no JSON records")
    ap.add_argument("--jobs", type=int, default=1,
                    help="processes for --all (one thread each)")
    trace.add_cli_flag(ap)
    args = ap.parse_args(argv)
    trace.enable_from_args(args)
    kw = dict(multi_pod=args.multi_pod, zero=args.zero, attn=args.attn,
              sp=not args.no_sp, capacity=args.capacity, remat=args.remat,
              moe_dispatch=args.moe_dispatch, kernel_cost=args.kernel_cost,
              tag=args.tag, save=not args.no_save)
    if args.all:
        results = run_all(jobs=args.jobs, **kw)
        failures = [(k, v) for k, v in results.items() if isinstance(v, str)]
        if failures:
            print(f"{len(failures)} cells failed: {failures}", flush=True)
            return 1
        print(f"ALL CELLS PASSED ({len(results)})", flush=True)
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape required (or --all)")
        run_cell(args.arch, args.shape, **kw)
    if args.trace and trace.export():
        print(f"trace -> {args.trace}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
