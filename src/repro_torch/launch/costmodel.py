"""Cost model on the ``meta`` device: FLOP, byte and peak-memory totals of a
step, with nothing allocated.

The port of ``repro/launch/costmodel.py``.  The JAX package walks a jaxpr,
recursing into scan bodies with their trip counts; the port runs the step
itself on ``meta`` tensors under a ``TorchDispatchMode`` and classes every
aten operation that reaches the dispatcher as the JAX walker classes
primitives:

* matmul family (``mm``, ``bmm``, ``addmm``, ``baddbmm``, the
  ``_scaled_dot_product_*`` attentions): 2·M·N·K (batch included);
* layout operations (views, transposes, dtype casts, fills): bytes only,
  fused bytes 0;
* data movement (gathers, scatters, concatenations, padding, a copy into a
  slice): bytes, and fused bytes the same;
* reductions: one operation a read element;
* sorts: n·log2 n;
* transcendentals: one operation an output element, counted apart too;
* anything else is elementwise: one operation an output element, fused
  bytes the output only (an operand read fuses with its producer).

``bytes`` is every operation's operands plus results (a fusion-blind upper
proxy for HBM traffic), ``fused_bytes`` the fusion estimate above.

Trip counts and recomputation need no special case: the model's Python loop
over layers runs every layer, the chunked scans' loops every chunk, a
``torch.autograd.grad`` inside the step dispatches its backward operations,
and ``torch.utils.checkpoint`` dispatches its recomputed forward again in
backward (the remat cost).

A hand-written kernel launches through ``ctypes``, where no dispatch mode
sees it.  While a cost is taken, every kernel wrapper records one **kernel
unit** instead of launching (:mod:`repro_torch.kernels._cost`): its visible
inputs read once and outputs written once (bytes and fused bytes), and the
operations of its bound in ``chip_smoke.py`` (the JAX ``pallas_call``
unit).  A unit is reached only through the cuda space's bindings, which take
``meta`` tensors while units are recorded.

The **peak tracker** follows live ``meta`` storage through the step: the
inputs' storages count as live from the start, every new output storage is
added when an operation makes it and taken off by a weakref finalizer when
it is freed.  Its peak is the step's per-process high-water mark of tensor
bytes, before any allocator rounding.
"""

from __future__ import annotations

import dataclasses
import math
import weakref
from typing import Any, Dict, List

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.kernels import _cost as kernel_cost

__all__ = ["Cost", "CostMode", "PeakTracker", "function_cost", "model_flops",
           "op_class", "MATMUL_OPS", "LAYOUT_OPS", "MOVEMENT_OPS",
           "REDUCTION_OPS", "SORT_OPS", "TRANSCENDENTAL", "FREE_OPS"]

#: 2·M·N·K products (``aten`` overload packet names)
MATMUL_OPS = {"mm", "bmm", "addmm", "baddbmm", "addbmm", "dot", "mv",
              "_scaled_dot_product_flash_attention",
              "_scaled_dot_product_efficient_attention",
              "_scaled_dot_product_cudnn_attention",
              "_scaled_dot_product_flash_attention_for_cpu",
              "_scaled_dot_product_flash_attention_backward",
              "_scaled_dot_product_efficient_attention_backward",
              "_scaled_dot_product_cudnn_attention_backward",
              "_scaled_dot_product_flash_attention_for_cpu_backward"}
#: pure layout: no operations, folded into their consumers (fused bytes 0)
LAYOUT_OPS = {"view", "_unsafe_view", "reshape", "permute", "transpose", "t",
              "expand", "squeeze", "unsqueeze", "slice", "select", "alias",
              "as_strided", "clone", "_to_copy", "detach", "narrow", "split",
              "split_with_sizes", "unbind", "diagonal", "unfold", "flip",
              "view_as_real", "view_as_complex", "lift_fresh", "_reshape_alias",
              "fill", "zero", "zeros", "zeros_like", "ones", "ones_like",
              "full", "full_like", "arange", "scalar_tensor", "tril", "triu",
              "contiguous", "expand_as", "new_zeros", "new_ones", "new_full"}
#: data movement: no operations, but the bytes really move
MOVEMENT_OPS = {"index", "index_select", "gather", "scatter", "scatter_add",
                "scatter_reduce", "index_add", "index_put", "_index_put_impl",
                "index_copy", "index_fill", "cat", "stack", "constant_pad_nd",
                "pad", "repeat", "repeat_interleave", "embedding",
                "embedding_dense_backward", "copy", "slice_scatter",
                "select_scatter", "as_strided_scatter", "roll",
                "masked_scatter", "take_along_dim", "_unsafe_index",
                "_unsafe_index_put", "narrow_copy", "one_hot"}
#: one operation a read element
REDUCTION_OPS = {"sum", "mean", "amax", "amin", "max", "min", "prod", "argmax",
                 "argmin", "cumsum", "cumprod", "cummax", "cummin",
                 "logcumsumexp", "any", "all", "logsumexp", "norm",
                 "linalg_vector_norm", "var", "std", "var_mean", "_softmax",
                 "_log_softmax", "_softmax_backward_data",
                 "_log_softmax_backward_data", "segment_reduce",
                 "_segment_reduce_backward", "count_nonzero", "searchsorted",
                 "bincount"}
SORT_OPS = {"sort", "argsort", "topk", "kthvalue", "msort"}
TRANSCENDENTAL = {"exp", "log", "tanh", "sigmoid", "sin", "cos", "rsqrt",
                  "sqrt", "erf", "cbrt", "log1p", "expm1", "pow", "exp2",
                  "log2", "silu", "gelu", "softplus", "logit"}
#: no work and no traffic: allocation and metadata
FREE_OPS = {"empty", "empty_like", "empty_strided", "new_empty",
            "new_empty_strided", "_local_scalar_dense", "is_same_size",
            "set", "resize", "record_stream", "_has_compatible_shallow_copy_type",
            "sym_size", "sym_stride", "sym_numel", "sym_storage_offset",
            "_efficientzerotensor", "_conj", "_neg_view", "conj",
            "resolve_conj", "resolve_neg", "_assert_async",
            "_functional_assert_async", "_print", "lift", "_nested_tensor_size"}


@dataclasses.dataclass
class Cost:
    flops: float = 0.0
    bytes: float = 0.0  # unfused: every operation's operands + results
    fused_bytes: float = 0.0  # fusion estimate: elementwise -> output only
    transcendentals: float = 0.0
    matmul_flops: float = 0.0  # the matmul family's share of ``flops``


def op_class(name: str) -> str:
    """The cost class of an ``aten`` overload packet name (an in-place
    ``add_`` is ``add``)."""
    base = name[:-1] if name.endswith("_") and not name.startswith("__") \
        else name
    for cls, names in (("free", FREE_OPS), ("matmul", MATMUL_OPS),
                       ("layout", LAYOUT_OPS), ("movement", MOVEMENT_OPS),
                       ("reduction", REDUCTION_OPS), ("sort", SORT_OPS),
                       ("transcendental", TRANSCENDENTAL)):
        if base in names or name in names:
            return cls
    return "elementwise"


_CLASS: Dict[str, str] = {}


def _tensors(tree) -> List[torch.Tensor]:
    """The tensors in nested tuples, lists and dicts (an op's arguments or
    results)."""
    out, stack = [], [tree]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (tuple, list)):
            stack.extend(reversed(x))
        elif isinstance(x, dict):
            stack.extend(reversed(list(x.values())))
    return out


_SCALARS = (bool, int, float, str, torch.dtype, torch.device,
            torch.memory_format, torch.layout, type(None))


def _signature(args):
    """A hashable key of a sequence of op arguments' metadata (a tensor's
    shape, strides and dtype; a scalar's type and value); None where an
    argument has none.  An offset changes no fresh result's metadata."""
    out = []
    for x in args:
        if isinstance(x, torch.Tensor):
            out.append((x.shape, x.stride(), x.dtype))
        elif type(x) in _SCALARS:
            out.append((type(x), x))  # 1, 1.0 and True promote differently
        elif isinstance(x, (tuple, list)):
            inner = _signature(x)
            if inner is None:
                return None
            out.append(inner)
        else:
            return None
    return tuple(out)


def _nbytes(ts) -> float:
    return float(sum(t.numel() * t.element_size() for t in ts))


def _elems(ts) -> float:
    return float(sum(t.numel() for t in ts))


def _matmul_flops(name: str, ts) -> float:
    """2·M·N·K of one matmul-family call (batch included); ``ts`` its
    tensor arguments in order."""
    if name in ("mm",):
        (m, k), n = ts[0].shape, ts[1].shape[1]
        return 2.0 * m * n * k
    if name in ("addmm",):
        (m, k), n = ts[1].shape, ts[2].shape[1]
        return 2.0 * m * n * k
    if name == "bmm":
        (b, m, k), n = ts[0].shape, ts[1].shape[2]
        return 2.0 * b * m * n * k
    if name == "baddbmm":
        (b, m, k), n = ts[1].shape, ts[2].shape[2]
        return 2.0 * b * m * n * k
    if name == "addbmm":
        (b, m, k), n = ts[1].shape, ts[2].shape[2]
        return 2.0 * b * m * n * k
    if name == "dot":
        return 2.0 * ts[0].numel()
    if name == "mv":
        m, k = ts[0].shape
        return 2.0 * m * k
    # attention: q (B, H, S, D), k (B, H, Skv, D), v (B, H, Skv, Dv): the
    # score and value products, and in backward five such products
    q, k, v = ts[:3] if not name.endswith("_backward") else ts[1:4]
    B, H, S, D = q.shape
    Skv, Dv = k.shape[-2], v.shape[-1]
    fwd = 2.0 * B * H * S * Skv * (D + Dv)
    return 2.5 * fwd if name.endswith("_backward") else fwd


def _unit_cost(name, cls, ins, out) -> Cost:
    outs = [out] if isinstance(out, torch.Tensor) else _tensors(out)
    io = _nbytes(ins) + _nbytes(outs)
    if cls == "matmul":
        f = _matmul_flops(name, ins)
        extra = _elems(outs) if name in ("addmm", "baddbmm", "addbmm") else 0.0
        return Cost(flops=f + extra, bytes=io, fused_bytes=io, matmul_flops=f)
    if cls == "layout":
        return Cost(bytes=io)
    if cls == "movement":
        return Cost(bytes=io, fused_bytes=io)
    if cls == "reduction":
        return Cost(flops=_elems(ins[:1]), bytes=io, fused_bytes=io)
    if cls == "sort":
        n = _elems(ins[:1])
        return Cost(flops=n * max(math.log2(max(n, 2.0)), 1.0), bytes=io,
                    fused_bytes=io)
    n = _elems(outs)
    if cls == "transcendental":
        return Cost(flops=n, bytes=io, fused_bytes=_nbytes(outs),
                    transcendentals=n)
    return Cost(flops=n, bytes=io, fused_bytes=_nbytes(outs))


class PeakTracker:
    """Live tensor storage and its high-water mark: :meth:`hold` a storage
    when it appears, a weakref finalizer lets it go when it is freed."""

    def __init__(self):
        self.live: Dict[int, int] = {}
        self.current = 0
        self.peak = 0

    def hold(self, t: torch.Tensor) -> None:
        storage = t.untyped_storage()
        key = storage._cdata
        if key in self.live:
            return
        n = int(storage.nbytes())
        self.live[key] = n
        self.current += n
        self.peak = max(self.peak, self.current)
        weakref.finalize(storage, self._free, key)

    def _free(self, key: int) -> None:
        self.current -= self.live.pop(key, 0)


class CostMode(TorchDispatchMode):
    """Totals every ``aten`` operation dispatched inside it (and the kernel
    units recorded there) as a :class:`Cost`, per class in ``by_class``,
    and tracks the peak of live storage."""

    def __init__(self):
        super().__init__()
        #: (op, argument metadata) -> the op's class, cost and results'
        #: metadata: a repeated op (a chunk loop's) skips its meta kernel
        self.memo = {}
        self.cost = Cost()
        self.by_class: Dict[str, Cost] = {}
        self.units: Dict[str, Dict[str, float]] = {}
        self.tracker = PeakTracker()

    def _add(self, cls: str, c: Cost) -> None:
        for total in (self.cost, self.by_class.setdefault(cls, Cost())):
            total.flops += c.flops
            total.bytes += c.bytes
            total.fused_bytes += c.fused_bytes
            total.transcendentals += c.transcendentals
            total.matmul_flops += c.matmul_flops

    def unit(self, name: str, in_bytes: float, out_bytes: float,
             flops: float) -> None:
        io = in_bytes + out_bytes
        self._add("kernel", Cost(flops=flops, bytes=io, fused_bytes=io))
        u = self.units.setdefault(name, {"count": 0, "flops": 0.0,
                                         "bytes": 0.0})
        u["count"] += 1
        u["flops"] += flops
        u["bytes"] += io

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        key = hit = None
        sig = _signature(args)
        if sig is not None and kwargs:
            ksig = _signature(tuple(kwargs.values()))
            sig = None if ksig is None else (sig, tuple(kwargs), ksig)
        if sig is not None:
            key = (func, sig)
            hit = self.memo.get(key)
        if hit is not None:
            cls, cost, spec = hit
            # a view (spec None) runs again (a C++ metadata op); anything
            # else is remade from the recorded metadata
            out = func(*args, **kwargs) if spec is None else \
                self._replay(spec, args)
        else:
            out = func(*args, **kwargs)
            name = func.overloadpacket.__name__
            cls = _CLASS.get(name)
            if cls is None:
                cls = _CLASS[name] = op_class(name)
            ins = _tensors((args, kwargs))
            cost = _unit_cost(name, cls, ins, out) if cls != "free" \
                else None
            if key is not None:
                self.memo[key] = (cls, cost, self._record(out, ins))
        if cost is not None:
            self._add(cls, cost)
        if isinstance(out, torch.Tensor):
            self.tracker.hold(out)
        else:
            for t in _tensors(out):
                self.tracker.hold(t)
        return out

    @staticmethod
    def _record(out, ins):
        """How to remake ``out`` from metadata alone: each result either one
        of the arguments itself (an in-place op's) or a fresh tensor; None
        (run the op again) for a view of an argument or a non-tensor
        result."""
        single = isinstance(out, torch.Tensor)
        outs = []
        for t in ([out] if single else out if isinstance(out, (tuple, list))
                  else [None]):
            if not isinstance(t, torch.Tensor) or t.device.type != "meta":
                return None
            same = [i for i, a in enumerate(ins) if a is t]
            if same:
                outs.append(("arg", same[0]))
                continue
            key = t.untyped_storage()._cdata
            if any(a.untyped_storage()._cdata == key for a in ins):
                return None
            outs.append(("new", tuple(t.shape), t.stride(), t.dtype))
        return (single, any(o[0] == "arg" for o in outs), tuple(outs))

    @staticmethod
    def _replay(spec, args):
        single, uses_args, outs = spec
        ins = _tensors(args) if uses_args else None
        made = [ins[o[1]] if o[0] == "arg" else
                torch.empty_strided(o[1], o[2], dtype=o[3], device="meta")
                for o in outs]
        return made[0] if single else tuple(made)


def function_cost(fn, *args, **kwargs) -> Dict[str, Any]:
    """Run ``fn(*args, **kwargs)`` (``meta`` tensors) under a
    :class:`CostMode` and with kernel units recorded.  Returns the totals
    (``flops``, ``bytes``, ``fused_bytes``, ``transcendentals``,
    ``matmul_flops``), ``peak_bytes`` (the inputs' storage included),
    ``by_class`` and the kernel ``units``."""
    from repro_torch.core import tree as tree_lib

    mode = CostMode()
    # the inputs' storage is live from the start (parameter trees, caches
    # and optimizer states included)
    for leaf in tree_lib.leaves((list(args), dict(kwargs))):
        if isinstance(leaf, torch.Tensor):
            mode.tracker.hold(leaf)
    with kernel_cost.record_units(mode.unit), mode:
        fn(*args, **kwargs)
    c = mode.cost
    return {
        "flops": c.flops,
        "bytes": c.bytes,
        "fused_bytes": c.fused_bytes,
        "transcendentals": c.transcendentals,
        "matmul_flops": c.matmul_flops,
        "peak_bytes": float(mode.tracker.peak),
        "by_class": {k: dataclasses.asdict(v) for k, v in mode.by_class.items()},
        "units": mode.units,
    }


def model_flops(cfg, shape):
    """(MODEL_FLOPS, n_total, n_active): 6·N·D for training and 2·N·D for
    prefill and decode (D the global tokens, one a sequence in decode), N
    the floating-point parameters, with MoE's inactive routed experts
    (padded ones included) taken off."""
    from repro_torch.launch import steps as steps_lib
    from repro_torch.core import tree as tree_lib
    from repro_torch.nn.moe import padded_experts

    shapes, _ = steps_lib.model_shapes_and_axes(cfg)
    n_total = sum(t.numel() for t in tree_lib.leaves(shapes)
                  if t.dtype.is_floating_point)
    n_active = n_total
    if cfg.family == "moe":
        per_expert = 3 * cfg.d_model * cfg.d_expert * cfg.n_layers
        n_active = n_total - (padded_experts(cfg) - cfg.top_k) * per_expert
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    factor = 6 if shape.kind == "train" else 2
    return factor * n_active * tokens, n_total, n_active
