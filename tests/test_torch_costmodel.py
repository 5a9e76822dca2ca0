"""The port's meta-device cost model (``repro_torch.launch.costmodel``): the
cases of ``tests/launch/test_costmodel.py``, the kernel units, the peak
tracker, and the port's counts held against the JAX package's jaxpr walker
(``repro.launch.costmodel``) at smoke width.

Matmul FLOPs: the JAX side is ``_dot_flops`` over every ``dot_general``
equation, plus 2 x (lhs elements) x (rhs free dimensions) over every
``ragged_dot_general`` (the MoE grouped GEMMs), recursing as ``jaxpr_cost``
does (a scan body times its length).  The JAX walker's own ragged branch
matches the primitive name ``ragged_dot``, and under jax 0.9 the grouped
GEMMs are ``ragged_dot_general``: ``jaxpr_cost`` counts them as elementwise
(one operation an output element), which the total comparisons correct.
"""

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCH_IDS, SHAPES, cells, get_smoke_config
from repro_torch.core import make_executor
from repro_torch.core import tree as tree_lib
from repro_torch.launch import costmodel as cm
from repro_torch.launch import steps
from repro_torch.models import lm
from repro_torch.nn.common import trainable
from repro_torch.optim import adamw, warmup_cosine_schedule

META = "meta"


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _m(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device=META)


# -- the JAX package's cases ---------------------------------------------------


def test_loop_trip_counts_exact():
    d = 128
    w, x = _m(d, d), _m(8, d)

    def looped(x, w):
        for _ in range(10):
            x = x @ w
        return x

    c = cm.function_cost(looped, x, w)
    assert c["matmul_flops"] == 10 * 2 * 8 * d * d
    np.testing.assert_allclose(c["flops"], 10 * 2 * 8 * d * d, rtol=0.01)


def test_dot_flops_batched():
    a, b = _m(4, 16, 32), _m(4, 32, 8)
    c = cm.function_cost(lambda a, b: torch.einsum("bik,bkj->bij", a, b), a, b)
    assert c["matmul_flops"] == 2 * 4 * 16 * 32 * 8
    np.testing.assert_allclose(c["flops"], 2 * 4 * 16 * 32 * 8, rtol=0.01)


def test_checkpointed_backward_counts_the_recompute():
    from torch.utils.checkpoint import checkpoint

    d = 64
    w = _m(d, d).requires_grad_(True)
    x = _m(4, d)

    def body(c, w):
        return torch.tanh(c @ w)

    def loss(w, remat):
        c = x
        for _ in range(6):
            c = checkpoint(body, c, w, use_reentrant=False) if remat \
                else body(c, w)
        return c.sum()

    fwd = cm.function_cost(lambda w: loss(w, False), w)
    plain = cm.function_cost(
        lambda w: torch.autograd.grad(loss(w, False), w), w)
    remat = cm.function_cost(
        lambda w: torch.autograd.grad(loss(w, True), w), w)
    one = 2 * 4 * d * d
    assert fwd["matmul_flops"] == 6 * one
    # forward, then the gradients of the input (5 of the 6 products: the
    # first input needs none) and of w
    assert plain["matmul_flops"] == 6 * one + 5 * one + 6 * one
    # the checkpointed blocks run their forward again in backward
    assert remat["matmul_flops"] == plain["matmul_flops"] + 6 * one
    assert remat["flops"] > 2.5 * fwd["flops"]


def test_fused_bytes_leq_unfused():
    x = _m(128, 128)
    c = cm.function_cost(lambda x: torch.sum(torch.tanh(x * 2.0 + 1.0)), x)
    assert 0 < c["fused_bytes"] <= c["bytes"]
    assert c["transcendentals"] == 128 * 128


@pytest.mark.parametrize("name,cls", [
    ("mm", "matmul"), ("bmm", "matmul"), ("addmm", "matmul"),
    ("view", "layout"), ("_to_copy", "layout"), ("transpose", "layout"),
    ("index", "movement"), ("cat", "movement"), ("copy_", "movement"),
    ("sum", "reduction"), ("amax", "reduction"), ("sort", "sort"),
    ("exp", "transcendental"), ("rsqrt", "transcendental"),
    ("add", "elementwise"), ("mul_", "elementwise"), ("empty", "free")])
def test_op_classes(name, cls):
    assert cm.op_class(name) == cls


# -- kernel units and the peak tracker -------------------------------------------


def test_kernel_unit_costs_its_visible_io_once():
    from repro_torch import kernels as K

    ex = make_executor("cuda", device=META)
    B, H, Hkv, S, D = 2, 8, 2, 256, 64
    q = _m(B, H, S, D, dtype=torch.bfloat16)
    k = _m(B, Hkv, S, D, dtype=torch.bfloat16)
    v = _m(B, Hkv, S, D, dtype=torch.bfloat16)
    before = K.flash_attention.launches
    c = cm.function_cost(
        lambda q, k, v: ex_call(ex, q, k, v), q, k, v)
    assert K.flash_attention.launches == before  # nothing launched
    io = 2 * (2 * B * H * S * D + 2 * B * Hkv * S * D)
    assert c["units"] == {"flash_attention": {
        "count": 1, "flops": 4.0 * D * B * H * S * (S + 1) // 2,
        "bytes": float(io)}}
    assert c["by_class"]["kernel"]["bytes"] == io
    assert c["by_class"]["kernel"]["fused_bytes"] == io
    assert c["matmul_flops"] == 0


def ex_call(ex, q, k, v):
    from repro_torch.core import registry

    return registry.operation("nn_attention")(q, k, v, executor=ex)


def test_kernel_units_of_the_scans_and_rmsnorm():
    from repro_torch import kernels as K

    x = _m(2, 130, 4, 16, dtype=torch.bfloat16)
    w = _m(16)
    c = cm.function_cost(lambda x, w: K.rmsnorm(x, w), x, w)
    assert c["units"]["rmsnorm"] == {"count": 1, "flops": 4.0 * x.numel(),
                                     "bytes": 2.0 * x.numel() * 2 + 16 * 4}
    r = _m(2, 130, 4, 16, dtype=torch.bfloat16)
    lw = _m(2, 130, 4, 16)
    u = _m(4, 16, dtype=torch.bfloat16)
    c = cm.function_cost(lambda *a: K.rwkv6_scan_log(*a), r, r, r, lw, u)
    L, lower = 64, 64 * 63 // 2
    assert c["units"]["rwkv6_scan_log"]["flops"] == \
        2 * 4 * 3 * (4 * L * 16 * 16 + 2 * lower * 16 + 4 * lower * 16)


def test_kernel_unit_refuses_tensors_off_meta():
    """A wrapper under a cost context launches nothing, so real tensors
    (which would get uncomputed outputs back) are refused."""
    from repro_torch import kernels as K
    from repro_torch.kernels import _cost

    x, w = torch.randn(4, 16), torch.ones(16)
    with _cost.record_units(lambda *a: None):
        with pytest.raises(ValueError, match="meta tensors only"):
            K.rmsnorm(x, w)
    assert torch.equal(K.rmsnorm(x, w), K.rmsnorm_plain(x, w))


def test_peak_tracker_is_exact_on_a_known_sequence():
    x = _m(1024)  # 4,096 bytes, live from the start

    def seq(x):
        a = torch.empty(1000, device=META)  # + 4,000
        b = a + 1  # + 4,000: 12,096
        del a  # 8,096
        c = torch.empty(3000, device=META)  # + 12,000: 20,096
        d = c.view(30, 100)  # a view: nothing new
        del b, c, d  # 4,096
        e = torch.empty(4000, dtype=torch.float64, device=META)  # + 32,000
        return e.sum()

    c = cm.function_cost(seq, x)
    assert c["peak_bytes"] == 4096 + 32000 + 8
    tracker = cm.PeakTracker()
    t1 = _m(10)
    tracker.hold(t1)
    tracker.hold(t1[2:])  # the same storage
    t2 = _m(20)
    tracker.hold(t2)
    assert (tracker.current, tracker.peak) == (120, 120)
    del t2
    assert (tracker.current, tracker.peak) == (40, 120)


# -- the port against the JAX walker ---------------------------------------------


def _jax_matmul_flops(jaxpr) -> float:
    from repro.launch import costmodel as jcm

    total = 0.0
    for e in jaxpr.eqns:
        name = e.primitive.name
        if name == "dot_general":
            total += jcm._dot_flops(e)
        elif name == "ragged_dot_general":
            dn = e.params["ragged_dot_dimension_numbers"]
            (_, rc), (_, rb) = dn.dot_dimension_numbers
            lhs, rhs = e.invars[0].aval, e.invars[1].aval
            skip = set(rc) | set(rb) | set(dn.rhs_group_dimensions)
            free = np.prod([d for i, d in enumerate(rhs.shape) if i not in skip],
                           dtype=np.float64)
            total += 2.0 * np.prod(lhs.shape, dtype=np.float64) * free
        elif name == "scan":
            total += _jax_matmul_flops(e.params["jaxpr"].jaxpr) * e.params["length"]
        elif name == "while":
            total += (_jax_matmul_flops(e.params["body_jaxpr"].jaxpr)
                      + _jax_matmul_flops(e.params["cond_jaxpr"].jaxpr))
        elif name == "cond":
            total += max(_jax_matmul_flops(b.jaxpr) for b in e.params["branches"])
        else:
            for key in ("jaxpr", "call_jaxpr", "fun_jaxpr"):
                sub = e.params.get(key)
                if sub is not None:
                    total += _jax_matmul_flops(getattr(sub, "jaxpr", sub))
                    break
    return total


def _jax_ragged_elementwise(jaxpr) -> float:
    """What ``jaxpr_cost`` counts for the ragged GEMMs (their output
    elements), with trip counts."""
    total = 0.0
    for e in jaxpr.eqns:
        name = e.primitive.name
        if name == "ragged_dot_general":
            total += float(sum(np.prod(v.aval.shape) for v in e.outvars))
        elif name == "scan":
            total += _jax_ragged_elementwise(e.params["jaxpr"].jaxpr) * e.params["length"]
        else:
            for key in ("jaxpr", "call_jaxpr", "fun_jaxpr"):
                sub = e.params.get(key)
                if sub is not None:
                    total += _jax_ragged_elementwise(getattr(sub, "jaxpr", sub))
                    break
    return total


_JAX_COSTS = {}

#: arch -> the family it stands for in the walker comparison
WALKER_ARCHS = {"smollm-135m": "dense", "qwen2-moe-a2.7b": "moe",
                "minicpm3-4b": "mla", "zamba2-2.7b": "hybrid",
                "rwkv6-3b": "rwkv6"}
B, S = 2, 64


def _jax_costs(arch):
    if arch in _JAX_COSTS:
        return _JAX_COSTS[arch]
    import jax

    from repro.configs import get_smoke_config as jax_smoke
    from repro.launch import costmodel as jcm
    from repro.launch import steps as jsteps
    from repro.models import lm as jlm
    from repro.optim import adamw as jadamw
    from repro.optim import warmup_cosine_schedule as jwarmup

    cfg = jax_smoke(arch)
    shapes, _ = jsteps.model_shapes_and_axes(cfg)
    batch = jsteps.batch_struct(cfg, B, S)
    fwd = jax.make_jaxpr(lambda p, b: jlm.loss_fn(p, cfg, b))(shapes, batch)
    opt = jadamw(jwarmup(3e-4, 10, 100))
    train = jax.make_jaxpr(jsteps.make_train_step(cfg, opt))(
        shapes, jax.eval_shape(opt.init, shapes), batch)
    out = {}
    for key, j in (("forward", fwd.jaxpr), ("train", train.jaxpr)):
        c = jcm.jaxpr_cost(j)
        mm = _jax_matmul_flops(j)
        ragged = _jax_ragged_elementwise(j)
        out[key] = {"matmul_flops": mm, "bytes": c.bytes,
                    "fused_bytes": c.fused_bytes,
                    # the ragged GEMMs counted as the products they are
                    "flops": c.flops - ragged + (mm - _jax_dense_dots(j))}
    _JAX_COSTS[arch] = out
    return out


def _jax_dense_dots(jaxpr) -> float:
    from repro.launch import costmodel as jcm

    total = 0.0
    for e in jaxpr.eqns:
        name = e.primitive.name
        if name == "dot_general":
            total += jcm._dot_flops(e)
        elif name == "scan":
            total += _jax_dense_dots(e.params["jaxpr"].jaxpr) * e.params["length"]
        else:
            for key in ("jaxpr", "call_jaxpr", "fun_jaxpr"):
                sub = e.params.get(key)
                if sub is not None:
                    total += _jax_dense_dots(getattr(sub, "jaxpr", sub))
                    break
    return total


def _port_costs(arch):
    cfg = get_smoke_config(arch)
    ex = make_executor("torch", device=META)
    params, _ = steps.model_shapes_and_axes(cfg)
    batch = steps.batch_struct(cfg, B, S)
    fwd = cm.function_cost(
        lambda p, b: lm.loss_fn(p, cfg, b, executor=ex), params, batch)
    params = trainable(params)
    opt = adamw(warmup_cosine_schedule(3e-4, 10, 100))
    train = cm.function_cost(steps.make_train_step(cfg, opt, executor=ex),
                             params, opt.init(params), batch)
    return {"forward": fwd, "train": train}


def _zero_carry_products(cfg) -> float:
    """The products JAX's uniform scan body transposes and the port's
    autograd skips, a Mamba2 layer: the gradient of the zero initial state
    (one chunk product) and of the final state's update, whose cotangent is
    zero (two)."""
    d_inner = cfg.ssm_expand * cfg.d_model
    H, N, P, L = d_inner // cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_head_dim, 64
    return cfg.n_layers * 3 * 2.0 * B * min(L, S) * H * N * P


@pytest.mark.parametrize("arch", list(WALKER_ARCHS))
def test_matmul_flops_match_the_jax_walker(arch):
    """Equal for the dense, MoE and MLA families (forward and train step)
    and the hybrid forward.  Two differences are the chunked scans':
    JAX's uniform scan body also transposes the products of the zero
    initial state and of the unused final state (the hybrid train step:
    exactly those products), and JAX's RWKV6 chunk writes its elementwise
    products as three-operand einsums, which contract to ``dot_general``
    equations without contraction (the port's chunk multiplies and sums):
    the RWKV6 port then counts fewer matmul FLOPs, within 6 %."""
    jax_c, port = _jax_costs(arch), _port_costs(arch)
    family = WALKER_ARCHS[arch]
    for key in ("forward", "train"):
        want, got = jax_c[key]["matmul_flops"], port[key]["matmul_flops"]
        if family == "rwkv6":
            assert want * 0.94 <= got <= want, (key, got, want)
        elif family == "hybrid" and key == "train":
            assert got == want - _zero_carry_products(get_smoke_config(arch))
        else:
            assert got == want, (key, got, want)


@pytest.mark.parametrize("arch", list(WALKER_ARCHS))
def test_totals_within_the_stated_tolerance(arch):
    """Total operations within 12 %, fused bytes within a factor of 1.6 and
    unfused bytes within 1.8 of the JAX walker's (its ragged GEMMs counted
    as products).  The byte counts part because one formulation's layout
    steps are not the other's: the port's eager ops write dtype casts,
    broadcasts and the autograd engine's gradient accumulation that XLA's
    jaxpr folds, and the other way round."""
    jax_c, port = _jax_costs(arch), _port_costs(arch)
    for key in ("forward", "train"):
        j, p = jax_c[key], port[key]
        assert abs(p["flops"] / j["flops"] - 1) <= 0.12, (key, p["flops"], j)
        assert 1 / 1.6 <= p["fused_bytes"] / j["fused_bytes"] <= 1.6, key
        assert 1 / 1.8 <= p["bytes"] / j["bytes"] <= 1.8, key
        assert p["fused_bytes"] <= p["bytes"]


def jax_dryrun():
    """``repro.launch.dryrun``, imported without its first lines' effect:
    they set XLA_FLAGS to 512 host devices for a process of its own, and
    this one must keep its own (jax reads the flag when its backend
    starts)."""
    import os

    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return dryrun


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_equal_the_jax_package(arch):
    from repro import configs as jax_configs

    from repro_torch.configs import get_config

    jdryrun = jax_dryrun()
    for shape_name in cells(arch):
        got = cm.model_flops(get_config(arch), SHAPES[shape_name])
        want = jdryrun.model_flops(jax_configs.get_config(arch),
                                   jax_configs.SHAPES[shape_name])
        assert tuple(float(v) for v in got) == tuple(float(v) for v in want), \
            (arch, shape_name)


def test_every_kernel_wrapper_records_a_unit():
    """Each of the thirteen wrappers, under a cost context, records one unit
    of its visible bytes and its bound's operations and launches nothing."""
    from repro_torch import kernels as K

    i32, bf16 = torch.int32, torch.bfloat16
    m, k, n, nb = 64, 5, 48, 3
    cases = {
        "spmv_ell": (lambda: K.spmv_ell(_m(m, k, dtype=i32), _m(m, k), _m(n)),
                     2 * m * k),
        "spmv_dot_ell": (lambda: K.spmv_dot_ell(_m(m, k, dtype=i32), _m(m, k),
                                                _m(n), _m(m)),
                         2 * m * k + 2 * m),
        "axpy_norm": (lambda: K.axpy_norm(_m(), _m(n), _m(n)), 4 * n),
        "axpy_norm_rows": (lambda: K.axpy_norm_rows(_m(nb), _m(nb, n),
                                                    _m(nb, n)), 4 * nb * n),
        "block_jacobi_apply": (lambda: K.block_jacobi_apply(_m(nb, 8, 8),
                                                            _m(nb, 8)),
                               2 * nb * 64),
        "spgemm_expand": (lambda: K.spgemm_expand(_m(m), _m(m, k, dtype=i32),
                                                  _m(n)), m * k),
        "csr_permute": (lambda: K.csr_permute(_m(n), _m(n, dtype=i32)), 0),
        "spgemm_merge": (lambda: K.spgemm_merge(_m(n), _m(m // 4,
                                                          dtype=torch.int64)),
                         n - m // 4),
        "spmv_sellp": (lambda: K.spmv_sellp(_m(m * k, dtype=i32), _m(m * k),
                                            _m(m // 8 + 1, dtype=i32), _m(n),
                                            m, 8), 2 * m * k),
        "spmv_batch_ell": (lambda: K.spmv_batch_ell(_m(m, k, dtype=i32),
                                                    _m(nb, m, k), _m(nb, n)),
                           2 * nb * m * k),
        "rmsnorm": (lambda: K.rmsnorm(_m(m, n, dtype=bf16), _m(n)), 4 * m * n),
    }
    before = K.launch_counts()
    for name, (call, flops) in cases.items():
        c = cm.function_cost(call)
        assert list(c["units"]) == [name]
        assert c["units"][name]["count"] == 1
        assert c["units"][name]["flops"] == flops, name
        assert c["units"][name]["bytes"] == c["by_class"]["kernel"]["bytes"] > 0
    assert K.launch_counts() == before



def test_peak_counts_parameter_trees_and_caches_as_live():
    """A step's inputs (a ParamTree, a cache dataclass, an optimizer
    state) are live from the start: the peak holds their bytes though no
    operation makes them."""
    cfg = get_smoke_config("smollm-135m")
    params, _ = steps.model_shapes_and_axes(cfg)
    cache = steps.cache_struct(cfg, 2, 64)
    batch = steps.batch_struct(cfg, 2, 1)
    batch.pop("labels")
    nbytes = sum(t.numel() * t.element_size()
                 for t in tree_lib.leaves((params, cache)))
    c = cm.function_cost(lambda *a: None, params, batch, 63, cache)
    assert c["peak_bytes"] == nbytes + 2 * 4
    step = steps.make_decode_step(cfg, executor=make_executor("torch",
                                                              device=META))
    assert cm.function_cost(step, params, batch, 63, cache)["peak_bytes"] > \
        c["peak_bytes"]
