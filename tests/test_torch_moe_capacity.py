"""The MoE routes the dry run and serving take, against the JAX package at
smoke size: the expert-parallel capacity body at one rank (the dry run's
route: ``moe_spec`` set, a mesh with every axis of size 1) and the sort
route (serving's default), each on the same weights and tokens; and the
capacity body's ``meta`` run (equal segments, no host read)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.launch.mesh import make_host_mesh, use_mesh as jax_use_mesh
from repro.nn import moe as jax_moe
from repro_torch.configs import get_smoke_config
from repro_torch.launch import costmodel
from repro_torch.launch.mesh import Mesh, use_mesh
from repro_torch.nn import moe
from repro_torch.nn.common import Initializer

ARCHS = ("qwen2-moe-a2.7b", "olmoe-1b-7b")
SPEC = (("data",), "model")


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _inputs(arch):
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    ini = Initializer(torch.Generator("cpu").manual_seed(3), torch.float32, "cpu")
    p = moe.moe_init(ini, cfg)
    x = np.random.default_rng(7).normal(size=(2, 24, cfg.d_model)).astype(np.float32)
    return cfg, p, x


@pytest.mark.parametrize("route", ["capacity", "sort"])
@pytest.mark.parametrize("arch", ARCHS)
def test_route_matches_the_jax_package(arch, route):
    cfg, p, x = _inputs(arch)
    jcfg = dataclasses.replace(jax_smoke_config(arch), dtype="float32")
    if route == "capacity":
        cfg = dataclasses.replace(cfg, moe_spec=SPEC)
        jcfg = dataclasses.replace(jcfg, moe_spec=SPEC)
    with use_mesh(Mesh({"data": 1, "model": 1})):
        y, metrics = moe.moe_forward(p, torch.from_numpy(x), cfg)
    jp = {k: jnp.asarray(v.numpy()) for k, v in p.items()}
    with jax_use_mesh(make_host_mesh(1, 1)):
        jy, jmetrics = jax.jit(lambda p, x: jax_moe.moe_forward(p, x, jcfg))(
            jp, jnp.asarray(x))
    jy = np.asarray(jy)
    np.testing.assert_allclose(y.numpy(), jy, rtol=0,
                               atol=1e-5 * float(np.abs(jy).max()))
    assert sorted(metrics) == sorted(jmetrics)
    for k in metrics:
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]),
                                   rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("arch", ARCHS)
def test_capacity_body_on_meta_reads_nothing_and_counts_its_rows(arch):
    """On ``meta`` the capacity body's grouped GEMM takes equal segments:
    three products a row of its ``capacity_factor * T * k`` buffer (rounded
    up to 8), besides the router and the shared expert."""
    cfg = dataclasses.replace(get_smoke_config(arch), moe_spec=SPEC)
    p = moe.moe_init(Initializer(None, torch.float32, "meta"), cfg)
    T, d = 2 * 24, cfg.d_model
    x = torch.empty(2, 24, d, device="meta")
    with use_mesh(Mesh({"data": 1, "model": 1})):
        c = costmodel.function_cost(lambda p, x: moe.moe_forward(p, x, cfg), p, x)
    C = moe._capacity(cfg, T, 1)
    experts = 3 * 2 * C * d * cfg.d_expert
    router = 2 * T * d * cfg.n_experts
    shared = 0
    if cfg.shared_expert_ff:
        shared = 3 * 2 * T * d * cfg.shared_expert_ff + 2 * T * d
    assert c["matmul_flops"] == experts + router + shared
