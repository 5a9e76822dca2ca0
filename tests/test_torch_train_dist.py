"""The training path's distributed parts on gloo worlds of CPU processes,
against the JAX package under ``jax.vmap`` with an axis name (which runs
``psum``, ``pmax``, ``ppermute``, ``all_to_all`` and ``axis_index`` on
one device) and against the port's dense MoE; and the sharding rules
against the JAX package's.

* one world of 4 ranks: ``compressed_psum`` (mean and each rank's error
  state), both ring matmuls (each rank's block), and the expert-parallel
  MoE on a 2 x 2 (data, model) mesh in both dispatches — outputs and
  gradients of sum(y^2) against ``impl="dense"`` (the JAX package's
  ``test_moe_expert_parallel_matches_dense`` measure: outputs within 1e-4,
  gradients within 1e-3 of their max), the all-to-all body's output
  against the JAX body's;
* the gather body alone (no collective) at a capacity that drops tokens,
  each model rank against the JAX body's under ``vmap``;
* compressed DP on 2 ranks tracks the uncompressed run (the JAX package's
  ``test_compressed_dp_training_converges``: within 0.05 at every step,
  the last loss below the first less 0.1) and leaves the ranks' parameters
  bitwise equal; both runs' losses against the JAX package's
  ``make_train_step`` and ``make_compressed_dp_train_step`` from the same
  weights (``tests/_torch_dp_witness.py``); gradient accumulation against
  one full-batch step;
* ``spec_for_leaf`` over every configuration's parameter, moment and cache
  trees at several (pod, data, model) meshes and each zero mode, against
  the JAX rules (a stand-in mesh: the rules read ``mesh.shape`` only).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.distributed import collective_matmul as jax_cm
from repro.distributed import sharding as jax_shd
from repro.models import lm as jax_lm
from repro.nn import moe as jax_moe
from repro.optim import compressed_psum as jax_compressed_psum
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.configs.base import ModelConfig
from repro_torch.core import make_executor
from repro_torch.core import tree as tree_lib
from repro_torch.data import DataConfig, global_step_batch
from repro_torch.distributed import comm
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.train_cases import dp_weights, run_train_cases
from repro_torch.launch import steps as steps_lib
from repro_torch.launch.mesh import Mesh
from repro_torch.models import lm
from repro_torch.nn import moe
from repro_torch.nn.common import Initializer, trainable
from repro_torch.optim import adamw, constant_schedule

P = 4
RNG = np.random.default_rng(12)
G = RNG.standard_normal((P, 40)).astype(np.float32)
E = (RNG.standard_normal((P, 40)) * 1e-2).astype(np.float32)
X = RNG.standard_normal((16, 64)).astype(np.float32)
W = RNG.standard_normal((64, 32)).astype(np.float32)
MOE_X = np.random.default_rng(50).normal(size=(4, 16, 32)).astype(np.float32)


def _moe_fields(dispatch, capacity=8.0):
    return dict(name="t", family="moe", n_layers=1, d_model=32, vocab=64,
                n_experts=8, top_k=2, d_expert=64, shared_expert_ff=48,
                moe_spec=(("data",), "model"), moe_capacity_factor=capacity,
                moe_dispatch=dispatch)


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@functools.lru_cache(maxsize=None)
def _world():
    cases = [{"op": "compressed_psum", "g": G, "err": E},
             {"op": "ring_rs", "x": X, "w": W},
             {"op": "ring_ag", "x": X, "w": W}]
    for dispatch in ("gather", "a2a"):
        cases.append({"op": "moe_ep", "cfg": _moe_fields(dispatch),
                      "mesh": {"data": 2, "model": 2}, "seed": 0, "x": MOE_X})
    return comm.run_world(run_train_cases, P, (cases, "cpu"), threads=1)


def test_compressed_psum_matches_jax():
    res = [r[0] for r in _world()]
    mean, err = jax.vmap(
        lambda g, e: jax_compressed_psum({"g": g}, {"g": e}, "i"),
        axis_name="i")(jnp.asarray(G), jnp.asarray(E))
    for r in range(P):
        np.testing.assert_allclose(res[r]["mean"], np.asarray(mean["g"][r]),
                                   rtol=0, atol=1e-7)
        np.testing.assert_allclose(res[r]["err"], np.asarray(err["g"][r]),
                                   rtol=0, atol=1e-7)


def test_ring_matmuls_match_jax():
    res = _world()
    k, m, n = X.shape[1] // P, X.shape[0] // P, W.shape[1] // P
    xs = jnp.stack([X[:, r * k:(r + 1) * k] for r in range(P)])
    ws = jnp.stack([W[r * k:(r + 1) * k] for r in range(P)])
    rs = jax.vmap(lambda a, b: jax_cm.ring_reduce_scatter_matmul(a, b, "model"),
                  axis_name="model")(xs, ws)
    xa = jnp.stack([X[r * m:(r + 1) * m] for r in range(P)])
    wa = jnp.stack([W[:, r * n:(r + 1) * n] for r in range(P)])
    ag = jax.vmap(lambda a, b: jax_cm.ring_all_gather_matmul(a, b, "model"),
                  axis_name="model")(xa, wa)
    dense = X @ W
    for r in range(P):
        got_rs, got_ag = res[r][1]["y"], res[r][2]["y"]
        np.testing.assert_allclose(got_rs, np.asarray(rs[r]), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got_ag, np.asarray(ag[r]), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got_rs, dense[:, r * n:(r + 1) * n],
                                   rtol=1e-4, atol=1e-4)


def _dense(fields):
    cfg = ModelConfig(**fields)
    ini = Initializer(torch.Generator("cpu").manual_seed(0), torch.float32, "cpu")
    p = {k: v.requires_grad_(True) for k, v in moe.moe_init(ini, cfg).items()}
    x = torch.from_numpy(MOE_X).requires_grad_(True)
    y, _ = moe.moe_forward(p, x, cfg, impl="dense")
    grads = torch.autograd.grad((y ** 2).sum(), list(p.values()) + [x])
    return cfg, p, y.detach().numpy(), dict(zip(p, grads[:-1])), grads[-1]


@pytest.mark.parametrize("dispatch,index", [("gather", 3), ("a2a", 4)])
def test_expert_parallel_matches_dense(dispatch, index):
    """Ranks are laid out (data, model) row-major: 0 = (0, 0), 1 = (0, 1),
    2 = (1, 0), 3 = (1, 1).  Each model rank holds the whole gradient; the
    data ranks' gradients sum to the dense one."""
    res = [r[index] for r in _world()]
    _, p, y, grads, dx = _dense(_moe_fields(dispatch))
    y_ep = np.concatenate([res[0]["y"], res[2]["y"]])
    assert np.abs(y_ep - y).max() < 1e-4
    assert res[0]["metrics"]["moe_drop_frac"] == 0.0
    for key, g in grads.items():
        g = g.numpy()
        for a, b in ((0, 2), (1, 3)):
            got = res[a]["grads"][key] + res[b]["grads"][key]
            assert np.abs(got - g).max() <= 1e-3 * max(np.abs(g).max(), 1e-9), key
        np.testing.assert_array_equal(res[0]["grads"][key], res[1]["grads"][key])
    dx_ep = np.concatenate([res[0]["dx"], res[2]["dx"]])
    assert np.abs(dx_ep - dx.numpy()).max() <= 1e-3 * np.abs(dx.numpy()).max()
    if dispatch == "a2a":
        # the JAX body under vmap over the model axis, data shard 0
        cfg = jax_moe_cfg(_moe_fields(dispatch))
        pn = res[0]["params"]
        xl = MOE_X[:2]
        x2 = jnp.stack([xl[:, m * 8:(m + 1) * 8].reshape(-1, 32) for m in range(2)])
        y2, _ = jax.vmap(
            lambda x2, g, u, d: jax_moe._experts_ep_a2a_body(
                x2, jnp.asarray(pn["router"]), g, u, d, cfg, "model"),
            axis_name="model")(x2, *(jnp.asarray(pn[n]).reshape(2, 4, *pn[n].shape[1:])
                                     for n in ("gate", "up", "down")))
        y2 = np.concatenate([np.asarray(y2[m]).reshape(2, 8, 32) for m in range(2)],
                            axis=1)
        # the port's output adds the shared expert: remove it for the body
        x2t = torch.from_numpy(xl.reshape(-1, 32))
        sh = ((torch.nn.functional.silu(x2t @ p["sh_gate"]) * (x2t @ p["sh_up"]))
              @ p["sh_down"]) * torch.sigmoid(x2t @ p["sh_gate_proj"])
        body = res[0]["y"] - sh.detach().numpy().reshape(2, 16, 32)
        assert np.abs(body - y2).max() < 1e-5


def jax_moe_cfg(fields):
    from repro.configs.base import ModelConfig as JaxModelConfig

    return JaxModelConfig(**fields)


def test_gather_body_with_drops_matches_jax():
    """At capacity factor 0.5 some tokens overflow; each model rank's
    partial output and drop share against the JAX body's."""
    fields = _moe_fields("gather", capacity=0.5)
    cfg, jcfg = ModelConfig(**fields), jax_moe_cfg(fields)
    ini = Initializer(torch.Generator("cpu").manual_seed(1), torch.float32, "cpu")
    p = moe.moe_init(ini, cfg)
    x2 = torch.from_numpy(MOE_X.reshape(-1, 32))
    n = 2
    stack = lambda t: jnp.asarray(t.numpy()).reshape(n, 8 // n, *t.shape[1:])  # noqa: E731
    y2j, mj = jax.vmap(
        lambda g, u, d: jax_moe._experts_ep_body(
            jnp.asarray(x2.numpy()), jnp.asarray(p["router"].numpy()), g, u, d,
            jcfg, "model"), axis_name="model")(
        stack(p["gate"]), stack(p["up"]), stack(p["down"]))
    drops = []
    for m in range(n):
        sl = slice(m * 4, (m + 1) * 4)
        y2, met = moe._experts_ep_body(x2, p["router"], p["gate"][sl],
                                       p["up"][sl], p["down"][sl], cfg, m, n)
        assert np.abs(y2.numpy() - np.asarray(y2j[m])).max() < 1e-5
        assert abs(float(met["moe_drop_frac"]) - float(mj["moe_drop_frac"][m])) < 1e-7
        drops.append(float(met["moe_drop_frac"]))
    assert max(drops) > 0  # the case exercises the capacity


def test_ep_needs_a_mesh():
    cfg = ModelConfig(**_moe_fields("gather"))
    ini = Initializer(torch.Generator("cpu").manual_seed(0), torch.float32, "cpu")
    with pytest.raises(ValueError, match="needs a mesh"):
        moe.moe_forward(moe.moe_init(ini, cfg), torch.zeros(1, 4, 32), cfg)


# -- compressed DP and gradient accumulation ----------------------------------------


def test_compressed_dp_tracks_uncompressed():
    case = {"op": "compressed_dp", "arch": "smollm_135m", "steps": 12,
            "global_batch": 8, "seq_len": 32, "lr": 3e-3, "data_seed": 3}
    res = comm.run_world(run_train_cases, 2, ([case], "cpu"), threads=1)
    cfg = get_smoke_config("smollm_135m")
    opt = adamw(constant_schedule(3e-3), weight_decay=0.0)
    params = dp_weights(cfg, "cpu")  # the weights the ranks start from
    state = opt.init(params)
    step = steps_lib.make_train_step(cfg, opt, executor=make_executor("torch"))
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=8, seed=3)
    ref = []
    for i in range(12):
        batch = {k: torch.from_numpy(v) for k, v in global_step_batch(dcfg, i).items()}
        params, state, m = step(params, state, batch)
        ref.append(float(m["loss"]))
    com = np.array(res[0][0]["losses"])
    assert com[-1] < com[0] - 0.1, com
    assert np.abs(np.array(ref) - com).max() < 0.05, (ref, com)
    assert res[0][0]["digest"] == res[1][0]["digest"]
    assert res[0][0]["losses"] == res[1][0]["losses"]


@pytest.mark.parametrize("ranks", [2, 4])
def test_compressed_dp_matches_jax(ranks):
    """The port's uncompressed and compressed-DP loss trajectories against
    the JAX package's from the same weights and chain data, 12 steps of
    the smoke config, f32: the uncompressed run within 1e-4 at every step,
    the compressed within 2e-3 (a gradient summed in another order can
    round to the next int8 level, and AdamW's normalised step carries the
    change on; the two algorithms part by 8e-3 to 1.2e-2 here)."""
    from _torch_dp_witness import witness

    res = witness(ranks=ranks)
    gaps = res["max_diff"]
    assert gaps["port_vs_jax_uncompressed"] <= 1e-4, res
    assert gaps["port_vs_jax_compressed"] <= 2e-3, res
    assert res["port"]["ranks_bitwise_equal"]


def test_grad_accumulation_matches_full_batch():
    """Four microbatches' f32 gradients, summed and divided by four, against
    the full batch's gradient (each leaf within 1e-6 of its norm), and the
    mean loss; the optimizer sees them through a recording stand-in."""
    from repro_torch.optim import Optimizer

    cfg = get_smoke_config("smollm_135m")
    ex = make_executor("torch")
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=8, seed=4)
    batch = {k: torch.from_numpy(v) for k, v in global_step_batch(dcfg, 0).items()}
    seen = []
    opt = Optimizer(init=lambda p: None,
                    update=lambda p, g, s: (seen.append(g) or p, s,
                                            {"lr": torch.tensor(0.0)}))
    params = trainable(lm.init_model(cfg, device="cpu"))
    _, _, full = steps_lib.make_train_step(cfg, opt, executor=ex)(
        params, None, batch)
    _, _, acc = steps_lib.make_grad_accum_train_step(cfg, opt, 4, executor=ex)(
        params, None, batch)
    assert abs(float(full["loss"]) - float(acc["loss"])) <= 1e-6 * float(full["loss"])
    g_full, g_acc = seen
    for (key, a), b in zip(tree_lib.flat(g_full).items(), tree_lib.leaves(g_acc)):
        assert b.dtype == torch.float32
        assert float(torch.linalg.vector_norm(a - b)) <= \
            1e-6 * float(torch.linalg.vector_norm(a)) + 1e-12, key


# -- sharding rules ------------------------------------------------------------------------


class _MeshShape:
    def __init__(self, shape):
        self.shape = dict(shape)


MESHES = ({"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16},
          {"data": 8, "model": 1}, {"data": 2, "model": 4})


@functools.lru_cache(maxsize=None)
def _jax_trees(arch):
    jcfg = jax_get_config(arch)
    box = {}

    def init():
        params, axes = jax_lm.init_model(jax.random.PRNGKey(0), jcfg)
        box["axes"] = axes
        return params

    shapes = jax.eval_shape(init)
    cache = jax.eval_shape(lambda: jax_lm.init_cache(jcfg, 128, 4096))
    return shapes, box["axes"], cache, jax_lm.cache_axes(jcfg)


def _stack_dims(path):
    return sum(1 for part in path.split("/") if part.isdigit())


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_sharding_rules_match_jax(arch):
    cfg = get_config(arch)
    jshapes, jaxes, jcache, jcache_axes = _jax_trees(arch)
    shapes, axes = steps_lib.model_shapes_and_axes(cfg)
    cache = steps_lib.cache_struct(cfg, 128, 4096)
    flat_axes = tree_lib.flat(axes, is_leaf=shd._is_axes_leaf)
    paths = jax.tree_util.tree_flatten_with_path(jshapes)[0]
    jax_axes_leaves = jax.tree_util.tree_leaves(jaxes, is_leaf=jax_shd._is_axes_leaf)
    assert len(paths) == len(jax_axes_leaves)
    jflat = {"/".join(str(k.key) for k in path): (leaf.shape, a)
             for (path, leaf), a in zip(paths, jax_axes_leaves)}
    assert set(jflat) == {"/".join(p for p in k.split("/") if not p.isdigit())
                          for k in flat_axes}
    for mesh_shape in MESHES:
        mesh = _MeshShape(mesh_shape)
        for zero in ("none", "zero1", "fsdp"):
            specs = tree_lib.flat(shd.param_shardings(mesh, shapes, axes, zero=zero),
                                  is_leaf=lambda x: isinstance(x, tuple))
            for key, spec in specs.items():
                jkey = "/".join(p for p in key.split("/") if not p.isdigit())
                jshape, jax_axes = jflat[jkey]
                want = tuple(jax_shd.spec_for_leaf(jshape, jax_axes, mesh, zero=zero))
                k = _stack_dims(key)
                assert all(e is None for e in want[:k]), (key, want)
                assert spec == want[k:], (arch, mesh_shape, zero, key, spec, want)
        cspecs = shd.cache_shardings(mesh, cache, lm.cache_axes(cfg))
        jc = jax.tree_util.tree_map(
            lambda s, a: tuple(jax_shd.spec_for_leaf(s.shape, a, mesh)), jcache,
            jcache_axes, is_leaf=jax_shd._is_axes_leaf)
        got = tree_lib.flat(cspecs, is_leaf=lambda x: isinstance(x, tuple))
        want = {"/".join(str(getattr(k, "key", getattr(k, "name", k)))
                         for k in path): leaf
                for path, leaf in jax.tree_util.tree_flatten_with_path(
                    jc, is_leaf=lambda x: isinstance(x, tuple))[0]}
        assert got == want, (arch, mesh_shape)
        for b in (128, 8, 3):
            for extra in (1, 2):
                assert shd.batch_spec(mesh, b, extra) == tuple(
                    jax_shd.batch_spec(mesh, b, extra))


def test_train_shardings_and_shard_local():
    cfg = get_smoke_config("granite_8b")
    mesh = _MeshShape({"data": 2, "model": 4})
    opt = adamw(constant_schedule(1e-3))
    shapes, axes, p_sh, opt_shapes, opt_sh = steps_lib.train_shardings(mesh, cfg, opt)
    assert opt_sh.step == ()
    wq = tree_lib.flat(p_sh, is_leaf=lambda x: isinstance(x, tuple))["blocks/0/attn/wq"]
    mu = tree_lib.flat(opt_sh.mu, is_leaf=lambda x: isinstance(x, tuple))["blocks/0/attn/wq"]
    assert wq == (None, "model") and mu == ("data", "model")
    full = torch.arange(8 * 12.0).reshape(8, 12)
    m = Mesh({"data": 2, "model": 4})
    parts = [[shd.shard_local(full, ("data", "model"), m, {"data": d, "model": c})
              for c in range(4)] for d in range(2)]
    assert torch.equal(torch.cat([torch.cat(r, 1) for r in parts], 0), full)
    assert torch.equal(shd.shard_local(full, (("data", "model"), None), m,
                                       {"data": 1, "model": 2}), full[6:7])


