"""AdamW, schedules, the data pipeline, gradient compression, checkpoints
and the fault-tolerance runtime of the port against the JAX package (and
``tests/substrate/test_substrate.py``'s cases for the port).

Tolerances: f32 parameters and moments within 1e-6 relative of the JAX
package's after 6 steps (XLA's ``pow`` and fused products round in another
order), bf16 parameters within one bf16 ulp; schedules within 1e-6; the data
arrays, stub embeddings and int8 payloads bitwise.
"""

import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import data as jax_data
from repro import optim as jax_optim
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core import tree as tree_lib
from repro_torch.data import (DataConfig, DataIterator, entropy_floor,
                              global_step_batch, shard_batch_np)
from repro_torch.optim import (adamw, clip_by_global_norm, compress_tree,
                               constant_schedule, decompress_tree,
                               dequantize_int8, ef_compress, init_error_state,
                               quantize_int8, warmup_cosine_schedule,
                               warmup_linear_schedule)
from repro_torch.runtime import (PreemptionHandler, StragglerMonitor,
                                 run_with_restarts)


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _np(t):
    return t.detach().float().numpy() if t.dtype == torch.bfloat16 else \
        t.detach().numpy()


# -- schedules and AdamW ------------------------------------------------------------


@pytest.mark.parametrize("name,args", [
    ("warmup_cosine_schedule", (3e-3, 4, 40)),
    ("warmup_cosine_schedule", (1.0, 10, 100, 0.2)),
    ("warmup_linear_schedule", (2e-3, 5, 30)),
    ("constant_schedule", (3e-3,)),
])
def test_schedules_match_jax(name, args):
    from repro_torch import optim

    mine, theirs = getattr(optim, name)(*args), getattr(jax_optim, name)(*args)
    for step in (0, 1, 3, 4, 5, 10, 29, 40, 55):
        got = float(mine(torch.tensor(step, dtype=torch.int32)))
        want = float(theirs(jnp.int32(step)))
        assert abs(got - want) <= 1e-6 * max(abs(want), 1e-12), (step, got, want)


def _tree(rng, dtype):
    shapes = {"a": (4, 3), "b": {"c": (5,), "d": (2, 2, 3)}}

    def draw(s):
        return rng.standard_normal(s).astype(np.float32)

    p = {"a": draw(shapes["a"]), "b": {k: draw(v) for k, v in shapes["b"].items()}}
    return p


def _to_torch(tree, dtype):
    return tree_lib.tree_map(lambda a: torch.from_numpy(np.array(a)).to(dtype),
                             tree)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip", [1.0, None])
def test_adamw_states_and_stats_match_jax(dtype, clip):
    tdt = getattr(torch, dtype)
    jdt = getattr(jnp, dtype)
    rng = np.random.default_rng(4)
    p0 = _tree(rng, dtype)
    sched = (warmup_cosine_schedule(1e-2, 2, 6), jax_optim.warmup_cosine_schedule(1e-2, 2, 6))
    opt = adamw(sched[0], weight_decay=0.1, clip_norm=clip)
    jopt = jax_optim.adamw(sched[1], weight_decay=0.1, clip_norm=clip)
    params = _to_torch(p0, tdt)
    jparams = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jdt), p0)
    state, jstate = opt.init(params), jopt.init(jparams)
    for _ in range(6):
        g = _tree(rng, dtype)
        g = jax.tree_util.tree_map(lambda a: a * 3.0, g)
        params, state, stats = opt.update(params, _to_torch(g, tdt), state)
        jparams, jstate, jstats = jopt.update(
            jparams, jax.tree_util.tree_map(lambda a: jnp.asarray(a, jdt), g),
            jstate)
        for key in ("grad_norm", "lr", "param_norm"):
            assert abs(float(stats[key]) - float(jstats[key])) <= \
                1e-5 * abs(float(jstats[key])), key
    assert int(state.step) == int(jstate.step) == 6
    got = tree_lib.flat(params)
    want = tree_lib.flat({"a": jparams["a"], "b": jparams["b"]})
    for key, w in want.items():
        w = np.asarray(w, np.float32)
        tol = (2.0 ** -8) * np.abs(w) + 1e-7 if dtype == "bfloat16" else \
            1e-6 * np.abs(w).max()
        assert np.all(np.abs(_np(got[key]) - w) <= tol), key
    for mine, theirs in ((state.mu, jstate.mu), (state.nu, jstate.nu)):
        for key, w in tree_lib.flat({"a": theirs["a"], "b": theirs["b"]}).items():
            w = np.asarray(w)
            assert tree_lib.flat(mine)[key].dtype == torch.float32
            assert np.abs(_np(tree_lib.flat(mine)[key]) - w).max() <= \
                1e-5 * np.abs(w).max() + 1e-12, key


def test_adamw_converges_quadratic():
    opt = adamw(warmup_cosine_schedule(0.1, 10, 200), weight_decay=0.0)
    params = {"w": torch.ones(4) * 3.0}
    state = opt.init(params)
    for _ in range(200):
        g = {"w": 2 * (params["w"] - 1.0)}
        params, state, _ = opt.update(params, g, state)
    np.testing.assert_allclose(params["w"].numpy(), 1.0, atol=1e-2)


def test_adamw_weight_decay_pulls_to_zero():
    opt = adamw(constant_schedule(0.05), weight_decay=1.0, clip_norm=None)
    params = {"w": torch.ones(4)}
    state = opt.init(params)
    for _ in range(100):
        params, state, _ = opt.update(params, {"w": torch.zeros(4)}, state)
    assert float(params["w"].abs().max()) < 0.1


def test_clip_by_global_norm():
    clipped, norm = clip_by_global_norm({"a": torch.ones(4) * 10.0}, 1.0)
    np.testing.assert_allclose(float(norm), 20.0)
    np.testing.assert_allclose(float(torch.linalg.norm(clipped["a"])), 1.0,
                               rtol=1e-5)


def test_adamw_updates_a_param_tree_in_place():
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import lm
    from repro_torch.nn.common import ParamTree, trainable

    cfg = get_smoke_config("smollm_135m")
    params = trainable(lm.init_model(cfg, device="cpu"))
    opt = adamw(constant_schedule(1e-2))
    state = opt.init(params)
    assert isinstance(state.mu, ParamTree)
    before = params["final_norm"]["scale"].detach().clone()
    grads = tree_lib.tree_map(torch.ones_like, params)
    out, state, _ = opt.update(params, grads, state)
    assert out is params and params["final_norm"]["scale"].requires_grad
    assert not torch.equal(before, params["final_norm"]["scale"])


# -- data ------------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(vocab=256, seq_len=64, global_batch=8, seed=17),
    dict(vocab=49152, seq_len=33, global_batch=6, num_shards=3, seed=5),
    dict(vocab=64, seq_len=8, global_batch=4, seed=1, stub_embed_dim=32),
])
def test_data_arrays_bitwise_jax(kw):
    mine, theirs = DataConfig(**kw), jax_data.DataConfig(**kw)
    for step in (0, 1, 17):
        a, b = global_step_batch(mine, step), jax_data.global_step_batch(theirs, step)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])
        for shard in range(mine.num_shards):
            a = shard_batch_np(mine, step, shard)
            b = jax_data.shard_batch_np(theirs, step, shard)
            for k in a:
                assert np.array_equal(a[k], b[k])
    assert entropy_floor(mine) == jax_data.entropy_floor(theirs)


def test_data_determinism_sharding_and_resume():
    cfg = DataConfig(vocab=64, seq_len=8, global_batch=4, num_shards=2, seed=5)
    b1 = global_step_batch(cfg, 3)
    s0, s1 = shard_batch_np(cfg, 3, 0), shard_batch_np(cfg, 3, 1)
    np.testing.assert_array_equal(np.concatenate([s0["tokens"], s1["tokens"]]),
                                  b1["tokens"])
    np.testing.assert_array_equal(b1["tokens"][:, 1:], b1["labels"][:, :-1])
    it = DataIterator(DataConfig(vocab=64, seq_len=8, global_batch=2, seed=1))
    next(it)
    it2 = DataIterator(it.cfg)
    it2.restore(it.state())
    np.testing.assert_array_equal(next(it)["tokens"], next(it2)["tokens"])


# -- compression -----------------------------------------------------------------------


def test_quantize_and_ef_match_jax():
    rng = np.random.default_rng(8)
    x = rng.standard_normal((64, 3)).astype(np.float32)
    e = (rng.standard_normal((64, 3)) * 1e-2).astype(np.float32)
    q, s = quantize_int8(torch.from_numpy(x))
    jq, js = jax_optim.quantize_int8(jnp.asarray(x))
    assert np.array_equal(q.numpy(), np.asarray(jq)) and float(s) == float(js)
    np.testing.assert_array_equal(dequantize_int8(q, s).numpy(),
                                  np.asarray(jax_optim.dequantize_int8(jq, js)))
    q, s, ne = ef_compress(torch.from_numpy(x), torch.from_numpy(e))
    jq, js, jne = jax_optim.ef_compress(jnp.asarray(x), jnp.asarray(e))
    assert np.array_equal(q.numpy(), np.asarray(jq)) and float(s) == float(js)
    np.testing.assert_allclose(ne.numpy(), np.asarray(jne), atol=1e-7)
    zeros = np.zeros(5, np.float32)
    q, s = quantize_int8(torch.from_numpy(zeros))
    assert float(s) == 1.0 and not q.any()


def test_compress_tree_matches_jax():
    rng = np.random.default_rng(9)
    g = {"w": rng.standard_normal((16,)).astype(np.float32),
         "b": {"c": rng.standard_normal((3, 4)).astype(np.float32)}}
    tg = tree_lib.tree_map(torch.from_numpy, g)
    jg = jax.tree_util.tree_map(jnp.asarray, g)
    err, jerr = init_error_state(tg), jax_optim.init_error_state(jg)
    for _ in range(3):
        (q, s), err = compress_tree(tg, err)
        (jq, js), jerr = jax_optim.compress_tree(jg, jerr)
        for key, a in tree_lib.flat(q).items():
            assert np.array_equal(a.numpy(), np.asarray(tree_lib.flat(jq)[key]))
        for key, a in tree_lib.flat(err).items():
            np.testing.assert_allclose(a.numpy(), np.asarray(
                tree_lib.flat(jerr)[key]), atol=1e-7)
    dec = decompress_tree(q, s, tg)
    jdec = jax_optim.decompress_tree(jq, js, jg)
    for key, a in tree_lib.flat(dec).items():
        np.testing.assert_array_equal(a.numpy(), np.asarray(tree_lib.flat(jdec)[key]))


def test_quantize_roundtrip_bounds(rng):
    x = torch.from_numpy(rng.normal(size=(64,)).astype(np.float32))
    q, s = quantize_int8(x)
    assert float((dequantize_int8(q, s) - x).abs().max()) <= float(s) / 2 + 1e-7


def test_error_feedback_unbiased_over_time(rng):
    g = {"w": torch.from_numpy((rng.normal(size=(128,)) * 1e-3).astype(np.float32))}
    err = init_error_state(g)
    acc = torch.zeros(128)
    acc_q = torch.zeros(128)
    for _ in range(50):
        (q, s), err = compress_tree(g, err)
        acc = acc + g["w"]
        acc_q = acc_q + decompress_tree(q, s, g)["w"]
    assert float(torch.linalg.norm(acc - acc_q) / torch.linalg.norm(acc)) < 0.01


def test_compressed_psum_without_a_group_is_the_ef_mean():
    from repro_torch.optim import compressed_psum

    g = {"w": torch.linspace(-1, 1, 9)}
    mean, err = compressed_psum(g, init_error_state(g))
    q, s, ne = ef_compress(g["w"], torch.zeros(9))
    torch.testing.assert_close(mean["w"], dequantize_int8(q, s), rtol=0, atol=0)
    torch.testing.assert_close(err["w"], ne, rtol=0, atol=0)


# -- checkpoint --------------------------------------------------------------------------


def test_checkpoint_roundtrip_keepk_atomic():
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d, keep_k=2)
        tree = {"a": torch.arange(6.0), "b": {"c": torch.ones((2, 3), dtype=torch.int32)}}
        for s in (1, 2, 3):
            mgr.save(s, tree, metadata={"step": s})
        mgr.wait()
        assert mgr.all_steps() == [2, 3]
        proto = tree_lib.tree_map(torch.zeros_like, tree)
        got, meta = mgr.restore(target=proto)
        assert meta["step"] == 3
        assert torch.equal(got["a"], tree["a"]) and torch.equal(got["b"]["c"], tree["b"]["c"])
        os.makedirs(os.path.join(d, "step_00000009.tmp"))
        CheckpointManager(d)
        assert not os.path.exists(os.path.join(d, "step_00000009.tmp"))


def test_checkpoint_restores_dataclass_trees_and_bf16():
    opt = adamw(constant_schedule(1e-3))
    params = {"w": torch.linspace(-2, 2, 6).reshape(3, 2).to(torch.bfloat16)}
    state = opt.init(params)
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d)
        mgr.save(1, {"params": params, "opt": state}, block=True)
        proto = {"params": tree_lib.tree_map(torch.zeros_like, params),
                 "opt": tree_lib.tree_map(torch.zeros_like, state)}
        got, _ = mgr.restore(target=proto)
        assert got["params"]["w"].dtype == torch.bfloat16
        assert torch.equal(got["params"]["w"].view(torch.int16),
                           params["w"].view(torch.int16))
        assert int(got["opt"].step) == 0 and type(got["opt"]) is type(state)
        flat, _ = mgr.restore()
        assert flat["params/w"].dtype == torch.bfloat16


def test_checkpoint_write_error_surfaces_on_wait():
    """A write that fails in the background thread (a file where its .tmp
    directory goes) raises on the next wait(), once."""
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d)
        with open(os.path.join(d, "step_00000002.tmp"), "w") as f:
            f.write("in the way")
        mgr.save(2, {"x": torch.ones(2)})
        with pytest.raises(OSError):
            mgr.wait()
        mgr.wait()  # the error was surfaced once
        assert mgr.all_steps() == []


# -- runtime -----------------------------------------------------------------------------


def test_straggler_monitor():
    mon = StragglerMonitor(window=20, factor=2.0, min_samples=5)
    for _ in range(10):
        assert not mon.record(0.1)
    assert mon.record(0.5)
    assert mon.alarms == 1
    assert not mon.record(0.12)


def test_preemption_handler_simulation():
    h = PreemptionHandler()
    assert not h.preempted
    h.simulate()
    assert h.preempted


def test_run_with_restarts():
    calls = {"n": 0}

    def loop(state):
        calls["n"] += 1
        if calls["n"] < 3:
            raise RuntimeError("injected fault")
        return "done"

    restarts = []
    out = run_with_restarts(dict, loop, max_restarts=5,
                            on_restart=lambda i, e: restarts.append(i))
    assert out == "done" and calls["n"] == 3 and restarts == [1, 2]


def test_run_with_restarts_exhausts():
    def loop(state):
        raise RuntimeError("always fails")

    with pytest.raises(RuntimeError):
        run_with_restarts(dict, loop, max_restarts=2)
