"""The port's Zamba2 serving slice against the JAX package, on the CPU.

Layers (RMSNorm, rotary embeddings, SwiGLU), the Mamba2 block
(``mamba_forward`` / ``mamba_step``) and the shared attention
(``gqa_prefill`` / ``gqa_decode``) on ``zamba2-smoke``, then the slice as a
whole — ``forward``, ``prefill``, four ``decode_step``s and greedy serving —
against the JAX reference executor, with the JAX parameters carried across
by ``convert.lm_params``.  Inputs come from numpy generators.

Tolerances: the JAX package's own serving bounds
(``tests/models/test_serving.py``): prefill / forward logits within 1e-4 of
max |logit|, decode within 1e-3; a single layer in f32 within 1e-5 of its
output's max (sums in another order).
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke_config as jax_get_smoke_config
from repro.core import make_executor as jax_make_executor
from repro.models import lm as jax_lm
from repro.nn import attention as jax_attn
from repro.nn import layers as jax_layers
from repro.nn import mamba as jax_mamba
from repro_torch import convert
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import make_executor
from repro_torch.launch import serve as serve_lib
from repro_torch.models import lm
from repro_torch.nn import attention as attn
from repro_torch.nn import layers
from repro_torch.nn import mamba
from repro_torch.nn.attention import KVCache
from repro_torch.nn.mamba import MambaState

SRC = Path(__file__).resolve().parents[1] / "src"
ARCH = "zamba2-2.7b"
SPACES = ("torch", "reference")


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def smoke():
    """The smoke config, JAX parameters (PRNGKey 3) and their port copy."""
    cfg, jcfg = get_smoke_config(ARCH), jax_get_smoke_config(ARCH)
    jparams, _ = jax_lm.init_model(jax.random.PRNGKey(3), jcfg)
    params = convert.lm_params(cfg, jax.tree_util.tree_map(np.asarray, jparams),
                               device="cpu")
    return cfg, jcfg, jparams, params


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _rel(got, want) -> float:
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max() / max(np.abs(want).max(), 1e-30))


def _tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S))


# -- configuration and conversion -------------------------------------------------


def test_zamba2_config_equals_the_jax_config_field_for_field():
    assert dataclasses.asdict(get_config(ARCH)) == dataclasses.asdict(jax_get_config(ARCH))
    assert (dataclasses.asdict(get_smoke_config("zamba2_2_7b"))
            == dataclasses.asdict(jax_get_smoke_config("zamba2_2_7b")))


def test_unported_families_raise_naming_the_roadmap():
    """Every architecture of the JAX package now resolves (its config and
    its family's init); an unknown one raises KeyError.  The expert-parallel
    MoE dispatch a ``moe_spec`` asks for, the last piece that named a
    ROADMAP item here, is ported: without a mesh it raises naming what it
    needs, and over a mesh of one rank it gives the sort dispatch's
    logits."""
    from repro.configs import ARCH_IDS as JAX_ARCH_IDS
    from repro_torch.launch.mesh import make_host_mesh, use_mesh
    from repro_torch.nn import moe

    for arch in JAX_ARCH_IDS:
        cfg = get_config(arch.replace("_", "-"))
        assert cfg == get_config(arch)
        lm.init_model(get_smoke_config(arch), device="meta")
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("no-such-model")
    base = get_smoke_config("qwen2-moe-a2.7b")
    cfg = dataclasses.replace(base, moe_spec=(("data",), "model"))
    params = lm.init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    toks = torch.zeros(1, 3, dtype=torch.int64)
    ex = make_executor("torch")
    with pytest.raises(ValueError, match="needs a mesh"):
        lm.forward(params, cfg, toks, executor=ex)
    with pytest.raises(ValueError, match="needs a mesh"):
        moe.moe_forward(params["blocks"][0]["moe"],
                        torch.zeros(1, 3, cfg.d_model), cfg, impl="ep")
    with use_mesh(make_host_mesh(1, 1)):
        ep, _ = lm.forward(params, cfg, toks, executor=ex)
    sort, _ = lm.forward(params, base, toks, executor=ex)
    assert (ep - sort).abs().max() <= 1e-5 * sort.abs().max()


def test_full_width_parameter_count():
    """Zamba2-2.7B at full width and depth: 2,646,049,440 parameters,
    5.29 GB in bf16 (shapes only, no storage)."""
    params = lm.init_model(get_config(ARCH), device="meta")
    assert sum(p.numel() for p in params.parameters()) == 2_646_049_440
    assert len(params["mamba"]) == 9 and len(params["mamba"][0]) == 6
    assert params["mamba"][0][0]["in_proj"].shape == (2560, 10576)
    assert params["shared"]["attn"]["wq"].shape == (5120, 5120)
    assert params["shared"]["attn"]["wq"].dtype == torch.bfloat16
    assert params["final_norm"]["scale"].dtype == torch.float32


def test_lm_params_unstacks_and_rejects_bad_trees(smoke):
    cfg, _, jparams, params = smoke
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    G, per = 2, 2
    for g in range(G):
        for i in range(per):
            np.testing.assert_array_equal(
                params["mamba"][g][i]["in_proj"].numpy(),
                np_params["mamba"]["in_proj"][g, i])
        np.testing.assert_array_equal(params["lora"][g]["q_b"].numpy(),
                                      np_params["lora"]["q_b"][g])
    bad = dict(np_params, lm_head=np_params["lm_head"][:, :-1])
    with pytest.raises(ValueError, match="shape"):
        convert.lm_params(cfg, bad, device="cpu")
    extra = dict(np_params, shared=dict(np_params["shared"], stray=np.zeros(3)))
    with pytest.raises(ValueError, match="left-over keys \\['stray'\\]"):
        convert.lm_params(cfg, extra, device="cpu")
    missing = {k: v for k, v in np_params.items() if k != "final_norm"}
    with pytest.raises(ValueError, match="missing keys \\['final_norm'\\]"):
        convert.lm_params(cfg, missing, device="cpu")
    short = dict(np_params, lora={k: v[:1] for k, v in np_params["lora"].items()})
    with pytest.raises(ValueError, match="does not lead with 2"):
        convert.lm_params(cfg, short, device="cpu")


def test_port_init_draws_the_jax_distributions():
    """Same shapes, dtypes and init rules as the JAX package: a truncated
    normal at +-2 sigma (std 0.8796 sigma) with each std, zeros and ones."""
    cfg = dataclasses.replace(get_smoke_config(ARCH), d_model=256, d_ff=512,
                              vocab=2048)
    params = lm.init_model(cfg, torch.Generator().manual_seed(1), device="cpu")
    jparams, _ = jax_lm.init_model(jax.random.PRNGKey(1),
                                   dataclasses.replace(jax_get_smoke_config(ARCH),
                                                       d_model=256, d_ff=512,
                                                       vocab=2048))
    # the JAX tree converts onto the port's structure, so keys and shapes agree
    convert.lm_params(cfg, jax.tree_util.tree_map(np.asarray, jparams),
                      device="cpu")
    trunc = 0.8796  # std of a standard normal truncated to [-2, 2]
    checks = [
        (params["embedding"]["table"], 0.02),
        (params["mamba"][0][0]["in_proj"], 256 ** -0.5),
        (params["mamba"][1][0]["conv_w"], 0.5),
        (params["shared"]["attn"]["wq"], 512 ** -0.5),
        (params["shared"]["mlp"]["down"], 512 ** -0.5),
        (params["lora"][0]["q_b"], 1e-4),
        (params["lm_head"], 256 ** -0.5),
    ]
    for t, std in checks:
        assert abs(float(t.std()) / (trunc * std) - 1) < 0.05
        assert float(t.abs().max()) <= 2 * std * (1 + 1e-6)
    m = params["mamba"][0][1]
    assert not m["A_log"].any() and not m["dt_bias"].any() and not m["conv_b"].any()
    assert bool((m["D"] == 1).all()) and bool((m["norm_scale"] == 1).all())


# -- layers -------------------------------------------------------------------------


def test_layers_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    pos = np.tile(np.arange(5, dtype=np.int32) + 7, (2, 1))
    got = layers.apply_rope(_t(x), _t(pos), 10000.0)
    want = jax_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10000.0)
    assert _rel(got, want) < 1e-5
    p = {k: rng.standard_normal(s).astype(np.float32) * 0.2
         for k, s in (("gate", (16, 24)), ("up", (16, 24)), ("down", (24, 16)))}
    h = rng.standard_normal((3, 16)).astype(np.float32)
    got = layers.swiglu({k: _t(v) for k, v in p.items()}, _t(h))
    want = jax_layers.swiglu({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(h))
    assert _rel(got, want) < 1e-5
    scale = rng.standard_normal(16).astype(np.float32)
    for space in SPACES:
        got = layers.rmsnorm({"scale": _t(scale)}, _t(h), 1e-5,
                             executor=make_executor(space))
        want = jax_layers.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(h), 1e-5)
        assert _rel(got, want) < 1e-6
    table = rng.standard_normal((11, 16)).astype(np.float32)
    toks = np.array([[1, 10, 3]])
    np.testing.assert_array_equal(layers.embed({"table": _t(table)}, _t(toks)).numpy(),
                                  table[toks])


@pytest.mark.parametrize("space", SPACES)
def test_mamba_forward_and_step_match_jax(smoke, space):
    cfg, jcfg, jparams, params = smoke
    jp = jax.tree_util.tree_map(lambda a: a[1, 0], jparams["mamba"])
    p = params["mamba"][1][0]
    B, S = 2, 70  # more than one chunk, not a chunk multiple
    x = 0.5 * np.random.default_rng(1).standard_normal((B, S, cfg.d_model)).astype(np.float32)
    d_inner = cfg.ssm_expand * cfg.d_model
    H = d_inner // cfg.ssm_head_dim
    conv_dim = d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
    jst = jax_mamba.MambaState.zeros(B, cfg.ssm_conv, conv_dim, H, cfg.ssm_state,
                                     cfg.ssm_head_dim, jnp.float32)
    st = MambaState.zeros(B, cfg.ssm_conv, conv_dim, H, cfg.ssm_state,
                          cfg.ssm_head_dim, torch.float32, "cpu")
    ex = make_executor(space)
    want, jst = jax_mamba.mamba_forward(jp, jnp.asarray(x[:, :-1]), jcfg, jst,
                                        executor=jax_make_executor("reference"))
    got, st = mamba.mamba_forward(p, _t(x[:, :-1]), cfg, st, executor=ex)
    assert _rel(got, want) < 1e-5
    assert _rel(st.ssm, jst.ssm) < 1e-5 and _rel(st.conv, jst.conv) < 1e-6
    want, jst = jax_mamba.mamba_step(jp, jnp.asarray(x[:, -1:]), jcfg, jst)
    got, st = mamba.mamba_step(p, _t(x[:, -1:]), cfg, st)
    assert _rel(got, want) < 1e-5 and _rel(st.ssm, jst.ssm) < 1e-5


@pytest.mark.parametrize("space", SPACES)
def test_gqa_prefill_and_decode_match_jax(smoke, space):
    cfg, jcfg, jparams, params = smoke
    scfg, jscfg = lm._shared_cfg(cfg), jax_lm._shared_cfg(jcfg)
    B, S, Smax = 2, 9, 12
    hd = scfg.resolved_head_dim
    x = np.random.default_rng(2).standard_normal((B, S + 1, scfg.d_model)).astype(np.float32)
    pos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    jcache = jax_attn.KVCache.zeros(B, scfg.n_kv_heads, Smax, hd, jnp.float32)
    cache = KVCache.zeros(B, scfg.n_kv_heads, Smax, hd, torch.float32, "cpu")
    jp, p = jparams["shared"]["attn"], params["shared"]["attn"]
    want, jcache = jax_attn.gqa_prefill(jp, jnp.asarray(x[:, :S]), jscfg,
                                        jnp.asarray(pos), jcache,
                                        executor=jax_make_executor("reference"))
    got, cache = attn.gqa_prefill(p, _t(x[:, :S]), scfg, _t(pos), cache,
                                  executor=make_executor(space))
    assert _rel(got, want) < 1e-5 and _rel(cache.k, jcache.k) < 1e-6
    want, jcache = jax_attn.gqa_decode(jp, jnp.asarray(x[:, S:]), jscfg,
                                       jnp.int32(S), jcache)
    got, cache = attn.gqa_decode(p, _t(x[:, S:]), scfg, S, cache)
    assert _rel(got, want) < 1e-5 and _rel(cache.v, jcache.v) < 1e-6


def test_chunked_attention_is_not_ported(smoke):
    """The chunked attention is ported: on the Zamba2 shared block with
    ``attn_impl="chunked"`` the port's forward equals the JAX package's
    (``attention_xla_chunked`` at a chunk of 4 rows, and at the chunk the
    tuning table resolves), in the reference and torch spaces, and equals
    the dense route."""
    cfg, jcfg, jparams, params = smoke
    B, S = 2, 11
    x = np.random.default_rng(8).standard_normal(
        (B, S, 2 * cfg.d_model)).astype(np.float32)
    pos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    jp, p = jparams["shared"]["attn"], params["shared"]["attn"]
    dense = attn.gqa_forward(p, _t(x), lm._shared_cfg(cfg), _t(pos),
                             executor=make_executor("torch"))
    for chunk in (4, None):
        scfg = dataclasses.replace(lm._shared_cfg(cfg), attn_impl="chunked",
                                   attn_chunk=chunk)
        jscfg = dataclasses.replace(jax_lm._shared_cfg(jcfg),
                                    attn_impl="chunked", attn_chunk=chunk)
        want = jax_attn.gqa_forward(jp, jnp.asarray(x), jscfg, jnp.asarray(pos),
                                    executor=jax_make_executor("reference"))
        for space in SPACES:
            got = attn.gqa_forward(p, _t(x), scfg, _t(pos),
                                   executor=make_executor(space))
            assert _rel(got, want) < 1e-5
            assert _rel(got, dense.numpy()) < 1e-5
    assert make_executor("torch").launch_config(
        "nn_attention_chunked", {"S": S, "Skv": S, "D": 32, "itemsize": 4}
    )["chunk"] == 512


# -- the slice as a whole --------------------------------------------------------------


@pytest.mark.parametrize("space", SPACES)
def test_forward_prefill_and_decode_match_jax(smoke, space):
    cfg, jcfg, jparams, params = smoke
    jex, ex = jax_make_executor("reference"), make_executor(space)
    B, S, pre, Smax = 2, 12, 8, 16
    toks = _tokens(cfg, B, S, seed=4)
    want, _ = jax_lm.forward(jparams, jcfg, tokens=jnp.asarray(toks, jnp.int32),
                             executor=jex)
    got, metrics = lm.forward(params, cfg, _t(toks), executor=ex)
    assert metrics == {} and got.dtype == torch.float32
    assert _rel(got, want) < 1e-4

    jcache = jax_lm.init_cache(jcfg, B, Smax)
    cache = lm.init_cache(cfg, B, Smax, device="cpu")
    jl, jcache = jax_lm.prefill(jparams, jcfg, tokens=jnp.asarray(toks[:, :pre], jnp.int32),
                                cache=jcache, executor=jex)
    pl, cache = lm.prefill(params, cfg, _t(toks[:, :pre]), cache=cache, executor=ex)
    scale = max(float(np.abs(np.asarray(jl)).max()), 1.0)
    assert float(np.abs(pl.numpy() - np.asarray(jl)).max()) / scale < 1e-4
    for t in range(pre, pre + 4):
        jl, jcache = jax_lm.decode_step(jparams, jcfg,
                                        tokens=jnp.asarray(toks[:, t:t + 1], jnp.int32),
                                        length=jnp.int32(t), cache=jcache,
                                        executor=jex)
        dl, cache = lm.decode_step(params, cfg, _t(toks[:, t:t + 1]), length=t,
                                   cache=cache, executor=ex)
        assert float(np.abs(dl.numpy() - np.asarray(jl)).max()) / scale < 1e-3
    # the cache in the JAX package's stacked layout
    assert _rel(cache["mamba"].ssm, jcache["mamba"].ssm) < 1e-4
    assert _rel(cache["kv"].k, jcache["kv"].k) < 1e-5


def test_decode_matches_full_forward(smoke):
    """The port's own serving contract: prefill + token-by-token decode
    reproduce the full forward (the JAX package's test_serving bounds)."""
    cfg, _, _, params = smoke
    ex = make_executor("torch")
    B, S, Smax, pre = 2, 10, 16, 6
    toks = _t(_tokens(cfg, B, S, seed=7))
    full, _ = lm.forward(params, cfg, toks, executor=ex)
    cache = lm.init_cache(cfg, B, Smax, device="cpu")
    pre_logits, cache = lm.prefill(params, cfg, toks[:, :pre], cache=cache, executor=ex)
    scale = max(float(full.abs().max()), 1.0)
    assert float((pre_logits - full[:, :pre]).abs().max()) / scale < 1e-4
    outs = []
    for t in range(pre, S):
        lg, cache = lm.decode_step(params, cfg, toks[:, t:t + 1], length=t,
                                   cache=cache, executor=ex)
        outs.append(lg)
    dec = torch.cat(outs, dim=1)
    assert float((dec - full[:, pre:]).abs().max()) / scale < 1e-3


def test_greedy_serve_tokens_match_jax(smoke, capsys):
    cfg, jcfg, jparams, params = smoke
    B, P, gen, seed = 2, 8, 6, 5
    res = serve_lib.serve(cfg, batch=B, prompt_len=P, gen_len=gen, seed=seed,
                          executor=make_executor("torch"), device="cpu",
                          params=params)
    assert "[serve] zamba2-smoke" in capsys.readouterr().out
    prompt = np.random.default_rng(seed).integers(0, cfg.vocab, size=(B, P))
    np.testing.assert_array_equal(res.prompt.numpy(), prompt)
    # the JAX package's greedy loop (launch/serve.py) on the reference executor
    jex = jax_make_executor("reference")
    jcache = jax_lm.init_cache(jcfg, B, P + gen)
    lg, jcache = jax_lm.prefill(jparams, jcfg, tokens=jnp.asarray(prompt, jnp.int32),
                                cache=jcache, executor=jex)
    scale = max(float(np.abs(np.asarray(lg[:, -1])).max()), 1.0)
    assert float(np.abs(res.prefill_logits.numpy() - np.asarray(lg[:, -1])).max()) / scale < 1e-4
    tok = jnp.argmax(lg[:, -1], axis=-1).astype(jnp.int32)
    want = [tok]
    for t in range(P, P + gen - 1):
        lg, jcache = jax_lm.decode_step(jparams, jcfg, tokens=tok[:, None],
                                        length=jnp.int32(t), cache=jcache,
                                        executor=jex)
        tok = jnp.argmax(lg[:, -1], axis=-1).astype(jnp.int32)
        want.append(tok)
    np.testing.assert_array_equal(res.tokens.numpy(), np.stack(want, axis=1))
    assert len(res.step_logits) == gen - 1 and res.tokens.shape == (B, gen)


def test_temperature_sampling_is_seeded(smoke):
    cfg, _, _, params = smoke
    kw = dict(batch=2, prompt_len=5, gen_len=4, greedy=False, temperature=0.7,
              executor=make_executor("torch"), device="cpu", params=params)
    a = serve_lib.serve(cfg, seed=3, **kw)
    b = serve_lib.serve(cfg, seed=3, **kw)
    assert torch.equal(a.tokens, b.tokens)
    assert int(a.tokens.min()) >= 0 and int(a.tokens.max()) < cfg.vocab


# -- the entry point ---------------------------------------------------------------------


def test_serve_cli_smoke_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH,
         "--smoke", "--device", "cpu", "--executor", "torch", "--batch", "2",
         "--prompt-len", "8", "--gen-len", "4"],
        env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "[serve] zamba2-smoke: prefill 2x8" in r.stdout


def test_serve_asks_for_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_lib.main(["--arch", ARCH, "--smoke"])
    with pytest.raises(SystemExit):  # the cuda executor on the CPU: refused
        serve_lib.main(["--arch", ARCH, "--smoke", "--device", "cpu"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lm.init_model(get_smoke_config(ARCH))
