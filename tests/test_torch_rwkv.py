"""The port's RWKV6-3B serving slice against the JAX package, on the CPU.

Layers (LayerNorm, group norm), the RWKV6 block (``time_mix_forward`` /
``time_mix_step`` / ``channel_mix_forward``) on ``rwkv6-smoke``, then the
slice as a whole — ``forward``, ``prefill``, four ``decode_step``s and greedy
serving — against the JAX reference executor, with the JAX parameters
carried across by ``convert.lm_params``.  Inputs come from numpy generators.

The JAX init zeroes ``w0``, ``w_lora_b`` and ``mix_lora_b``, so at init every
decay is exactly e^-1 and every token-shift mix is data-independent.  Each
parity test therefore also runs on "perturbed" parameters: those three
leaves replaced by seeded numpy draws, handed to both packages, which spread
the decays e^(-e^w) over (0.01, 0.95) across channels and make them depend
on the token.

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
from repro.nn import layers as jax_layers
from repro.nn import rwkv as jax_rwkv
from repro_torch import convert
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import make_executor
from repro_torch.launch import serve as serve_lib
from repro_torch.models import lm
from repro_torch.nn import layers
from repro_torch.nn import rwkv
from repro_torch.nn.rwkv import RWKVState

SRC = Path(__file__).resolve().parents[1] / "src"
ARCH = "rwkv6-3b"
SPACES = ("torch", "reference")
INITS = ("plain", "perturbed")


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def perturb(np_params, seed: int):
    """``w0``, ``w_lora_b`` and ``mix_lora_b`` of every layer replaced by
    seeded draws (numpy, stacked over the layers): w0 uniform in (-3, 1.5)
    per channel, the LoRA outputs of order 0.5, so tokens move the decay."""
    rng = np.random.default_rng(seed)
    tm = dict(np_params["blocks"]["time_mix"])
    L, d = tm["w0"].shape
    r = tm["w_lora_b"].shape[1]
    tm["w0"] = rng.uniform(-3.0, 1.5, (L, d)).astype(tm["w0"].dtype)
    tm["w_lora_b"] = (0.8 / np.sqrt(r) * rng.standard_normal(
        tm["w_lora_b"].shape)).astype(tm["w_lora_b"].dtype)
    tm["mix_lora_b"] = (0.5 / np.sqrt(r) * rng.standard_normal(
        tm["mix_lora_b"].shape)).astype(tm["mix_lora_b"].dtype)
    blocks = dict(np_params["blocks"], time_mix=tm)
    return dict(np_params, blocks=blocks)


@pytest.fixture(scope="module")
def smoke():
    """The smoke config and, per init, the JAX parameters (PRNGKey 3; the
    perturbed ones with seeded decay / mix leaves) and their port copy."""
    cfg, jcfg = get_smoke_config(ARCH), jax_get_smoke_config(ARCH)
    jparams, _ = jax_lm.init_model(jax.random.PRNGKey(3), jcfg)
    np_plain = jax.tree_util.tree_map(np.asarray, jparams)
    out = {}
    for init, np_params in (("plain", np_plain),
                            ("perturbed", perturb(np_plain, seed=9))):
        out[init] = (jax.tree_util.tree_map(jnp.asarray, np_params),
                     convert.lm_params(cfg, np_params, device="cpu"))
    return cfg, jcfg, out


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _rel(got, want) -> float:
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max() / max(np.abs(want).max(), 1e-30))


def _tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S))


# -- configuration and conversion -------------------------------------------------


def test_rwkv6_config_equals_the_jax_config_field_for_field():
    assert dataclasses.asdict(get_config(ARCH)) == dataclasses.asdict(jax_get_config(ARCH))
    assert (dataclasses.asdict(get_smoke_config("rwkv6_3b"))
            == dataclasses.asdict(jax_get_smoke_config("rwkv6_3b")))


def test_full_width_parameter_count():
    """RWKV6-3B at full width and depth: 3,094,374,400 parameters, 6.19 GB;
    the four layernorms' scale and bias f32, every other leaf bf16 (shapes
    only, no storage)."""
    params = lm.init_model(get_config(ARCH), device="meta")
    named = dict(params.named_parameters())
    assert sum(p.numel() for p in named.values()) == 3_094_374_400
    assert sum(p.numel() * p.element_size() for p in named.values()) == 6_189_424_640
    for name, p in named.items():
        is_ln = name.split(".")[-2:-1] in (["ln0"], ["ln1"], ["ln2"],
                                           ["final_norm"])
        assert p.dtype == (torch.float32 if is_ln else torch.bfloat16), name
    assert len(params["blocks"]) == 32
    tm = params["blocks"][0]["time_mix"]
    assert tm["mix_lora_a"].shape == (2560, 48) and tm["mix_lora_b"].shape == (48, 12800)
    assert tm["u"].shape == (40, 64)
    assert params["blocks"][31]["channel_mix"]["wk"].shape == (2560, 8960)
    assert params["lm_head"].shape == (2560, 65536)


def test_lm_params_unstacks_nested_blocks_and_rejects_bad_trees(smoke):
    cfg, _, inits = smoke
    jparams, params = inits["perturbed"]
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    for i in range(cfg.n_layers):
        b = params["blocks"][i]
        np.testing.assert_array_equal(b["time_mix"]["w0"].numpy(),
                                      np_params["blocks"]["time_mix"]["w0"][i])
        np.testing.assert_array_equal(b["channel_mix"]["wv"].numpy(),
                                      np_params["blocks"]["channel_mix"]["wv"][i])
        np.testing.assert_array_equal(b["ln2"]["bias"].numpy(),
                                      np_params["blocks"]["ln2"]["bias"][i])
    blocks = np_params["blocks"]
    short = dict(np_params, blocks=dict(blocks, time_mix=dict(
        blocks["time_mix"], u=blocks["time_mix"]["u"][:1])))
    with pytest.raises(ValueError, match="blocks.time_mix.u: stacked shape .* "
                                         "does not lead with 2"):
        convert.lm_params(cfg, short, device="cpu")
    extra = dict(np_params, blocks=dict(blocks, ln1=dict(blocks["ln1"],
                                                         stray=np.zeros((2, 3)))))
    with pytest.raises(ValueError, match="blocks\\[0\\].ln1: missing keys \\[\\], "
                                         "left-over keys \\['stray'\\]"):
        convert.lm_params(cfg, extra, device="cpu")
    bad = dict(np_params, blocks=dict(blocks, channel_mix=dict(
        blocks["channel_mix"], wk=blocks["channel_mix"]["wk"][:, :, :-1])))
    with pytest.raises(ValueError, match="blocks\\[0\\].channel_mix.wk: shape"):
        convert.lm_params(cfg, bad, device="cpu")
    with pytest.raises(ValueError, match="blocks: expected a mapping"):
        convert.lm_params(cfg, dict(np_params, blocks=[blocks]), device="cpu")
    with pytest.raises(ValueError, match="missing keys \\['ln0'\\]"):
        convert.lm_params(cfg, {k: v for k, v in np_params.items() if k != "ln0"},
                          device="cpu")


# -- layers and blocks ----------------------------------------------------------------


def test_layernorm_and_groupnorm_match_jax():
    rng = np.random.default_rng(0)
    x = (1.5 + 2 * rng.standard_normal((2, 5, 48))).astype(np.float32)
    p = {"scale": (1 + 0.1 * rng.standard_normal(48)).astype(np.float32),
         "bias": (0.1 * rng.standard_normal(48)).astype(np.float32)}
    got = layers.layernorm({k: _t(v) for k, v in p.items()}, _t(x), 1e-5)
    want = jax_layers.layernorm({k: jnp.asarray(v) for k, v in p.items()},
                                jnp.asarray(x), 1e-5)
    assert got.dtype == torch.float32 and _rel(got, want) < 1e-5
    got = layers.groupnorm(_t(x), 3, eps=64e-5)
    want = jax_layers.groupnorm(jnp.asarray(x), 3, eps=64e-5)
    assert _rel(got, want) < 1e-5
    # bf16 x, f32 parameters: statistics in f32, the output in x's dtype
    xb = _t(x).to(torch.bfloat16)
    out = layers.layernorm({k: _t(v) for k, v in p.items()}, xb, 1e-5)
    assert out.dtype == torch.bfloat16
    assert layers.groupnorm(xb, 3).dtype == torch.bfloat16


@pytest.mark.parametrize("init", INITS)
@pytest.mark.parametrize("space", SPACES)
def test_rwkv_block_matches_jax(smoke, space, init):
    """time_mix_forward (with a state: its token shift is read, its WKV
    state is not), then time_mix_step and channel_mix_forward one token on."""
    cfg, jcfg, inits = smoke
    jparams, params = inits[init]
    jp = jax.tree_util.tree_map(lambda a: a[1], jparams["blocks"])
    p = params["blocks"][1]
    B, S, d = 2, 45, cfg.d_model  # a chunk and a ragged tail of 13
    H, K = d // cfg.rwkv_head_dim, cfg.rwkv_head_dim
    rng = np.random.default_rng(1)
    x = rng.standard_normal((B, S + 1, d)).astype(np.float32)
    shift = rng.standard_normal((B, d)).astype(np.float32)
    wkv = rng.standard_normal((B, H, K, K)).astype(np.float32)
    jst = jax_rwkv.RWKVState(wkv=jnp.asarray(wkv), shift_tm=jnp.asarray(shift),
                             shift_cm=jnp.asarray(-shift))
    st = RWKVState(wkv=_t(wkv), shift_tm=_t(shift), shift_cm=_t(-shift))
    want, jst = jax_rwkv.time_mix_forward(jp["time_mix"], jnp.asarray(x[:, :S]),
                                          jcfg, jst,
                                          executor=jax_make_executor("reference"))
    got, st = rwkv.time_mix_forward(p["time_mix"], _t(x[:, :S]), cfg, st,
                                    executor=make_executor(space))
    assert _rel(got, want) < 1e-5
    assert _rel(st.wkv, jst.wkv) < 1e-5
    assert torch.equal(st.shift_tm, _t(x[:, S - 1]))
    assert torch.equal(st.shift_cm, _t(-shift))
    want, jst = jax_rwkv.time_mix_step(jp["time_mix"], jnp.asarray(x[:, S:]),
                                       jcfg, jst)
    got, st = rwkv.time_mix_step(p["time_mix"], _t(x[:, S:]), cfg, st)
    assert _rel(got, want) < 1e-5 and _rel(st.wkv, jst.wkv) < 1e-5
    want, jst = jax_rwkv.channel_mix_forward(jp["channel_mix"],
                                             jnp.asarray(x[:, :S]), jcfg, jst)
    got, st = rwkv.channel_mix_forward(p["channel_mix"], _t(x[:, :S]), cfg, st)
    assert _rel(got, want) < 1e-5
    assert torch.equal(st.shift_cm, _t(x[:, S - 1]))


def test_perturbed_decays_spread_across_channels_and_tokens(smoke):
    """The perturbed leaves make the decay depend on channel and token (at
    init it is e^-1 everywhere)."""
    cfg, _, inits = smoke
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (1, 16, cfg.d_model)).astype(np.float32))
    for init, (_, params) in inits.items():
        p = params["blocks"][0]["time_mix"]
        xw = rwkv._mixed(p, x, rwkv._token_shift(x, x.new_zeros(1, cfg.d_model)))[3]
        w = torch.exp(rwkv._log_decay(p, xw))
        if init == "plain":
            assert torch.allclose(w, torch.full_like(w, float(np.exp(-1.0))))
        else:
            assert float(w.min()) < 0.05 and float(w.max()) > 0.9
            assert float(w.std(dim=1).mean()) > 0.01  # varies token to token


# -- the slice as a whole --------------------------------------------------------------


@pytest.mark.parametrize("init", INITS)
@pytest.mark.parametrize("space", SPACES)
def test_forward_prefill_and_decode_match_jax(smoke, space, init):
    cfg, jcfg, inits = smoke
    jparams, params = inits[init]
    jex, ex = jax_make_executor("reference"), make_executor(space)
    B, S, pre = 2, 44, 36  # prefill crosses a chunk boundary
    toks = _tokens(cfg, B, S, seed=4)
    want, _ = jax_lm.forward(jparams, jcfg, tokens=jnp.asarray(toks, jnp.int32),
                             executor=jex)
    got, metrics = lm.forward(params, cfg, _t(toks), executor=ex)
    assert metrics == {} and got.dtype == torch.float32
    assert _rel(got, want) < 1e-4

    jcache = jax_lm.init_cache(jcfg, B, S)
    cache = lm.init_cache(cfg, B, S, device="cpu")
    assert cache.wkv.shape == jcache.wkv.shape == (2, B, 4, 16, 16)
    assert cache.shift_tm.shape == (2, B, cfg.d_model)
    jl, jcache = jax_lm.prefill(jparams, jcfg,
                                tokens=jnp.asarray(toks[:, :pre], jnp.int32),
                                cache=jcache, executor=jex)
    pl, cache = lm.prefill(params, cfg, _t(toks[:, :pre]), cache=cache,
                           executor=ex)
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
    assert _rel(cache.wkv, jcache.wkv) < 1e-4
    assert _rel(cache.shift_tm, jcache.shift_tm) < 1e-5
    assert _rel(cache.shift_cm, jcache.shift_cm) < 1e-5


@pytest.mark.parametrize("init", INITS)
def test_split_prefill_and_decode_match_full_prefill(smoke, init):
    """The port's own serving contract: prefill(S - 4) + 4 decode steps
    reproduce prefill(S) (the JAX package's test_serving bounds)."""
    cfg, _, inits = smoke
    _, params = inits[init]
    ex = make_executor("torch")
    B, S = 2, 40
    toks = _t(_tokens(cfg, B, S, seed=7))
    full, _ = lm.prefill(params, cfg, toks, cache=lm.init_cache(cfg, B, S, "cpu"),
                         executor=ex)
    fwd, _ = lm.forward(params, cfg, toks, executor=ex)
    scale = max(float(full.abs().max()), 1.0)
    assert float((fwd - full).abs().max()) / scale < 1e-5
    cache = lm.init_cache(cfg, B, S, device="cpu")
    pre, cache = lm.prefill(params, cfg, toks[:, :S - 4], cache=cache, executor=ex)
    assert float((pre - full[:, :S - 4]).abs().max()) / scale < 1e-4
    for t in range(S - 4, S):
        lg, cache = lm.decode_step(params, cfg, toks[:, t:t + 1], length=t,
                                   cache=cache, executor=ex)
        assert float((lg[:, 0] - full[:, t]).abs().max()) / scale < 1e-3


def test_prefill_starts_the_wkv_state_from_zero(smoke):
    """As in the JAX package (ROADMAP C5): prefill reads the cache's token
    shifts but not its WKV state."""
    cfg, jcfg, inits = smoke
    jparams, params = inits["perturbed"]
    B, S = 2, 8
    toks = _tokens(cfg, B, S, seed=8)
    rng = np.random.default_rng(3)
    wkv = rng.standard_normal((cfg.n_layers, B, 4, 16, 16)).astype(np.float32)
    ex = make_executor("torch")
    zero, _ = lm.prefill(params, cfg, _t(toks), cache=lm.init_cache(cfg, B, S, "cpu"),
                         executor=ex)
    cache = lm.init_cache(cfg, B, S, device="cpu")
    cache.wkv.copy_(_t(wkv))
    got, cache = lm.prefill(params, cfg, _t(toks), cache=cache, executor=ex)
    assert torch.equal(got, zero)
    jcache = jax_lm.init_cache(jcfg, B, S)
    jcache = dataclasses.replace(jcache, wkv=jnp.asarray(wkv))
    want, _ = jax_lm.prefill(jparams, jcfg, tokens=jnp.asarray(toks, jnp.int32),
                             cache=jcache, executor=jax_make_executor("reference"))
    assert _rel(got, want) < 1e-4


@pytest.mark.parametrize("init", INITS)
def test_greedy_serve_tokens_match_jax(smoke, init, capsys):
    cfg, jcfg, inits = smoke
    jparams, params = inits[init]
    B, P, gen, seed = 2, 8, 6, 5
    res = serve_lib.serve(cfg, batch=B, prompt_len=P, gen_len=gen, seed=seed,
                          executor=make_executor("torch"), device="cpu",
                          params=params)
    assert "[serve] rwkv6-smoke" in capsys.readouterr().out
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


# -- the entry point ---------------------------------------------------------------------


def test_serve_cli_smoke_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH,
         "--smoke", "--device", "cpu", "--executor", "torch", "--batch", "2",
         "--prompt-len", "40", "--gen-len", "4"],
        env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "[serve] rwkv6-smoke: prefill 2x40" in r.stdout


def test_serve_asks_for_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_lib.main(["--arch", ARCH, "--smoke"])
    with pytest.raises(SystemExit):  # the cuda executor on the CPU: refused
        serve_lib.main(["--arch", ARCH, "--smoke", "--device", "cpu"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lm.init_model(get_smoke_config(ARCH))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lm.init_cache(get_smoke_config(ARCH), 1, 8)
