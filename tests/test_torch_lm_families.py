"""The port's transformer families (dense, MoE, MLA) with the stub-embedding
frontend, GELU, sinusoidal positions and chunked attention, against the JAX
package on the CPU.

Modules first — ``gelu_mlp`` and ``_sinusoidal``, the chunked attention at
two chunk sizes, one MLA layer's forward / prefill / decode, the MoE layer's
sort and dense dispatch with their router metrics — then, for each of the
eight smoke configurations and in the reference and torch spaces, the
family as a whole: ``forward``, ``prefill`` and four ``decode_step``s fed
the JAX package's greedy tokens against the JAX reference executor, decode
against the port's own full forward, and greedy serving's tokens.  The JAX
parameters come across through ``convert.lm_params``; inputs come from
numpy seeds.  Each configuration also resolves field for field, each full
configuration has the JAX package's parameter count (shapes only), and the
serving entry point runs every architecture.

Tolerances: the JAX package's serving bounds (``tests/models/
test_serving.py``): forward and prefill logits within 1e-4 of max |logit|,
decode within 1e-3; one layer in f32 within 1e-5 of its output's max (sums
in another order).
"""

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import ARCH_IDS as JAX_ARCH_IDS
from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke_config as jax_get_smoke_config
from repro.core import make_executor as jax_make_executor
from repro.models import lm as jax_lm
from repro.nn import attention as jax_attn
from repro.nn import layers as jax_layers
from repro.nn import moe as jax_moe
from repro_torch import convert
from repro_torch.configs import ARCH_IDS, PORTED_ARCHS, get_config, get_smoke_config
from repro_torch.core import make_executor
from repro_torch.launch import serve as serve_lib
from repro_torch.models import lm
from repro_torch.nn import attention as attn
from repro_torch.nn import layers
from repro_torch.nn import moe

#: the families this file covers (zamba2 and rwkv6 have their own files)
ARCHS = ("granite_8b", "yi_9b", "smollm_135m", "pixtral_12b", "musicgen_large",
         "qwen2_moe_a2_7b", "olmoe_1b_7b", "minicpm3_4b")
SPACES = ("torch", "reference")
#: batch, prompt length and generated tokens (the prefill's and 4 decodes')
B, P, GEN, SEED = 2, 8, 5, 11


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _rel(got, want) -> float:
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max()
                 / max(np.abs(want).max(), 1e-30))


def _scaled(got, want) -> float:
    """max |got - want| over max(max |want|, 1): the serving tests' measure."""
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max()
                 / max(np.abs(want).max(), 1.0))


@functools.lru_cache(maxsize=None)
def _model(arch):
    """Smoke config, JAX parameters (PRNGKey 3) and their port copy."""
    cfg, jcfg = get_smoke_config(arch), jax_get_smoke_config(arch)
    jparams, _ = jax_lm.init_model(jax.random.PRNGKey(3), jcfg)
    params = convert.lm_params(cfg, jax.tree_util.tree_map(np.asarray, jparams),
                               device="cpu")
    return cfg, jcfg, jparams, params


def _feed_key(cfg) -> str:
    return "embeds" if cfg.frontend == "stub_embeddings" else "tokens"


def _jfeed(cfg, a):
    a = np.asarray(a)
    return {_feed_key(cfg): jnp.asarray(a, jnp.int32 if a.dtype.kind == "i"
                                        else jnp.float32)}


def _tfeed(cfg, a):
    return {_feed_key(cfg): torch.from_numpy(np.array(a))}


@functools.lru_cache(maxsize=None)
def _jax_run(arch):
    """The JAX package's greedy serving loop (``launch/serve.py``) on the
    reference executor over serve's own prompt: the prefill's logits, each
    decode step's logits, the fed inputs (token ids, or for a stub
    frontend the sampled tokens' embeddings), the greedy tokens, the final
    cache, and the full forward over prompt and fed inputs."""
    cfg, jcfg, jparams, _ = _model(arch)
    prompt = serve_lib._prompt(cfg, B, P, SEED, "cpu").numpy()
    jex = jax_make_executor("reference")
    cache = jax_lm.init_cache(jcfg, B, P + GEN)
    pre, cache = jax_lm.prefill(jparams, jcfg, cache=cache, executor=jex,
                                **_jfeed(cfg, prompt))
    tok = jnp.argmax(pre[:, -1], axis=-1).astype(jnp.int32)
    decode = jax.jit(lambda p, feed, length, c: jax_lm.decode_step(
        p, jcfg, length=length, cache=c, executor=jex, **feed))
    toks, steps, fed = [tok], [], []
    for t in range(P, P + GEN - 1):
        if cfg.frontend == "stub_embeddings":
            x = jax_lm.embed(jparams["embedding"], tok[:, None]).astype(jcfg.dtype)
        else:
            x = tok[:, None]
        fed.append(np.asarray(x))
        lg, cache = decode(jparams, _jfeed(cfg, x), jnp.int32(t), cache)
        steps.append(np.asarray(lg))
        tok = jnp.argmax(lg[:, -1], axis=-1).astype(jnp.int32)
        toks.append(tok)
    full_in = np.concatenate([prompt] + fed, axis=1)
    full, metrics = jax_lm.forward(jparams, jcfg, executor=jex,
                                   **_jfeed(cfg, full_in))
    return dict(prompt=prompt, prefill=np.asarray(pre), steps=steps, fed=fed,
                tokens=np.stack([np.asarray(t) for t in toks], axis=1),
                cache=jax.tree_util.tree_map(np.asarray, cache),
                full_in=full_in, full=np.asarray(full),
                metrics={k: float(v) for k, v in metrics.items()})


# -- configurations -----------------------------------------------------------------


@pytest.mark.parametrize("arch", JAX_ARCH_IDS)
def test_config_equals_the_jax_config_field_for_field(arch):
    assert arch in ARCH_IDS and arch in PORTED_ARCHS
    assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(jax_get_config(arch))
    assert (dataclasses.asdict(get_smoke_config(arch))
            == dataclasses.asdict(jax_get_smoke_config(arch)))


@pytest.mark.parametrize("arch", ARCHS)
def test_full_config_has_the_jax_parameter_count(arch):
    """Shapes only: the port's init on the meta device against the JAX
    package's init under ``jax.eval_shape``."""
    cfg = get_config(arch)
    params = lm.init_model(cfg, device="meta")
    jshapes = jax.eval_shape(lambda: jax_lm.init_model(jax.random.PRNGKey(0),
                                                       jax_get_config(arch))[0])
    want = sum(math.prod(a.shape) for a in jax.tree_util.tree_leaves(jshapes))
    assert sum(p.numel() for p in params.parameters()) == want
    assert len(params["blocks"]) == cfg.n_layers
    assert params["blocks"][0]["norm1"]["scale"].dtype == torch.float32
    assert params["embedding"]["table"].dtype == torch.bfloat16


# -- layers -------------------------------------------------------------------------


def test_gelu_mlp_and_sinusoidal_match_jax():
    rng = np.random.default_rng(0)
    p = {"up": rng.standard_normal((16, 40)) * 0.3,
         "down": rng.standard_normal((40, 16)) * 0.2,
         "up_b": rng.standard_normal(40) * 0.1,
         "down_b": rng.standard_normal(16) * 0.1}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = rng.standard_normal((3, 5, 16)).astype(np.float32)
    want = jax_layers.gelu_mlp({k: jnp.asarray(v) for k, v in p.items()},
                               jnp.asarray(x))
    got = layers.gelu_mlp({k: _t(v) for k, v in p.items()}, _t(x))
    assert _rel(got, want) < 1e-5
    # jax.nn.gelu is the tanh form: PyTorch's default erf form misses it
    h = _t(x) @ _t(p["up"]) + _t(p["up_b"])
    exact = (F.gelu(h) @ _t(p["down"])) + _t(p["down_b"])
    assert _rel(exact, want) > 1e-5
    # the init: zero biases by default, none when asked
    ini = lm.Initializer(torch.Generator().manual_seed(0), torch.float32, "cpu")
    q = layers.gelu_mlp_init(ini, 8, 12)
    assert not q["up_b"].any() and q["down_b"].shape == (8,)
    assert set(layers.gelu_mlp_init(ini, 8, 12, bias=False)) == {"up", "down"}
    for d in (64, 33):
        pos = np.tile(np.arange(7, dtype=np.int32) + 1000, (2, 1))
        want = jax_lm._sinusoidal(jnp.asarray(pos), d)
        got = lm._sinusoidal(_t(pos), d)
        assert got.shape == (2, 7, d) and got.dtype == torch.float32
        assert float(np.abs(got.numpy() - np.asarray(want)).max()) < 1e-5


@pytest.mark.parametrize("chunk", [4, 8])
def test_chunked_attention_matches_jax(chunk):
    """GQA with Skv > S (a kv offset) and a ragged last chunk, with v at the
    head dim of q and k, and at a smaller one (MLA's case)."""
    rng = np.random.default_rng(chunk)
    q = rng.standard_normal((2, 4, 10, 16)).astype(np.float32)
    k = rng.standard_normal((2, 2, 13, 16)).astype(np.float32)
    for dv in (16, 8):
        v = rng.standard_normal((2, 2, 13, dv)).astype(np.float32)
        for causal in (True, False):
            want = jax_attn.attention_xla_chunked(
                jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                chunk=chunk)
            got = attn.attention_chunked(_t(q), _t(k), _t(v), causal=causal,
                                         chunk=chunk)
            assert got.shape == (2, 4, 10, dv)
            assert _rel(got, want) < 1e-5
            # and against the dense plain version
            dense = attn._attention_op(_t(q), _t(k), _t(v), causal=causal,
                                       executor=make_executor("torch"))
            assert _rel(got, dense.numpy()) < 1e-5


@pytest.mark.parametrize("space", SPACES)
def test_mla_layer_matches_jax(space):
    cfg, jcfg, jparams, params = _model("minicpm3_4b")
    jp = jax.tree_util.tree_map(lambda a: a[1], jparams["blocks"]["attn"])
    p = params["blocks"][1]["attn"]
    S, Smax = 9, 12
    x = np.random.default_rng(2).standard_normal((B, S + 1, cfg.d_model)).astype(np.float32)
    pos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    jex, ex = jax_make_executor("reference"), make_executor(space)
    want = jax_attn.mla_forward(jp, jnp.asarray(x[:, :S]), jcfg, jnp.asarray(pos),
                                executor=jex)
    got = attn.mla_forward(p, _t(x[:, :S]), cfg, _t(pos), executor=ex)
    assert _rel(got, want) < 1e-5
    jcache = jax_attn.MLACache.zeros(B, Smax, cfg.kv_lora_rank,
                                     cfg.qk_rope_head_dim, jnp.float32)
    cache = attn.MLACache.zeros(B, Smax, cfg.kv_lora_rank, cfg.qk_rope_head_dim,
                                torch.float32, "cpu")
    want, jcache = jax_attn.mla_prefill(jp, jnp.asarray(x[:, :S]), jcfg,
                                        jnp.asarray(pos), jcache, executor=jex)
    got, cache = attn.mla_prefill(p, _t(x[:, :S]), cfg, _t(pos), cache,
                                  executor=ex)
    assert _rel(got, want) < 1e-5
    assert _rel(cache.c_kv, jcache.c_kv) < 1e-6
    assert _rel(cache.k_rope, jcache.k_rope) < 1e-6
    want, jcache = jax_attn.mla_decode(jp, jnp.asarray(x[:, S:]), jcfg,
                                       jnp.int32(S), jcache, executor=jex)
    got, cache = attn.mla_decode(p, _t(x[:, S:]), cfg, S, cache, executor=ex)
    assert got.shape == (B, 1, cfg.d_model)
    assert _rel(got, want) < 1e-5
    assert _rel(cache.c_kv, jcache.c_kv) < 1e-6
    with pytest.raises(ValueError, match="past its length"):
        cache.write(Smax, torch.zeros(B, 1, cfg.kv_lora_rank),
                    torch.zeros(B, 1, cfg.qk_rope_head_dim))


@pytest.mark.parametrize("arch", ["qwen2_moe_a2_7b", "olmoe_1b_7b"])
def test_moe_sort_and_dense_match_jax(arch):
    cfg, jcfg, jparams, params = _model(arch)
    jp = jax.tree_util.tree_map(lambda a: a[0], jparams["blocks"]["moe"])
    p = params["blocks"][0]["moe"]
    x = np.random.default_rng(4).standard_normal((2, 7, cfg.d_model)).astype(np.float32)
    want, jm = jax_moe.moe_forward(jp, jnp.asarray(x), jcfg, impl="sort")
    got, m = moe.moe_forward(p, _t(x), cfg)
    dense, md = moe.moe_forward(p, _t(x), cfg, impl="dense")
    assert got.shape == x.shape
    assert _rel(got, want) < 1e-5 and _rel(dense, want) < 1e-5
    assert _rel(got, dense.numpy()) < 1e-5
    for key in ("moe_lb_loss", "moe_z_loss"):
        assert abs(float(m[key]) / float(jm[key]) - 1) < 1e-5
        assert float(md[key]) == float(m[key])
    assert moe.padded_experts(cfg) == p["gate"].shape[0]
    with pytest.raises(ValueError, match="unknown moe impl"):
        moe.moe_forward(p, _t(x), cfg, impl="nope")


# -- the families as a whole ---------------------------------------------------------


@pytest.mark.parametrize("space", SPACES)
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_prefill_and_decode_match_jax(arch, space):
    cfg, _, _, params = _model(arch)
    run = _jax_run(arch)
    ex = make_executor(space)
    full, metrics = lm.forward(params, cfg, executor=ex,
                               **_tfeed(cfg, run["full_in"]))
    assert full.dtype == torch.float32
    assert _scaled(full, run["full"]) < 1e-4
    assert set(metrics) == set(run["metrics"])
    for key, want in run["metrics"].items():
        assert abs(float(metrics[key]) / want - 1) < 1e-5

    cache = lm.init_cache(cfg, B, P + GEN, device="cpu")
    pl, cache = lm.prefill(params, cfg, cache=cache, executor=ex,
                           **_tfeed(cfg, run["prompt"]))
    scale = max(float(np.abs(run["prefill"]).max()), 1.0)
    assert float(np.abs(pl.numpy() - run["prefill"]).max()) / scale < 1e-4
    for j, t in enumerate(range(P, P + GEN - 1)):
        dl, cache = lm.decode_step(params, cfg, length=t, cache=cache,
                                   executor=ex, **_tfeed(cfg, run["fed"][j]))
        assert dl.shape == (B, 1, cfg.vocab)
        assert float(np.abs(dl.numpy() - run["steps"][j]).max()) / scale < 1e-3
    # the cache in the JAX package's stacked layout
    if cfg.family == "mla":
        assert cache.c_kv.shape == (cfg.n_layers, B, P + GEN, cfg.kv_lora_rank)
        assert _rel(cache.c_kv, run["cache"].c_kv) < 1e-5
        assert _rel(cache.k_rope, run["cache"].k_rope) < 1e-5
    else:
        assert cache.k.shape == (cfg.n_layers, B, cfg.n_kv_heads, P + GEN,
                                 cfg.resolved_head_dim)
        assert _rel(cache.k, run["cache"].k) < 1e-5
        assert _rel(cache.v, run["cache"].v) < 1e-5


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_full_forward(arch):
    """The serving contract: prefill + one-token decode steps reproduce the
    full forward (the JAX package's test_serving bounds)."""
    cfg, _, _, params = _model(arch)
    run = _jax_run(arch)
    ex = make_executor("torch")
    full, _ = lm.forward(params, cfg, executor=ex, **_tfeed(cfg, run["full_in"]))
    cache = lm.init_cache(cfg, B, P + GEN, device="cpu")
    pre, cache = lm.prefill(params, cfg, cache=cache, executor=ex,
                            **_tfeed(cfg, run["full_in"][:, :P]))
    scale = max(float(full.abs().max()), 1.0)
    assert float((pre - full[:, :P]).abs().max()) / scale < 1e-4
    outs = []
    for t in range(P, run["full_in"].shape[1]):
        lg, cache = lm.decode_step(params, cfg, length=t, cache=cache,
                                   executor=ex,
                                   **_tfeed(cfg, run["full_in"][:, t:t + 1]))
        outs.append(lg)
    assert float((torch.cat(outs, dim=1) - full[:, P:]).abs().max()) / scale < 1e-3


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_serve_tokens_match_jax(arch):
    cfg, _, _, params = _model(arch)
    run = _jax_run(arch)
    res = serve_lib.serve(cfg, batch=B, prompt_len=P, gen_len=GEN, seed=SEED,
                          executor=make_executor("torch"), device="cpu",
                          params=params)
    np.testing.assert_array_equal(res.prompt.numpy(), run["prompt"])
    if cfg.frontend == "stub_embeddings":
        assert res.prompt.dtype == torch.float32
        assert res.prompt.shape == (B, P, cfg.d_model)
    scale = max(float(np.abs(run["prefill"][:, -1]).max()), 1.0)
    assert float(np.abs(res.prefill_logits.numpy()
                        - run["prefill"][:, -1]).max()) / scale < 1e-4
    np.testing.assert_array_equal(res.tokens.numpy(), run["tokens"])
    assert len(res.step_logits) == GEN - 1


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_serve_entry_point_runs_every_arch_on_the_cpu(arch, capsys):
    cfg = get_smoke_config(arch)
    assert serve_lib.main(["--arch", arch.replace("_", "-"), "--smoke",
                           "--device", "cpu", "--executor", "torch",
                           "--batch", "2", "--prompt-len", "5",
                           "--gen-len", "3"]) == 0
    assert f"[serve] {cfg.name}: prefill 2x5" in capsys.readouterr().out


def test_stub_frontend_takes_embeds():
    cfg, _, _, params = _model("musicgen_large")
    with pytest.raises(ValueError, match="needs `embeds`"):
        lm.forward(params, cfg, tokens=torch.zeros(1, 2, dtype=torch.int64),
                   executor=make_executor("torch"))
    toks = torch.tensor([3, 7])
    fed = serve_lib.feed(cfg, params, tokens=toks)
    assert set(fed) == {"embeds"} and fed["embeds"].shape == (2, 1, cfg.d_model)
    assert torch.equal(fed["embeds"][:, 0], params["embedding"]["table"][toks])
    gcfg = get_smoke_config("granite_8b")
    assert torch.equal(serve_lib.feed(gcfg, params, tokens=toks)["tokens"],
                       toks[:, None])


def test_rmsnorm_takes_rows_at_a_stride():
    """MLA normalises the latent columns of the kv projection, a view of
    wider rows: the wrapper finds the row stride the kernel walks, and
    refuses rows it cannot walk at one stride."""
    from repro_torch import kernels as K
    from repro_torch.kernels.rmsnorm.kernel import row_stride

    kv = torch.randn(2, 5, 288, generator=torch.Generator().manual_seed(0))
    c_kv = kv[..., :256]
    assert not c_kv.is_contiguous() and row_stride(c_kv) == 288
    assert row_stride(kv) == 288 and row_stride(kv[0, :1]) == 288
    assert row_stride(torch.ones(7)) == 7
    assert row_stride(kv[:, ::2, :256]) is None  # two strides
    assert row_stride(kv.transpose(0, 1)) is None
    w = torch.rand(256) + 0.5
    y = K.rmsnorm(c_kv, w, 1e-6)
    assert y.is_contiguous()
    assert torch.equal(y, K.rmsnorm(c_kv.contiguous(), w, 1e-6))
    with pytest.raises(ValueError, match="contiguous"):
        K.rmsnorm(kv[:, ::2, :256], w)
