"""Gradients through the port's four LM kernels, the chunked attention's
custom backward, and serving left without an autograd graph — on the CPU.

* Each kernel's autograd Function (``repro_torch.kernels._autograd``): on
  CPU tensors the wrapper returns its plain version, so the Function's
  forward is the plain version's bits and its gradients must equal autograd
  through the plain version exactly; ``gradcheck`` in f64 at tiny shapes
  (the Function around the plain version, which computes in f64 for f64
  inputs).  rmsnorm on a strided view (MLA's latent columns) and the SSD
  scan on strided x, B, C views keep their strides.
* The chunked attention's backward against the JAX package's
  ``core_bwd`` (``attention_xla_chunked`` under ``jax.vjp``) at a ragged kv
  length, causal and not, f32, within 1e-5 of the gradient's max.
* Serving: the prefill and decode steps give outputs without ``grad_fn``
  and leave the parameters frozen.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.nn import attention as jax_attn
from repro_torch.configs import get_smoke_config
from repro_torch.core import make_executor
from repro_torch.kernels._autograd import RecomputeFunction, kernel_call
from repro_torch.kernels.flash_attention.kernel import (flash_attention,
                                                        flash_attention_plain)
from repro_torch.kernels.rmsnorm.kernel import rmsnorm, rmsnorm_plain
from repro_torch.kernels.rwkv6.kernel import rwkv6_scan_log, rwkv6_scan_plain
from repro_torch.kernels.ssd.kernel import ssd_scan, ssd_scan_plain
from repro_torch.launch import steps as steps_lib
from repro_torch.models import lm
from repro_torch.nn import attention as attn


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _rand(gen, *shape, dtype=torch.float32, scale=1.0):
    return (scale * torch.randn(shape, generator=gen, dtype=torch.float64)).to(dtype)


def _cases(dtype):
    """(name, kernel, plain, inputs) at tiny shapes."""
    g = torch.Generator().manual_seed(5)
    wide = _rand(g, 2, 5, 12, dtype=dtype)
    dt = torch.nn.functional.softplus(_rand(g, 2, 9, 4, dtype=dtype) - 1)
    xbc = _rand(g, 2, 9, 4 * 3 + 2 * 2 * 3, dtype=dtype)
    return [
        ("rmsnorm", functools.partial(rmsnorm, eps=1e-5),
         functools.partial(rmsnorm_plain, eps=1e-5),
         [_rand(g, 2, 5, 8, dtype=dtype), 1 + 0.1 * _rand(g, 8, dtype=dtype)]),
        ("rmsnorm strided", functools.partial(rmsnorm, eps=1e-5),
         functools.partial(rmsnorm_plain, eps=1e-5),
         [wide[..., :8], 1 + 0.1 * _rand(g, 8, dtype=dtype)]),
        ("flash_attention", flash_attention, flash_attention_plain,
         [_rand(g, 2, 4, 6, 8, dtype=dtype), _rand(g, 2, 2, 6, 8, dtype=dtype),
          _rand(g, 2, 2, 6, 8, dtype=dtype)]),
        ("flash_attention offset", functools.partial(flash_attention,
                                                     scale=0.3),
         functools.partial(flash_attention_plain, scale=0.3),
         [_rand(g, 1, 2, 3, 8, dtype=dtype), _rand(g, 1, 1, 7, 8, dtype=dtype),
          _rand(g, 1, 1, 7, 8, dtype=dtype)]),
        ("ssd_scan strided", ssd_scan, ssd_scan_plain,
         [xbc[..., :12].unflatten(-1, (4, 3)), dt,
          -torch.exp(0.3 * _rand(g, 4, dtype=dtype)),
          xbc[..., 12:18].unflatten(-1, (2, 3)),
          xbc[..., 18:].unflatten(-1, (2, 3))]),
        ("rwkv6_scan_log", rwkv6_scan_log, rwkv6_scan_plain,
         [_rand(g, 2, 9, 2, 4, dtype=dtype, scale=0.5),
          _rand(g, 2, 9, 2, 4, dtype=dtype, scale=0.5),
          _rand(g, 2, 9, 2, 3, dtype=dtype),
          -torch.exp(0.5 * _rand(g, 2, 9, 2, 4, dtype=dtype) - 1),
          _rand(g, 2, 4, dtype=dtype, scale=0.5)]),
    ]


CASE_NAMES = [c[0] for c in _cases(torch.float32)]


def _grads(out, inputs, gen):
    outs = out if isinstance(out, tuple) else (out,)
    cots = [torch.randn(o.shape, generator=gen, dtype=o.dtype) for o in outs]
    return torch.autograd.grad(outs, inputs, cots)


@pytest.mark.parametrize("name", CASE_NAMES)
def test_function_matches_autograd_through_plain(name):
    """f32 on the CPU: the Function's forward is the wrapper's (the plain
    version's bits), its gradients autograd's through the plain version,
    bit for bit (the scans' plain versions at the kernel's chunk, as the
    cuda registrations recompute them)."""
    _, kernel, plain, inputs = next(c for c in _cases(torch.float32)
                                    if c[0] == name)
    xs = [t.detach().requires_grad_(True) for t in inputs]
    got = kernel_call(kernel, plain, *xs)
    ys = [t.detach().requires_grad_(True) for t in inputs]
    ref = kernel(*ys)  # the wrapper on CPU tensors: the plain version
    for a, b in zip(got if isinstance(got, tuple) else (got,),
                    ref if isinstance(ref, tuple) else (ref,)):
        assert torch.equal(a, b)
    g_got = _grads(got, xs, torch.Generator().manual_seed(1))
    g_ref = _grads(plain(*ys), ys, torch.Generator().manual_seed(1))
    for a, b in zip(g_got, g_ref):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", CASE_NAMES)
def test_function_gradcheck_f64(name):
    """The scans at a chunk of 4, so that S = 9 crosses chunk boundaries."""
    _, _, plain, inputs = next(c for c in _cases(torch.float64)
                               if c[0] == name)
    if "scan" in name:
        plain = functools.partial(plain, chunk=4)
    xs = [t.detach().requires_grad_(True) for t in inputs]

    def fn(*args):
        out = RecomputeFunction.apply(plain, plain, *args)
        return out

    assert torch.autograd.gradcheck(fn, xs, eps=1e-6, atol=1e-6, rtol=1e-5)


def test_function_adds_nothing_without_grad():
    _, kernel, plain, inputs = _cases(torch.float32)[0]
    out = kernel_call(kernel, plain, *inputs)
    assert out.grad_fn is None
    xs = [t.requires_grad_(True) for t in inputs]
    with torch.no_grad():
        assert kernel_call(kernel, plain, *xs).grad_fn is None


def test_function_skips_unused_output_gradient():
    """A scan's final state unused in the loss: backward takes y alone."""
    _, kernel, plain, inputs = _cases(torch.float32)[-1]
    xs = [t.detach().requires_grad_(True) for t in inputs]
    y, _ = kernel_call(kernel, plain, *xs)
    g = torch.autograd.grad(y.sum(), xs)
    ys = [t.detach().requires_grad_(True) for t in inputs]
    g_ref = torch.autograd.grad(plain(*ys)[0].sum(), ys)  # state unused
    for a, b in zip(g, g_ref):
        assert torch.equal(a, b)


# -- the chunked attention's custom backward -------------------------------------


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S,Skv", [(37, 37), (5, 37)])
def test_chunked_attention_backward_matches_jax(causal, S, Skv):
    rng = np.random.default_rng(21)
    B, Hq, Hkv, D, chunk = 2, 4, 2, 8, 16
    q = rng.standard_normal((B, Hq, S, D)).astype(np.float32)
    k = rng.standard_normal((B, Hkv, Skv, D)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, Skv, 6)).astype(np.float32)
    ct = rng.standard_normal((B, Hq, S, 6)).astype(np.float32)

    f = lambda q, k, v: jax_attn.attention_xla_chunked(  # noqa: E731
        q, k, v, causal=causal, chunk=chunk)
    out_j, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    g_j = vjp(jnp.asarray(ct))

    qt, kt, vt = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    out = attn.attention_chunked(qt, kt, vt, causal=causal, chunk=chunk)
    g = torch.autograd.grad(out, (qt, kt, vt), torch.from_numpy(ct))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j),
                               atol=1e-5 * np.abs(np.asarray(out_j)).max())
    for a, b in zip(g, g_j):
        b = np.asarray(b)
        assert np.abs(a.numpy() - b).max() <= 1e-5 * np.abs(b).max()


def test_chunked_attention_backward_against_dense_autograd():
    """The custom backward equals autograd through the dense plain
    attention (a different algorithm) within f32 rounding."""
    g = torch.Generator().manual_seed(3)
    q = torch.randn((1, 2, 40, 8), generator=g, requires_grad=True)
    k = torch.randn((1, 1, 40, 8), generator=g, requires_grad=True)
    v = torch.randn((1, 1, 40, 8), generator=g, requires_grad=True)
    ct = torch.randn((1, 2, 40, 8), generator=g)
    a = torch.autograd.grad(attn.attention_chunked(q, k, v, chunk=16),
                            (q, k, v), ct)
    b = torch.autograd.grad(flash_attention_plain(q, k, v), (q, k, v), ct)
    for x, y in zip(a, b):
        assert (x - y).abs().max() <= 1e-5 * y.abs().max()


# -- serving is untouched ------------------------------------------------------------


@pytest.mark.parametrize("arch", ["smollm_135m", "zamba2_2_7b", "rwkv6_3b"])
def test_serving_records_no_graph(arch):
    cfg = get_smoke_config(arch)
    ex = make_executor("torch")
    params = lm.init_model(cfg, device="cpu")
    assert not any(p.requires_grad for p in params.parameters())
    tokens = torch.randint(0, cfg.vocab, (2, 6),
                           generator=torch.Generator().manual_seed(0))
    cache = lm.init_cache(cfg, 2, 8, device="cpu")
    logits, cache = steps_lib.make_prefill_step(cfg, ex)(
        params, {"tokens": tokens}, cache)
    assert logits.grad_fn is None
    logits, cache = steps_lib.make_decode_step(cfg, ex)(
        params, {"tokens": tokens[:, :1]}, 6, cache)
    assert logits.grad_fn is None
    assert not any(p.requires_grad for p in params.parameters())
