"""The port's RWKV6 WKV scan (``rwkv6_scan_log``) against the JAX package's
Pallas kernel, run in interpret mode as its own tests run it.

On the CPU the CUDA kernel's wrapper takes its plain PyTorch version (the
CUDA code runs only on the card, where ``chip_smoke.py`` holds it against
the same plain version).  Here the plain version at the Pallas kernel's
chunk, the wrapper, and the ``torch`` / ``reference`` spaces of the registry
op ``nn_rwkv6_scan`` are held against the Pallas kernel and its op under
``PallasInterpretExecutor``, on numpy-seeded inputs: S below the chunk and a
ragged tail, ordinary decays logw = -exp(N(-1, 1)) and strong ones
-exp(N(2.5, 1)) (which must stay finite).

Tolerances, f32: the plain version against the Pallas output at the same
chunk within 1e-4 of max |y| and of max |state| (the same algebra, summed in
another order); the reference space (the sequential recurrence) against the
JAX package's ``rwkv6_ref`` within 2e-3 of max |y| (the JAX test's own
bound).  bf16: both sides round one f32 result to bf16, so y may differ by
one bf16 ulp (2^-7 relative) beside 1e-4 of max |y|.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import make_executor as jax_make_executor
from repro.core import registry as jax_registry
from repro.kernels.rwkv6.kernel import rwkv6_scan as jax_rwkv6_scan
from repro.kernels.rwkv6.kernel import rwkv6_scan_log as jax_rwkv6_scan_log
from repro.kernels.rwkv6.ref import rwkv6_ref as jax_rwkv6_ref
from repro_torch import kernels as K
from repro_torch.core import make_executor, registry
from repro_torch.kernels.rwkv6.kernel import (
    CHUNK,
    rwkv6_scan_plain,
    rwkv6_smem_bytes,
)

BF16_ULP = 2.0 ** -7


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _inputs(B, S, H, K, V, seed, decay="normal"):
    """r, k, v, logw, u as f32 numpy arrays; logw = -exp(N(mu, 1))."""
    rng = np.random.default_rng(seed)
    r = rng.standard_normal((B, S, H, K)).astype(np.float32)
    k = rng.standard_normal((B, S, H, K)).astype(np.float32)
    v = rng.standard_normal((B, S, H, V)).astype(np.float32)
    mu = {"normal": -1.0, "strong": 2.5}[decay]
    logw = (-np.exp(rng.normal(mu, 1.0, (B, S, H, K)))).astype(np.float32)
    u = rng.standard_normal((H, K)).astype(np.float32)
    return r, k, v, logw, u


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.to(torch.float32).numpy()


def _rel(got, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.abs(np.asarray(got, np.float32) - want).max()
                 / max(np.abs(want).max(), 1e-30))


SCAN_CASES = [
    # S, K = V, Pallas chunk, decay
    (80, 16, 16, "normal"),   # five whole chunks
    (80, 32, 32, "normal"),   # a ragged tail of 16
    (8, 32, 32, "normal"),    # S below the chunk
    (8, 16, 16, "strong"),
    (80, 16, 32, "strong"),   # strong decay across a ragged tail
    (80, 32, 16, "strong"),
]


@pytest.mark.parametrize("S,D,chunk,decay", SCAN_CASES)
def test_rwkv6_plain_and_reference_match_pallas(S, D, chunk, decay):
    B, H = 2, 3
    r, k, v, logw, u = _inputs(B, S, H, D, D, seed=S * D + chunk,
                               decay=decay)
    jy, js = jax_rwkv6_scan_log(*(jnp.asarray(a) for a in (r, k, v, logw, u)),
                                chunk=chunk, interpret=True)
    want_y, want_s = np.asarray(jy), np.asarray(js)
    assert np.isfinite(want_y).all() and np.isfinite(want_s).all()
    args = [_t(a) for a in (r, k, v, logw, u)]
    y, s = rwkv6_scan_plain(*args, chunk=chunk)
    assert y.dtype == torch.float32 and s.dtype == torch.float32
    assert y.shape == (B, S, H, D) and s.shape == (B, H, D, D)
    assert torch.isfinite(y).all() and torch.isfinite(s).all()
    assert _rel(y, want_y) < 1e-4 and _rel(s, want_s) < 1e-4
    if chunk == CHUNK:  # CPU: the wrapper is the plain version at its chunk
        yw, sw = K.rwkv6_scan_log(*args)
        assert torch.equal(yw, y) and torch.equal(sw, s)
    # the reference space: the sequential recurrence on exp(logw)
    yr, sr = registry.operation("nn_rwkv6_scan")(
        *args, executor=make_executor("reference"))
    jry, jrs = jax_rwkv6_ref(*(jnp.asarray(a) for a in (r, k, v)),
                             jnp.exp(jnp.asarray(logw)), jnp.asarray(u))
    assert _rel(yr, jry) < 2e-3 and _rel(sr, jrs) < 2e-3
    assert _rel(yr, want_y) < 2e-3


def test_rwkv6_plain_matches_pallas_in_bf16():
    B, S, H, D = 2, 40, 3, 32
    r, k, v, logw, u = _inputs(B, S, H, D, D, seed=11)
    bf = [jnp.asarray(a, jnp.bfloat16) for a in (r, k, v)]
    jy, js = jax_rwkv6_scan_log(*bf, jnp.asarray(logw),
                                jnp.asarray(u, jnp.bfloat16), chunk=32,
                                interpret=True)
    assert jy.dtype == jnp.bfloat16
    tb = [_t(a).to(torch.bfloat16) for a in (r, k, v)]
    y, s = K.rwkv6_scan_log(*tb, _t(logw), _t(u).to(torch.bfloat16))
    assert y.dtype == torch.bfloat16 and s.dtype == torch.float32
    want_y = np.asarray(jy.astype(jnp.float32))
    np.testing.assert_allclose(_np(y), want_y, rtol=BF16_ULP,
                               atol=1e-4 * np.abs(want_y).max())
    assert _rel(s, js) < 1e-4


def test_rwkv6_linear_decay_wrapper_matches_pallas():
    """``rwkv6_scan`` takes w in linear space and clamps it at 1e-30 before
    the log, as the JAX package's wrapper does (w = 0 included)."""
    B, S, H, D = 2, 40, 2, 16
    r, k, v, logw, u = _inputs(B, S, H, D, D, seed=5)
    w = np.exp(logw.astype(np.float64)).astype(np.float32)
    w[0, 3, 1, :4] = 0.0  # a decay that underflowed
    jy, js = jax_rwkv6_scan(*(jnp.asarray(a) for a in (r, k, v, w, u)),
                            chunk=32, interpret=True)
    y, s = K.rwkv6_scan(*(_t(a) for a in (r, k, v, w, u)))
    assert _rel(y, jy) < 1e-4 and _rel(s, js) < 1e-4


@pytest.mark.parametrize("space", ["torch", "reference"])
def test_rwkv6_op_spaces_match_pallas_executor(space):
    r, k, v, logw, u = _inputs(2, 45, 3, 16, 16, seed=7)
    jy, js = jax_registry.operation("nn_rwkv6_scan")(
        *(jnp.asarray(a) for a in (r, k, v, logw, u)),
        executor=jax_make_executor("pallas_interpret"))
    y, s = registry.operation("nn_rwkv6_scan")(
        *(_t(a) for a in (r, k, v, logw, u)), executor=make_executor(space))
    assert _rel(y, jy) < 1e-4 and _rel(s, js) < 1e-4


# -- the cuda space and the wrapper's checks ------------------------------------------


def test_cuda_space_refuses_cpu_tensors():
    """The cuda space launches its kernel or raises; it never hands CPU
    tensors to the plain version."""
    args = [_t(a) for a in _inputs(1, 8, 2, 16, 16, seed=0)]
    with pytest.raises(ValueError, match="cuda kernel space needs CUDA"):
        registry.operation("nn_rwkv6_scan")(*args, executor=make_executor("cuda"))


def test_wrapper_checks_its_arguments():
    r, k, v, logw, u = (_t(a) for a in _inputs(1, 8, 2, 16, 16, seed=0))
    with pytest.raises(ValueError, match="do not match"):
        K.rwkv6_scan_log(r, k[:, :4], v, logw, u)
    with pytest.raises(ValueError, match="do not match"):
        K.rwkv6_scan_log(r, k, v, logw, u[:, :8])
    with pytest.raises(ValueError, match="expected r"):
        K.rwkv6_scan_log(r[0], k, v, logw, u)
    with pytest.raises(ValueError, match="all alike"):
        K.rwkv6_scan_log(r, k.to(torch.bfloat16), v, logw, u)
    with pytest.raises(ValueError, match="all alike"):
        K.rwkv6_scan_log(r.double(), k.double(), v.double(), logw, u.double())
    with pytest.raises(ValueError, match="logw must be float32"):
        K.rwkv6_scan_log(r, k, v, logw.double(), u)
    with pytest.raises(ValueError, match="contiguous"):
        K.rwkv6_scan_log(r.transpose(1, 2).contiguous().transpose(1, 2), k, v,
                         logw, u)


def test_rwkv6_counts_no_launch_on_the_cpu():
    K.reset_launch_counts()
    K.rwkv6_scan_log(*(_t(a) for a in _inputs(1, 8, 2, 16, 16, seed=0)))
    registry.operation("nn_rwkv6_scan")(
        *(_t(a) for a in _inputs(1, 8, 2, 16, 16, seed=1)),
        executor=make_executor("torch"))
    assert K.launch_counts()["rwkv6_scan_log"] == 0
    assert K.KERNELS["rwkv6_scan_log"] is K.rwkv6_scan_log


def test_h100_launch_config_fits_shared_memory():
    ex = make_executor("h100")
    cfg = ex.launch_config("nn_rwkv6_scan", {"S": 2048, "K": 64, "V": 64})
    # r, k, v, W, Wprev (32 x 65), the state (64 x 64), G (32 x 33), u, decay
    assert cfg["chunk"] == CHUNK == 32
    assert cfg.smem_bytes == rwkv6_smem_bytes() == 62_720
    assert 3 * cfg.smem_bytes <= ex.hw.smem_per_block_bytes  # three blocks an SM
