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

import re

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
    FMA_CHUNK,
    rwkv6_scan_plain,
    rwkv6_smem_bytes,
    rwkv6_tensor_cores,
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
    (130, 16, 64, "strong"),  # the kernel's chunk, a ragged tail of 2
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


# -- the tensor-core kernel's algebra (csrc/rwkv6_scan.cu, bf16) ---------------------
#
# The kernel runs only on the card.  ``_rwkv6_mma_mirror`` repeats its
# algebra in plain PyTorch: chunks of 64 masked past S, exponents in base 2
# (W = the prefix sum of logw log2(e), Wprev[t] = W[t - 1]), and the
# sub-chunk factorisation: warp w's 16 rows take ref = 16 w - 1 against the
# keys s < 16 w, its second sub-chunk of eight takes ref = 16 w + 7 against
# the first, each key operand is k exp(W[ref] - W[s]) in one factor, and
# only the diagonal 8 x 8 blocks keep the ratio form.  Each
# f32 operand is split into bf16 hi + lo: two products against an exact
# bf16 operand (v), three (hi hi + hi lo + lo hi) between two f32 ones.
# Held against the Pallas kernel at chip_smoke.py's tolerances.


def _split_bf16(t: torch.Tensor):
    """hi = t rounded to bf16, lo = (t - hi) rounded to bf16, both as f32."""
    hi = t.to(torch.bfloat16).to(torch.float32)
    return hi, (t - hi).to(torch.bfloat16).to(torch.float32)


def _mm2(a, b):
    """a b, ``a`` f32 split hi + lo, ``b`` exact in bf16: two products."""
    hi, lo = _split_bf16(a)
    return hi @ b + lo @ b


def _mm3(a, b):
    """a b, both f32 split hi + lo: hi hi + hi lo + lo hi."""
    ah, al = _split_bf16(a)
    bh, bl = _split_bf16(b)
    return ah @ bh + ah @ bl + al @ bh


def _rwkv6_mma_mirror(r, k, v, logw, u, exponents=None, sub=8):
    """(y, state) by the tensor-core kernel's algebra; every exponent it
    forms is appended to ``exponents`` (when given)."""
    L, W16 = 64, 16
    Bsz, S, H, K = r.shape
    V = v.shape[-1]
    rf, kf, vf, uf = (t.to(torch.float32) for t in (r, k, v, u))
    lw2 = logw.to(torch.float32) * np.float32(1.4426950408889634)

    def ex2(e):
        if exponents is not None and e.numel():
            exponents.append(float(e.max()))
        return torch.exp2(e)

    y = torch.zeros(Bsz, S, H, V)
    state = torch.zeros(Bsz, H, K, V)
    for b in range(Bsz):
        for h in range(H):
            St = torch.zeros(K, V)
            for t0 in range(0, S, L):
                n = min(L, S - t0)  # rows past S read as 0: masked, not padded
                rc, kc, vc, lc = (torch.zeros(L, d) for d in (K, K, V, K))
                rc[:n], kc[:n], vc[:n] = rf[b, t0:t0 + n, h], kf[b, t0:t0 + n, h], vf[b, t0:t0 + n, h]
                lc[:n] = lw2[b, t0:t0 + n, h]
                Wt = torch.cumsum(lc, 0)
                Wx = torch.cat([torch.zeros(1, K), Wt])  # Wx[t + 1] = W[t]
                G = torch.zeros(L, L)
                yc = torch.zeros(L, V)
                for w in range(L // W16):
                    rows = slice(W16 * w, W16 * w + W16)
                    ref = Wx[W16 * w]  # W[16 w - 1]
                    ra = rc[rows] * ex2(Wx[W16 * w:W16 * w + W16] - ref)
                    # y = (r exp(Wprev)) S: (ra exp(W[ref])) against S, 3 products
                    yc[rows] = _mm3(ra * ex2(ref), St)
                    # keys s < 16 w: k exp(W[ref] - W[s])
                    if w:
                        keys = slice(0, W16 * w)
                        G[rows, keys] = _mm3(ra, (kc[keys] * ex2(ref - Wt[keys])).T)
                    # the second sub-chunk against the first: ref = 16 w + 7
                    r2 = slice(W16 * w + sub, W16 * w + W16)
                    k2 = slice(W16 * w, W16 * w + sub)
                    ref2 = Wt[W16 * w + sub - 1]
                    rb = rc[r2] * ex2(Wx[W16 * w + sub:W16 * w + W16] - ref2)
                    G[r2, k2] = _mm3(rb, (kc[k2] * ex2(ref2 - Wt[k2])).T)
                # the diagonal sub-chunks: the ratio form, masked before the
                # exp, and the bonus on the diagonal
                for j in range(L // sub):
                    for ti in range(1, sub):
                        t = sub * j + ti
                        for s in range(sub * j, t):
                            G[t, s] = (rc[t] * kc[s] * ex2(Wx[t] - Wt[s])).sum()
                    for t in range(sub * j, sub * j + sub):
                        G[t, t] = (rc[t] * uf[h] * kc[t]).sum()
                yc = yc + _mm2(G, vc)
                y[b, t0:t0 + n, h] = yc[:n]
                kdec = kc * ex2(Wt[-1] - Wt)
                St = ex2(Wt[-1])[:, None] * St + _mm2(kdec.T, vc)
            state[b, h] = St
    return y.to(r.dtype), state


MMA_CASES = [
    # S, K = V, decay: a whole chunk plus a ragged tail, a tail shorter than
    # one sub-chunk of eight (S = 64 + 3), strong decays
    (100, 32, "normal"),
    (67, 16, "normal"),
    (70, 16, "strong"),
]


@pytest.mark.parametrize("S,D,decay", MMA_CASES)
def test_rwkv6_tensor_core_algebra_matches_pallas(S, D, decay):
    B, H = 1, 2
    r, k, v, logw, u = _inputs(B, S, H, D, D, seed=S + D, decay=decay)
    r, k, v, u = (np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)
                  for a in (r, k, v, u))
    bf = [jnp.asarray(a, jnp.bfloat16) for a in (r, k, v)]
    jy, js = jax_rwkv6_scan_log(*bf, jnp.asarray(logw),
                                jnp.asarray(u, jnp.bfloat16), chunk=32,
                                interpret=True)
    want_y = np.asarray(jy.astype(jnp.float32))
    exps = []
    tb = [_t(a).to(torch.bfloat16) for a in (r, k, v, u)]
    y, s = _rwkv6_mma_mirror(*tb[:3], _t(logw), tb[3], exps)
    assert y.dtype == torch.bfloat16 and torch.isfinite(s).all()
    np.testing.assert_allclose(_np(y), want_y, rtol=BF16_ULP,
                               atol=1e-4 * np.abs(want_y).max())
    assert _rel(s, js) < 1e-4
    # the factorisation forms no exponent above 0
    assert max(exps) <= 0.0


def test_strong_decay_overflows_the_unfactored_form():
    """With logw = -exp(N(2.5, 1)) the naive factorisation (r e^W)(k e^-W)
    over a chunk of 64 overflows f32 (and turns into inf / NaN), which is
    why the kernel factors through a reference row inside each query
    sub-chunk; the mirror of that stays finite (it is held to the Pallas
    kernel above)."""
    r, k, v, logw, u = _inputs(1, 64, 1, 16, 16, seed=3, decay="strong")
    W = torch.cumsum(_t(logw)[0, :, 0], 0)  # (64, 16)
    naive = (_t(r)[0, :, 0] * torch.exp(W)) @ (_t(k)[0, :, 0] * torch.exp(-W)).T
    assert not torch.isfinite(naive).all()
    y, s = _rwkv6_mma_mirror(*(_t(a) for a in (r, k, v, logw, u)))
    assert torch.isfinite(y).all() and torch.isfinite(s).all()


def test_sub_chunk_factorisation_is_exact_in_f64():
    """exp(Wprev[t] - W[s]) = exp(Wprev[t] - W[ref]) exp(W[ref] - W[s]) for
    every s <= ref < t, both exponents <= 0, with ref = t_i0 - 1 the row
    before t's sub-chunk of eight: the off-diagonal blocks of G are one
    product, the diagonal blocks keep the ratio form."""
    rng = np.random.default_rng(9)
    lw = -np.exp(rng.normal(-1.0, 1.0, (64, 8)))
    W = np.cumsum(lw, 0)
    Wx = np.concatenate([np.zeros((1, 8)), W])  # Wx[t + 1] = W[t]
    for t in range(64):
        ref = 8 * (t // 8) - 1
        for s in range(ref + 1):
            a, c = Wx[t] - Wx[ref + 1], Wx[ref + 1] - W[s]
            assert (a <= 0).all() and (c <= 0).all()
            np.testing.assert_allclose(np.exp(a) * np.exp(c), np.exp(Wx[t] - W[s]),
                                       rtol=1e-12)


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


def test_rwkv6_source_matches_its_wrapper():
    """The kernels' chunk lengths and the tensor-core kernel's geometry, as
    the wrapper's shared-memory mirror assumes them; the ratio form stays on
    the diagonal sub-chunks of eight."""
    from pathlib import Path

    src = (Path(K.__file__).parent / "csrc" / "rwkv6_scan.cu").read_text()
    const = {k: int(v) for k, v in
             re.findall(r"constexpr int (\w+) = (\d+);", src)}
    assert const["kL"] == CHUNK and const["kFL"] == FMA_CHUNK
    assert const["kMmaThreads"] == 128 and const["kLdG"] == 17
    assert "__launch_bounds__(kMmaThreads, 3)" in src
    assert "ex2(wt0.x - ws0.x)" in src  # the ratio form's exponent, s < t
    assert src.count("mma3(") >= 3 and src.count("mma_bf16(") >= 8


@pytest.mark.parametrize("K_,V_,dtype,offset,want", [
    (64, 64, torch.bfloat16, 0, True),    # the serving path's shape
    (16, 16, torch.bfloat16, 0, True),
    (12, 64, torch.bfloat16, 0, False),   # K not a multiple of 8
    (64, 12, torch.bfloat16, 0, False),   # V not a multiple of 8
    (64, 64, torch.bfloat16, 1, False),   # r not 16-byte aligned
    (64, 64, torch.float32, 0, False),    # f32 keeps the CUDA-core kernel
])
def test_rwkv6_tensor_core_route(K_, V_, dtype, offset, want):
    """The wrapper sends its inputs to the tensor-core entry only when they
    are bf16 with K and V multiples of 8 at 16-byte aligned addresses; the
    spec's shared memory follows the same choice."""
    n = 2 * 3 * 2

    def aligned(count, dt, off=0):
        buf = torch.zeros(count + 16, dtype=dt)
        step = 16 // buf.element_size()
        base = (-buf.data_ptr() // buf.element_size()) % step
        return buf[base + off:base + off + count]

    r = aligned(n * K_, dtype, offset).view(2, 3, 2, K_)
    k = aligned(n * K_, dtype).view(2, 3, 2, K_)
    v = aligned(n * V_, dtype).view(2, 3, 2, V_)
    logw = aligned(n * K_, torch.float32).view(2, 3, 2, K_)
    assert rwkv6_tensor_cores(r, k, v, logw) is want
    assert rwkv6_smem_bytes(want) == (68_368 if want else 62_720)


def test_h100_launch_config_fits_shared_memory():
    ex = make_executor("h100")
    cfg = ex.launch_config("nn_rwkv6_scan", {"S": 2048, "K": 64, "V": 64})
    # the tensor-core kernel (bf16): r, k, v (64 x 72 bf16) 27,648, W (65 x
    # 68 f32) 17,680, u 256, four warps' diagonal scores (16 x 17) 4,352, the
    # state (hi, lo) 18,432; three blocks an SM (each with 1 KB the card
    # reserves)
    assert cfg["chunk"] == CHUNK == 64
    assert cfg.smem_bytes == rwkv6_smem_bytes() == 68_368
    assert 3 * (cfg.smem_bytes + 1024) <= ex.hw.smem_per_block_bytes + 1024
    # the CUDA-core kernel (f32, fp16 and the bf16 inputs rwkv6_tensor_cores
    # refuses): r, k, v, W, Wprev (32 x 65), the
    # state (64 x 64), G (32 x 33), u, decay
    cfg = ex.launch_config("nn_rwkv6_scan", {"S": 2048, "K": 64, "V": 64,
                                             "tensor_cores": 0})
    assert cfg.smem_bytes == rwkv6_smem_bytes(False) == 62_720
    assert FMA_CHUNK == 32
    assert 3 * cfg.smem_bytes <= ex.hw.smem_per_block_bytes  # three blocks an SM
