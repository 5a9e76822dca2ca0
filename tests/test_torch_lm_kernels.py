"""The port's three LM kernels (rmsnorm, flash_attention, ssd_scan) against the
JAX package's Pallas kernels, run in interpret mode as its own tests run them.

On the CPU each CUDA kernel's wrapper takes its plain PyTorch version (the
CUDA code runs only on the card, where ``chip_smoke.py`` holds it against
the same plain version).  Here the plain versions, reached through the
wrappers, and the ``torch`` / ``reference`` spaces of the registry ops
``nn_rmsnorm`` / ``nn_attention`` / ``nn_ssd_scan`` are held against the
Pallas kernels and their ops under ``PallasInterpretExecutor``, on
numpy-seeded inputs with ragged shapes.

Tolerances, f32: rmsnorm 1e-6 relative (one f32 reduction in another
order); flash_attention 1e-5 of max |out| (softmax sums in another order and
tiling); ssd_scan 1e-4 relative to max |y| (the chunked sums run in another
order than the kernel's, and the reference space is the sequential
recurrence).  bf16: both sides round the same f32 result to bf16, so an
output may differ by one bf16 ulp (2^-7 relative); the Pallas flash kernel
also rounds its probabilities to bf16 before the PV product (the port keeps
them f32), so attention in bf16 is held to 1e-2 of max |out|.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import make_executor as jax_make_executor
from repro.core import registry as jax_registry
from repro.kernels.flash_attention.kernel import flash_attention as jax_flash
from repro.kernels.rmsnorm.kernel import rmsnorm as jax_rmsnorm
from repro.kernels.ssd.kernel import ssd_scan as jax_ssd
from repro_torch import kernels as K
from repro_torch.core import make_executor, registry
from repro_torch.kernels.flash_attention import kernel as FK
from repro_torch.kernels.flash_attention.kernel import (
    flash_smem_bytes,
    flash_tile_plan,
)
from repro_torch.kernels.rmsnorm.kernel import rmsnorm_geometry
from repro_torch.kernels.ssd.kernel import ssd_smem_bytes, ssd_tensor_cores

BF16_ULP = 2.0 ** -7


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _pair(a: np.ndarray, dtype: str):
    """The same values as a JAX and a torch array of ``dtype``."""
    if dtype == "bfloat16":
        return (jnp.asarray(a, jnp.bfloat16),
                torch.from_numpy(a).to(torch.bfloat16))
    return jnp.asarray(a, jnp.float32), torch.from_numpy(a)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.to(torch.float32).numpy()


def _jnp(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a, jnp.float32))


# -- rmsnorm --------------------------------------------------------------------


@pytest.mark.parametrize("rows,d,dtype", [(37, 40, "float32"), (5, 130, "float32"),
                                          (16, 64, "bfloat16"),
                                          (9, 1000, "bfloat16")])
def test_rmsnorm_plain_matches_pallas(rows, d, dtype):
    rng = np.random.default_rng(rows * d)
    x = (3 * rng.standard_normal((rows, d))).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    jx, tx = _pair(x, dtype)
    want = _jnp(jax_rmsnorm(jx, jnp.asarray(w), eps=1e-5, block_rows=8,
                            interpret=True))
    got = K.rmsnorm(tx, torch.from_numpy(w), 1e-5)  # CPU: the plain version
    assert got.dtype == tx.dtype
    rtol = 1e-6 if dtype == "float32" else BF16_ULP
    np.testing.assert_allclose(_np(got), want, rtol=rtol, atol=rtol * 1e-3)


@pytest.mark.parametrize("space", ["torch", "reference"])
def test_rmsnorm_op_spaces_match_pallas_executor(space):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 48)).astype(np.float32)
    w = rng.standard_normal(48).astype(np.float32)
    want = _jnp(jax_registry.operation("nn_rmsnorm")(
        jnp.asarray(x), jnp.asarray(w), 1e-6,
        executor=jax_make_executor("pallas_interpret")))
    got = registry.operation("nn_rmsnorm")(
        torch.from_numpy(x), torch.from_numpy(w), 1e-6,
        executor=make_executor(space))
    np.testing.assert_allclose(_np(got), want, rtol=1e-6, atol=1e-7)


def test_rmsnorm_geometry():
    # (vectorized, vectors a thread, threads a row, rows a block).  The
    # path's widths: 16-byte vectors, 160 threads (5 warps) a row
    assert rmsnorm_geometry(5120, 2, True, 4) == (True, 4, 160, 1)
    assert rmsnorm_geometry(2560, 2, True, 4) == (True, 2, 160, 1)
    assert rmsnorm_geometry(1024, 2, True, 4) == (True, 1, 128, 1)
    assert rmsnorm_geometry(1000, 4, True, 4) == (True, 2, 128, 1)
    assert rmsnorm_geometry(256, 2, True, 4) == (True, 1, 32, 4)  # a warp a row
    assert rmsnorm_geometry(256, 2, True, 16) == (True, 1, 32, 8)  # 256 threads
    assert rmsnorm_geometry(77, 2, True, 4) == (False, 1, 96, 1)  # not a vector multiple
    assert rmsnorm_geometry(64, 2, False, 4) == (False, 1, 64, 1)  # unaligned base
    assert rmsnorm_geometry(16384, 2, True, 4) == (True, 8, 256, 1)  # the widest
    assert rmsnorm_geometry(8192, 2, False, 4) == (False, 8, 1024, 1)  # no vectors
    with pytest.raises(ValueError, match="registers"):
        rmsnorm_geometry(40000, 4, True, 4)
    with pytest.raises(ValueError, match="registers"):
        rmsnorm_geometry(8193, 2, False, 4)


def test_rmsnorm_geometry_at_decode_rows():
    """A decode step's 8 rows take the prefill's 16,384-row geometry: the
    team per row depends only on d; the persistent grid (one wave of
    resident blocks at most) is what shrinks, to one block a row."""
    ex = make_executor("h100")
    for d in (5120, 2560):
        cfgs = [ex.launch_config("nn_rmsnorm", {"rows": rows, "d": d,
                                                "itemsize": 2})
                for rows in (8, 16384)]
        assert cfgs[0].block == cfgs[1].block == {"rows_per_block": 4}
        assert cfgs[0].smem_bytes == 2 * 32 * 4
    assert rmsnorm_geometry(5120, 2, True, 4)[2:] == (160, 1)


# -- flash attention --------------------------------------------------------------

FLASH_CASES = [
    # B, Hq, Hkv, S, Skv, D, dtype, causal
    (1, 4, 4, 50, 50, 16, "float32", True),     # S not a tile multiple
    (2, 4, 2, 40, 40, 20, "float32", True),     # Hkv < Hq, D = 20
    (1, 4, 1, 24, 56, 16, "float32", True),     # Skv > S: kv_offset 32
    (1, 4, 2, 56, 24, 20, "float32", True),     # Skv < S: 32 rows see nothing
    (1, 4, 2, 40, 40, 16, "bfloat16", True),
    (1, 4, 4, 33, 70, 20, "bfloat16", True),
    (1, 2, 1, 30, 45, 16, "float32", False),
]


def _qkv(B, Hq, Hkv, S, Skv, D, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Hq, S, D)).astype(np.float32)
    k = rng.standard_normal((B, Hkv, Skv, D)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, Skv, D)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("B,Hq,Hkv,S,Skv,D,dtype,causal", FLASH_CASES)
def test_flash_attention_plain_matches_pallas(B, Hq, Hkv, S, Skv, D, dtype,
                                              causal):
    q, k, v = _qkv(B, Hq, Hkv, S, Skv, D, seed=S * Skv + D)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dtype) for a in (q, k, v))
    want = _jnp(jax_flash(jq, jk, jv, causal=causal, block_q=16, block_kv=16,
                          interpret=True))
    got = K.flash_attention(tq, tk, tv, causal=causal)  # CPU: the plain version
    assert got.dtype == tq.dtype and got.shape == (B, Hq, S, D)
    scale = np.abs(want).max()
    tol = 1e-5 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(_np(got), want, rtol=0, atol=tol * scale)
    if causal and Skv < S:  # rows before the first key are exactly 0
        dead = S - Skv
        assert not _np(got)[:, :, :dead].any()
        assert not want[:, :, :dead].any()


@pytest.mark.parametrize("space", ["torch", "reference"])
def test_attention_op_spaces_match_pallas_executor(space):
    q, k, v = _qkv(2, 4, 2, 37, 37, 16, seed=5)
    want = _jnp(jax_registry.operation("nn_attention")(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        executor=jax_make_executor("pallas_interpret")))
    got = registry.operation("nn_attention")(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=True, executor=make_executor(space))
    np.testing.assert_allclose(_np(got), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


# -- ssd scan ---------------------------------------------------------------------

SSD_CASES = [
    # B, S, H, P, G, N, Pallas chunk, dtype
    (2, 100, 4, 16, 2, 16, 32, "float32"),   # S not a chunk multiple
    (1, 128, 4, 20, 1, 16, 64, "float32"),
    (1, 70, 4, 16, 2, 16, 64, "bfloat16"),
]


def _ssd_inputs(B, S, H, P, G, N, seed, dt_shift=-1.0, a_scale=0.5):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)) + dt_shift)).astype(np.float32)
    A = (-np.exp(a_scale * rng.standard_normal(H))).astype(np.float32)
    Bm = (0.5 * rng.standard_normal((B, S, G, N))).astype(np.float32)
    C = (0.5 * rng.standard_normal((B, S, G, N))).astype(np.float32)
    return x, dt, A, Bm, C


@pytest.mark.parametrize("B,S,H,P,G,N,chunk,dtype", SSD_CASES)
def test_ssd_scan_plain_and_reference_match_pallas(B, S, H, P, G, N, chunk,
                                                   dtype):
    x, dt, A, Bm, C = _ssd_inputs(B, S, H, P, G, N, seed=S + H)
    (jx, tx), (jB, tB), (jC, tC) = (_pair(a, dtype) for a in (x, Bm, C))
    jy, jh = jax_ssd(jx, jnp.asarray(dt), jnp.asarray(A), jB, jC, chunk=chunk,
                     interpret=True)
    want_y, want_h = _jnp(jy), np.asarray(jh)
    tdt, tA = torch.from_numpy(dt), torch.from_numpy(A)
    rtol = 1e-4 if dtype == "float32" else BF16_ULP
    for space in ("wrapper", "torch", "reference"):
        if space == "wrapper":  # CPU: the plain (chunked) version
            y, h = K.ssd_scan(tx, tdt, tA, tB, tC)
        else:
            y, h = registry.operation("nn_ssd_scan")(
                tx, tdt, tA, tB, tC, executor=make_executor(space))
        assert y.dtype == tx.dtype and h.dtype == torch.float32
        assert h.shape == (B, H, N, P)
        np.testing.assert_allclose(_np(y), want_y, rtol=rtol,
                                   atol=1e-4 * np.abs(want_y).max(),
                                   err_msg=space)
        np.testing.assert_allclose(h.numpy(), want_h, rtol=1e-4,
                                   atol=1e-4 * np.abs(want_h).max(),
                                   err_msg=space)


def test_ssd_scan_strong_decay_stays_finite():
    """exp(acum_t - acum_s) above the diagonal overflows f32 when the decay
    is strong; the chunked version masks before the exp, so nothing turns
    NaN, and it still agrees with the sequential recurrence."""
    x, dt, A, Bm, C = _ssd_inputs(1, 96, 2, 16, 1, 16, seed=3, dt_shift=4.0,
                                  a_scale=0.0)
    A = A * 30.0  # dt A about -150 a step: 64 steps reach exp(+9600)
    args = [torch.from_numpy(a) for a in (x, dt, A, Bm, C)]
    y, h = K.ssd_scan(*args)
    yr, hr = registry.operation("nn_ssd_scan")(
        *args, executor=make_executor("reference"))
    assert torch.isfinite(y).all() and torch.isfinite(h).all()
    np.testing.assert_allclose(y.numpy(), yr.numpy(), rtol=1e-4,
                               atol=1e-4 * float(yr.abs().max()))


# -- the tensor-core kernel's algebra (csrc/ssd_scan.cu, bf16) ------------------------
#
# The kernel runs only on the card.  ``_ssd_mma_mirror`` repeats its algebra
# in plain PyTorch: chunks of 64 masked past S (not padded), C B^T from the
# bf16 inputs as they are, and every f32 operand (the decay-weighted scores
# G, the carried state h, B scaled by wdt) split into bf16 hi + lo, each
# part multiplied in f32.  It is held against the Pallas kernel at the
# tolerances chip_smoke.py holds the kernel to: y within one bf16 ulp plus
# 1e-4 of max |y|, the state within 1e-4 of its max.


def _split_bf16(t: torch.Tensor):
    """hi = t rounded to bf16, lo = (t - hi) rounded to bf16, both as f32."""
    hi = t.to(torch.bfloat16).to(torch.float32)
    return hi, (t - hi).to(torch.bfloat16).to(torch.float32)


def _mm2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a b with ``a`` f32 split into hi + lo and ``b`` exact in bf16: the
    kernel's two products."""
    hi, lo = _split_bf16(a)
    return hi @ b + lo @ b


def _ssd_mma_mirror(x, dt, A, Bm, C, exponents=None):
    """(y, state) by the tensor-core kernel's algebra; every exponent it
    forms is appended to ``exponents`` (when given)."""
    L = 64
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    xf, Bf, Cf = (t.to(torch.float32) for t in (x, Bm, C))

    def exp(e):
        if exponents is not None:
            exponents.append(float(e.max()) if e.numel() else 0.0)
        return torch.exp(e)

    y = torch.zeros(Bsz, S, H, P)
    state = torch.zeros(Bsz, H, N, P)
    for b in range(Bsz):
        for h in range(H):
            g = h // (H // G)
            hs = torch.zeros(N, P)
            for t0 in range(0, S, L):
                n = min(L, S - t0)  # rows past S read as 0: masked, not padded
                xc = torch.zeros(L, P)
                Bc = torch.zeros(L, N)
                Cc = torch.zeros(L, N)
                dtc = torch.zeros(L)
                xc[:n], Bc[:n], Cc[:n] = xf[b, t0:t0 + n, h], Bf[b, t0:t0 + n, g], Cf[b, t0:t0 + n, g]
                dtc[:n] = dt[b, t0:t0 + n, h]
                acum = torch.cumsum(dtc * A[h], 0)
                wdt = exp(acum[-1] - acum) * dtc
                # y = exp(acum_t) (C h), h split hi + lo; C exact
                hi, lo = _split_bf16(hs)
                yc = exp(acum)[:, None] * (Cc @ hi + Cc @ lo)
                # G = (C B^T) exp(acum_t - acum_s) dt_s, masked before the exp
                lower = torch.tril(torch.ones(L, L, dtype=torch.bool))
                diff = (acum[:, None] - acum[None, :])[lower]
                decay = torch.zeros(L, L)
                decay[lower] = exp(diff)
                Gm = (Cc @ Bc.T) * decay * dtc[None, :]
                yc = yc + _mm2(Gm, xc)
                y[b, t0:t0 + n, h] = yc[:n]
                hs = exp(acum[-1]) * hs + _mm2((Bc * wdt[:, None]).T, xc)
            state[b, h] = hs
    return y.to(x.dtype), state


SSD_MMA_CASES = [
    # B, S, H, P, G, N, dt_shift, A scale: the path's ratios at a small size
    (1, 128, 4, 32, 2, 32, -1.0, 1.0),     # two whole chunks
    (2, 100, 4, 16, 2, 16, -1.0, 1.0),     # a ragged tail of 36
    (1, 70, 2, 32, 1, 32, 4.0, 30.0),      # strong decay, dt A ~ -150 a step
]


@pytest.mark.parametrize("B,S,H,P,G,N,dt_shift,a_mul", SSD_MMA_CASES)
def test_ssd_tensor_core_algebra_matches_pallas(B, S, H, P, G, N, dt_shift,
                                                a_mul):
    x, dt, A, Bm, C = _ssd_inputs(B, S, H, P, G, N, seed=B + S + P,
                                  dt_shift=dt_shift)
    A = A * a_mul
    (jx, tx), (jB, tB), (jC, tC) = (_pair(a, "bfloat16") for a in (x, Bm, C))
    jy, jh = jax_ssd(jx, jnp.asarray(dt), jnp.asarray(A), jB, jC, chunk=64,
                     interpret=True)
    want_y, want_h = _jnp(jy), np.asarray(jh)
    exps = []
    y, h = _ssd_mma_mirror(tx, torch.from_numpy(dt), torch.from_numpy(A), tB,
                           tC, exps)
    assert y.dtype == torch.bfloat16 and torch.isfinite(h).all()
    np.testing.assert_allclose(_np(y), want_y, rtol=BF16_ULP,
                               atol=1e-4 * np.abs(want_y).max())
    np.testing.assert_allclose(h.numpy(), want_h, rtol=0,
                               atol=1e-4 * np.abs(want_h).max())
    # no exponent above 0 is formed (the decays are masked before the exp)
    assert max(exps) <= 0.0


def test_bf16_split_keeps_sixteen_bits():
    """|x - hi - lo| <= 2^-16 |x| over f32 values of every magnitude the
    scans meet, and the split of a bf16 value is exact (lo = 0)."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.standard_normal(100_000)
                          * np.exp(rng.uniform(-60, 60, 100_000))).astype(np.float32))
    hi, lo = _split_bf16(x)
    assert ((x - hi - lo).abs() <= 2.0 ** -16 * x.abs()).all()
    b = x.to(torch.bfloat16).to(torch.float32)
    hi, lo = _split_bf16(b)
    assert torch.equal(hi, b) and not lo.any()


def test_ssd_wrapper_takes_strided_views():
    """x, B and C as mamba_forward cuts them from one conv output (a unit
    last stride, rows of H P + 2 G N elements) give the contiguous inputs'
    result; a last dimension that is not unit-stride is refused."""
    B, S, H, P, G, N = 1, 40, 4, 16, 2, 16
    rng = np.random.default_rng(4)
    conv = torch.from_numpy(rng.standard_normal((B, S, H * P + 2 * G * N))
                            .astype(np.float32))
    xv, Bv, Cv = torch.split(conv, [H * P, G * N, G * N], dim=-1)
    xv, Bv, Cv = xv.reshape(B, S, H, P), Bv.reshape(B, S, G, N), Cv.reshape(B, S, G, N)
    assert not xv.is_contiguous() and xv.stride(-1) == 1
    _, dt, A, _, _ = (torch.from_numpy(a) for a in _ssd_inputs(B, S, H, P, G, N, seed=4))
    y, h = K.ssd_scan(xv, dt, A, Bv, Cv)
    yc, hc = K.ssd_scan(xv.contiguous(), dt, A, Bv.contiguous(), Cv.contiguous())
    assert torch.equal(y, yc) and torch.equal(h, hc)
    with pytest.raises(ValueError, match="unit stride"):
        K.ssd_scan(xv.transpose(2, 3).contiguous().transpose(2, 3), dt, A, Bv, Cv)
    with pytest.raises(ValueError, match="contiguous"):
        K.ssd_scan(xv, dt.transpose(1, 2).contiguous().transpose(1, 2), A, Bv, Cv)


# -- the cuda space and the wrappers' checks -----------------------------------------


def test_cuda_space_refuses_cpu_tensors():
    """The cuda space launches its kernel or raises; it never hands CPU
    tensors to the plain version."""
    ex = make_executor("cuda")
    x = torch.ones(4, 16)
    with pytest.raises(ValueError, match="cuda kernel space needs CUDA"):
        registry.operation("nn_rmsnorm")(x, torch.ones(16), 1e-6, executor=ex)
    q = torch.ones(1, 2, 8, 16)
    with pytest.raises(ValueError, match="cuda kernel space needs CUDA"):
        registry.operation("nn_attention")(q, q, q, executor=ex)
    xs, dt, A, Bm, C = (torch.from_numpy(a) for a in
                        _ssd_inputs(1, 8, 2, 16, 1, 16, seed=0))
    with pytest.raises(ValueError, match="cuda kernel space needs CUDA"):
        registry.operation("nn_ssd_scan")(xs, dt, A, Bm, C, executor=ex)


def test_wrappers_check_their_arguments():
    with pytest.raises(ValueError, match="w shape"):
        K.rmsnorm(torch.ones(3, 8), torch.ones(7))
    with pytest.raises(ValueError, match="dtypes"):
        K.rmsnorm(torch.ones(3, 8), torch.ones(8, dtype=torch.float64))
    q = torch.ones(1, 3, 8, 16)
    with pytest.raises(ValueError, match="not divisible"):
        K.flash_attention(q, torch.ones(1, 2, 8, 16), torch.ones(1, 2, 8, 16))
    xs, dt, A, Bm, C = (torch.from_numpy(a) for a in
                        _ssd_inputs(1, 8, 2, 16, 1, 16, seed=0))
    with pytest.raises(ValueError, match="float32"):
        K.ssd_scan(xs, dt.double(), A, Bm, C)
    with pytest.raises(ValueError, match="contiguous"):
        K.rmsnorm(torch.ones(8, 3).T, torch.ones(8))


def test_lm_kernels_count_no_launch_on_the_cpu():
    K.reset_launch_counts()
    K.rmsnorm(torch.ones(3, 8), torch.ones(8))
    q = torch.ones(1, 2, 8, 16)
    K.flash_attention(q, q, q)
    K.ssd_scan(*(torch.from_numpy(a) for a in
                 _ssd_inputs(1, 8, 2, 16, 1, 16, seed=0)))
    counts = K.launch_counts()
    assert counts["rmsnorm"] == counts["flash_attention"] == counts["ssd_scan"] == 0


def _source_constants(name, keys):
    """The ``constexpr int`` values of ``keys`` in csrc/``name``."""
    src = (Path(K.__file__).parent / "csrc" / name).read_text()
    out = {}
    for key in keys:
        m = re.search(rf"constexpr int {key} = (\d+);", src)
        assert m, key
        out[key] = int(m.group(1))
    return out


@pytest.mark.parametrize("D,slabs,stages,smem", [
    (64, 1, 3, 66_688), (128, 2, 3, 132_224), (160, 3, 3, 197_760),
    (256, 4, 2, 197_760)])
def test_flash_tile_plan_matches_the_source(D, slabs, stages, smem):
    """The wgmma kernel's shared memory (WgGeom in the source): Q and each
    K / V tile in 64-column 128B-swizzled slabs, K and V in a ring of three
    stages, two when three do not fit a block."""
    c = _source_constants("flash_attention.cu", (
        "kWgBQ", "kWgBKV", "kSlab", "kSlabRow", "kSmemLimit", "kBarBytes",
        "kConsumers", "kProducerRegs", "kConsumerRegs"))
    plan = flash_tile_plan(D)
    assert (c["kWgBQ"], c["kWgBKV"], c["kSlab"]) == (
        FK.BLOCK_Q, FK.flash_block_kv(2), FK.SLAB)
    assert plan["slabs"] == slabs == -(-D // c["kSlab"])
    assert plan["q_bytes"] == slabs * c["kWgBQ"] * c["kSlabRow"]
    assert plan["stage_bytes"] == 2 * slabs * c["kWgBKV"] * c["kSlabRow"]
    assert plan["stages"] == stages
    assert plan["smem_bytes"] == smem == (
        plan["q_bytes"] + stages * plan["stage_bytes"] + c["kBarBytes"] + 1024)
    assert smem <= c["kSmemLimit"] == FK.SMEM_LIMIT
    assert plan["last_slab_cols"] == D - (slabs - 1) * 64
    # setmaxnreg: the producer warpgroup's registers pay for the consumers'
    src = (Path(K.__file__).parent / "csrc" / "flash_attention.cu").read_text()
    assert "constexpr int kWgThreads = kConsumers + 128;" in src
    threads = c["kConsumers"] + 128
    start = 65_536 // threads // 8 * 8
    assert start == 168
    assert (c["kConsumers"] * c["kConsumerRegs"] + 128 * c["kProducerRegs"]
            <= threads * start)


def test_ssd_source_matches_its_wrapper():
    """The tensor-core kernel's constants and occupancy, as the wrapper's
    shared-memory mirror assumes them: chunks of 64, four warps, x / B / C
    and state rows of 72 bf16, three blocks an SM, products by mma.sync."""
    from repro_torch.kernels.ssd import kernel as SK

    c = _source_constants("ssd_scan.cu", ("kL", "kW", "kMmaThreads"))
    assert (c["kL"], c["kW"]) == (SK.CHUNK, SK.MAX_DIM) == (64, 64)
    assert c["kMmaThreads"] == 128
    src = (Path(K.__file__).parent / "csrc" / "ssd_scan.cu").read_text()
    assert "constexpr int kLd = kW + 8;" in src
    assert "__launch_bounds__(kMmaThreads, 3)" in src
    assert src.count("mma_bf16(") >= 4 and '#include "mma_sync.cuh"' in src
    hdr = (Path(K.__file__).parent / "csrc" / "mma_sync.cuh").read_text()
    assert "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32" in hdr


@pytest.mark.parametrize("P,N,dtype,offset,want", [
    (64, 64, torch.bfloat16, 0, True),    # the serving path's views
    (32, 32, torch.bfloat16, 0, True),
    (12, 64, torch.bfloat16, 0, False),   # P not a multiple of 8
    (64, 12, torch.bfloat16, 0, False),   # N not a multiple of 8
    (64, 64, torch.bfloat16, 1, False),   # rows not 16-byte aligned
    (64, 64, torch.float32, 0, False),    # f32 keeps the CUDA-core kernel
])
def test_ssd_tensor_core_route(P, N, dtype, offset, want):
    """The wrapper sends x, B and C to the tensor-core entry only when they
    are bf16 with P and N multiples of 8 and 16-byte aligned rows; the spec's
    shared memory follows the same choice."""
    H, G = 4, 2
    width = H * P + 2 * G * N
    buf = torch.zeros(2 * 5 * width + 16, dtype=dtype)
    step = 16 // buf.element_size()
    base = (-buf.data_ptr() // buf.element_size()) % step  # 16-byte aligned
    conv = buf[base + offset:base + offset + 2 * 5 * width].view(2, 5, width)
    x, Bm, Cm = torch.split(conv, [H * P, G * N, G * N], dim=-1)
    x, Bm, Cm = x.reshape(2, 5, H, P), Bm.reshape(2, 5, G, N), Cm.reshape(2, 5, G, N)
    assert ssd_tensor_cores(x, Bm, Cm) is want
    assert ssd_smem_bytes(want) == (76_288 if want else 83_456)


def test_h100_launch_configs_fit_shared_memory():
    ex = make_executor("h100")
    assert ex.launch_config("nn_rmsnorm", {"rows": 16384, "d": 5120,
                                           "itemsize": 2})["rows_per_block"] == 4
    cfg = ex.launch_config("nn_attention", {"S": 2048, "Skv": 2048, "D": 160,
                                            "itemsize": 2})
    # Q 49,152 + 3 stages of K and V 147,456 + barriers 128 + alignment 1,024
    assert cfg["block_kv"] == 64 and cfg.smem_bytes == flash_smem_bytes(160, 2) == 197_760
    cfg = ex.launch_config("nn_attention", {"S": 512, "Skv": 512, "D": 256,
                                            "itemsize": 4})
    assert cfg["block_kv"] == 32
    assert cfg.smem_bytes == flash_smem_bytes(256, 4) <= ex.hw.smem_per_block_bytes
    # the tensor-core kernel (bf16): two stages of x, B, C (bf16 rows of 72)
    # and dt 55,808 + the state (hi, lo) 18,432 + acum and wdt 2,048; three
    # blocks an SM (each with 1 KB the card reserves)
    cfg = ex.launch_config("nn_ssd_scan", {"S": 2048, "N": 64, "P": 64})
    assert cfg["chunk"] == 64
    assert cfg.smem_bytes == ssd_smem_bytes() == 76_288
    assert 3 * (cfg.smem_bytes + 1024) <= ex.hw.smem_per_block_bytes + 1024
    # the CUDA-core kernel (f32, fp16 and the bf16 inputs ssd_tensor_cores
    # refuses) keeps its shared memory
    cfg = ex.launch_config("nn_ssd_scan", {"S": 2048, "N": 64, "P": 64,
                                           "tensor_cores": 0})
    assert cfg["chunk"] == 64 and cfg.smem_bytes == ssd_smem_bytes(False) == 83_456
