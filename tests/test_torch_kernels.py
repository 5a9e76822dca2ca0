"""The port's four kernels against the JAX package's Pallas kernels.

On the CPU each CUDA kernel's wrapper takes its plain PyTorch version (the
CUDA code runs only on the card, where ``chip_smoke.py`` holds it against
the same plain version).  Here the plain versions — reached through the
wrappers, as a CPU caller reaches them — are held against the Pallas kernels
run in interpret mode, with ragged shapes that are not a block multiple.

Tolerances: f32 sums taken in another order; 1e-5 relative to the sum of
magnitudes of the terms (about 100 eps32).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.axpy_norm.kernel import axpy_norm as jax_axpy_norm
from repro.kernels.block_jacobi.kernel import block_jacobi_apply as jax_bj
from repro.kernels.spmv_dot.kernel import spmv_dot_ell as jax_spmv_dot
from repro.kernels.spmv_ell.kernel import spmv_ell as jax_spmv_ell
from repro_torch import convert
from repro_torch import kernels as K
from repro_torch.core import make_executor, tuning
from repro_torch.kernels import _build

RTOL = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _ell(m, k, n, seed):
    """Random ELL arrays with ragged rows: each row's tail is padding
    (column 0, value 0), some rows are empty."""
    rng = np.random.default_rng(seed)
    cols = rng.integers(0, n, size=(m, k)).astype(np.int32)
    vals = rng.standard_normal((m, k)).astype(np.float32)
    fill = rng.integers(0, k + 1, size=m)
    pad = np.arange(k)[None, :] >= fill[:, None]
    cols[pad] = 0
    vals[pad] = 0.0
    return cols, vals, rng.standard_normal(n).astype(np.float32)


def _close(got, want, scale):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=RTOL, atol=RTOL * scale)


@pytest.mark.parametrize("m,k,n", [(37, 5, 29), (64, 7, 64), (3, 1, 5)])
def test_spmv_ell_matches_pallas(m, k, n):
    cols, vals, x = _ell(m, k, n, seed=m)
    want = jax_spmv_ell(jnp.asarray(cols), jnp.asarray(vals), jnp.asarray(x),
                        block_m=8, block_k=4, interpret=True)
    before = K.spmv_ell.launches
    got = K.spmv_ell(torch.from_numpy(cols), torch.from_numpy(vals),
                     torch.from_numpy(x))
    assert K.spmv_ell.launches == before  # the CPU path launches nothing
    scale = float(np.abs(vals).sum(1).max() * np.abs(x).max()) or 1.0
    _close(got, want, scale)
    _close(K.spmv_ell_plain(torch.from_numpy(cols), torch.from_numpy(vals),
                            torch.from_numpy(x)), want, scale)


@pytest.mark.parametrize("m,k,n", [(37, 5, 29), (100, 7, 100), (45, 1, 40),
                                   (70, 16, 50), (33, 17, 64), (50, 33, 41)])
def test_spmv_dot_ell_matches_pallas(m, k, n):
    cols, vals, x = _ell(m, k, n, seed=m + 1)
    w = np.random.default_rng(m).standard_normal(m).astype(np.float32)
    y_j, d_j = jax_spmv_dot(jnp.asarray(cols), jnp.asarray(vals),
                            jnp.asarray(x), jnp.asarray(w),
                            block_m=8, block_k=4, interpret=True)
    y, d = K.spmv_dot_ell(torch.from_numpy(cols), torch.from_numpy(vals),
                          torch.from_numpy(x), torch.from_numpy(w))
    y_np = np.asarray(y_j)
    _close(y, y_j, float(np.abs(vals).sum(1).max() * np.abs(x).max()) or 1.0)
    _close(d, d_j, float(np.abs(w * y_np).sum()))
    assert d.ndim == 0


@pytest.mark.parametrize("n", [1000, 128, 1, 4099, 2 * 1024 + 3])
def test_axpy_norm_matches_pallas(n):
    rng = np.random.default_rng(n)
    x = rng.standard_normal(n).astype(np.float32)
    y = rng.standard_normal(n).astype(np.float32)
    alpha = np.float32(-0.61)
    z_j, ss_j = jax_axpy_norm(jnp.asarray(alpha), jnp.asarray(x), jnp.asarray(y),
                              block_n=128, interpret=True)
    z, ss = K.axpy_norm(torch.tensor(alpha), torch.from_numpy(x),
                        torch.from_numpy(y))
    _close(z, z_j, float(np.abs(alpha * x).max() + np.abs(y).max()))
    _close(ss, ss_j, float(np.asarray(ss_j)))


@pytest.fixture
def x64():
    """``jax_enable_x64`` on for one test and restored after it (the JAX
    package's f64 arrays; ``jax.experimental.enable_x64`` is gone)."""
    import jax

    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", prev)


#: every (vector, storage) pair the adaptive selection makes for the float
#: types the solvers take: the vector's own type, bf16 and fp16
BJ_PAIRS = [(vec, storage) for vec in ("float32", "float64")
            for storage in (vec, "bfloat16", "float16")]


@pytest.mark.parametrize("bs", [4, 8, 5, 40])
@pytest.mark.parametrize("vec,storage", BJ_PAIRS)
def test_block_jacobi_apply_matches_pallas(vec, storage, bs, x64):
    """Each pair at the kernel's two packed block sizes, a general one and
    one above a warp (the CUDA kernel's wide route); 13 blocks fill no tile
    (the Pallas tile of 8 blocks, the CUDA warp's 4 or 8).  f64 vectors with bf16/fp16 blocks are the adaptive
    block-Jacobi of an f64 system (ROADMAP C13)."""
    nb = 13
    rng = np.random.default_rng(nb * bs)
    inv = rng.standard_normal((nb, bs, bs))
    vp = rng.standard_normal((nb, bs)).astype(vec)
    inv_j = jnp.asarray(inv).astype(storage)
    want = jax_bj(inv_j, jnp.asarray(vp), block_nb=8, interpret=True)
    assert want.dtype == jnp.dtype(vec)
    # the storage array crosses over as numpy (ml_dtypes for bfloat16)
    inv_t = convert.tensor(np.asarray(inv_j), device="cpu")
    assert inv_t.dtype == getattr(torch, storage)
    got = K.block_jacobi_apply(inv_t, torch.from_numpy(vp))
    assert got.dtype == getattr(torch, vec) and got.shape == (nb, bs)
    scale = float(np.abs(np.asarray(inv_j, np.float64)).sum(2).max()
                  * np.abs(vp).max())
    # f32: sums in another order (RTOL); f64: 4 bs eps of the sum of terms
    tol = RTOL if vec == "float32" else 4 * bs * np.finfo(np.float64).eps
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol,
                               atol=tol * scale)


@pytest.mark.parametrize("vec,storage", [
    ("float16", "float16"), ("float16", "bfloat16"),
    ("bfloat16", "bfloat16"), ("bfloat16", "float16")])
def test_block_jacobi_apply_refuses_16_bit_vectors(vec, storage):
    """No path of either package applies block-Jacobi to a 16-bit vector (a
    solve in bf16 or fp16): the wrapper names such a pair and refuses it."""
    with pytest.raises(ValueError, match=f"vector torch.{vec} with storage "
                       f"torch.{storage} not supported"):
        K.block_jacobi_apply(torch.zeros(2, 4, 4, dtype=getattr(torch, storage)),
                             torch.zeros(2, 4, dtype=getattr(torch, vec)))


def test_adaptive_f64_block_jacobi_classes_and_apply(x64):
    """The adaptive block-Jacobi of an f64 system: the port picks the JAX
    package's storage class for every block (f64, bf16 and fp16 all occur)
    and stores the same inverted blocks (the reduced classes bit for bit,
    the f64 class within 8 eps of its largest entry: the two inversions
    round differently), and the wrapper on the port's blocks with f64
    vectors equals the Pallas kernel on the JAX package's in interpret
    mode."""
    from repro import sparse as jsparse
    from repro.precond import block_jacobi as jax_block_jacobi
    from repro_torch.precond import block_jacobi
    from repro_torch.sparse import formats as F

    # blocks of 8: well conditioned (fp16), tiny with a huge inverse (bf16),
    # stretched to a condition number past both (f64); a weak coupling
    rng = np.random.default_rng(8)
    a = np.zeros((60, 60))
    for bi, s in enumerate(range(0, 60, 8)):
        w = min(8, 60 - s)
        blk = rng.normal(size=(w, w))
        blk = blk @ blk.T / w + 4 * np.eye(w)
        if bi % 3 == 1:
            blk = 1e-6 * np.eye(w)
        elif bi % 3 == 2:
            scale = np.linspace(1.0, 1e4, w)
            blk = blk * np.sqrt(scale[:, None] * scale[None, :])
        a[s:s + w, s:s + w] = blk
    for i in range(52):
        a[i, i + 8] = a[i + 8, i] = 0.01
    Pj = jax_block_jacobi(jsparse.ell_from_dense(a), 8, adaptive=True)
    Pt = block_jacobi(F.ell_from_dense(a, device="cpu"), 8, adaptive=True)
    assert Pt.precision_counts == Pj.precision_counts
    assert [d for d, _ in Pt.precision_counts] == ["float64", "bfloat16",
                                                   "float16"]
    # the same blocks in the same class order
    np.testing.assert_array_equal(Pt.gather_idx.numpy(), np.asarray(Pj.gather_idx))
    rng = np.random.default_rng(5)
    for tj, tt in zip(Pj.inv_blocks, Pt.inv_blocks):
        assert str(tt.dtype) == f"torch.{tj.dtype}"
        inv_j = np.asarray(tj).astype(np.float64)
        inv_t = tt.double().numpy()
        if tt.dtype == torch.float64:
            np.testing.assert_allclose(
                inv_t, inv_j, rtol=0,
                atol=8 * np.finfo(np.float64).eps * np.abs(inv_j).max())
        else:
            np.testing.assert_array_equal(inv_t, inv_j)
        vp = rng.standard_normal(tj.shape[:2])
        want = np.asarray(jax_bj(tj, jnp.asarray(vp), block_nb=8,
                                 interpret=True))
        got = K.block_jacobi_apply(tt, torch.from_numpy(vp))
        assert got.dtype == torch.float64
        scale = float(np.abs(np.asarray(tj, np.float64)).sum(2).max()
                      * np.abs(vp).max())
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=4 * 8 * np.finfo(np.float64).eps * scale)


@pytest.mark.parametrize("space", ["reference", "torch"])
def test_registry_spaces_serve_the_plain_versions(space):
    """The ops the solver dispatches give the plain versions' bits."""
    from repro_torch.sparse import ops
    from repro_torch.sparse.formats import Ell

    cols, vals, x = _ell(40, 6, 40, seed=3)
    A = Ell(torch.from_numpy(cols), torch.from_numpy(vals), (40, 40))
    xt = torch.from_numpy(x)
    ex = make_executor(space)
    y, d = ops.spmv_dot(A, xt, executor=ex)
    assert torch.equal(y, K.spmv_ell_plain(A.col_idx, A.values, xt))
    assert torch.equal(d, torch.dot(xt, y))
    z, ss = ops.axpy_norm(torch.tensor(0.5), xt, y, executor=ex)
    z_p, ss_p = K.axpy_norm_plain(torch.tensor(0.5), xt, y)
    assert torch.equal(z, z_p) and torch.equal(ss, ss_p)


def test_wrappers_check_their_arguments():
    cols, vals, x = _ell(10, 3, 10, seed=1)
    c, v, xt = torch.from_numpy(cols), torch.from_numpy(vals), torch.from_numpy(x)
    with pytest.raises(ValueError, match="int32"):
        K.spmv_ell(c.long(), v, xt)
    with pytest.raises(ValueError, match="dtype"):
        K.spmv_ell(c, v, xt.double())
    with pytest.raises(ValueError, match="contiguous"):
        K.spmv_ell(c, v, torch.cat([xt, xt])[::2])
    with pytest.raises(ValueError, match="device"):
        K.spmv_ell(c, v, xt.to("meta"))
    with pytest.raises(ValueError, match="not supported"):
        K.block_jacobi_apply(torch.zeros(2, 4, 4, dtype=torch.float16),
                             torch.zeros(2, 4, dtype=torch.float16))


def test_tuning_geometry_for_h100():
    hw = make_executor("h100").hw
    # the ELL path's k = 7: one thread a row, a warp's 32 rows staged in
    # shared memory at an odd stride (7 entries of 4 + 4 bytes a row)
    cfg = tuning.resolve("spmv_ell", {"m": 2_097_152, "k": 7}, hw)
    assert cfg["subgroup"] == 1 and cfg["block_threads"] == 256
    assert cfg.smem_bytes == 256 * 7 * 8 and cfg.source == "seed"
    # an even k is padded to k + 1; f64 values take 8 bytes
    cfg = tuning.resolve("spmv_ell", {"m": 10, "k": 4, "itemsize": 8}, hw)
    assert cfg["subgroup"] == 1 and cfg.smem_bytes == 256 * 5 * 12
    # wider rows keep lanes a row, with no shared memory
    cfg = tuning.resolve("spmv_ell", {"m": 10, "k": 27}, hw)
    assert cfg["subgroup"] == 8 and cfg.smem_bytes == 0
    # the fused SpMV + dot walks as spmv_ell: at k = 7 one thread a row, its
    # staged spans plus block_sum's 32 partials
    cfg = tuning.resolve("spmv_dot", {"m": 2_097_152, "k": 7, "itemsize": 4}, hw)
    assert cfg["subgroup"] == 1 and cfg["block_threads"] == 256
    assert cfg.smem_bytes == 256 * 7 * 8 + 128
    cfg = tuning.resolve("spmv_dot", {"m": 10, "k": 27, "itemsize": 4}, hw)
    assert cfg["subgroup"] == 8 and cfg["block_threads"] == 256
    assert cfg.smem_bytes == 128
    # axpy_norm: a persistent grid of one wave (8 blocks of 256 an SM), cut
    # to what n needs in 16-byte packs
    cfg = tuning.resolve("axpy_norm", {"n": 2_097_152, "itemsize": 4}, hw)
    assert cfg["block_threads"] == 256 and cfg["grid_blocks"] == 132 * 8
    cfg = tuning.resolve("axpy_norm", {"n": 4099, "itemsize": 8}, hw)
    assert cfg["grid_blocks"] == 9
    # a geometry over the shared-memory budget is refused, not shrunk
    tiny = dataclasses.replace(hw, smem_per_block_bytes=64)
    with pytest.raises(ValueError, match="shared memory"):
        tuning.resolve("spmv_dot", {"m": 10, "k": 27, "itemsize": 4}, tiny)
    tuning.set_table_entry("block_jacobi", "h100", {"block_threads": 1000})
    try:
        cfg = tuning.resolve("block_jacobi", {"nb": 5, "bs": 8}, hw)
        assert cfg.source == "table" and cfg["block_threads"] == 992
    finally:
        tuning._TABLE.pop(("block_jacobi", "h100"))


@pytest.mark.parametrize("k", range(4, 101))
def test_spmv_ell_walk_for_each_k(k):
    """The walk is a function of k over the AMG operators' range (k from 4
    to about 100): one thread a row up to 16 entries, the seed's 8 lanes to
    32, a whole warp beyond; the thread-per-row walk's blocks hold 256
    threads even where a table entry asks for more."""
    hw = make_executor("h100").hw
    want = 1 if k <= 16 else 8 if k <= 32 else 32
    assert tuning.resolve("spmv_ell", {"m": 1_048_576, "k": k}, hw)["subgroup"] == want
    tuning.set_table_entry("spmv_ell", "h100", {"block_threads": 1024,
                                                "subgroup": 8})
    try:
        cfg = tuning.resolve("spmv_ell", {"m": 1_048_576, "k": k}, hw)
        assert cfg["subgroup"] == want
        assert cfg["block_threads"] == (256 if want == 1 else 1024)
    finally:
        tuning._TABLE.pop(("spmv_ell", "h100"))


@pytest.mark.parametrize("k", range(4, 101))
def test_spmv_dot_walk_for_each_k(k):
    """The fused SpMV + dot walks as spmv_ell for every k of the AMG
    operators' range: one thread a row up to 16 entries (its blocks at most
    256 threads, shared memory for the staged spans and block_sum's 32
    partials), the seed's 8 lanes to 32, a whole warp beyond; a table entry
    keeps its block width where the walk allows it."""
    hw = make_executor("h100").hw
    want = 1 if k <= 16 else 8 if k <= 32 else 32
    shapes = {"m": 1_048_576, "k": k, "itemsize": 4}
    cfg = tuning.resolve("spmv_dot", shapes, hw)
    ell = tuning.resolve("spmv_ell", shapes, hw)
    assert cfg["subgroup"] == ell["subgroup"] == want
    assert cfg.smem_bytes == ell.smem_bytes + 128
    assert cfg.smem_bytes == (256 * (k | 1) * 8 if want == 1 else 0) + 128
    tuning.set_table_entry("spmv_dot", "h100", {"block_threads": 1024,
                                                "subgroup": 8})
    try:
        cfg = tuning.resolve("spmv_dot", shapes, hw)
        assert cfg["subgroup"] == want
        assert cfg["block_threads"] == (256 if want == 1 else 1024)
    finally:
        tuning._TABLE.pop(("spmv_dot", "h100"))


def test_wrappers_choose_their_route():
    """axpy_norm takes 16-byte packs where x, y and z are 16-byte aligned (a
    scalar tail covers an n that is not a multiple of the pack), single
    elements on an offset view; the row form needs n to be a multiple of the
    pack too.  The grid follows the route.  An empty operand gives a zero
    without a launch."""
    from repro_torch.kernels.axpy_norm.kernel import launch_grid, vector_width

    x = torch.zeros(4099 + 8)
    x64 = x.double()
    assert x.data_ptr() % 16 == 0 and x64.data_ptr() % 16 == 0
    assert vector_width(x, x) == 4 and vector_width(x64, x64) == 2
    assert vector_width(x[:4099], x[:4099]) == 4  # n % 4 = 3: a scalar tail
    assert vector_width(x[1:], x[:-1]) == 1  # x[1:] is 4 bytes off
    assert vector_width(x64[1:], x64[1:]) == 1
    assert vector_width(x[4:], x[8:]) == 4  # 16 bytes off: still aligned
    X = torch.zeros(8, 1024)
    assert vector_width(X, X, row=1024) == 4
    assert vector_width(X[:, :1023].contiguous(), X, row=1023) == 1
    assert vector_width(X.double(), X.double(), row=1022) == 2
    assert launch_grid(2_097_152, 4, 256, 1056) == 1056
    assert launch_grid(1_048_576, 4, 256, 1056) == 1024
    assert launch_grid(1_048_576, 1, 256, 1056) == 1056
    assert launch_grid(4099, 4, 256, 1056) == 5
    assert launch_grid(3, 4, 256, 1056) == 1
    before = K.launch_counts()
    z, ss = K.axpy_norm(torch.tensor(0.5), torch.zeros(0), torch.zeros(0))
    assert z.shape == (0,) and ss.ndim == 0 and float(ss) == 0.0
    Z, S = K.axpy_norm_rows(torch.ones(3), torch.zeros(3, 0), torch.zeros(3, 0))
    assert Z.shape == (3, 0) and torch.equal(S, torch.zeros(3))
    y, d = K.spmv_dot_ell(torch.zeros(0, 7, dtype=torch.int32),
                          torch.zeros(0, 7), torch.zeros(5), torch.zeros(0))
    assert y.shape == (0,) and float(d) == 0.0
    assert K.launch_counts() == before


def test_workspace_is_kept_per_kernel_and_stream():
    """The single-pass sums' workspace: zeroed tickets allocated once per
    (kernel, device, stream), reused while large enough, replaced by a
    larger zeroed one when a call needs more."""
    from repro_torch.kernels import _workspace

    dev = torch.device("cpu")
    t, p = _workspace.workspace("test_kernel", dev, 7, 4, 64)
    assert t.dtype == torch.int32 and t.numel() == 4 and not t.any()
    assert p.dtype == torch.uint8 and p.numel() == 64
    t2, p2 = _workspace.workspace("test_kernel", dev, 7, 2, 32)
    assert t2 is t and p2 is p
    t3, p3 = _workspace.workspace("test_kernel", dev, 7, 9, 16)
    assert t3 is not t and t3.numel() == 9 and not t3.any() and p3.numel() == 64
    t4, _ = _workspace.workspace("test_kernel", dev, 8, 1, 8)
    assert t4 is not t3
    for stream in (7, 8):
        _workspace._CACHE.pop(("test_kernel", dev, stream))


def test_launch_counts_reset_per_kernel_and_per_storage(monkeypatch):
    monkeypatch.setattr(K.spmv_ell, "launches", 3)
    monkeypatch.setattr(K.block_jacobi_apply, "launches", 2)
    monkeypatch.setattr(K.block_jacobi_apply, "launches_by_storage",
                        {"float16": 1, "bfloat16": 1})
    K.reset_launch_counts()
    assert set(K.launch_counts().values()) == {0}
    assert K.block_jacobi_apply.launches_by_storage == {}


def test_loader_check_needs_a_card(monkeypatch):
    from repro_torch.kernels import loader_check

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert loader_check.main(["--cudart", "static"]) == 2


def test_build_needs_nvcc(monkeypatch, tmp_path):
    """No nvcc: the build raises a clear error (never a silent fallback)."""
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()
    # the library name follows the sources, so an edit builds anew
    assert _build.library_path().name.startswith("librepro_torch_")
    assert {p.name for p in _build.CSRC.glob("*.cu")} >= {
        "spmv_ell.cu", "spmv_dot.cu", "axpy_norm.cu", "block_jacobi.cu"}


def _chip_smoke():
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_for_test", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("mangled", [False, True])
@pytest.mark.parametrize("fused_regs, spill, ok", [
    (48, 72, True),     # CUDA 12.9's build: spmv_ell's 5 blocks an SM
    (56, 72, False),    # 4 blocks an SM, fewer than spmv_ell's
    (48, 200, False),   # past the path's spill limit
])
def test_walk_occupancy_check(mangled, fused_regs, spill, ok, capsys):
    """The build phase's check of the fused thread-per-row kernel's
    ``__launch_bounds__`` against spmv_ell's copy of the walk, read from
    ptxas's table with demangled or mangled names."""
    cs = _chip_smoke()

    def name(kernel, kmax, kind):
        if mangled:
            return (f"_ZN12_GLOBAL__N_1{len(kernel) + 12}{kernel}_rows_kernel"
                    f"ILi{kmax}E{kind[0]}EEvPKiPKT0_")
        return f"void {kernel}_rows_kernel<{kmax}, {kind}>"

    table = [["spmv_ell.cu", name("spmv_ell", 8, "float"), 48, 0, 0],
             ["spmv_dot.cu", name("spmv_dot_ell", 8, "float"), fused_regs,
              144, spill],
             ["spmv_ell.cu", name("spmv_ell", 16, "double"), 80, 0, 0],
             ["spmv_dot.cu", name("spmv_dot_ell", 16, "double"), 80, 272, 448]]
    if ok:
        cs.walk_occupancy_check(table)
        assert "fused 5 blocks an SM" in capsys.readouterr().out
    else:
        with pytest.raises(SystemExit):
            cs.walk_occupancy_check(table)
    with pytest.raises(SystemExit):  # spmv_ell's row missing
        cs.walk_occupancy_check(table[1:2])
