"""The port's AMG over an ELL operand, with Pgm's unsmoothed transfer, and
its compiled aggregation.

* ``make_preconditioner(A_ell, "amg", ...)`` builds the hierarchy of the
  equal CSR matrix: the same levels, transfers, ELL mirrors, inverse
  diagonals, coarse inverse and gauges, and applies equal bit for bit in
  float64 — smoothed or not.  The ELL operand is its own level-0 ``A_op``.
* ``smooth_prolongator=False`` against the plain reference
  ``portbench/reference/amg.py`` at ``poisson_3d(16)`` and on an
  anisotropic matrix: the same aggregates level for level, applies within
  1e-13 of each other (float64 sums in another order through four
  levels), CG iterates within 1e-10 after as many iterations, and the same
  iteration count.
* In float64 the unsmoothed P and R hold float64 units (the JAX package's
  T is float32), and every coarse operator is bit for bit the Galerkin
  product over the float32 units.
* On the card only (``card``): the library's compiled aggregation gives
  :func:`repro_torch.precond.amg.aggregate`'s array bit for bit on the 3D
  stencil and on a seeded random graph Laplacian.
* Set-up's SpGEMM merge: ``spgemm_merge``'s plain version is the host
  coalesce's ``np.add.reduceat``; on the card (``card``) the kernel gives
  its sums bit for bit (runs of 1 to 5,000 terms, signed zeros, f32 and
  f64), and the cuda space's ``spgemm`` / ``sptranspose`` give the torch
  space's CSR bit for bit.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import kernels as K
from repro_torch.core import make_executor
from repro_torch.observability import metrics
from repro_torch.precond import Multigrid, amg, make_preconditioner
from repro_torch.solvers import CgSolver, Stop
from repro_torch.sparse import formats as F
from repro_torch.sparse import gallery, ops

ROOT = Path(__file__).resolve().parent.parent
PGM = dict(smooth_prolongator=False, cycle="v", pre_sweeps=1, post_sweeps=1,
           max_levels=10, coarse_size=64, theta=0.08, coarse_solver="dense")


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _matrix(name):
    if name == "poisson_3d":
        ip, ix, v, shape = gallery.poisson_3d(16)
    else:
        ip, ix, v, shape = gallery.anisotropic_2d(48, 0.01)
    return np.asarray(ip), np.asarray(ix), np.asarray(v, np.float64), shape


def _gauges():
    return {(s["name"], s["labels"].get("level")): s["value"]
            for s in metrics.samples() if s["kind"] == "gauge"
            and s["name"].startswith("amg_")}


def _same(a, b):
    return a.shape == b.shape and torch.equal(a, b)


def _same_csr(a, b):
    return (tuple(a.shape) == tuple(b.shape) and _same(a.indptr, b.indptr)
            and _same(a.indices, b.indices) and _same(a.values, b.values))


def _same_ell(a, b):
    return (tuple(a.shape) == tuple(b.shape) and _same(a.col_idx, b.col_idx)
            and _same(a.values, b.values))


@pytest.mark.parametrize("space", ["torch", "reference"])
@pytest.mark.parametrize("smooth", [False, True])
@pytest.mark.parametrize("name", ["poisson_3d", "anisotropic_2d"])
def test_amg_from_ell_equals_amg_from_csr(name, smooth, space):
    ip, ix, v, shape = _matrix(name)
    A_csr = F.csr_from_arrays(ip, ix, v, shape, device="cpu")
    A_ell = F.ell_from_csr_host(ip, ix, v, shape, device="cpu")
    opts = dict(PGM, smooth_prolongator=smooth)
    built = []
    for A in (A_csr, A_ell):
        metrics.reset()
        M = make_preconditioner(A, "amg", executor=make_executor(space), **opts)
        built.append((M, _gauges()))
    metrics.reset()
    (Mc, gc), (Me, ge) = built
    assert isinstance(Me, Multigrid) and Me.num_levels == Mc.num_levels >= 3
    assert ge == gc and Me.operator_complexity == Mc.operator_complexity
    assert Me.levels[0].A is A_ell and Me.levels[0].A_op is A_ell
    for k, (Lc, Le) in enumerate(zip(Mc.levels, Me.levels)):
        if k:
            assert _same_csr(Lc.A, Le.A)
        assert _same_csr(Lc.P, Le.P) and _same_csr(Lc.R, Le.R)
        for f in ("A_op", "P_op", "R_op"):
            assert _same_ell(getattr(Lc, f), getattr(Le, f)), (k, f)
        assert _same(Lc.inv_diag, Le.inv_diag)
    assert _same_csr(Mc.coarse_A, Me.coarse_A)
    assert _same(Mc._coarse_inv, Me._coarse_inv)
    g = torch.Generator().manual_seed(5)
    for _ in range(3):
        r = torch.randn(shape[0], dtype=torch.float64, generator=g)
        assert torch.equal(Mc.apply(r), Me.apply(r))


def test_small_ell_operand_is_solved_by_the_coarse_inverse():
    """An ELL operand at or below ``coarse_size`` rows is not coarsened: the
    dense coarse solve takes its entries as a CSR."""
    ip, ix, v, shape = gallery.poisson_3d(3)
    v = np.asarray(v, np.float64)
    A_ell = F.ell_from_csr_host(ip, ix, v, shape, device="cpu")
    M = make_preconditioner(A_ell, "amg", executor=make_executor("torch"), **PGM)
    assert M.num_levels == 1 and isinstance(M.coarse_A, F.Csr)
    assert _same_csr(M.coarse_A, F.csr_from_arrays(ip, ix, v, shape, device="cpu"))
    assert M.operator_complexity == 1.0


def test_pgm_transfer_is_the_unit_prolongator_and_its_transpose():
    ip, ix, v, shape = _matrix("poisson_3d")
    A = F.csr_from_arrays(ip, ix, v, shape, device="cpu")
    M = Multigrid(A, executor=make_executor("torch"), **PGM)
    ref = make_executor("reference")
    for L in M.levels:
        p = ops.to_dense(L.P, executor=ref).numpy()
        assert p.dtype == np.float64
        np.testing.assert_array_equal(p.sum(axis=1), 1.0)
        np.testing.assert_array_equal(ops.to_dense(L.R, executor=ref).numpy(), p.T)
    # T^T A T, exactly: the stencil's entries are whole numbers
    L = M.levels[0]
    a = ops.to_dense(L.A, executor=ref).numpy()
    p = ops.to_dense(L.P, executor=ref).numpy()
    c = ops.to_dense(M.levels[1].A, executor=ref).numpy()
    np.testing.assert_array_equal(c, p.T @ a @ p)


@pytest.mark.parametrize("space", ["torch", "reference"])
def test_f64_unit_transfer_gives_the_float32_units_coarse_operators(space):
    """In float64 the unsmoothed P and R hold their units in A's dtype where
    the JAX package keeps T in float32: a unit is exact in both, so every
    coarse operator is bit for bit the Galerkin product over the float32
    units, on a matrix whose values are not whole numbers."""
    ip, ix, v, shape = _matrix("anisotropic_2d")
    A = F.csr_from_arrays(ip, ix, v, shape, device="cpu")
    ex = make_executor(space)
    M = Multigrid(A, executor=ex, **dict(PGM, coarse_size=8))
    assert len(M.levels) >= 2
    for k, L in enumerate(M.levels):
        assert L.P.values.dtype == L.R.values.dtype == torch.float64
        agg = L.P.indices.numpy()
        T32 = amg.tentative_prolongator(agg, L.P.shape[1], device="cpu")
        assert T32.values.dtype == torch.float32
        assert _same(T32.indptr.long(), L.P.indptr.long())
        assert _same(T32.values.double(), L.P.values)
        want = ops.spgemm(ops.sptranspose(T32, executor=ex),
                          ops.spgemm(L.A, T32, executor=ex), executor=ex)
        got = M.levels[k + 1].A if k + 1 < len(M.levels) else M.coarse_A
        assert got.values.dtype == torch.float64
        assert _same_csr(got, want), k


def _reference(name):
    """``portbench/reference/<name>.py``, loaded as the benchmark loads it."""
    from portbench import spec
    return spec.load_module(ROOT / "portbench" / "reference" / f"{name}.py", "test")


@pytest.mark.parametrize("name", ["poisson_3d", "anisotropic_2d"])
def test_pgm_agrees_with_the_plain_reference(name):
    ip, ix, v, shape = _matrix(name)
    n = shape[0]
    A = F.ell_from_csr_host(ip, ix, v, shape, device="cpu")
    ex = make_executor("torch")
    M = make_preconditioner(A, "amg", executor=ex, **PGM)
    R = _reference("amg").build((ip, ix, v, shape), PGM, working=torch.float64,
                                  compute_dtype=torch.float64, device="cpu")
    assert [L.A.shape[0] for L in M.levels] == [L.n for L, _, _ in R.levels]
    for Lp, (Lr, _, _) in zip(M.levels, R.levels):
        assert torch.equal(Lp.P.indices.long(), Lr.agg)
    g = torch.Generator().manual_seed(11)
    for _ in range(3):
        r = torch.randn(n, dtype=torch.float64, generator=g)
        a, b = M.apply(r), R.apply(r)
        assert float((a - b).norm()) <= 1e-13 * float(b.norm())

    # CG: the port's fused solver against the reference's, iterate for iterate
    A_ref = _reference("csr").build((ip, ix, v, shape), dtype=torch.float64,
                                    device="cpu")
    stop = {"max_iters": 500, "reduction_factor": 1e-6}
    solver = CgSolver(A, stop=Stop(**stop), M=M, executor=ex, fused=True)
    for seed in (1, 2):
        b = torch.randn(n, dtype=torch.float64,
                        generator=torch.Generator().manual_seed(seed))
        res = solver.solve(b)
        ref = _reference("cg").solve(A_ref.apply, R.apply, b, stop,
                                    dtype=torch.float64, keep_at=res.iterations)
        assert res.converged and ref.converged
        assert res.iterations == ref.iterations
        err = float((res.x - ref.x_kept).norm() / ref.x_kept.norm())
        assert err <= 1e-10, err


def _random_laplacian(n, m, seed):
    rng = np.random.default_rng(seed)
    e = rng.integers(0, n, (m, 2))
    e = e[e[:, 0] != e[:, 1]]
    w = rng.random(e.shape[0])
    rows = np.concatenate([e[:, 0], e[:, 1], np.arange(n)])
    cols = np.concatenate([e[:, 1], e[:, 0], np.arange(n)])
    deg = np.bincount(e[:, 0], w, n) + np.bincount(e[:, 1], w, n)
    vals = np.concatenate([-w, -w, deg + 0.01])
    order = np.lexsort((cols, rows))
    rows, cols, vals = rows[order], cols[order], vals[order]
    key = rows * n + cols
    head = np.ones(key.size, bool)
    head[1:] = key[1:] != key[:-1]
    starts = np.flatnonzero(head)
    vals = np.add.reduceat(vals, starts)
    rows, cols = rows[starts], cols[starts]
    ip = np.zeros(n + 1, np.int64)
    ip[1:] = np.cumsum(np.bincount(rows, minlength=n))
    return ip, cols, vals


@pytest.mark.card
def test_compiled_aggregation_equals_python():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the compiled passes live in the port's "
                    "CUDA library, built with nvcc")
    from portbench.generators import poisson3d_7pt
    from repro_torch.kernels.amg_aggregate import aggregate_compiled

    ip, ix, v, shape = poisson3d_7pt.generate({"n_side": 48}, device="cpu")
    cases = [(ip, ix, v, shape[0], 0.08)]
    for seed, theta in ((1, 0.08), (2, 0.25)):
        lip, lix, lv = _random_laplacian(20000, 80000, seed)
        cases.append((lip, lix, lv, 20000, theta))
    for ip, ix, v, n, theta in cases:
        strong = amg.strength_mask(ip, ix, v, theta)
        want, n_want = amg.aggregate(ip, ix, strong, n)
        got, n_got = aggregate_compiled(ip, ix, strong, n)
        assert n_got == n_want and 1 <= n_got < n
        np.testing.assert_array_equal(got, want)


# -- spgemm_merge -------------------------------------------------------------------


def _runs(seed, dtype):
    """Values in runs of 1 to 5,000 terms (numpy's pairwise sum splits past
    128 and 8-wide blocks from 8), a fifth of them -0.0, one run all -0.0."""
    rng = np.random.default_rng(seed)
    lens = np.concatenate([rng.integers(1, 12, 400), [7, 8, 9, 128, 129, 130,
                                                      131, 257, 1000, 5000]])
    rng.shuffle(lens)
    n = int(lens.sum())
    v = (rng.standard_normal(n) * 10.0 ** rng.integers(-6, 6, n)).astype(dtype)
    v[rng.random(n) < 0.2] = -0.0
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int64)
    v[starts[3]:starts[4]] = -0.0
    return v, starts


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_spgemm_merge_plain_is_reduceat(dtype):
    v, starts = _runs(1, dtype)
    before = K.spgemm_merge.launches
    got = K.spgemm_merge(torch.from_numpy(v), torch.from_numpy(starts))
    assert K.spgemm_merge.launches == before
    want = np.add.reduceat(v, starts)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (np.signbit(got.numpy()) == np.signbit(want)).all()
    assert K.spgemm_merge(torch.ones(0), torch.zeros(0, dtype=torch.int64)).numel() == 0
    with pytest.raises(ValueError, match="int64"):
        K.spgemm_merge(torch.ones(3), torch.zeros(1, dtype=torch.int32))


@pytest.mark.card
def test_spgemm_merge_kernel_and_cuda_space_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are built with nvcc and run "
                    "there only")
    for seed, dtype in ((2, np.float32), (3, np.float64)):
        v, starts = _runs(seed, dtype)
        got = K.spgemm_merge(torch.from_numpy(v).cuda(),
                             torch.from_numpy(starts).cuda()).cpu().numpy()
        want = np.add.reduceat(v, starts)
        np.testing.assert_array_equal(got, want)
        assert (np.signbit(got) == np.signbit(want)).all()
    ex_c, ex_t = make_executor("cuda"), make_executor("torch", device="cuda")
    for seed in range(3):
        rng = np.random.default_rng(seed)
        a, b = (np.where(rng.random(shape) < density,
                         rng.standard_normal(shape), 0.0)
                for shape, density in (((300, 200), 0.05), ((200, 250), 0.3)))
        A, B = (F.csr_from_dense(x, device="cuda") for x in (a, b))
        for C, Ct in ((ops.spgemm(A, B, executor=ex_c),
                       ops.spgemm(A, B, executor=ex_t)),
                      (ops.sptranspose(A, executor=ex_c),
                       ops.sptranspose(A, executor=ex_t))):
            for f in ("indptr", "indices", "values"):
                assert torch.equal(getattr(C, f), getattr(Ct, f))
