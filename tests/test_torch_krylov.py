"""The port's Krylov set (pipelined CG, FCG, BiCGSTAB, CGS, GMRES and the
solver LinOps) against the JAX package's, and the main path's pins.

* ``spd_stencil_256`` (the JAX package's benchmark setup, copied: ``_spd(256)``
  as CSR, b from ``default_rng(2)``, ``Stop(500, 1e-6)``), counted through the
  port's torch-space dispatch log: 17 iterations unfused, fused and
  pipelined; a fused loop body of 2 launches against 7 unfused; one
  ``dot_batch`` of three dots an iteration in pipelined CG.
* The cases of the JAX package's ``test_krylov``, ``test_fused_parity``,
  ``test_gmres_nonsymmetric``, ``test_symmetry_guard`` and
  ``test_convergence_regression`` (the last shares ``test_torch_parilu_ir``'s
  ParILU rows): the iterations equal the JAX solve's (its ``xla`` space) and
  x agrees within 1e-4 relative (2-norm; 1e-3 for the nonsymmetric solvers,
  whose f32 recurrences amplify the dots' rounding more).  In the reference
  and torch spaces fused and unfused loops are bitwise equal.
* ``convdiff_48`` (the JAX package's nonsymmetric benchmark, b drawn in turn
  from ``default_rng(11)``, ``Stop(2000, 1e-6)``): GMRES takes 240 and 210
  iterations in both packages; on ``powerlaw_2048`` it stops unconverged at
  2010 (the reference's fault C3, reproduced, not fixed).  BiCGSTAB takes 71
  and 70 in the JAX package and 70 and 69 here: its residual history is
  erratic, so the last-bit difference of the f32 dots' summation order
  (torch's against XLA's; ‖b‖ already differs in its last bit) grows until
  the stopping test falls one iteration apart.  The test pins both counts.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import solvers as jsolvers
from repro import sparse as jsparse
from repro.core import make_executor as jax_make_executor
from repro.sparse import gallery as jgallery
from repro_torch.core import make_executor
from repro_torch.precond import block_jacobi
from repro_torch.solvers import (BicgstabSolver, CgSolver, CgsSolver,
                                 FcgSolver, GmresSolver, PipelinedCgSolver,
                                 Stop, bicgstab, cg, cgs, fcg, gmres,
                                 jacobi_preconditioner, probe_symmetry)
from repro_torch.sparse import formats as F
from repro_torch.sparse import gallery
from repro_torch.sparse import ops as blas

STOP = dict(max_iters=500, reduction_factor=1e-6)
#: iterations the port may differ from the JAX solve by on the regression
#: corpus: the f32 dots sum in another order (torch's, XLA's), and CG's and
#: BiCGSTAB's stopping iteration moves with that rounding on the longer
#: solves (powerlaw256: CG 92 against 93, BiCGSTAB 79 against 77); GMRES
#: counts whole cycles
ITER_SLACK = {"cg": 1, "fcg": 1, "bicgstab": 2, "cgs": 2, "gmres": 0}
#: x against the JAX solve, relative 2-norm
X_RTOL = 1e-4
X_RTOL_NONSYM = 1e-3


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _spd(n=96):
    """The JAX package benchmark's SPD stencil (``benchmarks/report.py``)."""
    a = np.zeros((n, n), np.float32)
    for i in range(n):
        a[i, i] = 4.0
        if i > 0:
            a[i, i - 1] = a[i - 1, i] = -1.0
        if i > 2:
            a[i, i - 3] = a[i - 3, i] = -0.5
    return a


def spd_system(n=96, rng=None):
    rng = rng or np.random.default_rng(3)
    a = _spd(n)
    x = rng.normal(size=n).astype(np.float32)
    return a, x, (a @ x).astype(np.float32)


def nonsym_system(n=96, rng=None):
    rng = rng or np.random.default_rng(4)
    a, x, _ = spd_system(n, rng)
    a = a + np.triu(rng.normal(size=(n, n)).astype(np.float32) * 0.05, 1)
    return a, x, (a @ x).astype(np.float32)


JAX_FN = {"cg": jsolvers.cg, "fcg": jsolvers.fcg, "bicgstab": jsolvers.bicgstab,
          "cgs": jsolvers.cgs, "gmres": jsolvers.gmres}
PORT_FN = {"cg": cg, "fcg": fcg, "bicgstab": bicgstab, "cgs": cgs,
           "gmres": gmres}
SYSTEMS = {"spd": spd_system, "nonsym": nonsym_system}


def _jax_solve(fn, A, b, **kw):
    res = JAX_FN[fn](A, jnp.asarray(b), executor=jax_make_executor("xla"), **kw)
    return int(res.iterations), np.asarray(res.x), bool(res.converged)


@functools.lru_cache(maxsize=None)
def _jax_system_solve(system, n, fn, fmt="csr", M=None, restart=None,
                      max_iters=500):
    a, _, b = SYSTEMS[system](n)
    A = getattr(jsparse, f"{fmt}_from_dense")(a)
    kw = {} if restart is None else {"restart": restart}
    if M == "jacobi":
        kw["M"] = jsolvers.jacobi_preconditioner(A)
    elif M is not None:
        kw["M"] = M
    return _jax_solve(fn, A, b, stop=jsolvers.Stop(max_iters, 1e-6), **kw)


def _port(a, fmt="csr"):
    return getattr(F, f"{fmt}_from_dense")(a, device="cpu")


def _close(x, x_ref, rtol):
    x = x.numpy() if isinstance(x, torch.Tensor) else x
    return np.linalg.norm(x - x_ref) <= rtol * np.linalg.norm(x_ref)


# -- the main path's pins: spd_stencil_256 ----------------------------------------


@functools.lru_cache(maxsize=None)
def _stencil():
    a = _spd(256)
    rng = np.random.default_rng(2)
    b = (a @ rng.normal(size=a.shape[0])).astype(np.float32)
    return a, b


VARIANTS = {"unfused": {"fused": False}, "fused": {"fused": True},
            "pipelined": {"pipeline": True}}


@functools.lru_cache(maxsize=None)
def _jax_stencil_iterations(variant):
    a, b = _stencil()
    res = jsolvers.cg(jsparse.csr_from_dense(a), jnp.asarray(b),
                      stop=jsolvers.Stop(500, 1e-6),
                      executor=jax_make_executor("xla"), **VARIANTS[variant])
    return int(res.iterations)


def _stencil_solve(variant, space="torch"):
    a, b = _stencil()
    ex = make_executor(space)
    res = cg(F.csr_from_dense(a, device="cpu"), torch.from_numpy(b),
             stop=Stop(500, 1e-6), executor=ex, **VARIANTS[variant])
    return res, dict(ex.dispatch_log)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_spd_stencil_256_cg_iterations(variant):
    res, _ = _stencil_solve(variant)
    assert res.converged
    assert res.iterations == 17 == _jax_stencil_iterations(variant)


def test_spd_stencil_256_body_launches():
    """The JAX benchmark's structural pins, from the port's dispatch log."""
    res, log = _stencil_solve("fused")
    k = res.iterations
    fused_body = (log["spmv_dot_csr"] + log["axpy_norm"]) / k
    assert fused_body == 2
    res_u, log = _stencil_solve("unfused")
    unfused_body = ((log["spmv_csr"] - 1) + (log["blas_dot"] - 1)
                    + (log["blas_norm2"] - 2) + log["blas_axpy"]) / res_u.iterations
    assert unfused_body == 7
    res_p, _ = _stencil_solve("pipelined")
    assert abs(res_p.iterations - res_u.iterations) == 0  # pipelined_iter_delta
    assert res.iterations == res_u.iterations  # fused_unfused_iters_equal


def test_pipelined_cg_one_dot_batch_an_iteration():
    """Pipelined CG: before the loop A twice, M once and one dot_batch of 3;
    an iteration applies A once, 8 axpys and one dot_batch of 3 dots, and
    no standalone dot or norm (the stop norm is sqrt of the batched r·r)."""
    res, log = _stencil_solve("pipelined")
    k = res.iterations
    assert log == {"blas_norm2": 1, "spmv_csr": k + 2, "blas_dot": 3 * (k + 1),
                   "blas_axpy": 8 * k}
    calls = []
    orig = blas.dot_batch

    def spy(pairs, **kw):
        calls.append(len(pairs))
        return orig(pairs, **kw)

    blas.dot_batch = spy
    try:
        again, _ = _stencil_solve("pipelined")
    finally:
        blas.dot_batch = orig
    assert calls == [3] * (k + 1)
    assert torch.equal(again.x, res.x)


def test_dot_batch_stacks_dots():
    rng = np.random.default_rng(0)
    x, y, z = (torch.from_numpy(rng.standard_normal(50).astype(np.float32))
               for _ in range(3))
    ex = make_executor("torch")
    d = blas.dot_batch([(x, y), (y, z), (z, z)], executor=ex)
    assert d.shape == (3,) and d.dtype == torch.float32
    assert torch.equal(d, torch.stack([torch.dot(x, y), torch.dot(y, z),
                                       torch.dot(z, z)]))
    assert ex.dispatch_log["blas_dot"] == 3


# -- parity with the JAX package: test_krylov ---------------------------------------


@pytest.mark.parametrize("fmt", ["csr", "ell", "sellp", "coo"])
@pytest.mark.parametrize("fn", ["cg", "fcg"])
def test_spd_solvers_all_formats_match_jax(fn, fmt):
    a, xstar, b = spd_system()
    k_j, x_j, conv_j = _jax_system_solve("spd", 96, fn, fmt)
    for space in ("reference", "torch"):
        res = PORT_FN[fn](_port(a, fmt), torch.from_numpy(b), stop=Stop(**STOP),
                          executor=make_executor(space))
        assert conv_j and res.converged
        assert res.iterations == k_j, (space, res.iterations, k_j)
        assert _close(res.x, x_j, X_RTOL)
        np.testing.assert_allclose(res.x.numpy(), xstar, atol=1e-3)


@pytest.mark.parametrize("case", ["bicgstab", "gmres", "cgs", "cgs_jacobi"])
def test_nonsymmetric_solvers_match_jax(case):
    fn, _, M = case.partition("_")
    a, xstar, b = nonsym_system()
    k_j, x_j, conv_j = _jax_system_solve("nonsym", 96, fn, M=M or None)
    A = _port(a)
    res = PORT_FN[fn](A, torch.from_numpy(b), stop=Stop(**STOP),
                      M=jacobi_preconditioner(A, make_executor("torch"))
                      if M else None,
                      executor=make_executor("torch"))
    assert conv_j and res.converged
    assert res.iterations == k_j
    assert _close(res.x, x_j, X_RTOL_NONSYM)
    np.testing.assert_allclose(res.x.numpy(), xstar, atol=5e-2)


@pytest.mark.parametrize("n,m", [(64, 5), (64, 10), (64, 20), (96, 4)])
def test_gmres_restarts_match_jax(n, m):
    """Restart lengths; at m = 4 the system needs many cycles, and the count
    is whole cycles of m."""
    a, xstar, b = nonsym_system(n)
    k_j, x_j, conv_j = _jax_system_solve("nonsym", n, "gmres", restart=m,
                                         max_iters=400)
    res = gmres(_port(a), torch.from_numpy(b), restart=m,
                stop=Stop(400, 1e-6), executor=make_executor("torch"))
    assert conv_j and res.converged
    assert res.iterations == k_j and res.iterations % m == 0
    assert _close(res.x, x_j, X_RTOL_NONSYM)
    if n == 96:
        assert res.iterations > m
        np.testing.assert_allclose(res.x.numpy(), xstar, atol=5e-2)


def test_stop_criterion_max_iters_and_history():
    a, _, b = spd_system(48)
    A, bt = _port(a), torch.from_numpy(b)
    ex = make_executor("torch")
    for fn in (fcg, bicgstab, cgs):
        res = fn(A, bt, stop=Stop(2, 1e-12), executor=ex, history=True)
        assert res.iterations == 2 and not res.converged
        assert res.history.shape == (2,) and bool(torch.isfinite(res.history).all())
    res = cg(A, bt, stop=Stop(2, 1e-12), executor=ex, pipeline=True)
    assert res.iterations == 2 and not res.converged
    res = gmres(A, bt, restart=5, stop=Stop(12, 1e-12), executor=ex, history=True)
    # counts whole cycles, one history slot a cycle
    assert res.iterations == 15 and res.history.shape == (12,)
    assert bool(torch.isfinite(res.history[:3]).all())
    assert bool(torch.isnan(res.history[3:]).all())


# -- parity with the JAX package: test_fused_parity -----------------------------------


def _fused_system(n=80, density=0.08, seed=0):
    rng = np.random.default_rng(seed)
    d = rng.standard_normal((n, n)) * (rng.random((n, n)) < density)
    s = (d @ d.T + n * np.eye(n)).astype(np.float32)
    return s, rng.standard_normal(n).astype(np.float32)


def _bicgstab_system():
    rng = np.random.default_rng(7)
    n = 70
    a = rng.standard_normal((n, n)) * (rng.random((n, n)) < 0.1)
    a = (a + n * np.eye(n)).astype(np.float32)
    return a, rng.standard_normal(n).astype(np.float32)


@pytest.mark.parametrize("fmt", ["csr", "ell"])
@pytest.mark.parametrize("space", ["reference", "torch"])
def test_bicgstab_fused_unfused_bitwise(space, fmt):
    """Fused BiCGSTAB takes ``spmv_dot`` with w = r̂ and w = s and
    ``axpy_norm``; in these spaces they are the literal composition, so the
    fused and unfused loops agree bit for bit; both match the JAX solve."""
    a, b = _bicgstab_system()
    A, bt = _port(a, fmt), torch.from_numpy(b)
    ex = make_executor(space)
    st = Stop(500, 1e-8)
    on = bicgstab(A, bt, stop=st, executor=ex, fused=True)
    log_on = dict(ex.dispatch_log)
    ex.dispatch_log.clear()
    off = bicgstab(A, bt, stop=st, executor=ex, fused=False)
    assert on.converged and on.iterations == off.iterations
    assert torch.equal(on.x, off.x)
    assert torch.equal(on.residual_norm, off.residual_norm)
    k = on.iterations
    assert log_on[f"spmv_dot_{fmt}"] == 2 * k and log_on["axpy_norm"] == k
    k_j, x_j, _ = _jax_solve("bicgstab", jsparse.csr_from_dense(a), b,
                             stop=jsolvers.Stop(500, 1e-8))
    assert k == k_j and _close(on.x, x_j, X_RTOL_NONSYM)


@pytest.mark.parametrize("M", [None, "jacobi", "block_jacobi"])
def test_bicgstab_fused_unfused_bitwise_preconditioned(M):
    a, b = _bicgstab_system()
    A, bt = _port(a, "ell"), torch.from_numpy(b)
    ex = make_executor("torch")
    on = bicgstab(A, bt, M=M, stop=Stop(500, 1e-8), executor=ex, fused=True)
    off = bicgstab(A, bt, M=M, stop=Stop(500, 1e-8), executor=ex, fused=False)
    assert on.converged and on.iterations == off.iterations
    assert torch.equal(on.x, off.x)


def test_pipelined_cg_matches_classic_and_jax():
    """Pipelining reassociates the recurrences: within 2 iterations of
    classic CG, the solution at solver tolerance; the iterations equal the
    JAX package's pipelined solve."""
    s, b = _fused_system(seed=11)
    A, bt = _port(s), torch.from_numpy(b)
    ex = make_executor("torch")
    classic = cg(A, bt, stop=Stop(500, 1e-6), executor=ex, fused=False)
    piped = cg(A, bt, stop=Stop(500, 1e-6), executor=ex, pipeline=True)
    assert piped.converged
    assert abs(piped.iterations - classic.iterations) <= 2
    xd = np.linalg.solve(s.astype(np.float64), b.astype(np.float64))
    np.testing.assert_allclose(piped.x.numpy().astype(np.float64), xd,
                               rtol=1e-4, atol=1e-4)
    k_j, x_j, _ = _jax_solve("cg", jsparse.csr_from_dense(s), b,
                             stop=jsolvers.Stop(500, 1e-6), pipeline=True)
    assert piped.iterations == k_j and _close(piped.x, x_j, X_RTOL)
    ref = cg(A, bt, stop=Stop(500, 1e-6), executor=make_executor("reference"),
             pipeline=True)
    assert ref.iterations == k_j and _close(ref.x, x_j, X_RTOL)


def test_pipelined_cg_solver_linop():
    s, b = _fused_system(seed=13)
    A, bt = _port(s), torch.from_numpy(b)
    ex = make_executor("torch")
    solver = PipelinedCgSolver(A, stop=Stop(500, 1e-6), executor=ex)
    res = solver.solve(bt)
    assert res.converged
    assert torch.equal(solver.apply(bt), res.x)
    assert torch.equal(cg(A, bt, stop=Stop(500, 1e-6), executor=ex,
                          pipeline=True).x, res.x)


@pytest.mark.parametrize("cls,fn,kw", [
    (CgSolver, cg, {}), (FcgSolver, fcg, {}), (BicgstabSolver, bicgstab, {}),
    (CgsSolver, cgs, {}), (GmresSolver, gmres, {"restart": 10})])
def test_solver_linops_equal_their_functions(cls, fn, kw):
    """Each factory LinOp solves as its function does, with a string
    preconditioner resolved once at generation."""
    s, b = _fused_system(seed=3)
    A, bt = _port(s), torch.from_numpy(b)
    ex = make_executor("torch")
    solver = cls(A, M="block_jacobi", precond_opts={"block_size": 4},
                 stop=Stop(**STOP), executor=ex, **kw)
    direct = fn(A, bt, M=block_jacobi(A, 4, executor=ex), stop=Stop(**STOP),
                executor=ex, **kw)
    got = solver.solve(bt)
    assert got.converged and got.iterations == direct.iterations
    assert torch.equal(got.x, direct.x) and torch.equal(solver.apply(bt), got.x)
    assert solver.shape == A.shape and solver.dtype == torch.float32


def test_distributed_operands_are_refused():
    """A distributed operand goes to ``dist_solve`` (the distributed layer's
    own cases are in ``test_torch_distributed.py``); one whose partition
    needs more ranks than this process's world is refused there."""
    from repro_torch.core import LinOp
    from repro_torch.distributed import Partition

    class Dist(LinOp):
        is_distributed = True
        shape = (4, 4)
        dtype = torch.float32
        partition = Partition.uniform(4, 2)
        rank = 0

    for fn in (cg, fcg, bicgstab, cgs, gmres):
        with pytest.raises(ValueError, match="world"):
            fn(Dist(), torch.ones(4))
    with pytest.raises(ValueError, match="world"):
        BicgstabSolver(Dist()).solve(torch.ones(4))


# -- parity with the JAX package: test_gmres_nonsymmetric ---------------------------

GMRES_REGIMES = {"diffusive_pe0p1": (0.1, "centered"),
                 "balanced_pe1": (1.0, "upwind"),
                 "advective_pe10": (10.0, "upwind")}
#: (regime, restart) -> the JAX package's recorded iterations (jax 0.4.37)
GMRES_RECORDED = {
    ("diffusive_pe0p1", 5): 125, ("diffusive_pe0p1", 10): 80,
    ("diffusive_pe0p1", 40): 80, ("balanced_pe1", 5): 55,
    ("balanced_pe1", 10): 70, ("balanced_pe1", 40): 80,
    ("advective_pe10", 5): 60, ("advective_pe10", 10): 90,
    ("advective_pe10", 40): 40,
}


@functools.lru_cache(maxsize=None)
def _convdiff16(regime):
    peclet, scheme = GMRES_REGIMES[regime]
    host = gallery.convection_diffusion_2d(16, peclet=peclet, scheme=scheme)
    ip, ix, v, shape = host
    a = np.zeros(shape, np.float32)
    a[np.repeat(np.arange(shape[0]), np.diff(ip)), ix] = v
    b = np.random.default_rng(0).normal(size=shape[0]).astype(np.float32)
    return a, host, b


@pytest.mark.parametrize("regime,restart", sorted(GMRES_RECORDED))
def test_gmres_regimes_match_jax(regime, restart):
    a, (ip, ix, v, shape), b = _convdiff16(regime)
    k_j, x_j, conv_j = _jax_solve(
        "gmres", jsparse.csr_from_arrays(ip, ix, v, shape), b,
        stop=jsolvers.Stop(1000, 1e-6), restart=restart)
    res = gmres(F.csr_from_arrays(ip, ix, v, shape, device="cpu"),
                torch.from_numpy(b), restart=restart, stop=Stop(1000, 1e-6),
                executor=make_executor("torch"))
    assert conv_j and res.converged
    assert res.iterations == k_j
    assert res.iterations <= int(np.ceil(GMRES_RECORDED[(regime, restart)] * 1.15))
    assert _close(res.x, x_j, X_RTOL_NONSYM)
    rel = np.linalg.norm(b - a @ res.x.numpy()) / np.linalg.norm(b)
    assert rel <= 1e-4


# -- parity with the JAX package: test_symmetry_guard --------------------------------

NONSYM10 = gallery.convection_diffusion_2d(10, peclet=5.0)
SPD10 = gallery.poisson_2d(10)


def _csr(host):
    return F.csr_from_arrays(*host, device="cpu")


def test_probe_classifies_gallery_matrices():
    from repro.solvers.common import probe_symmetry as jax_probe

    assert probe_symmetry(_csr(NONSYM10)) is False
    assert probe_symmetry(_csr(SPD10)) is True
    assert jax_probe(jsparse.csr_from_arrays(*NONSYM10)) is False


@pytest.mark.parametrize("fn", [cg, fcg])
def test_cg_family_raises_on_convection_diffusion(fn):
    B = torch.ones(100)
    with pytest.raises(ValueError, match="symmetry probe"):
        fn(_csr(NONSYM10), B)
    with pytest.raises(ValueError, match="gmres, bicgstab, or cgs"):
        fn(_csr(NONSYM10), B)
    res = fn(_csr(NONSYM10), B, strict=False, executor=make_executor("torch"))
    assert res.x.shape == B.shape  # runs; the result's quality is not claimed


@pytest.mark.parametrize("cls", [CgSolver, PipelinedCgSolver, FcgSolver])
def test_factories_raise_at_generation_time(cls):
    with pytest.raises(ValueError, match="symmetry probe"):
        cls(_csr(NONSYM10))
    cls(_csr(NONSYM10), strict=False)
    cls(_csr(SPD10))


@pytest.mark.parametrize("cls", [BicgstabSolver, GmresSolver])
def test_nonsym_solvers_accept_nonsymmetric_operands(cls):
    res = cls(_csr(NONSYM10), executor=make_executor("torch")).solve(
        torch.ones(100))
    assert res.converged


def test_probe_leaves_no_dispatch_footprint():
    ex = make_executor("torch")
    A = _csr(SPD10)
    CgSolver(A, executor=ex)
    PipelinedCgSolver(A, executor=ex)
    assert sum(ex.dispatch_log.values()) == 0


# -- parity with the JAX package: test_convergence_regression -------------------------

#: (solver, preconditioner) -> the JAX package's recorded iterations
SPD_RECORDED = {("cg", "identity"): 17, ("cg", "jacobi"): 17,
                ("cg", "block_jacobi"): 12, ("cg", "adaptive_bj"): 12,
                ("fcg", "identity"): 17, ("fcg", "jacobi"): 17,
                ("fcg", "block_jacobi"): 12, ("fcg", "adaptive_bj"): 12}
NONSYM_RECORDED = {
    ("bicgstab", "identity"): 11, ("bicgstab", "jacobi"): 11,
    ("bicgstab", "block_jacobi"): 8, ("bicgstab", "adaptive_bj"): 8,
    ("cgs", "identity"): 10, ("cgs", "jacobi"): 10,
    ("cgs", "block_jacobi"): 7, ("cgs", "adaptive_bj"): 7,
    ("gmres", "identity"): 30, ("gmres", "jacobi"): 30,
    ("gmres", "block_jacobi"): 30, ("gmres", "adaptive_bj"): 30,
}


def _preconditioners(name, Aj, At):
    """The same preconditioner for the JAX and the port operand."""
    from repro.solvers import block_jacobi_preconditioner as jbj

    if name == "identity":
        return None, None
    ex = make_executor("torch")
    if name == "jacobi":
        return jsolvers.jacobi_preconditioner(Aj), jacobi_preconditioner(At, ex)
    adaptive = name == "adaptive_bj"
    return (jbj(Aj, block_size=4, adaptive=adaptive),
            block_jacobi(At, 4, adaptive=adaptive, executor=ex))


@pytest.mark.parametrize("solver,precond",
                         sorted(SPD_RECORDED) + sorted(NONSYM_RECORDED))
def test_convergence_regression_matches_jax(solver, precond):
    system = "spd" if (solver, precond) in SPD_RECORDED else "nonsym"
    recorded = {**SPD_RECORDED, **NONSYM_RECORDED}[(solver, precond)]
    a, xstar, b = SYSTEMS[system]()
    Aj, At = jsparse.csr_from_dense(a), _port(a)
    Mj, Mt = _preconditioners(precond, Aj, At)
    k_j, x_j, conv_j = _jax_solve(solver, Aj, b, stop=jsolvers.Stop(**STOP),
                                  M=Mj)
    res = PORT_FN[solver](At, torch.from_numpy(b), stop=Stop(**STOP), M=Mt,
                          executor=make_executor("torch"))
    assert conv_j and res.converged
    assert abs(res.iterations - k_j) <= ITER_SLACK[solver], (res.iterations, k_j)
    assert k_j <= int(np.ceil(recorded * 1.15))
    rtol = X_RTOL if system == "spd" else X_RTOL_NONSYM
    assert _close(res.x, x_j, rtol)
    np.testing.assert_allclose(res.x.numpy(), xstar,
                               atol=2e-3 if system == "spd" else 5e-2)


#: (solver, gallery matrix) -> the JAX package's recorded iterations
GALLERY_RECORDED = {
    ("gmres", "convdiff16_pe0p5"): 60, ("gmres", "convdiff16_pe2"): 60,
    ("gmres", "convdiff16_pe10"): 60, ("bicgstab", "convdiff16_pe0p5"): 25,
    ("bicgstab", "convdiff16_pe2"): 28, ("bicgstab", "convdiff16_pe10"): 23,
    ("bicgstab", "powerlaw256"): 67, ("cg", "powerlaw256"): 93,
}
GALLERY = {
    "convdiff16_pe0p5": lambda g: g.convection_diffusion_2d(16, peclet=0.5,
                                                            scheme="centered"),
    "convdiff16_pe2": lambda g: g.convection_diffusion_2d(16, peclet=2.0,
                                                          scheme="upwind"),
    "convdiff16_pe10": lambda g: g.convection_diffusion_2d(16, peclet=10.0,
                                                           scheme="upwind"),
    "powerlaw256": lambda g: g.power_law_laplacian(256, seed=4),
}


@pytest.mark.parametrize("solver,matrix", sorted(GALLERY_RECORDED))
def test_gallery_convergence_regression_matches_jax(solver, matrix):
    ip, ix, v, shape = GALLERY[matrix](gallery)
    a = np.zeros(shape, np.float32)
    a[np.repeat(np.arange(shape[0]), np.diff(ip)), ix] = v
    b = np.random.default_rng(0).normal(size=shape[0]).astype(np.float32)
    k_j, x_j, conv_j = _jax_solve(
        solver, jsparse.csr_from_arrays(*GALLERY[matrix](jgallery)), b,
        stop=jsolvers.Stop(**STOP))
    res = PORT_FN[solver](F.csr_from_arrays(ip, ix, v, shape, device="cpu"),
                          torch.from_numpy(b), stop=Stop(**STOP),
                          executor=make_executor("torch"))
    assert conv_j and res.converged
    assert abs(res.iterations - k_j) <= ITER_SLACK[solver], (res.iterations, k_j)
    assert k_j <= int(np.ceil(GALLERY_RECORDED[(solver, matrix)] * 1.15))
    assert _close(res.x, x_j, X_RTOL_NONSYM)
    rel = np.linalg.norm(b - a @ res.x.numpy()) / np.linalg.norm(b)
    assert rel <= 1e-4


# -- the JAX package benchmark's nonsymmetric pins, and C3 ---------------------------

#: matrix -> (GMRES, the JAX package's BiCGSTAB, the port's BiCGSTAB)
NONSYM_PINS = {"convdiff_48_pe0p5": (240, 71, 70), "convdiff_48_pe5": (210, 70, 69)}


@functools.lru_cache(maxsize=None)
def _nonsym_suite():
    """The benchmark's suite and right-hand sides: one default_rng(11) draws
    each matrix's b in turn."""
    rng = np.random.default_rng(11)
    out = {}
    for name, build in (
        ("convdiff_48_pe0p5",
         lambda g: g.convection_diffusion_2d(48, peclet=0.5, scheme="centered")),
        ("convdiff_48_pe5",
         lambda g: g.convection_diffusion_2d(48, peclet=5.0, scheme="upwind")),
        ("powerlaw_2048", lambda g: g.power_law_laplacian(2048, seed=4)),
    ):
        host = build(gallery)
        out[name] = (host, rng.normal(size=host[3][0]).astype(np.float32),
                     build)
    return out


@pytest.mark.parametrize("solver", ["gmres", "bicgstab"])
@pytest.mark.parametrize("matrix", sorted(NONSYM_PINS))
def test_convdiff_48_iteration_pins(matrix, solver):
    host, b, build = _nonsym_suite()[matrix]
    k_j, x_j, conv_j = _jax_solve(solver, jsparse.csr_from_arrays(*build(jgallery)),
                                  b, stop=jsolvers.Stop(2000, 1e-6))
    res = PORT_FN[solver](F.csr_from_arrays(*host, device="cpu"),
                          torch.from_numpy(b), stop=Stop(2000, 1e-6),
                          executor=make_executor("torch"))
    gm, bi_jax, bi_port = NONSYM_PINS[matrix]
    assert conv_j and res.converged
    if solver == "gmres":
        assert res.iterations == k_j == gm
    else:
        assert (k_j, res.iterations) == (bi_jax, bi_port)
    assert _close(res.x, x_j, X_RTOL_NONSYM)


def test_gmres_powerlaw_2048_stops_unconverged():
    """Fault C3 of the reference, reproduced at its full size and cap:
    GMRES(30) on powerlaw_2048 stops at 2010 iterations unconverged in both
    packages, while BiCGSTAB converges."""
    host, b, build = _nonsym_suite()["powerlaw_2048"]
    Aj = jsparse.csr_from_arrays(*build(jgallery))
    k_j, _, conv_j = _jax_solve("gmres", Aj, b, stop=jsolvers.Stop(2000, 1e-6))
    A = F.csr_from_arrays(*host, device="cpu")
    ex = make_executor("torch")
    res = gmres(A, torch.from_numpy(b), stop=Stop(2000, 1e-6), executor=ex)
    assert (res.iterations, res.converged) == (k_j, conv_j) == (2010, False)
    assert bool(torch.isfinite(res.x).all())
    assert bicgstab(A, torch.from_numpy(b), stop=Stop(2000, 1e-6),
                    executor=ex).converged
