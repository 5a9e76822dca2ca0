"""Whole runs of small cells on the CPU, each with the timed path broken
underneath (the look for a card skipped, the torch kernel space in the
cuda space's place): ``correct`` comes out false for each fault a cell can
have, and true with none."""

import dataclasses

import pytest
import torch

from portbench import harness
from repro_torch.sparse import formats, ops
from repro_torch.solvers import krylov

SMALL = {
    "p3d256-bjcg-f32": {"config": {"problem": {"params": {"n_side": 12}}, "sizes": None}},
    "p3d256-bjcg-f64": {"config": {"problem": {"params": {"n_side": 12}}, "sizes": None}},
    "kron23-sellp-jcg-f32": {"config": {"problem": {"params": {"scale": 11}},
                                        "sizes": None}},
}


def run(cell):
    return harness.run_cell(cell, 2 ** 31 + 99, 0.2, False, device="cpu",
                            executor="torch", overrides=SMALL[cell])["result"]


def state_unchanged(mp):
    """Every axpy returns its input y: x never moves from x0."""
    mp.setattr(ops, "axpy", lambda alpha, x, y, *, executor=None: y)


def half_rows_left_out(mp):
    """The operator's apply leaves out the second half of the rows, and the
    fused dot is taken over the rest."""
    real_apply, real_spmv_dot = ops.apply, ops.spmv_dot

    def apply(A, x, *, executor=None):
        y = real_apply(A, x, executor=executor)
        if isinstance(A, formats.MatrixLinOp):
            y = y.clone()
            y[y.shape[0] // 2:] = 0
        return y

    def spmv_dot(A, x, w=None, *, executor=None):
        y, _ = real_spmv_dot(A, x, w, executor=executor)
        y = y.clone()
        y[y.shape[0] // 2:] = 0
        return y, torch.dot(x if w is None else w, y)
    mp.setattr(ops, "apply", apply)
    mp.setattr(ops, "spmv_dot", spmv_dot)


def answer_altered(mp):
    """The solve's answer is altered where it is produced: x[0] + 1."""
    real = krylov.KrylovSolver.solve

    def solve(self, b, x0=None, *, executor=None):
        res = real(self, b, x0, executor=executor)
        x = res.x.clone()
        x[0] += 1
        return dataclasses.replace(res, x=x)
    mp.setattr(krylov.KrylovSolver, "solve", solve)


def format_wrong(mp):
    """The format conversion stores row 0's diagonal one too large (its
    first entry: the columns ascend and row 0 has none below the diagonal)."""
    import repro_torch.sparse as sparse

    for name in ("ell_from_csr_host", "sellp_from_csr_host"):
        real = getattr(sparse, name)

        def wrong(indptr, indices, values, shape, *args, _real=real, **kw):
            values = values.copy()
            values[0] += 1
            return _real(indptr, indices, values, shape, *args, **kw)
        mp.setattr(sparse, name, wrong)


def preconditioner_wrong(mp):
    """The preconditioner the configuration names is swapped for a weaker
    one (block-Jacobi for scalar Jacobi, scalar Jacobi for none): the loop
    still converges, in other iterations and through other iterates."""
    import repro_torch.precond as precond

    real = precond.make_preconditioner

    def weaker(A, kind, *, executor=None, **opts):
        if kind == "block_jacobi":
            return real(A, "jacobi", executor=executor)
        return real(A, "identity", executor=executor)
    mp.setattr(precond, "make_preconditioner", weaker)


FAULTS = [state_unchanged, half_rows_left_out, answer_altered, format_wrong,
          preconditioner_wrong]


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_sound_run_is_correct(cell):
    assert run(cell)["correct"] is True


@pytest.mark.parametrize("fault", FAULTS, ids=lambda f: f.__name__)
@pytest.mark.parametrize("cell", sorted(SMALL))
def test_fault_is_not_correct(monkeypatch, cell, fault):
    fault(monkeypatch)
    res = run(cell)
    assert res["correct"] is False, res["checks"]
    assert res["failed"] >= 1
