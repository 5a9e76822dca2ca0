"""Whole runs of small cells on the CPU, each with the timed path broken
underneath (the look for a card skipped, the torch kernel space in the
cuda space's place): ``correct`` comes out false for each fault a cell can
have, and true with none."""

import dataclasses

import pytest
import torch

from portbench import harness, small, spec
from repro_torch.sparse import formats, ops
from repro_torch.solvers import krylov

CELLS = [w["name"] for w in spec.load()["workloads"]]


def run(cell, root=spec.ROOT):
    return harness.run_cell(cell, 2 ** 31 + 99, 0.2, False, root=root, device="cpu",
                            executor="torch",
                            overrides=small.overrides(cell, root))["result"]


# Each fault takes the monkeypatch and the cell's configuration, and breaks
# the timed path underneath.

def state_unchanged(mp, config):
    """Every axpy returns its input y: x never moves from x0."""
    mp.setattr(ops, "axpy", lambda alpha, x, y, *, executor=None: y)


def half_rows_left_out(mp, config):
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


def answer_altered(mp, config):
    """The solve's answer is altered where it is produced: x[0] + 1."""
    real = krylov.KrylovSolver.solve

    def solve(self, b, x0=None, *, executor=None):
        res = real(self, b, x0, executor=executor)
        x = res.x.clone()
        x[0] += 1
        return dataclasses.replace(res, x=x)
    mp.setattr(krylov.KrylovSolver, "solve", solve)


def format_wrong(mp, config):
    """The format conversion the configuration names stores row 0's first
    entry one too large (its diagonal in the stencils and Laplacians here:
    the columns ascend and row 0 has none below the diagonal)."""
    fn = config["program"]["format"]["fn"]
    real_resolve = harness.resolve

    def resolve(dotted):
        real = real_resolve(dotted)
        if dotted != fn:
            return real

        def wrong(indptr, indices, values, shape, *args, **kw):
            values = values.copy()
            values[0] += 1
            return real(indptr, indices, values, shape, *args, **kw)
        return wrong
    mp.setattr(harness, "resolve", resolve)


def preconditioner_wrong(mp, config):
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


def run_under(cell, fault, mp, root=spec.ROOT):
    """A run of ``cell`` with ``fault`` underneath (patched through ``mp``)."""
    fault(mp, harness.load_cell(cell, root)["config"])
    return run(cell, root)


def assert_caught(res):
    assert res["correct"] is False, res["checks"]
    assert res["failed"] >= 1


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    assert run(cell)["correct"] is True


@pytest.mark.parametrize("fault", FAULTS, ids=lambda f: f.__name__)
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_not_correct(monkeypatch, cell, fault):
    assert_caught(run_under(cell, fault, monkeypatch))
