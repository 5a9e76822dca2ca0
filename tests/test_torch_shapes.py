"""The port's shape cells and the API names it shares with the JAX package:
``ShapeConfig`` / ``SHAPES`` / ``cells``, the top-level ``sparse`` functions,
``registered_spaces`` and ``all_operations``."""

import dataclasses

import pytest
import torch

from repro import configs as jax_configs
from repro_torch import configs

#: the packages whose imports register every operation, in both packages
PACKAGES = ("sparse", "kernels", "precond", "solvers", "batch", "nn",
            "distributed", "serve", "models")

#: the JAX package's kernel spaces under the port's names
SPACE = {"reference": "reference", "xla": "torch", "pallas": "cuda"}


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def test_shapes_equal_the_jax_package_field_for_field():
    assert list(configs.SHAPES) == list(jax_configs.SHAPES)
    for name, shape in configs.SHAPES.items():
        assert dataclasses.asdict(shape) == \
            dataclasses.asdict(jax_configs.SHAPES[name])
    assert [f.name for f in dataclasses.fields(configs.ShapeConfig)] == \
        [f.name for f in dataclasses.fields(jax_configs.ShapeConfig)]
    with pytest.raises(dataclasses.FrozenInstanceError):
        configs.SHAPES["train_4k"].seq_len = 1


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_cells_equal_the_jax_package(arch):
    assert configs.cells(arch) == jax_configs.cells(arch)
    assert configs.cells(arch.replace("_", "-")) == configs.cells(arch)
    long_ok = configs.get_config(arch).supports_long_context
    assert ("long_500k" in configs.cells(arch)) == long_ok


@pytest.mark.parametrize("name", ["apply", "dot", "axpy", "scal", "norm2",
                                  "spgemm", "sptranspose", "to_dense"])
def test_sparse_top_level_names(name):
    from repro import sparse as jax_sparse
    from repro_torch import sparse
    from repro_torch.sparse import ops

    assert getattr(sparse, name) is getattr(ops, name)
    assert name in sparse.__all__ and name in jax_sparse.__all__


#: every package of the JAX package with an ``__all__``, and the names of
#: it the port leaves out on purpose: the TPU's Pallas and XLA executors
#: and the hardware tables of targets the port does not run on
ALL_LEFT_OUT = {
    "batch": set(), "checkpoint": set(), "configs": set(),
    "core": {"PallasTpuExecutor", "PallasInterpretExecutor", "XlaExecutor",
             "TPU_V4", "TPU_V5E", "CPU_INTERPRET", "CPU_XLA"},
    "data": set(), "distributed": set(), "kernels": set(),
    "models": set(), "nn": set(), "observability": set(), "optim": set(),
    "precond": set(), "runtime": set(), "serve": set(), "solvers": set(),
    "sparse": set(),
}


@pytest.mark.parametrize("pkg", sorted(ALL_LEFT_OUT))
def test_public_names_match_the_jax_package(pkg):
    """Each package's ``__all__`` holds its JAX counterpart's names, but for
    those left out on purpose, and every name it lists resolves."""
    import importlib

    jax_mod = importlib.import_module(f"repro.{pkg}")
    mod = importlib.import_module(f"repro_torch.{pkg}")
    names = set(getattr(mod, "__all__", ()))
    left_out = ALL_LEFT_OUT[pkg]
    assert set(jax_mod.__all__) - names == left_out
    assert not left_out & names
    for name in names:
        assert hasattr(mod, name) or importlib.util.find_spec(
            f"{mod.__name__}.{name}") is not None, name


def test_block_jacobi_preconditioner_and_linear_operator_shim():
    """``block_jacobi_preconditioner`` takes the executor's subgroup width
    when ``block_size`` is None and reports storage; the deprecated
    ``LinearOperator`` warns and applies its operand."""
    import numpy as np

    from repro_torch import sparse
    from repro_torch.core import make_executor
    from repro_torch.solvers import (LinearOperator,
                                     block_jacobi_preconditioner)

    rng = np.random.default_rng(1)
    a = rng.normal(size=(20, 20)).astype(np.float32) + 8 * np.eye(20, dtype=np.float32)
    A = sparse.csr_from_dense(a, device="cpu")
    ex = make_executor("torch")
    M = block_jacobi_preconditioner(A, executor=ex)
    assert M.block_size == ex.hw.subgroup_size == 8
    assert M.precision_counts == (("float32", 3),)
    assert M.storage_bytes == 3 * 8 * 8 * 4
    M16 = block_jacobi_preconditioner(A, 4, ex, adaptive="float16", tau=0.5)
    assert M16.precision_counts == (("float16", 5),)
    x = torch.from_numpy(rng.normal(size=20).astype(np.float32))
    with pytest.warns(DeprecationWarning, match="LinearOperator is deprecated"):
        op = LinearOperator(A, executor=ex)
    assert op.shape == (20, 20)
    np.testing.assert_allclose(op.apply(x).numpy(), a @ x.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_sparse_top_level_functions_compute():
    import numpy as np

    from repro_torch import sparse
    from repro_torch.core import make_executor

    rng = np.random.default_rng(0)
    a = np.where(rng.random((12, 9)) < 0.3, rng.normal(size=(12, 9)),
                 0.0).astype(np.float32)
    A = sparse.csr_from_dense(a, device="cpu")
    x = torch.from_numpy(rng.normal(size=9).astype(np.float32))
    ex = make_executor("torch")
    y = sparse.apply(A, x, executor=ex)
    np.testing.assert_allclose(y.numpy(), a @ x.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(sparse.to_dense(A, executor=ex).numpy(), a,
                               rtol=0, atol=0)
    assert float(sparse.dot(y, y, executor=ex)) == pytest.approx(
        float(sparse.norm2(y, executor=ex)) ** 2, rel=1e-5)
    assert torch.equal(sparse.axpy(2.0, y, y, executor=ex),
                       sparse.scal(3.0, y, executor=ex))
    At = sparse.sptranspose(A, executor=ex)
    np.testing.assert_allclose(sparse.to_dense(At, executor=ex).numpy(), a.T,
                               atol=0)
    AtA = sparse.spgemm(At, A, executor=ex)
    np.testing.assert_allclose(sparse.to_dense(AtA, executor=ex).numpy(),
                               a.T @ a, rtol=1e-5,
                               atol=1e-5)


_REGISTRIES = """
import importlib, json, sys
out = {}
for prefix in ("repro", "repro_torch"):
    for pkg in sys.argv[1:]:
        importlib.import_module(f"{prefix}.{pkg}")
    registry = importlib.import_module(f"{prefix}.core.registry")
    out[prefix] = {name: list(registry.registered_spaces(name))
                   for name in registry.all_operations()}
print(json.dumps(out))
"""


def _registries():
    """Each package's operations and their spaces, from a fresh process (a
    test may register an operation of its own in this one)."""
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root / "src"), JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", _REGISTRIES, *PACKAGES],
                       env=env, capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, r.stderr[-2000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    return out["repro"], out["repro_torch"]


def test_registry_names_exist_in_core():
    from repro_torch import core
    from repro_torch.core import registry

    assert core.registered_spaces is registry.registered_spaces
    assert core.all_operations is registry.all_operations
    ops = core.all_operations()
    assert ops["spmv_ell"] is registry.operation("spmv_ell")
    assert core.registered_spaces("spmv_ell") == ("cuda", "reference", "torch")
    ops.clear()  # a copy
    assert "spmv_ell" in core.all_operations()
    with pytest.raises(KeyError):
        core.registered_spaces("no_such_operation")


def test_operation_names_and_spaces_agree_with_the_jax_package():
    """The same operations in both packages; every one's kernel spaces the
    JAX package's under the port's names (xla -> torch, pallas -> cuda).
    One op has a space more in the port: ``sparse_to_dense``'s torch space
    (the JAX package's xla executor reaches its reference one)."""
    jax_ops, ops = _registries()
    assert sorted(ops) == sorted(jax_ops)
    for name, spaces in jax_ops.items():
        want = tuple(sorted(SPACE[sp] for sp in spaces))
        got = tuple(ops[name])
        if name == "sparse_to_dense":
            assert set(want) < set(got) == {"reference", "torch"}
        else:
            assert got == want, name
