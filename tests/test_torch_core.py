"""The port's core seam: imports, executors, registry, LinOps, telemetry.

* ``repro_torch`` and every module of the slice import neither JAX nor the
  JAX package (checked in a fresh interpreter).
* The default executor is the CUDA one, and without a card it raises.
* Strict mode raises ``NotCompiledError``; the ``cuda`` space's four kernel
  ops resolve to ``cuda`` and raise on CPU tensors instead of falling back.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import kernels as K
from repro_torch.core import (
    Composition,
    CudaExecutor,
    Identity,
    NotCompiledError,
    ReferenceExecutor,
    ScaledIdentity,
    Sum,
    TorchExecutor,
    as_linop,
    default_executor,
    make_executor,
    registry,
    reset_default_executor,
)
from repro_torch.observability import convergence, metrics, trace
from repro_torch.precond import block_jacobi
from repro_torch.sparse import formats as F
from repro_torch.sparse import gallery
from repro_torch.sparse import ops as blas

SRC = Path(__file__).resolve().parents[1] / "src"
SLICE_MODULES = [
    "repro_torch",
    "repro_torch.batch",
    "repro_torch.batch.formats",
    "repro_torch.batch.linop",
    "repro_torch.batch.ops",
    "repro_torch.batch.solvers",
    "repro_torch.configs",
    "repro_torch.configs.base",
    "repro_torch.configs.rwkv6_3b",
    "repro_torch.configs.zamba2_2_7b",
    "repro_torch.convert",
    "repro_torch.core.executor",
    "repro_torch.core.linop",
    "repro_torch.core.params",
    "repro_torch.core.registry",
    "repro_torch.core.tuning",
    "repro_torch.kernels",
    "repro_torch.kernels._build",
    "repro_torch.kernels._workspace",
    "repro_torch.kernels.axpy_norm.ops",
    "repro_torch.kernels.block_jacobi.ops",
    "repro_torch.kernels.ell_norm_probe",
    "repro_torch.kernels.flash_attention.kernel",
    "repro_torch.kernels.flash_attention.ops",
    "repro_torch.kernels.loader_check",
    "repro_torch.kernels.rmsnorm.kernel",
    "repro_torch.kernels.rmsnorm.ops",
    "repro_torch.kernels.rwkv6.kernel",
    "repro_torch.kernels.rwkv6.ops",
    "repro_torch.kernels.rwkv6.ref",
    "repro_torch.kernels.sellp_probe",
    "repro_torch.kernels.spgemm.kernel",
    "repro_torch.kernels.spgemm.ops",
    "repro_torch.kernels.spmv_batch_ell.kernel",
    "repro_torch.kernels.spmv_batch_ell.ops",
    "repro_torch.kernels.spmv_dot.ops",
    "repro_torch.kernels.spmv_ell.ops",
    "repro_torch.kernels.spmv_sellp.kernel",
    "repro_torch.kernels.spmv_sellp.ops",
    "repro_torch.kernels.ssd.kernel",
    "repro_torch.kernels.ssd.ops",
    "repro_torch.kernels.ssd.ref",
    "repro_torch.launch",
    "repro_torch.launch.amg_check",
    "repro_torch.launch.batch_solve",
    "repro_torch.launch.serve",
    "repro_torch.launch.steps",
    "repro_torch.models",
    "repro_torch.models.lm",
    "repro_torch.nn",
    "repro_torch.nn.attention",
    "repro_torch.nn.common",
    "repro_torch.nn.layers",
    "repro_torch.nn.mamba",
    "repro_torch.nn.rwkv",
    "repro_torch.observability.convergence",
    "repro_torch.observability.events",
    "repro_torch.observability.metrics",
    "repro_torch.observability.trace",
    "repro_torch.precond",
    "repro_torch.precond.amg",
    "repro_torch.precond.block_jacobi",
    "repro_torch.solvers",
    "repro_torch.solvers.common",
    "repro_torch.solvers.krylov",
    "repro_torch.sparse",
    "repro_torch.sparse.formats",
    "repro_torch.sparse.gallery",
    "repro_torch.sparse.ops",
]


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _ell(n_side=6):
    ip, ix, v, shape = gallery.poisson_2d(n_side)
    return F.ell_from_csr_host(ip, ix, v, shape, device="cpu")


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import importlib, sys\n"
        f"for m in {SLICE_MODULES!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(SRC))
    r = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "clean"


def test_default_executor_is_cuda_and_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    reset_default_executor()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        default_executor()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        blas.dot(torch.ones(3), torch.ones(3))  # no ambient executor: the card


def test_make_executor_kinds_and_targets():
    assert isinstance(make_executor("reference"), ReferenceExecutor)
    assert isinstance(make_executor("torch"), TorchExecutor)
    ex = make_executor("cuda")
    assert isinstance(ex, CudaExecutor) and ex.device.type == "cuda"
    assert ex.spaces == ("cuda", "torch", "reference")
    assert make_executor("h100").hw.smem_per_block_bytes == 232_448
    assert isinstance(make_executor("cpu_torch"), TorchExecutor)
    assert make_executor("torch").device == torch.device("cpu")
    with pytest.raises(KeyError):
        make_executor("tpu_v5e")


def test_strict_mode_raises_not_compiled():
    x = torch.ones(4)
    with pytest.raises(NotCompiledError):
        blas.dot(x, x, executor=make_executor("cuda", strict=True))
    assert float(blas.dot(x, x, executor=make_executor("torch", strict=True))) == 4.0
    assert not registry.operation("blas_dot").supports(
        make_executor("cuda", strict=True))


def test_cuda_space_resolves_kernels_and_refuses_cpu_tensors():
    ex = make_executor("cuda")
    for name in ("spmv_ell", "spmv_dot_ell", "axpy_norm", "block_jacobi_apply"):
        assert registry.operation(name).space_used(ex) == "cuda"
    for name in ("blas_dot", "blas_axpy", "blas_norm2", "spmv_csr", "spmv_dot_csr"):
        assert registry.operation(name).space_used(ex) == "torch"
    A = _ell()
    x = torch.ones(A.shape[0])
    P = block_jacobi(A, 8)
    before = K.launch_counts()
    with pytest.raises(ValueError, match="cuda kernel space"):
        blas.apply(A, x, executor=ex)
    with pytest.raises(ValueError, match="cuda kernel space"):
        blas.spmv_dot(A, x, executor=ex)
    with pytest.raises(ValueError, match="cuda kernel space"):
        blas.axpy_norm(torch.tensor(1.0), x, x, executor=ex)
    with pytest.raises(ValueError, match="cuda kernel space"):
        P.apply(x, executor=ex)
    assert K.launch_counts() == before
    assert blas.has_fused_ops(A, executor=ex)


def test_fused_capability_probe():
    A = _ell()
    C = F.csr_from_dense(np.eye(4, dtype=np.float32), device="cpu")
    for kind in ("reference", "torch", "cuda"):
        assert blas.has_fused_ops(A, executor=make_executor(kind))
        assert blas.has_fused_ops(C, executor=make_executor(kind))
    assert not blas.has_fused_ops(as_linop(lambda v: v), executor=make_executor("torch"))
    strict = make_executor("cuda", strict=True)
    assert blas.has_fused_ops(A, executor=strict)  # ELL: both ops have kernels
    assert not blas.has_fused_ops(C, executor=strict)  # CSR: no cuda kernel


def test_linop_combinators_and_executor_threading():
    A = _ell(4)
    n = A.shape[0]
    dense = torch.zeros(n, n)
    ip, ix, v = F.csr_host_arrays(A)
    dense[np.repeat(np.arange(n), np.diff(ip)), ix] = torch.from_numpy(v)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(n).astype(np.float32))
    ex, other = make_executor("torch"), make_executor("reference")
    shifted = Sum(A, ScaledIdentity(0.5, n), executor=other)
    torch.testing.assert_close(shifted.apply(x, executor=ex), dense @ x + 0.5 * x)
    assert ex.dispatch_log["spmv_ell"] == 1 and other.dispatch_log["spmv_ell"] == 0
    shifted.apply(x)  # the operator's own executor governs its subtree
    assert other.dispatch_log["spmv_ell"] == 1
    comp = Composition(A, A)
    torch.testing.assert_close(comp.apply(x, executor=ex), dense @ (dense @ x))
    torch.testing.assert_close(A.apply(2.0, x, 3.0, x, executor=ex), 2 * (dense @ x) + 3 * x)
    assert Identity().apply(x) is x
    with pytest.raises(ValueError):
        Composition(A, ScaledIdentity(1.0, n + 1))


def test_tracing_records_dispatch_events():
    class Tracer:
        def __init__(self):
            self.spans = []

        def rel_us(self, t):
            return 0.0

        def complete(self, name, ts, dur, cat, args):
            self.spans.append((name, cat, args["space"]))

    tr = Tracer()
    ex = make_executor("torch")
    trace.set_tracer(tr)
    try:
        blas.dot(torch.ones(3), torch.ones(3), executor=ex)
    finally:
        trace.set_tracer(None)
    assert not trace.TRACING
    assert tr.spans == [("blas_dot", "dispatch", "torch")]
    (ev,) = ex.dispatch_events
    assert (ev.op, ev.space, ev.target) == ("blas_dot", "torch", "cpu_torch")
    ex.dispatch_log.clear()
    assert not ex.dispatch_log and not ex.dispatch_events


def test_convergence_ring_buffer_wraps():
    hist = convergence.init(3)
    for k in range(5):
        convergence.push(hist, k, float(k))
    assert hist.tolist() == [3.0, 4.0, 2.0]
    assert convergence.finalize(convergence.init(0)) is None
    np.testing.assert_array_equal(convergence.trim(hist, 2), [3.0, 4.0])
    with pytest.raises(ValueError):
        convergence.capacity(-1, None)


def test_metrics_registry_series():
    reg = metrics.MetricsRegistry()
    reg.counter("solves", space="cuda").inc()
    reg.counter("solves", space="cuda").inc(2)
    with pytest.raises(ValueError):
        reg.counter("solves", space="cuda").inc(-1)
    reg.gauge("rows", level=0).set(256)
    h = reg.histogram("wall_s")
    for v in (0.3, 3.0, 3.5):
        h.observe(v)
    with pytest.raises(TypeError, match="already registered"):
        reg.gauge("solves", space="cuda")
    got = {(r["name"], tuple(r["labels"].items())): r for r in reg.samples()}
    assert got[("solves", (("space", "cuda"),))]["value"] == 3.0
    assert got[("rows", (("level", "0"),))]["value"] == 256.0
    hist = got[("wall_s", ())]
    assert hist["count"] == 3 and hist["min"] == 0.3 and hist["max"] == 3.5
    assert hist["buckets"] == {"0.5": 1, "4": 2}
    reg.reset()
    assert reg.samples() == []
