"""The port's distributed layer (``repro_torch.distributed`` over
``torch.distributed``) against the JAX package's.

* Host arrays, exactly: ``Partition`` (uniform, ragged, an empty part) —
  ``pad_index`` / ``unpad_index`` / ``pad_mask`` / ``padded_index`` and
  ``pad`` / ``unpad`` — ``split_by_rows``, the stacked ``DistCsr`` /
  ``DistEll`` arrays and halo maps, ``csr_slice_rows_host``, and the
  launcher's system (``launch/dist_solve.build_system``).
* Two spawned gloo worlds, P = 2 and a ragged P = 4 (101 rows), each running
  every case once (:func:`repro_torch.distributed.cases.run_cases`): SpMV of
  ``DistCsr`` / ``DistEll`` (also with an empty part); dot and norm with the
  padding poisoned; CG in f32 and f64 (iterations within 1 of the JAX
  package's single-device solve, f64 x within rtol 1e-10, as
  ``tests/distributed/test_dist_parity.py``); Jacobi and block-Jacobi;
  BiCGSTAB and GMRES on ``convection_diffusion_2d``; pipelined CG with one
  reduction collective an iteration (classic CG three); ``history`` equal
  to the single-device history; ``shard_batch``; a repeated solve bit for
  bit and every rank holding the same x.  A world of one in this process
  against the JAX package's ``dist_solve`` at one part.
* The JAX package's 4-part values from one subprocess with 4 forced host
  devices (the ``run_with_devices`` pattern of ``tests/distributed``),
  started first and read last.

Worlds meet at a ``file://`` rendezvous under ``tmp_path``, with a 60 s
collective timeout, and a world that has not returned in 180 s fails.  In
the tier-1 run the JAX package is locked to one device, so its multi-part
values come only from the subprocess; its f64 values come from
``jax.enable_x64(True)`` (the JAX tests' ``jax.experimental.enable_x64`` is
gone from the installed jax).
"""

import dataclasses
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import distributed as jdist
from repro import sparse as jsparse
from repro.batch import solvers as jbatch_solvers
from repro.launch import batch_solve as jbatch_solve
from repro.launch import dist_solve as jdist_solve
from repro.observability import convergence as jconvergence
from repro.solvers import krylov as jkrylov
from repro.solvers.common import Stop as JStop
from repro.sparse.formats import csr_slice_rows_host as jax_slice_rows
from repro_torch import convert
from repro_torch.distributed import (
    DistCsr,
    DistEll,
    Partition,
    comm,
    split_by_rows,
    stacked_host_arrays,
)
from repro_torch.distributed.cases import run_cases
from repro_torch.distributed.sharding import shard_pad_mask, zero_shard_padding
from repro_torch.launch import dist_solve
from repro_torch.observability import convergence
from repro_torch.sparse import csr_slice_rows_host
from repro_torch.sparse.gallery import convection_diffusion_2d

REPO_SRC = os.path.join(os.path.dirname(__file__), "..", "src")
N = 101  # prime: ragged under every multi-part count
WORLD_TIMEOUT_S = 60.0
JOIN_TIMEOUT_S = 180.0
STOP_CG = (500, 1e-6)
STOP_F64 = (500, 1e-12)
STOP_NONSYM = (500, 1e-6)


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# -- the fixtures of tests/distributed -------------------------------------------


def _sparse_pattern(n=N, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(n, n)).astype(dtype)
    a[rng.random((n, n)) > 0.15] = 0.0
    a[np.arange(n), np.arange(n)] = 6.0
    return a


def _spd_system(n=96, dtype=np.float32):
    """The convergence-regression SPD fixture of ``test_dist_parity``."""
    rng = np.random.default_rng(3)
    a = np.zeros((n, n), dtype)
    for i in range(n):
        a[i, i] = 4.0
        if i > 0:
            a[i, i - 1] = a[i - 1, i] = -1.0
        if i > 2:
            a[i, i - 3] = a[i - 3, i] = -0.5
    x = rng.normal(size=n).astype(dtype)
    return a, x, (a @ x).astype(dtype)


def _host(a):
    """The host CSR triplet of a dense matrix (row-major nonzeros, as the
    JAX package's ``csr_from_dense``), in ``a``'s dtype."""
    r, c = np.nonzero(a)
    indptr = np.concatenate([[0], np.cumsum(np.bincount(r, minlength=len(a)))])
    return indptr, c.astype(np.int64), a[r, c]


def _nonsym():
    ip, ix, v, shape = convection_diffusion_2d(16, peclet=2.0)
    b = np.random.default_rng(1).normal(size=shape[0]).astype(np.float32)
    return (ip, ix, v), shape, b


def _sizes(P, n=N):
    return list(Partition.uniform(n, P).part_sizes)


def _empty_sizes(P, n=N):
    return list(Partition.uniform(n, P - 1).part_sizes) + [0]


# -- the cases every world runs -----------------------------------------------------


def _cases(P):
    a = _sparse_pattern()
    x = np.random.default_rng(1).normal(size=N).astype(np.float32)
    a101, xs101, b101 = _spd_system(N)
    a96, xs96, b96 = _spd_system(96)
    a96d, _, b96d = _spd_system(96, np.float64)
    ns_host, _, ns_b = _nonsym()
    rng = np.random.default_rng(5)
    bx, by = rng.normal(size=N).astype(np.float32), rng.normal(size=N).astype(np.float32)
    cases = {}
    for fmt in ("csr", "ell"):
        cases[f"spmv_{fmt}"] = dict(op="spmv", fmt=fmt, host=_host(a),
                                    sizes=_sizes(P), x=x)
        cases[f"spmv_empty_{fmt}"] = dict(op="spmv", fmt=fmt, host=_host(a),
                                          sizes=_empty_sizes(P), x=x)
        cases[f"cg_f32_{fmt}"] = dict(op="solve", solver="cg", fmt=fmt,
                                      host=_host(a101), sizes=_sizes(P), b=b101,
                                      stop=STOP_CG, repeat=True)
        cases[f"cg_f64_{fmt}"] = dict(op="solve", solver="cg", fmt=fmt,
                                      host=_host(a96d), sizes=_sizes(P, 96),
                                      b=b96d, stop=STOP_F64)
    cases["cg_empty"] = dict(op="solve", solver="cg", fmt="csr",
                             host=_host(a101), sizes=_empty_sizes(P), b=b101,
                             stop=STOP_CG)
    cases["blas"] = dict(op="blas", sizes=_sizes(P), x=bx, y=by, poison=None)
    cases["blas_poison"] = dict(op="blas", sizes=_sizes(P), x=bx, y=bx,
                                poison=1e9)
    for kind, opts in (("jacobi", None), ("block_jacobi", {"block_size": 4})):
        cases[f"cg_{kind}"] = dict(op="solve", solver="cg", fmt="csr",
                                   host=_host(a96), sizes=_sizes(P, 96), b=b96,
                                   stop=(300, 1e-6), M=kind, precond_opts=opts)
        cases[f"apply_{kind}"] = dict(op="precond", kind=kind, fmt="csr",
                                      host=_host(a96), sizes=_sizes(P, 96),
                                      v=b96, precond_opts=opts)
    cases["pipelined"] = dict(op="solve", solver="cg", fmt="csr",
                              host=_host(a101), sizes=_sizes(P), b=b101,
                              stop=STOP_CG, options={"pipeline": True})
    cases["pipelined_ell"] = dict(cases["pipelined"], fmt="ell")
    cases["classic_unfused"] = dict(op="solve", solver="cg", fmt="csr",
                                    host=_host(a101), sizes=_sizes(P), b=b101,
                                    stop=STOP_CG, options={"fused": False})
    cases["classic_bj"] = dict(op="solve", solver="cg", fmt="ell",
                               host=_host(a96), sizes=_sizes(P, 96), b=b96,
                               stop=(300, 1e-6), M="block_jacobi",
                               precond_opts={"block_size": 4})
    for opt in ("classic", "pipelined"):
        cases[f"history_{opt}"] = dict(
            op="solve", solver="cg", fmt="csr", host=_host(a101),
            sizes=_sizes(P), b=b101, stop=(300, 1e-6),
            options={"history": True, "pipeline": opt == "pipelined"})
    for solver in ("bicgstab", "gmres", "cgs", "fcg"):
        host, b = (_host(a101), b101) if solver == "fcg" else (ns_host, ns_b)
        cases[solver] = dict(op="solve", solver=solver, fmt="csr", host=host,
                             sizes=_sizes(P, len(b)), b=b, stop=STOP_NONSYM)
    cases["shard_batch"] = dict(op="shard_batch", nb=10, n=24, fmt="ell",
                                stop=(500, 1e-6))
    return cases


# -- the JAX package's values: in process (one device) and a 4-device subprocess ----

_JAX_SCRIPT = """
import sys
import numpy as np
import jax
import jax.numpy as jnp
from repro import sparse
from repro.distributed import (DistCsr, DistEll, DistVector, Partition,
                               dist_dot, dist_norm2, dist_preconditioner)
from repro.observability import convergence
from repro.solvers import krylov
from repro.solvers.common import Stop
assert len(jax.devices()) == 4, jax.devices()
P = 4
data = dict(np.load(sys.argv[1], allow_pickle=True))
out = {}

def part(n, empty=False):
    if empty:
        return Partition.from_part_sizes(
            list(Partition.uniform(n, P - 1).part_sizes) + [0])
    return Partition.uniform(n, P)

def csr(key):
    return sparse.csr_from_dense(data[key])

stop = Stop(max_iters=500, reduction_factor=1e-6)
A101 = csr("a101")
for fmt, cls in (("csr", DistCsr), ("ell", DistEll)):
    r = krylov.cg(cls.from_matrix(A101, part(101)), jnp.asarray(data["b101"]),
                  stop=stop)
    out[f"cg_f32_{fmt}"] = np.asarray(r.x)
    out[f"cg_f32_{fmt}_k"] = int(r.iterations)
    r = krylov.cg(DistCsr.from_matrix(A101, part(101)),
                  jnp.asarray(data["b101"]), stop=stop, pipeline=True)
    out["pipelined_k"] = int(r.iterations)
    out["pipelined"] = np.asarray(r.x)
r = krylov.cg(DistCsr.from_matrix(A101, part(101)), jnp.asarray(data["b101"]),
              stop=Stop(max_iters=300, reduction_factor=1e-6), history=True)
out["history"] = np.asarray(convergence.trim(r.history))
A96 = csr("a96")
Ad96 = DistCsr.from_matrix(A96, part(96))
for kind, opts in (("jacobi", {}), ("block_jacobi", {"block_size": 4})):
    r = krylov.cg(Ad96, jnp.asarray(data["b96"]),
                  stop=Stop(max_iters=300, reduction_factor=1e-6), M=kind,
                  precond_opts=opts or None)
    out[f"cg_{kind}"] = np.asarray(r.x)
    out[f"cg_{kind}_k"] = int(r.iterations)
    M = dist_preconditioner(Ad96, kind, **opts)
    out[f"apply_{kind}"] = np.asarray(M.apply(jnp.asarray(data["b96"])))
An = sparse.csr_from_arrays(data["ns_ip"], data["ns_ix"], data["ns_v"],
                            tuple(data["ns_shape"]))
And = DistCsr.from_matrix(An, part(An.shape[0]))
for solver in ("bicgstab", "gmres"):
    r = getattr(krylov, solver)(And, jnp.asarray(data["ns_b"]), stop=stop)
    out[solver] = np.asarray(r.x)
    out[f"{solver}_k"] = int(r.iterations)
xv = DistVector.from_global(jnp.asarray(data["bx"]), part(101))
yv = DistVector.from_global(jnp.asarray(data["by"]), part(101))
out["dot"] = float(dist_dot(xv, yv))
out["norm"] = float(dist_norm2(xv))
with jax.enable_x64(True):
    Ad = DistCsr.from_matrix(sparse.csr_from_dense(data["a96d"]), part(96))
    r = krylov.cg(Ad, jnp.asarray(data["b96d"]),
                  stop=Stop(max_iters=500, reduction_factor=1e-12))
    out["cg_f64"] = np.asarray(r.x)
    out["cg_f64_k"] = int(r.iterations)
np.savez(sys.argv[2], **out)
print("OK")
"""


def _start_jax_4(tmp):
    a101, _, b101 = _spd_system(N)
    a96, _, b96 = _spd_system(96)
    a96d, _, b96d = _spd_system(96, np.float64)
    ns_host, ns_shape, ns_b = _nonsym()
    rng = np.random.default_rng(5)
    inp, outp = os.path.join(tmp, "jax_in.npz"), os.path.join(tmp, "jax_4.npz")
    np.savez(inp, a101=a101, b101=b101, a96=a96, b96=b96, a96d=a96d, b96d=b96d,
             ns_ip=ns_host[0], ns_ix=ns_host[1], ns_v=ns_host[2],
             ns_shape=np.asarray(ns_shape), ns_b=ns_b,
             bx=rng.normal(size=N).astype(np.float32),
             by=rng.normal(size=N).astype(np.float32))
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = REPO_SRC + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.Popen([sys.executable, "-c", textwrap.dedent(_JAX_SCRIPT),
                             inp, outp], env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    return proc, outp


def _jax_single():
    """The JAX package's single-device solves of every system (in process)."""
    out = {}
    stop = JStop(*STOP_CG)
    a101, _, b101 = _spd_system(N)
    A101 = jsparse.csr_from_dense(a101)
    for fmt, build in (("csr", jsparse.csr_from_dense), ("ell", jsparse.ell_from_dense)):
        r = jkrylov.cg(build(a101), jnp.asarray(b101), stop=stop)
        out[f"cg_f32_{fmt}"] = (np.asarray(r.x), int(r.iterations))
    r = jkrylov.cg(A101, jnp.asarray(b101), stop=stop, fused=False)
    out["unfused"] = (np.asarray(r.x), int(r.iterations))
    for opt in (False, True):
        r = jkrylov.cg(A101, jnp.asarray(b101), stop=JStop(300, 1e-6),
                       history=True, pipeline=opt)
        out[f"history_{'pipelined' if opt else 'classic'}"] = (
            np.asarray(jconvergence.trim(r.history)), int(r.iterations))
    ns_host, shape, ns_b = _nonsym()
    An = jsparse.csr_from_arrays(*ns_host, shape)
    for solver in ("bicgstab", "gmres", "cgs"):
        r = getattr(jkrylov, solver)(An, jnp.asarray(ns_b), stop=JStop(*STOP_NONSYM))
        out[solver] = (np.asarray(r.x), int(r.iterations))
    r = jkrylov.fcg(A101, jnp.asarray(b101), stop=JStop(*STOP_NONSYM))
    out["fcg"] = (np.asarray(r.x), int(r.iterations))
    with jax.enable_x64(True):
        a96d, _, b96d = _spd_system(96, np.float64)
        for fmt, build in (("csr", jsparse.csr_from_dense),
                           ("ell", jsparse.ell_from_dense)):
            r = jkrylov.cg(build(a96d), jnp.asarray(b96d), stop=JStop(*STOP_F64))
            out[f"cg_f64_{fmt}"] = (np.asarray(r.x), int(r.iterations),
                                    float(r.residual_norm))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every world's results, the JAX package's single-device and 4-part
    values; the JAX subprocess runs while the worlds do."""
    tmp = str(tmp_path_factory.mktemp("dist"))
    proc, jax_out = _start_jax_4(tmp)
    try:
        worlds = {}
        for P in (2, 4):
            names = list(_cases(P))
            res = comm.run_world(run_cases, P, ([_cases(P)[k] for k in names],),
                                 timeout_s=WORLD_TIMEOUT_S,
                                 join_timeout_s=JOIN_TIMEOUT_S, threads=1,
                                 rendezvous_dir=tmp)
            worlds[P] = {k: [r[i] for r in res] for i, k in enumerate(names)}
        single = _jax_single()
        stdout, stderr = proc.communicate(timeout=JOIN_TIMEOUT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, f"STDOUT:\n{stdout}\nSTDERR:\n{stderr}"
    return {"worlds": worlds, "single": single,
            "jax4": dict(np.load(jax_out, allow_pickle=True))}


def _same_on_every_rank(per_rank, key):
    first = per_rank[0][key]
    for r in per_rank[1:]:
        if isinstance(first, np.ndarray):
            assert np.array_equal(r[key], first, equal_nan=True), \
                f"rank {r['rank']}: {key}"
        else:
            assert r[key] == first, f"rank {r['rank']}: {key}"
    return first


# =============================================================================
# Host arrays, exactly
# =============================================================================


@pytest.mark.parametrize("sizes", [(101,), (51, 50), (26, 25, 25, 25),
                                   (34, 34, 33, 0), (0, 7, 3)])
def test_partition_maps_equal_jax(sizes):
    part = Partition.from_part_sizes(sizes)
    jpart = jdist.Partition.from_part_sizes(sizes)
    assert part.offsets == jpart.offsets
    assert part.max_part_size == jpart.max_part_size
    np.testing.assert_array_equal(part.pad_mask, jpart.pad_mask)
    np.testing.assert_array_equal(part.pad_index, jpart._pad_gather)
    np.testing.assert_array_equal(part.unpad_index, jpart._unpad_gather)
    rows = np.arange(part.global_size)
    np.testing.assert_array_equal(part.padded_index(rows), jpart.padded_index(rows))
    np.testing.assert_array_equal(part.part_of(rows), jpart.part_of(rows))
    x = np.random.default_rng(0).normal(size=part.global_size).astype(np.float32)
    xp = part.pad(torch.as_tensor(x))
    np.testing.assert_array_equal(xp.numpy(), np.asarray(jpart.pad(jnp.asarray(x))))
    np.testing.assert_array_equal(part.unpad(xp).numpy(), x)
    for p in range(part.num_parts):
        np.testing.assert_array_equal(part.pad_part(torch.as_tensor(x), p).numpy(),
                                      xp[p].numpy())


def test_partition_uniform_and_errors_match_jax():
    for n, P in ((101, 4), (96, 4), (5, 8), (0, 3)):
        assert Partition.uniform(n, P).offsets == jdist.Partition.uniform(n, P).offsets
    for bad in ((1, 0), (0, 3, 2)):
        with pytest.raises(ValueError):
            Partition(bad)
    with pytest.raises(ValueError):
        Partition.uniform(4, 0)


def test_shard_pad_mask_and_zero_padding():
    from repro.distributed.sharding import shard_pad_mask as jax_mask

    np.testing.assert_array_equal(shard_pad_mask((3, 2, 0), 3), jax_mask((3, 2, 0), 3))
    with pytest.raises(ValueError):
        shard_pad_mask((3, 2), 2)
    x = torch.tensor([1.0, float("nan"), 3.0])
    got = zero_shard_padding(x, torch.tensor([True, False, True]))
    assert got.tolist() == [1.0, 0.0, 3.0]
    assert zero_shard_padding(x, None) is x


def test_csr_slice_rows_host_equals_jax():
    ip, ix, v = _host(_sparse_pattern())
    for lo, hi in ((0, 101), (13, 57), (40, 40), (100, 101)):
        for g, w in zip(csr_slice_rows_host(ip, ix, v, lo, hi),
                        jax_slice_rows(ip, ix, v, lo, hi)):
            np.testing.assert_array_equal(g, w)
            assert g.dtype == w.dtype
    with pytest.raises(ValueError):
        csr_slice_rows_host(ip, ix, v, 5, 200)


@pytest.mark.parametrize("sizes", [(101,), (51, 50), (26, 25, 25, 25),
                                   (34, 34, 33, 0)])
def test_split_by_rows_equals_jax(sizes):
    ip, ix, v = _host(_sparse_pattern())
    part = Partition.from_part_sizes(sizes)
    got = split_by_rows(ip, ix, v, part)
    want = jdist.split_by_rows(ip, ix, v, jdist.Partition.from_part_sizes(sizes))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["halo_cols"], w["halo_cols"])
        for key in ("local", "interior", "boundary", "halo"):
            for ga, wa in zip(g[key], w[key]):
                np.testing.assert_array_equal(ga, wa, err_msg=key)


@pytest.mark.parametrize("fmt", ["csr", "ell"])
@pytest.mark.parametrize("sizes", [(101,), (51, 50), (26, 25, 25, 25),
                                   (34, 34, 33, 0)])
def test_stacked_arrays_and_halo_maps_equal_jax(fmt, sizes):
    a = _sparse_pattern()
    host = _host(a)
    part = Partition.from_part_sizes(sizes)
    jpart = jdist.Partition.from_part_sizes(sizes)
    cls, jcls = {"csr": (DistCsr, jdist.DistCsr), "ell": (DistEll, jdist.DistEll)}[fmt]
    A = (jsparse.csr_from_dense if fmt == "csr" else jsparse.ell_from_dense)(a)
    jA = jcls.from_matrix(A, jpart)
    fields = stacked_host_arrays(fmt, *host, part)
    assert fields["halo_counts"] == jA.num_halo_cols
    names = [f.name for f in dataclasses.fields(jA)
             if f.name not in ("shape", "nnz", "partition", "_halo_counts")]
    assert sorted(names) == sorted(k for k in fields if k != "halo_counts")
    for name in names:
        np.testing.assert_array_equal(fields[name], np.asarray(getattr(jA, name)),
                                      err_msg=name)
        assert fields[name].dtype == np.asarray(getattr(jA, name)).dtype, name
    # convert carries the JAX object's arrays across to the same rank blocks
    build = convert.dist_csr if fmt == "csr" else convert.dist_ell
    for p in range(part.num_parts):
        mine = cls.from_stacked(fields, shape=A.shape, nnz=jA.nnz,
                                partition=part, rank=p, device="cpu")
        carried = build({n: np.asarray(getattr(jA, n)) for n in names}, jA.shape,
                        jA.nnz, jpart.offsets, jA.num_halo_cols, rank=p,
                        device="cpu")
        assert carried.num_halo_cols == mine.num_halo_cols
        assert torch.equal(carried.halo_map, mine.halo_map)
        for blk in ("interior", "boundary", "halo"):
            for t_m, t_c in zip(dataclasses.astuple(getattr(mine, blk))[:-1],
                                dataclasses.astuple(getattr(carried, blk))[:-1]):
                assert torch.equal(t_m, t_c), (p, blk)
        # the merged diagonal block is the JAX package's local_block(p)
        lb, jlb = mine.local_block(), jA.local_block(p)
        arrays = ("indptr", "indices", "values") if fmt == "csr" else (
            "col_idx", "values")
        for f in arrays:
            np.testing.assert_array_equal(getattr(lb, f).numpy(),
                                          np.asarray(getattr(jlb, f)), err_msg=f)


def test_a_partition_needs_a_world_of_its_parts():
    ip, ix, v = _host(_sparse_pattern())
    with pytest.raises(ValueError, match="world"):
        DistCsr.from_host(ip, ix, v, Partition.uniform(N, 2), device="cpu")
    with pytest.raises(ValueError, match="rows"):
        DistCsr.from_host(ip, ix, v, Partition.uniform(N - 1, 1), device="cpu")


@pytest.mark.parametrize("n,nonsym", [(225, False), (225, True), (101, True),
                                      (37, False)])
def test_launcher_system_equals_jax(n, nonsym):
    a, xs, b = jdist_solve.build_system(n, nonsym=nonsym)
    (ip, ix, v), xs2, b2 = dist_solve.build_system(n, nonsym=nonsym)
    A = jsparse.csr_from_dense(a)
    np.testing.assert_array_equal(ip, np.asarray(A.indptr))
    np.testing.assert_array_equal(ix, np.asarray(A.indices))
    np.testing.assert_array_equal(v, np.asarray(A.values))
    np.testing.assert_array_equal(xs2, xs)
    # b: the dense f32 product against an f64 sum rounded once
    np.testing.assert_allclose(b2, b, rtol=2e-6, atol=2e-6 * np.abs(b).max())


# =============================================================================
# The worlds
# =============================================================================


@pytest.mark.parametrize("P", [2, 4])
def test_spmv_matches_single_device_and_jax(runs, P):
    a = _sparse_pattern()
    x = np.random.default_rng(1).normal(size=N).astype(np.float32)
    for fmt in ("csr", "ell"):
        for key in (f"spmv_{fmt}", f"spmv_empty_{fmt}"):
            y = _same_on_every_rank(runs["worlds"][P][key], "y")
            np.testing.assert_allclose(y, a @ x, rtol=1e-5, atol=1e-5, err_msg=key)


@pytest.mark.parametrize("P", [2, 4])
def test_dot_and_norm_mask_the_padding(runs, P):
    rng = np.random.default_rng(5)
    x, y = rng.normal(size=N).astype(np.float32), rng.normal(size=N).astype(np.float32)
    r = runs["worlds"][P]
    dot = _same_on_every_rank(r["blas"], "dot")
    norm = _same_on_every_rank(r["blas"], "norm")
    assert np.isclose(dot, float(x @ y), rtol=1e-5)
    assert np.isclose(norm, float(np.linalg.norm(x)), rtol=1e-6)
    if P == 4:
        assert np.isclose(dot, float(runs["jax4"]["dot"]), rtol=1e-5)
        assert np.isclose(norm, float(runs["jax4"]["norm"]), rtol=1e-6)
    # 1e9 in every padding slot (101 rows are ragged over 2 and 4 parts)
    assert not Partition.uniform(N, P).pad_mask.all()
    p = r["blas_poison"]
    assert np.isclose(_same_on_every_rank(p, "norm"), float(np.linalg.norm(x)),
                      rtol=1e-6)
    assert np.isclose(_same_on_every_rank(p, "dot"), float(x @ x), rtol=1e-5)
    np.testing.assert_array_equal(_same_on_every_rank(p, "x"), x)
    # axpy / scal are rank-local: the gathered results are the global ones
    q = r["blas"]
    np.testing.assert_array_equal(_same_on_every_rank(q, "axpy"),
                                  np.float32(2.0) * x + y)
    np.testing.assert_array_equal(_same_on_every_rank(q, "scal"),
                                  np.float32(-3.0) * x)
    assert _same_on_every_rank(q, "axis_size") == P


@pytest.mark.parametrize("P", [2, 4])
@pytest.mark.parametrize("fmt", ["csr", "ell"])
def test_cg_f32_matches_jax(runs, P, fmt):
    r = runs["worlds"][P][f"cg_f32_{fmt}"]
    x = _same_on_every_rank(r, "x")
    k = _same_on_every_rank(r, "iterations")
    _same_on_every_rank(r, "residual_norm")
    assert all(q["converged"] and q["repeat_equal"] for q in r)
    xs, ks = runs["single"][f"cg_f32_{fmt}"]
    assert abs(k - ks) <= 1
    np.testing.assert_allclose(x, xs, rtol=1e-4, atol=1e-5)
    if P == 4:
        assert abs(k - int(runs["jax4"][f"cg_f32_{fmt}_k"])) <= 1
        np.testing.assert_allclose(x, runs["jax4"][f"cg_f32_{fmt}"], rtol=1e-4,
                                   atol=1e-5)
    _, xstar, _ = _spd_system(N)
    np.testing.assert_allclose(x, xstar, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("P", [2, 4])
@pytest.mark.parametrize("fmt", ["csr", "ell"])
def test_cg_f64_matches_jax_at_its_tolerances(runs, P, fmt):
    """``test_dist_parity.test_cg_parity_f64``'s bounds: iterations within 1,
    the residual within rtol 1e-6, x within rtol 1e-10 / atol 1e-12."""
    r = runs["worlds"][P][f"cg_f64_{fmt}"]
    x = _same_on_every_rank(r, "x")
    assert x.dtype == np.float64 and all(q["converged"] for q in r)
    xs, ks, rs = runs["single"][f"cg_f64_{fmt}"]
    assert abs(r[0]["iterations"] - ks) <= 1
    np.testing.assert_allclose(r[0]["residual_norm"], rs, rtol=1e-6)
    np.testing.assert_allclose(x, xs, rtol=1e-10, atol=1e-12)
    if P == 4 and fmt == "csr":
        assert abs(r[0]["iterations"] - int(runs["jax4"]["cg_f64_k"])) <= 1
        np.testing.assert_allclose(x, runs["jax4"]["cg_f64"], rtol=1e-10,
                                   atol=1e-12)


@pytest.mark.parametrize("P", [2, 4])
def test_cg_survives_an_empty_part(runs, P):
    r = runs["worlds"][P]["cg_empty"]
    x = _same_on_every_rank(r, "x")
    assert r[0]["converged"]
    xs, ks = runs["single"]["cg_f32_csr"]
    assert abs(r[0]["iterations"] - ks) <= 1
    np.testing.assert_allclose(x, xs, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("P", [2, 4])
@pytest.mark.parametrize("kind", ["jacobi", "block_jacobi"])
def test_preconditioned_cg_and_applies(runs, P, kind):
    _, xstar, _ = _spd_system(96)
    r = runs["worlds"][P][f"cg_{kind}"]
    x = _same_on_every_rank(r, "x")
    assert r[0]["converged"]
    np.testing.assert_allclose(x, xstar, rtol=1e-3, atol=1e-3)
    y = _same_on_every_rank(runs["worlds"][P][f"apply_{kind}"], "y")
    if P == 4:
        assert abs(r[0]["iterations"] - int(runs["jax4"][f"cg_{kind}_k"])) <= 1
        np.testing.assert_allclose(x, runs["jax4"][f"cg_{kind}"], rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_allclose(y, runs["jax4"][f"apply_{kind}"], rtol=1e-6,
                                   atol=1e-7)


@pytest.mark.parametrize("P", [2, 4])
def test_pipelined_cg_one_reduction_collective_an_iteration(runs, P):
    """The JAX pin (``test_pipelined_cg.py``): one reduction an iteration for
    the pipelined loop, at least three for classic CG; here counted:
    ``norm2(b)`` and the first batched dots before the loop, then one
    ``dot_batch`` an iteration."""
    w = runs["worlds"][P]
    for key in ("pipelined", "pipelined_ell"):
        q = w[key][0]
        assert q["converged"]
        assert q["collectives"]["reduction"] == q["iterations"] + 2, key
        assert q["collectives"]["halo"] == q["iterations"] + 2  # A x, A u, then one an iteration
    xs, ks = runs["single"]["unfused"]
    assert abs(w["pipelined"][0]["iterations"] - ks) <= 2
    c = w["classic_unfused"][0]
    assert c["collectives"]["reduction"] == 3 + 3 * c["iterations"]
    # the fused loop with block-Jacobi: SpMV + dot, axpy + norm, r·z
    f = w["classic_bj"][0]
    assert f["collectives"]["reduction"] == 3 + 3 * f["iterations"]
    if P == 4:
        assert abs(w["pipelined"][0]["iterations"]
                   - int(runs["jax4"]["pipelined_k"])) <= 2


@pytest.mark.parametrize("P", [2, 4])
@pytest.mark.parametrize("opt,rtol", [("classic", 1e-3), ("pipelined", 5e-2)])
def test_history_matches_single_device(runs, P, opt, rtol):
    """``test_dist_history``'s case: the recorded norms are the global ones
    (every rank the same), as many as iterations, the last the final
    residual, and the single-device history within 1e-3 (5e-2 pipelined)."""
    r = runs["worlds"][P][f"history_{opt}"]
    q = r[0]
    h = convergence.trim(torch.as_tensor(_same_on_every_rank(r, "history")),
                         q["iterations"])
    h = np.asarray(h)
    assert len(h) == q["iterations"]
    np.testing.assert_allclose(h[-1], q["residual_norm"], rtol=1e-4)
    hs, ks = runs["single"][f"history_{opt}"]
    assert len(hs) == len(h)
    np.testing.assert_allclose(h, hs, rtol=rtol)
    if P == 4 and opt == "classic":
        np.testing.assert_allclose(h, runs["jax4"]["history"], rtol=1e-3)


@pytest.mark.parametrize("P", [2, 4])
@pytest.mark.parametrize("solver", ["bicgstab", "gmres", "cgs"])
def test_nonsymmetric_solvers_converge_and_match_jax(runs, P, solver):
    ns_host, shape, b = _nonsym()
    r = runs["worlds"][P][solver]
    x = _same_on_every_rank(r, "x")
    assert r[0]["converged"]
    ip, ix, v = ns_host
    a = np.zeros(shape, np.float64)
    a[np.repeat(np.arange(shape[0]), np.diff(ip)), ix] = v
    rel = np.linalg.norm(b - a @ x) / np.linalg.norm(b)
    assert rel <= 1e-4, rel
    xs, ks = runs["single"][solver]
    np.testing.assert_allclose(x, xs, rtol=1e-3, atol=1e-3 * np.abs(xs).max())
    if solver != "gmres":  # a shifted restart boundary moves GMRES by a cycle
        assert abs(r[0]["iterations"] - ks) <= 2
    if P == 4 and solver in ("bicgstab", "gmres"):
        np.testing.assert_allclose(x, runs["jax4"][solver], rtol=1e-3,
                                   atol=1e-3 * np.abs(xs).max())


@pytest.mark.parametrize("P", [2, 4])
def test_fcg_matches_jax(runs, P):
    r = runs["worlds"][P]["fcg"]
    x = _same_on_every_rank(r, "x")
    xs, ks = runs["single"]["fcg"]
    assert r[0]["converged"] and abs(r[0]["iterations"] - ks) <= 1
    np.testing.assert_allclose(x, xs, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("P", [2, 4])
def test_shard_batch_gives_each_rank_its_rows(runs, P):
    """Each rank's values and right-hand sides are its uniform share of the
    batch (the JAX package's ``shard_batch`` spec), and its solve equals
    those rows of the JAX package's whole-batch solve."""
    from repro_torch.launch import batch_solve

    A, B, _ = batch_solve.build_batch(10, 24, fmt="ell", device="cpu")
    jA, jB, _ = jbatch_solve.build_batch(10, 24, fmt="ell")
    res = jbatch_solvers.batch_cg(jA, jB, stop=JStop(500, 1e-6))
    part = Partition.uniform(10, P)
    seen = 0
    for q in runs["worlds"][P]["shard_batch"]:
        lo, hi = part.range_of(q["rank"])
        seen += hi - lo
        np.testing.assert_array_equal(q["values"], A.values[lo:hi].numpy())
        np.testing.assert_array_equal(q["B"], B[lo:hi].numpy())
        np.testing.assert_array_equal(q["values"], np.asarray(jA.values)[lo:hi])
        assert np.abs(q["iterations"] - np.asarray(res.iterations)[lo:hi]).max() <= 1
        np.testing.assert_allclose(q["x"], np.asarray(res.x)[lo:hi], rtol=1e-5,
                                   atol=1e-5)
    assert seen == 10


# =============================================================================
# A world of one, in this process, against the JAX package's one-part dist_solve
# =============================================================================


def _one_part_solves():
    from repro_torch.core import make_executor
    from repro_torch.distributed import dist_preconditioner
    from repro_torch.solvers import krylov

    ex = make_executor("torch")
    a96, _, b96 = _spd_system(96)
    out = {}
    for fmt, cls in (("csr", DistCsr), ("ell", DistEll)):
        Ad = cls.from_host(*_host(a96), Partition.uniform(96, 1), device="cpu")
        for kind in (None, "block_jacobi"):
            r = krylov.cg(Ad, torch.as_tensor(b96), stop=krylov.Stop(300, 1e-6),
                          M=kind, precond_opts={"block_size": 4} if kind else None,
                          executor=ex)
            out[(fmt, kind)] = (r.x.numpy(), r.iterations)
        with pytest.raises(ValueError, match="uniform storage"):
            dist_preconditioner(Ad, "block_jacobi", adaptive=True)
    return out


def test_one_part_world_matches_jax_dist_solve():
    got = comm.run_world(_one_part_solves, 1, in_process=True)[0]
    a96, _, b96 = _spd_system(96)
    for fmt, cls in (("csr", jdist.DistCsr), ("ell", jdist.DistEll)):
        A = (jsparse.csr_from_dense if fmt == "csr" else jsparse.ell_from_dense)(a96)
        Ad = cls.from_matrix(A, jdist.Partition.uniform(96, 1))
        for kind in (None, "block_jacobi"):
            r = jkrylov.cg(Ad, jnp.asarray(b96), stop=JStop(300, 1e-6), M=kind,
                           precond_opts={"block_size": 4} if kind else None)
            x, k = got[(fmt, kind)]
            assert k == int(r.iterations), (fmt, kind)
            np.testing.assert_allclose(x, np.asarray(r.x), rtol=1e-5, atol=1e-6)


def test_world_runner_reports_a_failing_rank(tmp_path):
    with pytest.raises(RuntimeError, match="rank"):
        comm.run_world(run_cases, 2, ([{"op": "no_such_op"}],), threads=1,
                       timeout_s=WORLD_TIMEOUT_S, join_timeout_s=JOIN_TIMEOUT_S,
                       rendezvous_dir=str(tmp_path))
