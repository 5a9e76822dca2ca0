"""The port's COO and SELL-P formats, transposes, ``convert`` and SELL-P SpMV
against the JAX package's, and Jacobi-CG on a power-law matrix as SELL-P.

* Host layouts are integer/array bookkeeping in numpy on both sides, so the
  SELL-P and COO buffers, the CSR readback, the transposes and every
  ``convert`` target must be identical, not merely close — at ``m % C != 0``,
  with empty rows, all-zero rows and several slice sizes and stride factors.
* ``spmv_sellp_plain`` (through the kernel's wrapper, as a CPU caller reaches
  it) and the reference/torch spaces are held against the Pallas
  ``spmv_sellp`` in interpret mode at ragged m: f32 sums in another order,
  so 1e-5 relative to the sum of the terms' magnitudes (about 100 eps32).
* Jacobi-CG on ``power_law_laplacian(512, seed=4)`` as SELL-P: iterations
  within ±1 of the JAX solve, x within 1e-4 relative (2-norm).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import solvers as jsolvers
from repro.core import make_executor as jax_make_executor
from repro.core.linop import Transpose as JTranspose
from repro.kernels.spmv_sellp.kernel import spmv_sellp as jax_spmv_sellp
from repro.solvers.common import extract_diag_op as jax_extract_diag
from repro.sparse import formats as JF
from repro.sparse import gallery as jgallery
from repro.sparse import ops as JO
from repro_torch import convert
from repro_torch import kernels as K
from repro_torch.core import (
    Composition,
    MatrixFreeOp,
    Sum,
    Transpose,
    make_executor,
)
from repro_torch.solvers import Stop, cg
from repro_torch.solvers.common import extract_diag_op
from repro_torch.sparse import formats as F
from repro_torch.sparse import gallery as tgallery
from repro_torch.sparse import ops as O

RTOL = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _dense(m, n, seed, density=0.3):
    """Random dense matrix with empty rows, an all-zero last row and (where
    m allows) a wide row, so slice widths differ."""
    rng = np.random.default_rng(seed)
    a = (rng.standard_normal((m, n)) * (rng.random((m, n)) < density)
         ).astype(np.float32)
    if m > 3:
        a[2] = 0.0
        a[m - 1] = 0.0
        a[1, : n // 2 + 1] = 1.0 + rng.random(n // 2 + 1).astype(np.float32)
    return a


#: (m, n, slice_size, stride_factor): ragged m, tiny, single-row, empty,
#: other slice sizes and strides
SHAPES = [(37, 29, 8, 8), (29, 23, 4, 2), (5, 9, 8, 8), (1, 3, 8, 8),
          (0, 4, 8, 8), (17, 17, 3, 5), (26, 20, 16, 1)]
SHAPE_IDS = [f"{m}x{n}-C{c}-s{s}" for m, n, c, s in SHAPES]


def _pair(a, C, sf):
    return (JF.sellp_from_dense(a, slice_size=C, stride_factor=sf),
            F.sellp_from_dense(a, slice_size=C, stride_factor=sf, device="cpu"))


def _same_arrays(jax_obj, port_obj, fields):
    for f in fields:
        want = np.asarray(getattr(jax_obj, f))
        got = getattr(port_obj, f).numpy()
        assert got.dtype == want.dtype, f
        np.testing.assert_array_equal(got, want, err_msg=f)


SELLP_FIELDS = ("col_idx", "values", "slice_sets", "slice_cols")


@pytest.mark.parametrize("m,n,C,sf", SHAPES, ids=SHAPE_IDS)
def test_sellp_layout_identical(m, n, C, sf):
    J, P = _pair(_dense(m, n, seed=m + n), C, sf)
    _same_arrays(J, P, SELLP_FIELDS)
    assert (P.max_slice_cols, P.slice_size, P.stride_factor, P.shape) == (
        J.max_slice_cols, J.slice_size, J.stride_factor, tuple(J.shape))
    assert P.nnz == J.nnz and P.memory_bytes == J.memory_bytes
    for want, got in zip(JF.csr_host_arrays(J), F.csr_host_arrays(P)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("m,n,C,sf", SHAPES, ids=SHAPE_IDS)
def test_sellp_from_csr_keeps_stored_zeros_as_jax(m, n, C, sf):
    """A CSR entry stored as 0 stays in the SELL-P buffers (both packages)
    and is dropped by the CSR readback."""
    a = _dense(m, n, seed=3 * m + 1)
    r, c = np.nonzero(a)
    v = a[r, c].copy()
    v[::3] = 0.0
    indptr = np.zeros(m + 1, np.int64)
    indptr[1:] = np.cumsum(np.bincount(r, minlength=m))
    J = JF.sellp_from_csr_host(indptr, c, v, (m, n), slice_size=C,
                               stride_factor=sf)
    P = F.sellp_from_csr_host(indptr, c, v, (m, n), slice_size=C,
                              stride_factor=sf, device="cpu")
    _same_arrays(J, P, SELLP_FIELDS)
    for want, got in zip(JF.csr_host_arrays(J), F.csr_host_arrays(P)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("m,n,C,sf", SHAPES, ids=SHAPE_IDS)
def test_transposes_identical(m, n, C, sf):
    a = _dense(m, n, seed=2 * m + 5)
    J, P = _pair(a, C, sf)
    _same_arrays(J.transpose(), P.transpose(), SELLP_FIELDS)
    assert P.transpose().slice_size == C
    _same_arrays(JF.coo_from_dense(a).transpose(),
                 F.coo_from_dense(a, device="cpu").transpose(),
                 ("row_idx", "col_idx", "values"))
    _same_arrays(JF.csr_from_dense(a).transpose(),
                 F.csr_from_dense(a, device="cpu").transpose(),
                 ("indptr", "indices", "values"))
    _same_arrays(JF.ell_from_dense(a).transpose(),
                 F.ell_from_dense(a, device="cpu").transpose(),
                 ("col_idx", "values"))
    np.testing.assert_array_equal(
        F.Dense(torch.from_numpy(a)).transpose().values.numpy(), a.T)


CONVERT_FIELDS = {
    "coo": ("row_idx", "col_idx", "values"),
    "csr": ("indptr", "indices", "values"),
    "ell": ("col_idx", "values"),
    "sellp": SELLP_FIELDS,
    "dense": ("values",),
}


@pytest.mark.parametrize("target", sorted(CONVERT_FIELDS))
@pytest.mark.parametrize("source", ["coo", "csr", "ell", "sellp", "dense"])
def test_convert_identical(source, target):
    a = _dense(21, 13, seed=7)
    J = JF.convert(JF.Dense(jnp.asarray(a)), source)
    P = F.convert(F.Dense(torch.from_numpy(a)), source)
    kw = {"slice_size": 4, "stride_factor": 2} if target == "sellp" else {}
    Jt, Pt = JF.convert(J, target, **kw), F.convert(P, target, **kw)
    assert type(Pt).__name__ == type(Jt).__name__
    _same_arrays(Jt, Pt, CONVERT_FIELDS[target])
    assert F.convert(P, type(P)) is P
    with pytest.raises(KeyError, match="unknown format"):
        F.convert(P, "hyb")


def test_convert_carries_jax_objects():
    a = _dense(19, 11, seed=9)
    J = JF.sellp_from_dense(a)
    P = convert.sellp(J.col_idx, J.values, J.slice_sets, J.slice_cols, J.shape,
                      J.slice_size, J.stride_factor, J.max_slice_cols,
                      device="cpu")
    _same_arrays(J, P, SELLP_FIELDS)
    Jc = JF.coo_from_dense(a)
    Pc = convert.coo(Jc.row_idx, Jc.col_idx, Jc.values, Jc.shape, device="cpu")
    _same_arrays(Jc, Pc, ("row_idx", "col_idx", "values"))


@pytest.mark.parametrize("m,n,C,sf", [s for s in SHAPES if s[0] and s[1]],
                         ids=[i for s, i in zip(SHAPES, SHAPE_IDS)
                              if s[0] and s[1]])
def test_spmv_sellp_matches_pallas(m, n, C, sf):
    J, P = _pair(_dense(m, n, seed=m * 7 + n), C, sf)
    x = np.random.default_rng(m).standard_normal(n).astype(np.float32)
    want = np.asarray(jax_spmv_sellp(
        J.col_idx, J.values, J.slice_sets, jnp.asarray(x), m=m, slice_size=C,
        block_cols=sf, max_slice_cols=J.max_slice_cols, interpret=True))
    xt = torch.from_numpy(x)
    scale = float((np.abs(np.asarray(JO.to_dense(J))) @ np.abs(x)).max())
    got = [K.spmv_sellp(P.col_idx, P.values, P.slice_sets, xt, m, C)]
    for space in ("reference", "torch"):
        got.append(O.apply(P, xt, executor=make_executor(space)))
    for y in got:
        assert y.shape == (m,) and y.dtype == torch.float32
        np.testing.assert_allclose(y.numpy(), want, rtol=RTOL,
                                   atol=RTOL * max(scale, 1.0))


def test_spmv_coo_and_to_dense_match_jax():
    a = _dense(23, 17, seed=11)
    x = np.random.default_rng(1).standard_normal(17).astype(np.float32)
    Jc, Pc = JF.coo_from_dense(a), F.coo_from_dense(a, device="cpu")
    want = np.asarray(JO.apply(Jc, jnp.asarray(x)))
    for space in ("reference", "torch"):
        ex = make_executor(space)
        np.testing.assert_allclose(
            O.apply(Pc, torch.from_numpy(x), executor=ex).numpy(), want,
            rtol=RTOL, atol=RTOL * float(np.abs(a).sum()))
        for P in (Pc, F.sellp_from_dense(a, device="cpu")):
            np.testing.assert_array_equal(O.to_dense(P, executor=ex).numpy(), a)
    assert O.to_dense(F.sellp_from_dense(np.zeros((0, 3), np.float32),
                                         device="cpu")).shape == (0, 3)


@pytest.mark.parametrize("fmt", ["coo", "sellp"])
def test_extract_diagonal_matches_jax(fmt):
    """SELL-P's diagonal is read from the slice layout; the JAX package
    densifies.  The values must be equal."""
    a = _dense(26, 26, seed=13)
    np.fill_diagonal(a, np.arange(1, 27, dtype=np.float32))
    a[5, 5] = 0.0
    J = JF.convert(JF.Dense(jnp.asarray(a)), fmt)
    P = F.convert(F.Dense(torch.from_numpy(a)), fmt)
    want = np.asarray(jax_extract_diag(J, executor=jax_make_executor("xla")))
    for space in ("reference", "torch"):
        got = extract_diag_op(P, executor=make_executor(space)).numpy()
        np.testing.assert_array_equal(got, want)


def test_transpose_linop():
    a = _dense(12, 9, seed=17)
    P = F.sellp_from_dense(a, device="cpu")
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(12)
                         .astype(np.float32))
    ex = make_executor("torch")
    T = Transpose(P)
    assert T.shape == (9, 12) and T.dtype == torch.float32
    np.testing.assert_allclose(T.apply(x, executor=ex).numpy(), a.T @ x.numpy(),
                               rtol=RTOL, atol=RTOL * float(np.abs(a).sum()))
    assert Transpose(T)._t is P
    C = F.coo_from_dense(a.T.copy(), device="cpu")  # 9 x 12
    comp = Transpose(Composition(P, C))  # (P C)^T = C^T P^T, 12 x 12
    y = torch.from_numpy(np.random.default_rng(3).standard_normal(12)
                         .astype(np.float32))
    np.testing.assert_allclose(comp.apply(y, executor=ex).numpy(),
                               (a @ a.T).T @ y.numpy(), rtol=1e-4, atol=1e-4)
    s = Transpose(Sum(P, P))
    np.testing.assert_allclose(s.apply(x, executor=ex).numpy(),
                               2 * a.T @ x.numpy(), rtol=1e-4, atol=1e-4)
    with pytest.raises(NotImplementedError, match="not transposable"):
        Transpose(MatrixFreeOp(lambda v: v, shape=(3, 3)))
    # the JAX package's Transpose agrees on the same operator
    Jt = JTranspose(JF.sellp_from_dense(a))
    np.testing.assert_allclose(np.asarray(Jt.apply(jnp.asarray(x.numpy()))),
                               T.apply(x, executor=ex).numpy(), rtol=RTOL,
                               atol=RTOL * float(np.abs(a).sum()))


def test_power_law_gallery_identical():
    for seed in (0, 4):
        want = jgallery.power_law_laplacian(700, seed=seed)
        got = tgallery.power_law_laplacian(700, seed=seed)
        for w, g in zip(want[:3], got[:3]):
            assert w.dtype == g.dtype
            np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError, match="at least 2"):
        tgallery.power_law_laplacian(1)


@functools.lru_cache(maxsize=None)
def _power_law_problem():
    ip, ix, v, shape = tgallery.power_law_laplacian(512, seed=4)
    b = np.random.default_rng(0).standard_normal(shape[0]).astype(np.float32)
    J = JF.sellp_from_csr_host(ip, ix, v, shape)
    # the JAX package's SELL-P diagonal densifies through its reference
    # SpMV (a minute here); its CSR twin's Jacobi has the same values
    M = jsolvers.jacobi_preconditioner(JF.convert(J, "csr"))
    res = jsolvers.cg(J, jnp.asarray(b), M=M,
                      stop=jsolvers.Stop(max_iters=500, reduction_factor=1e-6),
                      executor=jax_make_executor("xla"))
    return (ip, ix, v, shape, b), (int(res.iterations), np.asarray(res.x),
                                   bool(res.converged))


@pytest.mark.parametrize("space", ["reference", "torch"])
def test_jacobi_cg_on_power_law_sellp_matches_jax(space):
    (ip, ix, v, shape, b), (k_j, x_j, conv_j) = _power_law_problem()
    P = F.sellp_from_csr_host(ip, ix, v, shape, device="cpu")
    assert not O.has_fused_ops(P, executor=make_executor(space))
    res = cg(P, torch.from_numpy(b), M="jacobi",
             stop=Stop(max_iters=500, reduction_factor=1e-6),
             executor=make_executor(space))
    assert conv_j and res.converged
    assert abs(res.iterations - k_j) <= 1, (res.iterations, k_j)
    assert np.linalg.norm(res.x.numpy() - x_j) <= 1e-4 * np.linalg.norm(x_j)


def test_cuda_space_and_wrapper_checks():
    P = F.sellp_from_dense(_dense(10, 10, seed=1), device="cpu")
    x = torch.ones(10)
    with pytest.raises(ValueError, match="CUDA tensors"):
        O.apply(P, x, executor=make_executor("cuda"))
    assert O.spmv_sellp.space_used(make_executor("cuda")) == "cuda"
    with pytest.raises(ValueError, match="int32"):
        K.spmv_sellp(P.col_idx.long(), P.values, P.slice_sets, x, 10, 8)
    with pytest.raises(ValueError, match="slice_sets"):
        K.spmv_sellp(P.col_idx, P.values, P.slice_sets, x, 17, 8)
    with pytest.raises(ValueError, match="whole columns"):
        K.spmv_sellp(P.col_idx[:-1], P.values[:-1], P.slice_sets, x, 10, 8)
    with pytest.raises(ValueError, match="dtype"):
        K.spmv_sellp(P.col_idx, P.values, P.slice_sets, x.double(), 10, 8)


def test_sellp_geometry_for_h100():
    """The H100 geometry (the probe's sweep on the path matrix): blocks of
    256 threads, the one tuned parameter, which the wrapper also defaults
    to; the range size follows from the matrix and the warps of a wave.  The
    kernel's shared memory is each warp's ring of the stream (4 steps of its
    lanes' slots, a column index and a value each) and, with several columns
    a step, its tile of row partials."""
    from repro_torch.core import tuning
    from repro_torch.kernels.spmv_sellp import kernel as SK

    hw = make_executor("h100").hw
    cfg = tuning.resolve("spmv_sellp", {"m": 2_097_152, "slice_size": 8,
                                        "itemsize": 4}, hw)
    assert dict(cfg.block) == {"block_threads": 256} == {
        "block_threads": SK.BLOCK_THREADS}
    # the path matrix (3,996,928 stored columns at C = 8) over a wave of 132
    # SMs x 32 warps: 474 columns a range, 8,433 ranges
    R = SK.range_cols(8, 3_996_928, 132 * 32)
    assert R == 474 and -(-3_996_928 // R) <= SK.RANGES_PER_WARP * 132 * 32
    assert cfg.smem_bytes == 256 * (4 * 4 * 8 + 4 * 4)
    cfg = tuning.resolve("spmv_sellp", {"m": 100, "slice_size": 3,
                                        "itemsize": 8}, hw)
    assert cfg.smem_bytes == 256 * (4 * 1 * 12 + 1 * 8)
    assert tuning.resolve("spmv_sellp", {"m": 100, "slice_size": 512,
                                         "itemsize": 4}, hw).smem_bytes == (
        256 * 4 * 4 * 8)


def _sellp_source_constants():
    from pathlib import Path
    import re

    src = (Path(K.__file__).parent / "csrc" / "spmv_sellp.cu").read_text()
    found = {k: int(re.search(rf"constexpr int {k} = (\d+);", src).group(1))
             for k in ("kWarp", "kStages")}
    found["launch_bounds"] = int(re.search(
        r"__launch_bounds__\((\d+), min_blocks<T>\(\)\)\nspmv_sellp_kernel",
        src).group(1))
    found["flush_guard"] = re.search(
        r"if \(cps == 1\) \{\n(?:\s*//.*\n)*\s*if \((.*)\) \{", src).group(1)
    return found


def _flush_stores(C, vec, lanes, cols, passes):
    """Rows a slice's flush stores, lane by lane and pass by pass, as the
    source's ``flush``: with one column a step each lane its own partials,
    under the guard the source states; with several, lane (r, g) of the
    reduction over the tile, the rows r, r + 32, ... of part g = 0."""
    stores = []
    for pas in range(passes):
        for lane in range(SK_WARP):
            p, q = lane // lanes, lane % lanes + pas * SK_WARP
            if cols == 1:
                if p < cols and q < C // vec:  # q < lanes_col
                    stores += [(pas, lane, q * vec + i) for i in range(vec)]
            else:
                g = lane // C if C <= SK_WARP else 0
                r0 = lane - g * C if C <= SK_WARP else lane
                stores += [(pas, lane, r) for r in range(r0, C, SK_WARP)
                           if g == 0]
    return stores


@pytest.mark.parametrize("C,vec,lanes,cols,passes", [
    (3, 1, 3, 10, 1), (8, 4, 2, 16, 1), (18, 1, 18, 1, 1),
    (32, 4, 8, 4, 1), (96, 4, 24, 1, 1), (512, 4, 32, 1, 4)])
def test_sellp_lane_mapping_and_counts(C, vec, lanes, cols, passes):
    """The kernel's walk for slice size C: lane l copies ``vec`` consecutive
    slots (16 bytes of indices when C is a multiple of 4) into its part of
    the warp's ring, lanes = C / vec of them a column (at most 32), 32 //
    lanes columns a step, and a column of more than 32 lane-loads in passes
    of 32.  Over a range's steps and passes the lanes load every slot of
    every column once, each lane's slots within one column and of the rows
    it holds partials for; a flush stores each of the slice's C rows from
    exactly one lane, also where lanes past a column's last lane-load idle
    (C = 18 and 96: 18 and 24 lanes a column, one column a step)."""
    from repro_torch.kernels.spmv_sellp import kernel as SK

    c = _sellp_source_constants()
    assert (c["kWarp"], c["kStages"], c["launch_bounds"]) == (
        SK.WARP, SK.RING_STAGES, SK.MAX_BLOCK_THREADS)
    assert c["flush_guard"] == "p < cps && q < lanes_col"
    stored_rows = sorted(r for _, _, r in _flush_stores(C, vec, lanes, cols,
                                                        passes))
    assert stored_rows == list(range(C))
    geo = SK.sellp_geometry(C, itemsize=8)
    assert (geo["vec"], geo["lanes_per_col"], geo["cols_per_step"],
            geo["passes"]) == (vec, lanes, cols, passes)
    # the ring's slots (a column index and a value each), then the tile
    assert geo["smem_per_thread"] == (
        SK.RING_STAGES * vec * 12 + (vec * 8 if cols > 1 else 0))
    # the slots of a range of 11 columns, as the kernel loads them
    width = 11
    seen = []
    for pas in range(passes):
        for lane in range(SK.WARP):
            p, q = lane // lanes, lane % lanes + pas * SK.WARP
            if p >= cols or q * vec >= C:
                continue
            for b in range(0, width, cols):
                j = b + p
                if j < width:
                    slots = [j * C + q * vec + i for i in range(vec)]
                    assert {e // C for e in slots} == {j}
                    assert [e % C for e in slots] == [q * vec + i
                                                      for i in range(vec)]
                    seen += slots
    assert sorted(seen) == list(range(width * C))


def _slices_ended_by(ss, c):
    """``slices_ended_by`` of the source: the 32-way search for the first
    slice ending past column c."""
    lo, hi = 0, len(ss) - 1
    while hi > lo:
        step = -(-(hi - lo) // SK_WARP)
        le = [lo + (t + 1) * step - 1 < hi
              and ss[1 + lo + (t + 1) * step - 1] <= c for t in range(SK_WARP)]
        below = sum(le)
        assert le == [True] * below + [False] * (SK_WARP - below)
        hi = min(hi, lo + (below + 1) * step - 1)
        lo += below * step
    return lo


SK_WARP = 32


def _walk(P, x, range_cols, order):
    """Model of ``csrc/spmv_sellp.cu``'s walk at the step of its warps,
    ranges taken in ``order``: y, the times each row of y and each stored
    column was written or read, the slices that carried shares, and the
    tickets after the launch."""
    from repro_torch.kernels.spmv_sellp import kernel as SK

    C, m, R = P.slice_size, P.shape[0], range_cols
    ss = P.slice_sets.numpy().astype(np.int64)
    cols = P.col_idx.numpy().reshape(-1, C)
    vals = P.values.numpy().astype(np.float64).reshape(-1, C)
    prod = vals * x[cols]
    ns, total = len(ss) - 1, int(ss[-1])
    cps = SK.sellp_geometry(C)["cols_per_step"]
    ranges = -(-total // R)
    head, own = np.full((ranges, C), np.nan), np.full((ranges, C), np.nan)
    tickets = np.zeros(ranges, np.int64)
    y, writes = np.full(m, np.nan), np.zeros(m, np.int64)
    read = np.zeros(total, np.int64)
    carried = set()

    def write_rows(s, rows):
        n = min(C, m - s * C)
        y[s * C:s * C + n] = rows[:n]
        writes[s * C:s * C + n] += 1

    for k in order:
        c_lo, c_hi = k * R, min(k * R + R, total)
        s0 = 0 if k == 0 else _slices_ended_by(ss, c_lo)
        assert s0 == np.sum(ss[1:] <= c_lo)
        began_before = ss[s0] < c_lo
        s, start, e = s0, ss[s0], ss[s0 + 1]
        acc = np.zeros(C)

        def flush():
            if s == s0 and began_before:
                head[k] = acc
            elif e <= c_hi:
                write_rows(s, acc)
            else:
                own[k] = acc
            acc[:] = 0

        for bu in range(c_lo, c_hi, cps):
            nv, lo = min(cps, c_hi - bu), 0
            while s < ns and e <= bu + nv:
                acc += prod[bu + lo:e].sum(axis=0)
                read[bu + lo:e] += 1
                flush()
                lo, s, start = e - bu, s + 1, e
                e = ss[s + 1] if s < ns else 2 ** 31 - 1
            acc += prod[bu + lo:bu + nv].sum(axis=0)
            read[bu + lo:bu + nv] += 1
        open_ = s < ns and start < c_hi
        if open_:
            flush()

        def settle(s_, k0, k1):
            carried.add(s_)
            tickets[k0] += 1
            if tickets[k0] == k1 - k0 + 1:
                write_rows(s_, own[k0] + head[k0 + 1:k1 + 1].sum(axis=0))
                tickets[k0] = 0

        if began_before:
            settle(s0, ss[s0] // R, (ss[s0 + 1] - 1) // R)
        if open_ and not (s == s0 and began_before):
            settle(s, k, (e - 1) // R)
    return y, writes, read, carried, tickets


def _carried_matrix(C, seed):
    """A seeded SELL-P matrix of ragged m (not a multiple of C) with an
    all-empty first slice (one padded column), slices of every width and a
    hub row of 40 entries, at stride 1."""
    rng = np.random.default_rng(seed)
    m, n = 5 * C + 1, max(5 * C + 1, 64)
    a = np.zeros((m, n), np.float32)
    for i in range(C, m):
        nz = rng.choice(n, size=rng.integers(0, 7), replace=False)
        a[i, nz] = rng.standard_normal(nz.size)
    a[C + 1, rng.choice(n, size=40, replace=False)] = 1.0
    return F.sellp_from_dense(a, slice_size=C, stride_factor=1, device="cpu")


@pytest.mark.parametrize("C", [3, 8, 32, 512])
def test_sellp_ranges_and_carries_against_a_brute_force_split(C):
    """``sellp_geometry``'s ranges and cut slices against a column-by-column
    split of the stored columns into ranges, at ranges of 1, 4 and 13
    columns and one past every column; then the walk (:func:`_walk`, ranges
    in a shuffled order) reads every stored column once, writes every row
    once, leaves every ticket at 0, carries exactly the cut slices, and gives
    the plain version's y."""
    from repro_torch.kernels.spmv_sellp import kernel as SK

    P = _carried_matrix(C, seed=C)
    ss = P.slice_sets.numpy().astype(np.int64)
    total, (m, n) = int(ss[-1]), P.shape
    assert m % C and ss[1] == 1  # ragged m, an all-empty slice
    x = np.random.default_rng(C + 1).standard_normal(n)
    want = K.spmv_sellp_plain(P.col_idx, P.values.double(), P.slice_sets,
                              torch.from_numpy(x), m, C).numpy()
    slice_of = np.repeat(np.arange(len(ss) - 1), np.diff(ss))
    spans = []
    for R in (1, 4, 13, total + 1):
        ranges_of = {}
        for j in range(total):
            ranges_of.setdefault(slice_of[j], set()).add(j // R)
        cut = {s for s, r in ranges_of.items() if len(r) > 1}
        geo = SK.sellp_geometry(C, P.slice_sets, R)
        assert geo["range_cols"] == R
        assert geo["ranges"] == len({j // R for j in range(total)})
        assert geo["carries"] == len(cut)
        spans.append(max(len(r) for r in ranges_of.values()))
        order = np.random.default_rng(R).permutation(geo["ranges"])
        y, writes, read, carried, tickets = _walk(P, x, R, order)
        assert (read == 1).all() and (writes == 1).all()
        assert not tickets.any() and carried == cut
        np.testing.assert_allclose(y, want, rtol=1e-12, atol=1e-12)
    assert spans[1] > 2 and spans[-1] == 1  # a slice over more than two ranges


@pytest.mark.parametrize("C", [3, 8, 512])
def test_sellp_range_cols_from_the_wave(C):
    """The range size the wrapper sets: the fewest columns that cut the
    stored columns into at most RANGES_PER_WARP ranges a warp of the wave,
    and never under MIN_RANGE_SLOTS slots; so a matrix too small to give
    every warp its ranges walks ranges of the floor's size."""
    from repro_torch.kernels.spmv_sellp import kernel as SK

    floor = -(-SK.MIN_RANGE_SLOTS // C)
    for total in (1, 7, floor * 5 + 3, 3_996_928, 225_454_472):
        for warps in (1, 33, 132 * 32):
            R = SK.range_cols(C, total, warps)
            ranges = -(-total // R)
            assert R >= floor and R * C >= SK.MIN_RANGE_SLOTS
            if R > floor:
                assert ranges <= SK.RANGES_PER_WARP * warps
                assert -(-total // (R - 1)) > SK.RANGES_PER_WARP * warps
            else:
                assert total <= floor * SK.RANGES_PER_WARP * warps


def test_sellp_probe_needs_a_card(monkeypatch):
    from repro_torch.kernels import sellp_probe

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert sellp_probe.main(["--n", "64"]) == 2
