"""The port's cooperative groups (``repro_torch.core.coop``) against the JAX
package's ``repro.core.coop``, on the CPU.

Every case of ``tests/core/test_coop.py`` runs through both packages on the
same numpy inputs: reductions, scans and shuffles must give the same values
(the same butterfly and Hillis-Steele orders, so the same f32 roundings:
bitwise), the ballots the same lane masks in the same unsigned type.  The
64-lane (AMD wavefront) ballot needs x64 in JAX: a fixture turns
``jax_enable_x64`` on and restores it.  The port needs no switch; its
64-lane masks are ``torch.uint64`` with bit 63 set where lane 63 votes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import coop as jcoop
from repro_torch.core import coop

SIZES = (2, 4, 8, 16, 32)


def _np(x) -> np.ndarray:
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _same(got, want) -> None:
    got, want = _np(got), _np(want)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


def _pair(a: np.ndarray):
    return torch.from_numpy(a.copy()), jnp.asarray(a)


@pytest.fixture
def x64():
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", prev)


def test_coop_is_exported_from_core():
    import repro_torch.core as core

    assert core.coop is coop and "coop" in core.__all__


@pytest.mark.parametrize("size", SIZES + (64, 128))
def test_reduce_matches_jax(size):
    a = np.random.default_rng(size).normal(size=(4, 128)).astype(np.float32)
    t, j = _pair(a)
    got = coop.subgroup(t, size).sum()
    _same(got, jcoop.subgroup(j, size).sum())
    seg = a.reshape(4, 128 // size, size)
    want = np.broadcast_to(seg.sum(-1, keepdims=True), seg.shape).reshape(4, 128)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name,npop", [("max", np.max), ("min", np.min)])
def test_reduce_minmax_matches_jax(name, npop):
    a = np.random.default_rng(1).normal(size=(2, 64)).astype(np.float32)
    t, j = _pair(a)
    got = getattr(coop.subgroup(t, 8), name)()
    _same(got, getattr(jcoop.subgroup(j, 8), name)())
    op = {"max": torch.maximum, "min": torch.minimum}[name]
    _same(coop.subgroup(t, 8).reduce(op), got)
    seg = a.reshape(2, 8, 8)
    want = np.broadcast_to(npop(seg, -1, keepdims=True), seg.shape).reshape(2, 64)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("size", SIZES)
def test_inclusive_scan_matches_jax(size):
    a = np.random.default_rng(2).normal(size=(3, 64)).astype(np.float32)
    t, j = _pair(a)
    got = coop.subgroup(t, size).inclusive_scan()
    _same(got, jcoop.subgroup(j, size).inclusive_scan())
    want = np.cumsum(a.reshape(3, 64 // size, size), -1).reshape(3, 64)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("size", [8, 16, 32])
@pytest.mark.parametrize("bitmask", range(8))
def test_shfl_xor_matches_jax(bitmask, size):
    a = np.random.default_rng(1).normal(size=(2, 128)).astype(np.float32)
    t, j = _pair(a)
    got = coop.subgroup(t, size).shfl_xor(bitmask)
    _same(got, jcoop.subgroup(j, size).shfl_xor(bitmask))
    # involution: applying twice restores the input
    _same(coop.subgroup(got, size).shfl_xor(bitmask), a)


def test_shfl_and_shfl_down_match_jax():
    a = np.random.default_rng(3).normal(size=(2, 32)).astype(np.float32)
    t, j = _pair(a)
    sg, jsg = coop.subgroup(t, 8), jcoop.subgroup(j, 8)
    _same(sg.shfl(3), jsg.shfl(3))
    _same(sg.shfl_down(2), jsg.shfl_down(2))
    seg = a.reshape(2, 4, 8)
    np.testing.assert_array_equal(
        sg.shfl(3).numpy(), np.broadcast_to(seg[..., 3:4], seg.shape).reshape(2, 32))


@pytest.mark.parametrize("seed", [0, 17, 99])
@pytest.mark.parametrize("size", SIZES)
def test_ballot_any_all_count_match_jax(size, seed):
    """(warp.ballot & Mask) >> LaneOffset: bit i set iff member i's pred."""
    pred = np.random.default_rng(seed).integers(0, 2, size=(128,)).astype(bool)
    sg = coop.subgroup(torch.zeros(128), size, warp_size=32)
    jsg = jcoop.subgroup(jnp.zeros((128,)), size, warp_size=32)
    tp, jp = torch.from_numpy(pred), jnp.asarray(pred)
    ballot = sg.ballot(tp)
    assert ballot.dtype == torch.uint32
    _same(ballot, jsg.ballot(jp))
    _same(sg.any(tp), jsg.any(jp))
    _same(sg.all(tp), jsg.all(jp))
    _same(sg.count(tp), jsg.count(jp))
    pr = pred.reshape(128 // size, size)
    want = [sum(int(pr[g, i]) << i for i in range(size)) for g in range(len(pr))]
    np.testing.assert_array_equal(ballot.numpy().reshape(-1, size)[:, 0], want)


def test_ballot_wavefront64_matches_jax_under_x64(x64):
    pred = np.tile(np.arange(64) % 3 == 0, 2)
    sg = coop.subgroup(torch.zeros(128), 8, warp_size=64)
    jsg = jcoop.subgroup(jnp.zeros((128,)), 8, warp_size=64)
    tp, jp = torch.from_numpy(pred), jnp.asarray(pred)
    assert sg.ballot(tp).dtype == torch.uint64
    _same(sg.ballot(tp), jsg.ballot(jp))
    _same(sg.count(tp), jsg.count(jp))
    want = np.tile((np.arange(64) % 3 == 0).reshape(8, 8).sum(1), 2)
    np.testing.assert_array_equal(sg.count(tp).numpy().reshape(16, 8)[:, 0], want)


def test_ballot_wavefront64_keeps_bit_63(x64):
    """A full 64-lane subgroup whose lane 63 votes: the mask's sign bit in
    int64, handed back as uint64 and counted by popcnt."""
    rng = np.random.default_rng(5)
    pred = rng.integers(0, 2, size=(2, 64)).astype(bool)
    pred[:, 63] = True
    pred[1] = True
    sg = coop.subgroup(torch.zeros(2, 64), 64, warp_size=64)
    jsg = jcoop.subgroup(jnp.zeros((2, 64)), 64, warp_size=64)
    tp, jp = torch.from_numpy(pred), jnp.asarray(pred)
    ballot = sg.ballot(tp)
    _same(ballot, jsg.ballot(jp))
    assert int(ballot.numpy()[1, 0]) == 2 ** 64 - 1
    _same(sg.count(tp), jsg.count(jp))
    _same(sg.all(tp), jsg.all(jp))
    assert coop.lane_mask_type(64) == torch.uint64
    assert coop.lane_mask_bits(64) == 64 and coop.lane_mask_bits(32) == 32
    with pytest.raises(ValueError, match="exceeds 64-bit"):
        coop.lane_mask_type(128)


def test_popcnt_overloads_match_jax(x64):
    vals = np.array([0, 1, 3, 255, 2 ** 31 + 7], np.uint32)
    _same(coop.popcnt(torch.from_numpy(vals)), jcoop.popcnt(jnp.asarray(vals)))
    np.testing.assert_array_equal(coop.popcnt(torch.from_numpy(vals)).numpy(),
                                  [0, 1, 2, 8, 4])
    v64 = np.array([0, 2 ** 63, 2 ** 64 - 1, 12345678901234], np.uint64)
    _same(coop.popcnt(torch.from_numpy(v64)), jcoop.popcnt(jnp.asarray(v64)))
    for dt in (np.int32, np.int64):
        signed = np.array([-1, 5, -(2 ** 20)], dt)
        _same(coop.popcnt(torch.from_numpy(signed)),
              jcoop.popcnt(jnp.asarray(signed)))
    with pytest.raises(TypeError):
        coop.popcnt(torch.zeros(3))


def test_thread_rank_matches_jax():
    sg = coop.subgroup(torch.zeros(2, 32), 8)
    ranks = sg.thread_rank()
    _same(ranks, jcoop.subgroup(jnp.zeros((2, 32)), 8).thread_rank())
    assert (ranks.numpy() == np.tile(np.arange(8), 4)).all()


def test_subgroup_size_validation():
    with pytest.raises(ValueError):
        coop.subgroup(torch.zeros(32), 3)  # not a power of two
    with pytest.raises(ValueError):
        coop.subgroup(torch.zeros(31), 8).sum()  # not divisible
    with pytest.raises(ValueError, match="<= warp_size"):
        coop.subgroup(torch.zeros(64), 64, warp_size=32).ballot(
            torch.ones(64, dtype=torch.bool))
    with pytest.raises(ValueError, match="out of range"):
        coop.subgroup(torch.zeros(32), 8).shfl_xor(8)
