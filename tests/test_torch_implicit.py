"""The port's implicit layer (``nn/implicit.py``) and DEQ model
(``models/deq.py``) against the JAX package's, on the same seeded inputs.

* ``make_implicit_solve``: the forward against JAX's and a dense f64 solve
  (rtol 1e-4, atol 1e-5, as ``tests/nn/test_implicit.py``); the ``b`` and
  ``values`` gradients against ``jax.grad`` of the same loss (rtol 1e-4 of
  the largest entry) and against central finite differences of a dense f64
  solve (1e-3, the JAX test's bound); a batch of right-hand sides equal to
  JAX's ``vmap``; ``bwd_stop``; the rectangular pattern refused.
* the DEQ: ``deq_forward``, ``deq_loss`` and the gradients of every
  parameter with the JAX parameters carried across
  (``convert.deq_params_from_jax``; rtol 1e-4); ``synthetic_batch``'s inputs
  equal to JAX's, and its targets with the JAX teacher carried across.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import deq as jdeq
from repro.nn.implicit import make_implicit_solve as jax_make_implicit_solve
from repro.solvers.common import Stop as JStop
from repro.sparse.gallery import convection_diffusion_2d as jax_convdiff
from repro_torch import convert
from repro_torch.core import make_executor
from repro_torch.models import deq
from repro_torch.nn.implicit import make_implicit_solve
from repro_torch.solvers import Stop
from repro_torch.sparse.gallery import convection_diffusion_2d

TORCH = make_executor("torch")
TIGHT = dict(max_iters=400, reduction_factor=1e-10)
GRAD_RTOL = 1e-4


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _fixture(n_side=6, peclet=2.0, seed=0):
    """``tests/nn/test_implicit.py``'s fixture: perturbed values and b."""
    indptr, indices, values, shape = convection_diffusion_2d(n_side, peclet=peclet)
    rng = np.random.default_rng(seed)
    vals = (values + 0.01 * rng.standard_normal(values.shape)
            .astype(np.float32)).astype(np.float32)
    b = rng.standard_normal(shape[0]).astype(np.float32)
    rows = np.repeat(np.arange(shape[0]), np.diff(indptr))
    return indptr, indices, shape, rows, vals, b


def _dense(rows, indices, n, values):
    d = np.zeros((n, n), np.float64)
    d[rows, indices] = values
    return d


def _loss_weights(n):
    return np.random.default_rng(1).standard_normal(n).astype(np.float32)


def _torch_grads(solve, vals, b, w):
    tv = torch.tensor(vals, requires_grad=True)
    tb = torch.tensor(b, requires_grad=True)
    x = solve(tv, tb)
    loss = (torch.as_tensor(w) * x).sum() + 0.5 * (x * x).sum()
    loss.backward()
    return x.detach().numpy(), tv.grad.numpy(), tb.grad.numpy()


def test_gallery_matches_jax():
    for args in ((6, 2.0), (8, 2.0)):
        got = convection_diffusion_2d(args[0], peclet=args[1])
        want = jax_convdiff(args[0], peclet=args[1])
        for g, w in zip(got[:3], want[:3]):
            np.testing.assert_array_equal(g, w)


def test_forward_is_the_solve_and_matches_jax():
    indptr, indices, shape, rows, vals, b = _fixture()
    solve = make_implicit_solve(indptr, indices, shape, stop=Stop(**TIGHT),
                                executor=TORCH)
    x = solve(torch.as_tensor(vals), torch.as_tensor(b)).numpy()
    xd = np.linalg.solve(_dense(rows, indices, shape[0], vals),
                         b.astype(np.float64))
    np.testing.assert_allclose(x, xd, rtol=1e-4, atol=1e-5)
    jsolve = jax_make_implicit_solve(indptr, indices, shape, stop=JStop(**TIGHT))
    xj = np.asarray(jsolve(jnp.asarray(vals), jnp.asarray(b)))
    np.testing.assert_allclose(x, xj, rtol=1e-4, atol=1e-5)


def test_gradients_match_jax_grad():
    indptr, indices, shape, rows, vals, b = _fixture()
    w = _loss_weights(shape[0])
    solve = make_implicit_solve(indptr, indices, shape, stop=Stop(**TIGHT),
                                executor=TORCH)
    _, gv, gb = _torch_grads(solve, vals, b, w)
    jsolve = jax_make_implicit_solve(indptr, indices, shape, stop=JStop(**TIGHT))

    def loss(vv, bb):
        x = jsolve(vv, bb)
        return jnp.sum(w * x) + 0.5 * jnp.sum(x * x)

    jgv, jgb = jax.grad(loss, argnums=(0, 1))(jnp.asarray(vals), jnp.asarray(b))
    jgv, jgb = np.asarray(jgv), np.asarray(jgb)
    np.testing.assert_allclose(gv, jgv, rtol=GRAD_RTOL,
                               atol=GRAD_RTOL * np.abs(jgv).max())
    np.testing.assert_allclose(gb, jgb, rtol=GRAD_RTOL,
                               atol=GRAD_RTOL * np.abs(jgb).max())


def test_gradients_match_finite_differences():
    indptr, indices, shape, rows, vals, b = _fixture()
    n = shape[0]
    w = _loss_weights(n)
    solve = make_implicit_solve(indptr, indices, shape, stop=Stop(**TIGHT),
                                executor=TORCH)
    _, gv, gb = _torch_grads(solve, vals, b, w)

    def loss_np(va, bb):
        x = np.linalg.solve(_dense(rows, indices, n, va), bb)
        return float(np.sum(w.astype(np.float64) * x) + 0.5 * np.sum(x * x))

    v64, b64 = vals.astype(np.float64), b.astype(np.float64)
    eps = 1e-6
    for t in (0, 7, len(v64) // 2, len(v64) - 1):
        vp, vm = v64.copy(), v64.copy()
        vp[t] += eps
        vm[t] -= eps
        fd = (loss_np(vp, b64) - loss_np(vm, b64)) / (2 * eps)
        assert abs(fd - gv[t]) <= 1e-3 * max(1.0, abs(fd)), (t, fd, gv[t])
    for i in (0, n // 2, n - 1):
        bp, bm = b64.copy(), b64.copy()
        bp[i] += eps
        bm[i] -= eps
        fd = (loss_np(v64, bp) - loss_np(v64, bm)) / (2 * eps)
        assert abs(fd - gb[i]) <= 1e-3 * max(1.0, abs(fd)), (i, fd, gb[i])


def test_gradients_in_f64_match_finite_differences_along_a_direction():
    """The whole values gradient at once: the directional derivative of the
    f64 solve's loss along a seeded direction, by central differences of the
    layer itself."""
    indptr, indices, shape, rows, vals, b = _fixture()
    solve = make_implicit_solve(indptr, indices, shape,
                                stop=Stop(max_iters=400, reduction_factor=1e-13),
                                executor=TORCH)
    v = torch.tensor(vals, dtype=torch.float64, requires_grad=True)
    bb = torch.tensor(b, dtype=torch.float64)
    w = torch.as_tensor(_loss_weights(shape[0]), dtype=torch.float64)

    def loss(vv):
        x = solve(vv, bb)
        return (w * x).sum() + 0.5 * (x * x).sum()

    loss(v).backward()
    d = torch.as_tensor(np.random.default_rng(5).standard_normal(len(vals)))
    eps = 1e-6
    with torch.no_grad():
        fd = (loss(v + eps * d) - loss(v - eps * d)) / (2 * eps)
    got = float(v.grad @ d)
    assert abs(got - float(fd)) <= 1e-6 * max(1.0, abs(float(fd))), (got, fd)


def test_batch_matches_jax_vmap():
    indptr, indices, shape, rows, vals, b = _fixture()
    B = np.stack([b, 2 * b, -b, np.roll(b, 3)])
    solve = make_implicit_solve(indptr, indices, shape, stop=Stop(**TIGHT),
                                executor=TORCH)
    tv = torch.as_tensor(vals)
    got = torch.stack([solve(tv, torch.as_tensor(bi)) for bi in B]).numpy()
    jsolve = jax_make_implicit_solve(indptr, indices, shape, stop=JStop(**TIGHT))
    want = np.asarray(jax.jit(jax.vmap(lambda bb: jsolve(jnp.asarray(vals), bb)))(
        jnp.asarray(B)))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_bwd_stop_bounds_the_adjoint_solve():
    """A loose ``bwd_stop`` leaves the forward as it is and stops the
    transposed solve early, so its gradient moves off the tight one."""
    indptr, indices, shape, rows, vals, b = _fixture()
    w = _loss_weights(shape[0])
    tight = make_implicit_solve(indptr, indices, shape, stop=Stop(**TIGHT),
                                executor=TORCH)
    loose = make_implicit_solve(indptr, indices, shape, stop=Stop(**TIGHT),
                                bwd_stop=Stop(max_iters=2, reduction_factor=1e-10),
                                restart=2, executor=TORCH)
    x_t, gv_t, _ = _torch_grads(tight, vals, b, w)
    x_l, gv_l, _ = _torch_grads(loose, vals, b, w)
    assert np.abs(gv_l - gv_t).max() > 1e-3 * np.abs(gv_t).max()
    np.testing.assert_allclose(x_l, x_t, rtol=1e-4, atol=1e-5)


def test_rectangular_pattern_rejected():
    with pytest.raises(ValueError, match="square"):
        make_implicit_solve(np.array([0, 1, 2]), np.array([0, 1]), (2, 3))


# -- the DEQ model -----------------------------------------------------------------


def _deq_pair(batch=4, seed=3):
    """The JAX package's config, parameters (nonzero theta) and batch, and the
    port's config with the same parameters carried across."""
    jcfg = jdeq.DeqConfig(n_side=6)
    jparams = jdeq.init_deq(jax.random.PRNGKey(0), jcfg)
    theta = np.random.default_rng(seed).standard_normal(jcfg.nnz).astype(np.float32)
    jparams = dict(jparams, theta=jnp.asarray(theta))
    u, y = jdeq.synthetic_batch(seed, batch, jcfg)
    cfg = deq.DeqConfig(n_side=6, device="cpu", executor=TORCH)
    params = convert.deq_params_from_jax(
        {k: np.asarray(v) for k, v in jparams.items()}, cfg)
    return jcfg, jparams, (u, y), cfg, params


def test_deq_config_matches_jax():
    jcfg = jdeq.DeqConfig()
    cfg = deq.DeqConfig(device="cpu", executor=TORCH)
    assert (cfg.n, cfg.nnz, cfg.d_in, cfg.restart) == (jcfg.n, jcfg.nnz,
                                                       jcfg.d_in, jcfg.restart)
    np.testing.assert_array_equal(cfg.base_values.numpy(),
                                  np.asarray(jcfg.base_values))


def test_deq_forward_loss_and_gradients_match_jax():
    jcfg, jparams, (u, y), cfg, params = _deq_pair()
    tu, ty = torch.as_tensor(np.array(u)), torch.as_tensor(np.array(y))
    pred = deq.deq_forward(params, tu, cfg)
    np.testing.assert_allclose(pred.numpy(),
                               np.asarray(jdeq.deq_forward(jparams, u, jcfg)),
                               rtol=1e-4, atol=1e-6)
    for p in params.values():
        p.requires_grad_(True)
    loss = deq.deq_loss(params, (tu, ty), cfg)
    loss.backward()
    jloss, jgrads = jax.value_and_grad(jdeq.deq_loss)(jparams, (u, y), jcfg)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-4)
    for k in ("theta", "w_in", "w_out"):
        want = np.asarray(jgrads[k])
        np.testing.assert_allclose(params[k].grad.numpy(), want,
                                   rtol=GRAD_RTOL,
                                   atol=GRAD_RTOL * np.abs(want).max(),
                                   err_msg=k)


def test_synthetic_batch_inputs_and_teacher_targets_match_jax():
    jcfg = jdeq.DeqConfig(n_side=6)
    u, y = jdeq.synthetic_batch(11, 3, jcfg)
    cfg = deq.DeqConfig(n_side=6, device="cpu", executor=TORCH)
    jteacher = dict(jdeq.init_deq(jax.random.PRNGKey(7), jcfg),
                    theta=jnp.asarray(np.random.default_rng(7)
                                      .standard_normal(jcfg.nnz)
                                      .astype(np.float32)))
    teacher = convert.deq_params_from_jax(
        {k: np.asarray(v) for k, v in jteacher.items()}, cfg)
    tu, ty = deq.synthetic_batch(11, 3, cfg, teacher=teacher)
    np.testing.assert_array_equal(tu.numpy(), np.asarray(u))
    np.testing.assert_allclose(ty.numpy(), np.asarray(y), rtol=1e-4, atol=1e-6)
    # the default teacher draws from a generator seeded 7: repeatable
    a = deq.synthetic_batch(11, 3, cfg)[1]
    b = deq.synthetic_batch(11, 3, cfg)[1]
    assert torch.equal(a, b) and not a.requires_grad


def test_deq_init_and_forward_batch_shapes():
    cfg = deq.DeqConfig(n_side=6, device="cpu", executor=TORCH)
    params = deq.init_deq(torch.Generator().manual_seed(0), cfg)
    again = deq.init_deq(torch.Generator().manual_seed(0), cfg)
    assert all(torch.equal(params[k], again[k]) for k in params)
    assert params["w_in"].shape == (cfg.n, cfg.d_in)
    assert float(params["theta"].abs().max()) == 0.0
    y = deq.deq_forward(params, torch.ones((5, cfg.d_in)), cfg)
    assert y.shape == (5,) and bool(torch.isfinite(y).all())
    with pytest.raises(ValueError, match="theta"):
        convert.deq_params_from_jax({"theta": np.zeros(cfg.nnz)}, cfg)
