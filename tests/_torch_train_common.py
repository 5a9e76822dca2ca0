"""Shared by tests/test_torch_train_loss_*.py: the port's ``loss_fn``, its
metrics and its gradient tree against ``jax.value_and_grad`` of the JAX
package's ``lm.loss_fn`` from the same parameters and batch."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_smoke_config as jax_get_smoke_config
from repro.core import make_executor as jax_make_executor
from repro.models import lm as jax_lm
from repro_torch import convert
from repro_torch.configs import get_smoke_config
from repro_torch.core import make_executor
from repro_torch.core import tree as tree_lib
from repro_torch.launch import steps as steps_lib
from repro_torch.nn.common import trainable

B, S, SEED = 2, 16, 7
#: loss and metrics: relative; gradients: each leaf's ||g - g_jax|| over
#: max(||g_jax||, 1e-3 ||all of g_jax||) (f32, sums in another order; a
#: leaf whose gradient is near zero is held against the tree's scale)
LOSS_RTOL = 2e-5
GRAD_RTOL = 2e-4


def batch_np(cfg):
    rng = np.random.default_rng(SEED)
    out = {"labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.frontend == "stub_embeddings":
        out["embeds"] = rng.standard_normal((B, S, cfg.d_model)).astype(
            np.float32)
    else:
        out["tokens"] = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    return out


@functools.lru_cache(maxsize=None)
def jax_run(arch):
    """Smoke config, the JAX parameters (PRNGKey 3) as numpy, and the JAX
    loss, metrics and gradients on the reference executor."""
    jcfg = jax_get_smoke_config(arch)
    jparams, _ = jax_lm.init_model(jax.random.PRNGKey(3), jcfg)
    batch = {k: jnp.asarray(v) for k, v in batch_np(jcfg).items()}
    jex = jax_make_executor("reference")
    fn = jax.jit(jax.value_and_grad(
        lambda p, b: jax_lm.loss_fn(p, jcfg, b, executor=jex), has_aux=True))
    (loss, metrics), grads = fn(jparams, batch)
    as_np = functools.partial(jax.tree_util.tree_map, np.asarray)
    return (as_np(jparams), float(loss),
            {k: float(v) for k, v in metrics.items()}, as_np(grads))


def check_loss_and_grads(arch, space):
    jparams, jloss, jmetrics, jgrads = jax_run(arch)
    cfg = get_smoke_config(arch)
    params = trainable(convert.lm_params(cfg, jparams, device="cpu"))
    batch = {k: torch.from_numpy(v) for k, v in batch_np(cfg).items()}
    loss, metrics, grads = steps_lib.loss_and_grads(
        params, cfg, batch, make_executor(space))
    assert abs(float(loss) - jloss) <= LOSS_RTOL * abs(jloss)
    assert set(metrics) == set(jmetrics)
    for k, v in jmetrics.items():
        assert abs(float(metrics[k]) - v) <= LOSS_RTOL * max(abs(v), 1e-6), k
    want = tree_lib.flat(convert.lm_params(cfg, jgrads, device="cpu"))
    got = tree_lib.flat(grads)
    assert set(got) == set(want)
    total = float(np.sqrt(sum(float(torch.sum(w.double() ** 2))
                              for w in want.values())))
    for key, w in want.items():
        diff = float(torch.linalg.vector_norm((got[key] - w).double()))
        ref = max(float(torch.linalg.vector_norm(w.double())), 1e-3 * total)
        assert diff <= GRAD_RTOL * ref, (key, diff / ref)
