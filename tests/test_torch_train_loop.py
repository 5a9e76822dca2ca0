"""The port's training loop on the smollm smoke configuration (CPU):

* it learns the synthetic chain (``tests/test_system.py``'s criteria: the
  last 5 losses' mean at least 0.25 below the first 5's, above the entropy
  floor less 0.05);
* from the JAX package's initial weights its first 10 losses are within
  1e-4 relative of the JAX ``train()``'s (same data, schedule, AdamW);
* a run stopped at step 10 and resumed gives the uninterrupted run's losses
  (the first 10 bitwise, the rest within the JAX test's rtol = atol =
  2e-4), a simulated preemption checkpoints step 1 and exits, and a tree
  saved from a run restores into a fresh one;
* ``train_deq`` passes its gate; the module runs as a command.
"""

import os
import subprocess
import sys
import tempfile

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_get_smoke_config
from repro.launch import train as jax_train
from repro.models import lm as jax_lm
from repro_torch import convert
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_smoke_config
from repro_torch.data import DataConfig, entropy_floor
from repro_torch.launch import train as train_lib
from repro_torch.runtime import PreemptionHandler

SRC = os.path.join(os.path.dirname(__file__), "..", "src")


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def test_training_learns_synthetic_chain():
    cfg = get_smoke_config("smollm_135m")
    _, losses = train_lib.train(cfg, steps=60, global_batch=8, seq_len=64,
                                device="cpu")
    start, end = np.mean(losses[:5]), np.mean(losses[-5:])
    floor = entropy_floor(DataConfig(vocab=cfg.vocab, seq_len=64,
                                     global_batch=8, seed=17))
    assert end < start - 0.25, (start, end)
    assert end > floor - 0.05


def test_first_losses_match_jax_train():
    jcfg = jax_get_smoke_config("smollm_135m")
    _, jlosses = jax_train.train(jcfg, steps=12, global_batch=8, seq_len=64)
    jparams, _ = jax_lm.init_model(jax.random.PRNGKey(0), jcfg)
    cfg = get_smoke_config("smollm_135m")
    params = convert.lm_params(cfg, jax.tree_util.tree_map(np.asarray, jparams),
                               device="cpu")
    _, losses = train_lib.train(cfg, steps=12, global_batch=8, seq_len=64,
                                init_params=params, device="cpu")
    np.testing.assert_allclose(losses[:10], jlosses[:10], rtol=1e-4)


def test_checkpoint_resume_exact():
    cfg = get_smoke_config("smollm_135m")
    kw = dict(steps=20, global_batch=4, seq_len=32, device="cpu")
    with tempfile.TemporaryDirectory() as d:
        _, full = train_lib.train(cfg, ckpt_dir=None, **kw)
        _, first = train_lib.train(cfg, ckpt_dir=d, ckpt_every=10,
                                   stop_at_step=10, **kw)
        _, rest = train_lib.train(cfg, ckpt_dir=d, ckpt_every=10, resume=True,
                                  **kw)
        assert first == full[:10]
        np.testing.assert_allclose(full[10:], rest, rtol=2e-4, atol=2e-4)
        with pytest.raises(SystemExit):
            train_lib.train(cfg, ckpt_dir=d, **kw)  # checkpoints and no --resume


def test_preemption_checkpoints_and_exits():
    cfg = get_smoke_config("smollm_135m")
    handler = PreemptionHandler()
    handler.simulate()
    with tempfile.TemporaryDirectory() as d:
        _, losses = train_lib.train(cfg, steps=50, global_batch=4, seq_len=32,
                                    ckpt_dir=d, ckpt_every=1000,
                                    preemption=handler, device="cpu")
        assert len(losses) == 1
        mgr = CheckpointManager(d)
        assert mgr.latest_step() == 1
        flat, meta = mgr.restore()
        assert meta == {"step": 1, "data": {"step": 1}}
        assert "opt/step" in flat and "params/blocks/0/attn/wq" in flat


def test_train_deq_passes():
    assert train_lib.train_deq(steps=8, batch=4, device="cpu")


def test_train_module_runs_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "smollm_135m", "--smoke", "--steps", "3", "--device", "cpu"],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "[train] done: 3 steps" in out.stdout


@pytest.mark.parametrize("arch", ["smollm_135m", "rwkv6_3b", "zamba2_2_7b"])
@pytest.mark.parametrize("remat", ["block", "dots"])
def test_remat_keeps_loss_and_gradients(arch, remat):
    """Checkpointed blocks (a Zamba2 group) recompute the same forward:
    the loss and every gradient leaf as without remat, within f32 rounding
    of a recomputation (1e-6 of each leaf's norm)."""
    import dataclasses

    from repro_torch.core import make_executor
    from repro_torch.core import tree as tree_lib
    from repro_torch.launch import steps as steps_lib
    from repro_torch.models import lm
    from repro_torch.nn.common import trainable

    cfg = get_smoke_config(arch)
    params = trainable(lm.init_model(cfg, device="cpu"))
    g = torch.Generator().manual_seed(2)
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, 12), generator=g),
             "labels": torch.randint(0, cfg.vocab, (2, 12), generator=g)}
    ex = make_executor("torch")
    l0, _, g0 = steps_lib.loss_and_grads(params, cfg, batch, ex)
    l1, _, g1 = steps_lib.loss_and_grads(
        params, dataclasses.replace(cfg, remat=remat), batch, ex)
    assert abs(float(l0) - float(l1)) <= 1e-6 * abs(float(l0))
    for (key, a), b in zip(tree_lib.flat(g0).items(), tree_lib.leaves(g1)):
        assert float(torch.linalg.vector_norm(a - b)) <= \
            1e-6 * float(torch.linalg.vector_norm(a)) + 1e-12, key
