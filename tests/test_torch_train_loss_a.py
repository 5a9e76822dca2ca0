"""The port's loss and gradients against the JAX package, first five of the
ten smoke configurations (the dense and MoE transformers, MLA), in the
torch and reference spaces.  See ``_torch_train_common.py`` for the
measure and the tolerances: loss and metrics within 2e-5 relative, each
gradient leaf within 2e-4 of its norm (f32, sums in another order)."""

import pytest
import torch

from _torch_train_common import check_loss_and_grads

ARCHS = ("granite_8b", "smollm_135m", "qwen2_moe_a2_7b", "olmoe_1b_7b",
         "minicpm3_4b")


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("space", ["torch", "reference"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(arch, space):
    check_loss_and_grads(arch, space)
