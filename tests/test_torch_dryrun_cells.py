"""Every live cell of smollm-135m through the port's dry run on ``meta``,
with nothing allocated (``tests/test_torch_dryrun.py`` builds one cell of
every arch)."""

import pytest
import torch

from repro_torch.configs import SHAPES, cells

from test_torch_dryrun import jax_per_rank_bytes, run_meta_only


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("shape", cells("smollm_135m"))
def test_smollm_every_live_cell(shape):
    r = run_meta_only("smollm_135m", shape)
    s = SHAPES[shape]
    assert r["share"]["batch"] == max(1, s.global_batch // 16)
    params, moments = jax_per_rank_bytes("smollm_135m")
    assert r["per_rank_bytes"]["params"] == params
    assert r["per_rank_bytes"]["moments"] == (moments if s.kind == "train"
                                              else 0.0)
    units = r["share"]["kernel_units"]
    assert units["rmsnorm"]["count"] >= 2 * 30 + 1
    if s.kind != "decode":
        # one flash_attention unit a layer (a train step's backward
        # recomputes the plain version, not the kernel)
        assert units["flash_attention"]["count"] >= 30
    # the model's FLOPs against the step's: a forward is at most a train
    # step's third, and the walker counts more than the model's 2 N D
    assert 0 < r["model_flops"]["useful_fraction"] < 1.0
    if s.kind == "train":
        assert r["collectives"]["reduce-scatter"]["count"] > 0
    else:
        assert r["collectives"] == {}
