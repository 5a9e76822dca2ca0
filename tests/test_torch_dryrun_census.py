"""The dry run's collective census (``repro_torch.launch.dryrun``): the
census of a step on rank 0 of a mesh of census groups equals what a 2-rank
gloo world counts for the same step; the data-parallel part of a training
step; and a failing cell gives a non-zero exit."""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core import make_executor
from repro_torch.core import tree as tree_lib
from repro_torch.distributed import comm
from repro_torch.launch import dryrun, steps
from repro_torch.nn.common import trainable
from repro_torch.optim import adamw, warmup_cosine_schedule

from test_torch_dryrun import run_meta_only


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("mesh", [{"data": 1, "model": 2},
                                  {"data": 2, "model": 1}])
def test_census_equals_a_two_rank_gloo_world(mesh):
    """qwen2-moe's smoke config expert-parallel over the model axis: one
    train step on each rank of a gloo world of 2 counts its collectives
    (``comm.collective_counts`` / ``collective_bytes``); the census of the
    same step on rank 0 of a census mesh gives the same counts and bytes."""
    from repro_torch.distributed.train_cases import run_train_cases

    arch, B, S = "qwen2-moe-a2.7b", 2, 16
    cfg = dataclasses.replace(get_smoke_config(arch),
                              moe_spec=(("data",), "model"))
    tokens = np.random.default_rng(0).integers(0, cfg.vocab, (B, S),
                                               dtype=np.int32)
    case = {"op": "census_step", "arch": arch, "mesh": mesh, "batch": tokens}
    world = comm.run_world(run_train_cases, 2, ([case], "cpu"), threads=1)
    params = trainable(steps.model_shapes_and_axes(cfg)[0])
    opt = adamw(warmup_cosine_schedule(3e-4, 10, 100))
    local = B // mesh["data"]
    census = dryrun.census_of(
        steps.make_train_step(cfg, opt, executor=make_executor(
            "torch", device="meta")),
        (params, opt.init(params), steps.batch_struct(cfg, local, S)), mesh)
    assert census["all-reduce"]["count"] > 0
    for (got,) in world:
        assert {k: v for k, v in got["counts"].items() if v} == \
            {k: v["count"] for k, v in census.items()}
        assert {k: float(v) for k, v in got["bytes"].items() if v} == \
            {k: v["bytes"] for k, v in census.items()}


def test_moe_census_on_the_production_mesh():
    """qwen2-moe's decode step through its expert-parallel capacity dispatch
    on rank 0 of 16 x 16: the output all-reduce of every layer and the
    router metrics' means; nothing gathered."""
    r = run_meta_only("qwen2_moe_a2_7b", "decode_32k")
    coll = r["collectives"]
    assert coll["all-reduce"]["count"] >= 24
    assert "all-gather" not in coll and "reduce-scatter" not in coll


def test_dp_census_of_a_training_step():
    """ZeRO-1 on 16 x 16: a leaf whose moments split over the data axis has
    its gradient reduce-scattered and its update gathered, any other leaf
    its gradient all-reduced; one collective of either kind a leaf."""
    cell = dryrun.build_cell("smollm_135m", "train_4k")
    counts = {k: v["count"] for k, v in dryrun.dp_census(cell).items()}
    n = len(tree_lib.leaves(cell.specs["param_shapes"]))
    assert counts.get("reduce-scatter", 0) == counts.get("all-gather", 0)
    assert counts.get("reduce-scatter", 0) + counts.get("all-reduce", 0) == n
    fsdp = {k: v["count"] for k, v in dryrun.dp_census(
        dryrun.build_cell("smollm_135m", "train_4k", zero="fsdp")).items()}
    assert fsdp["all-gather"] >= 2 * fsdp["reduce-scatter"] > 0
    assert dryrun.dp_census(dryrun.build_cell("smollm_135m", "prefill_32k")) == {}


def test_a_failing_cell_gives_a_nonzero_exit(monkeypatch, capsys):
    def flaky(arch, shape, **kw):
        if arch == "yi_9b":
            raise RuntimeError("cannot build")
        return {"arch": arch, "shape": shape}

    monkeypatch.setattr(dryrun, "run_cell", flaky)
    assert dryrun.main(["--all", "--no-save"]) == 1
    assert "[yi_9b x train_4k] FAILED" in capsys.readouterr().out
    monkeypatch.undo()
    with pytest.raises(KeyError):
        dryrun.main(["--arch", "smollm_135m", "--shape", "train_9k",
                     "--no-save"])
