"""The port's dry run (``repro_torch.launch.dryrun``) on the ``meta`` device:
every arch builds and costs one cell with nothing allocated, the per-rank
bytes of parameters and moments equal the JAX package's ``PartitionSpec``
split of the same leaves on 16 x 16, the collective census equals what a
2-rank gloo world counts for the same step (``test_torch_dryrun_census.py``),
and a failing cell gives a non-zero exit (there too).  smollm-135m's every
cell is in ``tests/test_torch_dryrun_cells.py``."""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import ARCH_IDS
from repro_torch.launch import dryrun


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


class MetaOnly(TorchDispatchMode):
    """Fails on any operation whose result is not a ``meta`` tensor."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else [out]):
            if isinstance(t, torch.Tensor):
                assert t.device.type == "meta", (func, t.device)
        return out


def run_meta_only(*args, **kw):
    with MetaOnly():
        return dryrun.run_cell(*args, save=False, verbose=False, **kw)


def jax_per_rank_bytes(arch: str, zero: str = "zero1"):
    """The JAX package's per-rank bytes of parameters and of both moments
    on an abstract 16 x 16 mesh: each leaf's bytes over the mesh sizes its
    ``PartitionSpec`` names (no devices)."""
    import jax
    from jax.sharding import AbstractMesh

    from repro.configs import get_config
    from repro.distributed import sharding as jshd
    from repro.launch import steps as jsteps
    from repro.optim import adamw as jadamw
    from repro.optim import warmup_cosine_schedule as jwarmup

    mesh = AbstractMesh((16, 16), ("data", "model"))
    cfg = get_config(arch)
    shapes, axes = jsteps.model_shapes_and_axes(cfg)
    opt = jadamw(jwarmup(3e-4, 2000, 100_000))
    opt_shapes = jsteps.opt_state_shapes(opt, shapes)

    def split(tree, zero_):
        flat_axes, treedef = jax.tree_util.tree_flatten(
            axes, is_leaf=jshd._is_axes_leaf)
        leaves = treedef.flatten_up_to(tree)
        total = 0.0
        for leaf, ax in zip(leaves, flat_axes):
            spec = jshd.spec_for_leaf(leaf.shape, ax, mesh, zero=zero_)
            parts = 1
            for e in spec:
                for name in ((e,) if isinstance(e, str) else (e or ())):
                    parts *= mesh.shape[name]
            total += np.prod(leaf.shape, dtype=np.float64) * \
                np.dtype(leaf.dtype).itemsize / parts
        return total

    params = split(shapes, "fsdp" if zero == "fsdp" else "none")
    m_zero = "zero1" if zero in ("zero1", "fsdp") else "none"
    moments = split(opt_shapes.mu, m_zero) + split(opt_shapes.nu, m_zero)
    return params, moments


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_arch_builds_one_cell_on_meta(arch):
    """decode_32k (one token a step: the quickest cell) of every arch."""
    r = run_meta_only(arch, "decode_32k")
    assert r["chips"] == 256 and r["mesh"] == "16x16"
    pd, share = r["per_device"], r["share"]
    assert pd["logical_flops"] > 0 and pd["logical_bytes_fused_est"] > 0
    assert pd["logical_bytes_fused_est"] <= pd["logical_bytes_unfused"]
    assert share["batch"] == 128 // 16
    assert share["peak_bytes"] >= r["per_rank_bytes"]["batch"]
    assert r["roofline"]["bottleneck"] in ("compute", "memory", "collective")
    assert 0 < r["model_flops"]["useful_fraction"]
    # the cuda space's share reached its kernels as units (decode: the
    # norms; an attention-free or LayerNorm model may reach none)
    assert isinstance(share["kernel_units"], dict)
    params, _ = jax_per_rank_bytes(arch)
    assert r["per_rank_bytes"]["params"] == params


@pytest.mark.parametrize("arch,zero", [
    ("smollm_135m", "zero1"), ("olmoe_1b_7b", "zero1"), ("minicpm3_4b", "zero1"),
    ("zamba2_2_7b", "zero1"), ("smollm_135m", "fsdp"), ("granite_8b", "none")])
def test_param_and_moment_bytes_equal_the_jax_split(arch, zero):
    cell = dryrun.build_cell(arch, "train_4k", zero=zero)
    sp = cell.specs
    got_p = dryrun._tree_bytes(sp["param_shapes"], sp["params"], cell.mesh)
    got_m = (dryrun._tree_bytes(sp["opt_shapes"].mu, sp["mu"], cell.mesh)
             + dryrun._tree_bytes(sp["opt_shapes"].nu, sp["nu"], cell.mesh))
    assert (got_p, got_m) == jax_per_rank_bytes(arch, zero)
