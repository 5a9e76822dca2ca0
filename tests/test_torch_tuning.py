"""The port's launch-configuration layer: tables, seeds, the autotune cache
and its persistence.

Mirrors ``tests/core/test_tuning.py`` on the port.  Against the JAX package:
``bucket_shapes`` gives the same buckets, and a table saved by either
package loads in the other (one JSON schema, ``{"version": 1, "entries":
[...]}``).  Where the JAX package shrinks a geometry to fit VMEM, the port
raises: a geometry that does not fit a block's shared memory is refused,
whatever entry proposed it.
"""

import dataclasses
import json

import pytest
import torch

from repro.core import tuning as jtuning
from repro_torch.core import make_executor, params, tuning

#: each kernel family at a shape of its path
OPS_AND_SHAPES = {
    "spmv_ell": {"m": 2_097_152, "k": 7, "itemsize": 4},
    "spmv_dot": {"m": 2_097_152, "k": 7, "itemsize": 4},
    "axpy_norm": {"n": 2_097_152, "itemsize": 4},
    "axpy_norm_rows": {"nb": 256, "n": 1024, "itemsize": 4},
    "block_jacobi": {"nb": 262_144, "bs": 4},
    "spgemm": {"nnz_a": 5_000_000, "nnz_b": 5_000_000},
    "spmv_sellp": {"m": 2_097_152, "slice_size": 8, "itemsize": 4},
    "spmv_batch_ell": {"m": 1024, "k": 3, "n": 1024, "itemsize": 4},
    "nn_rmsnorm": {"rows": 16_384, "d": 5120, "itemsize": 2},
    "nn_attention": {"S": 2048, "Skv": 2048, "D": 160, "itemsize": 2},
    "nn_attention_chunked": {"S": 2048, "Skv": 2048, "D": 128, "itemsize": 2},
    "nn_rwkv6_scan": {"S": 2048, "K": 64, "V": 64, "tensor_cores": 1},
    "nn_ssd_scan": {"S": 2048, "N": 64, "P": 64, "tensor_cores": 1},
}


@pytest.fixture(autouse=True)
def _one_thread_clean_tables():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    table = dict(tuning._TABLE)
    tuning.clear_autotune_cache()
    yield
    tuning.clear_autotune_cache()
    tuning._TABLE.clear()
    tuning._TABLE.update(table)
    torch.set_num_threads(prev)


def test_every_family_registers_a_spec():
    assert sorted(tuning.all_specs()) == sorted(OPS_AND_SHAPES)


@pytest.mark.parametrize("op", sorted(OPS_AND_SHAPES))
def test_resolved_config_fits_shared_memory(op):
    """At its path's shape every family's seed resolves on the H100 within a
    block's shared memory, with every parameter of its spec."""
    cfg = tuning.resolve(op, OPS_AND_SHAPES[op], params.H100)
    assert cfg.op == op and cfg.target == "h100" and cfg.source == "seed"
    assert 0 <= cfg.smem_bytes <= params.H100.smem_per_block_bytes
    assert set(tuning.get_spec(op).params) <= set(cfg.block)
    assert all(v >= 1 for v in cfg.block.values())


def test_default_table_covers_all_targets():
    table = tuning.default_table()
    assert set(table) == {(op, t) for op in OPS_AND_SHAPES
                          for t in params.TARGETS}
    spec = tuning.get_spec("spmv_ell")
    assert table[("spmv_ell", "h100")] == spec.seed(params.H100)
    tuning.set_table_entry("spmv_ell", "h100", {"block_threads": 128,
                                                "subgroup": 1})
    assert tuning.default_table()[("spmv_ell", "h100")] == {
        "block_threads": 128, "subgroup": 1}


def test_bucketing_pow2_equals_the_jax_package():
    assert tuning.next_pow2(1) == 1 and tuning.next_pow2(3) == 4
    assert tuning.next_pow2(1024) == 1024
    assert tuning.prev_pow2(1000) == 512
    for shapes in ({"S": 1000, "itemsize": 4}, {"S": 1024, "itemsize": 4},
                   {"S": 1025, "itemsize": 8}, {"m": 3, "k": 7, "n": 1},
                   {"nb": 16_384, "n": 1024, "itemsize": 4}):
        assert tuning.bucket_shapes(shapes) == jtuning.bucket_shapes(shapes)
    b1 = tuning.bucket_shapes({"S": 1000, "itemsize": 4})
    assert b1 == tuning.bucket_shapes({"S": 1024, "itemsize": 4})
    assert tuning.bucket_shapes({"S": 1025, "itemsize": 4}) != b1


def test_resolve_order_autotuned_table_seed():
    """The autotuned entry of the shapes' bucket, then the table entry,
    then the seed."""
    shapes = {"nb": 250, "n": 1000, "itemsize": 4}
    hw = params.H100
    assert tuning.resolve("axpy_norm_rows", shapes, hw).source == "seed"
    tuning.set_table_entry("axpy_norm_rows", "h100",
                           {"block_threads": 128, "grid_blocks": 264})
    cfg = tuning.resolve("axpy_norm_rows", shapes, hw)
    assert cfg.source == "table" and cfg["block_threads"] == 128
    tuning.record_autotuned("axpy_norm_rows", "h100", shapes,
                            {"block_threads": 512, "grid_blocks": 528})
    # the same bucket (sizes rounded up to powers of two) hits the cache
    cfg = tuning.resolve("axpy_norm_rows", {"nb": 256, "n": 1024,
                                            "itemsize": 4}, hw)
    assert cfg.source == "autotuned" and dict(cfg.block) == {
        "block_threads": 512, "grid_blocks": 528}
    # another bucket, or another target, falls back to the table
    other = tuning.resolve("axpy_norm_rows", {"nb": 8, "n": 64,
                                              "itemsize": 4}, hw)
    assert other.source == "table"
    assert tuning.resolve("axpy_norm_rows", shapes,
                          params.CPU_TORCH).source == "seed"


def test_stale_entries_missing_params_are_ignored():
    """Entries lacking one of the spec's parameters (hand-edited or older
    tables) are skipped, at both levels."""
    shapes = OPS_AND_SHAPES["spmv_ell"]
    tuning.record_autotuned("spmv_ell", "h100", shapes, {"block_threads": 128})
    tuning.set_table_entry("spmv_ell", "h100", {"subgroup": 4})
    cfg = tuning.resolve("spmv_ell", shapes, params.H100)
    assert cfg.source == "seed" and set(cfg.block) == {"block_threads",
                                                       "subgroup"}


def test_entry_the_kernel_cannot_take_raises():
    """No shrink and no fallback: an autotuned or table geometry over a
    block's shared memory raises, where the seed would have fitted."""
    shapes = OPS_AND_SHAPES["spmv_sellp"]
    small = dataclasses.replace(params.H100, name="h100_50k",
                                smem_per_block_bytes=50000)
    assert tuning.resolve("spmv_sellp", shapes, small).smem_bytes == 36864
    wide = {"block_threads": 512}
    tuning.record_autotuned("spmv_sellp", "h100_50k", shapes, wide)
    with pytest.raises(ValueError, match="shared memory"):
        tuning.resolve("spmv_sellp", shapes, small)
    tuning.clear_autotune_cache()
    tuning.set_table_entry("spmv_sellp", "h100_50k", wide)
    with pytest.raises(ValueError, match="shared memory"):
        tuning.resolve("spmv_sellp", shapes, small)


def test_autotune_cache_roundtrip_and_the_jax_schema(tmp_path):
    shapes = {"nb": 250, "n": 1000, "itemsize": 4}
    block = {"block_threads": 512, "grid_blocks": 528}
    tuning.record_autotuned("axpy_norm_rows", "h100", shapes, block)
    tuning.record_autotuned("spmv_ell", "cpu_torch", {"m": 9, "k": 3},
                            {"block_threads": 64, "subgroup": 1})
    path = tmp_path / "tables" / "h100.json"
    assert tuning.save_table(str(path), target="h100") == 1
    payload = json.loads(path.read_text())
    assert payload["version"] == 1
    assert payload["entries"] == [{
        "op": "axpy_norm_rows", "target": "h100", "block": block,
        "bucket": [["itemsize", 4], ["n", 1024], ["nb", 256]]}]
    tuning.clear_autotune_cache()
    assert tuning.autotune_entries() == []
    assert tuning.load_table(str(path)) == 1
    cfg = tuning.resolve("axpy_norm_rows", shapes, params.H100)
    assert cfg.source == "autotuned" and dict(cfg.block) == block
    # one schema: the JAX package reads the port's file, and the port reads
    # the JAX package's
    try:
        jtuning.clear_autotune_cache()
        assert jtuning.load_table(str(path)) == 1
        assert jtuning.autotune_entries() == tuning.autotune_entries()
        jpath = tmp_path / "jax.json"
        jtuning.save_table(str(jpath))
        tuning.clear_autotune_cache()
        assert tuning.load_table(str(jpath)) == 1
        assert tuning.autotune_entries() == jtuning.autotune_entries()
    finally:
        jtuning.clear_autotune_cache()


def test_env_table_is_the_ports_own(monkeypatch, tmp_path):
    """``REPRO_TORCH_TUNING_PATH`` is loaded at the first resolve; the JAX
    package's ``REPRO_TUNING_PATH`` (TPU geometries) is not read."""
    shapes = {"nb": 256, "n": 1024, "itemsize": 4}
    ours, theirs = tmp_path / "port.json", tmp_path / "jax.json"
    tuning.record_autotuned("axpy_norm_rows", "h100", shapes,
                            {"block_threads": 128, "grid_blocks": 64})
    tuning.save_table(str(ours))
    tuning.clear_autotune_cache()
    tuning.record_autotuned("axpy_norm_rows", "h100", shapes,
                            {"block_threads": 64, "grid_blocks": 32})
    tuning.save_table(str(theirs))
    tuning.clear_autotune_cache()
    assert tuning.TUNING_PATH_ENV != jtuning.TUNING_PATH_ENV
    monkeypatch.setenv(jtuning.TUNING_PATH_ENV, str(theirs))
    monkeypatch.setattr(tuning, "_ENV_LOADED", False)
    assert tuning.resolve("axpy_norm_rows", shapes, params.H100).source == "seed"
    monkeypatch.setenv(tuning.TUNING_PATH_ENV, str(ours))
    monkeypatch.setattr(tuning, "_ENV_LOADED", False)
    cfg = tuning.resolve("axpy_norm_rows", shapes, params.H100)
    assert cfg.source == "autotuned" and cfg["block_threads"] == 128
    # an unreadable file warns and leaves the seeds in force
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    tuning.clear_autotune_cache()
    monkeypatch.setenv(tuning.TUNING_PATH_ENV, str(bad))
    monkeypatch.setattr(tuning, "_ENV_LOADED", False)
    with pytest.warns(UserWarning, match="unreadable tuning table"):
        cfg = tuning.resolve("axpy_norm_rows", shapes, params.H100)
    assert cfg.source == "seed"


def test_executor_launch_config_entry_point():
    ex = make_executor("h100", device="cpu")
    cfg = ex.launch_config("nn_attention", {"S": 128, "Skv": 128, "D": 64,
                                            "itemsize": 2})
    assert cfg.target == "h100" and cfg["block_kv"] >= 16
    assert ex._last_launch_config is cfg  # what a traced dispatch records
    cfg_t = make_executor("torch").launch_config(
        "axpy_norm", {"n": 4096, "itemsize": 4})
    assert cfg_t.target == "cpu_torch"


def test_unknown_op_raises():
    with pytest.raises(KeyError):
        tuning.resolve("no_such_op", {}, params.CPU_TORCH)
