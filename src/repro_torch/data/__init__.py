"""repro_torch.data — deterministic, shard-aware, resumable synthetic pipeline."""

from repro_torch.data.pipeline import (
    DataConfig,
    DataIterator,
    entropy_floor,
    global_step_batch,
    shard_batch_np,
)

__all__ = [
    "DataConfig",
    "DataIterator",
    "entropy_floor",
    "global_step_batch",
    "shard_batch_np",
]
