"""repro_torch.optim — AdamW, schedules, clipping, gradient compression."""

from repro_torch.optim.adamw import (
    AdamWState,
    Optimizer,
    adamw,
    clip_by_global_norm,
    constant_schedule,
    global_norm,
    warmup_cosine_schedule,
    warmup_linear_schedule,
)
from repro_torch.optim.compression import (
    compress_tree,
    compressed_psum,
    decompress_tree,
    dequantize_int8,
    ef_compress,
    init_error_state,
    quantize_int8,
)

__all__ = [
    "AdamWState",
    "Optimizer",
    "adamw",
    "clip_by_global_norm",
    "constant_schedule",
    "global_norm",
    "warmup_cosine_schedule",
    "warmup_linear_schedule",
    "compress_tree",
    "compressed_psum",
    "decompress_tree",
    "dequantize_int8",
    "ef_compress",
    "init_error_state",
    "quantize_int8",
]
