"""rwkv6-3b — RWKV-6 Finch 3B [arXiv:2404.05892], attention-free.

32L d_model=2560 d_ff=8960 vocab=65536, head_dim=64 (40 heads),
data-dependent per-channel decay, LoRA rank 96 (48 in each time-mix LoRA),
layernorm.
"""

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-3b",
        family="rwkv6",
        n_layers=32,
        d_model=2560,
        vocab=65536,
        d_ff=8960,
        rwkv_head_dim=64,
        lora_rank=96,
        norm_kind="layernorm",
        norm_eps=1e-5,
        dtype="bfloat16",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-smoke",
        family="rwkv6",
        n_layers=2,
        d_model=64,
        vocab=256,
        d_ff=128,
        rwkv_head_dim=16,
        lora_rank=16,
        norm_kind="layernorm",
        dtype="float32",
    )
