"""qwen2-moe-a2.7b — Qwen1.5-MoE-A2.7B [hf:Qwen/Qwen1.5-MoE-A2.7B].

24L d_model=2048 16H (GQA kv=16) d_ff(expert)=1408 vocab=151936,
MoE: 60 routed experts top-4 + 4 shared experts (shared hidden 4x1408=5632).
"""

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-moe-a2.7b",
        family="moe",
        n_layers=24,
        d_model=2048,
        vocab=151936,
        n_heads=16,
        n_kv_heads=16,
        rope_theta=1_000_000.0,
        d_ff=1408,
        n_experts=60,
        n_experts_padded=64,  # EP over a 16-wide model axis (60 -> 4/device)
        top_k=4,
        d_expert=1408,
        shared_expert_ff=5632,
        norm_eps=1e-6,
        dtype="bfloat16",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-moe-smoke",
        family="moe",
        n_layers=2,
        d_model=64,
        vocab=256,
        n_heads=4,
        n_kv_heads=4,
        d_ff=96,
        n_experts=8,
        top_k=4,
        d_expert=96,
        shared_expert_ff=128,
        dtype="float32",
    )
