"""olmoe-1b-7b — OLMoE-1B-7B [arXiv:2409.02060].

16L d_model=2048 16H (GQA kv=16) d_ff(expert)=1024 vocab=50304,
MoE: 64 experts top-8, no shared experts.
"""

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="olmoe-1b-7b",
        family="moe",
        n_layers=16,
        d_model=2048,
        vocab=50304,
        n_heads=16,
        n_kv_heads=16,
        rope_theta=10000.0,
        d_ff=1024,
        n_experts=64,
        top_k=8,
        d_expert=1024,
        shared_expert_ff=0,
        norm_eps=1e-5,
        dtype="bfloat16",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="olmoe-smoke",
        family="moe",
        n_layers=2,
        d_model=64,
        vocab=256,
        n_heads=4,
        n_kv_heads=4,
        d_ff=64,
        n_experts=8,
        top_k=2,
        d_expert=64,
        dtype="float32",
    )
