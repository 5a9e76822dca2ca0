"""zamba2-2.7b — Zamba2-2.7B hybrid [arXiv:2411.15242].

54L d_model=2560, Mamba2 backbone (ssm_state=64, head_dim=64, expand 2) with a
SHARED attention+MLP block (32H, d_ff=10240) applied every 6 mamba layers over
concat(hidden, original embedding) (width 2*d_model), with per-invocation LoRA
deltas (rank 128) on the shared q/k/v.  vocab=32000.
"""

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-2.7b",
        family="hybrid",
        n_layers=54,
        d_model=2560,
        vocab=32000,
        n_heads=32,
        n_kv_heads=32,
        d_ff=10240,
        ssm_state=64,
        ssm_head_dim=64,
        ssm_groups=2,
        ssm_expand=2,
        ssm_conv=4,
        shared_attn_every=6,
        lora_rank=128,
        norm_eps=1e-5,
        dtype="bfloat16",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-smoke",
        family="hybrid",
        n_layers=4,
        d_model=64,
        vocab=256,
        n_heads=4,
        n_kv_heads=4,
        d_ff=128,
        ssm_state=16,
        ssm_head_dim=16,
        ssm_groups=2,
        ssm_expand=2,
        ssm_conv=4,
        shared_attn_every=2,
        lora_rank=8,
        dtype="float32",
    )
