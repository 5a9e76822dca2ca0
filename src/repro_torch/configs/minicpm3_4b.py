"""minicpm3-4b — MiniCPM3-4B [hf:openbmb/MiniCPM3-4B], MLA attention.

62L d_model=2560 40H d_ff=6400 vocab=73448.
MLA: q_lora_rank=768, kv_lora_rank=256, qk_nope=64, qk_rope=32, v_head=64.
MiniCPM scaling: scale_emb=12, scale_depth=1.4 (residual 1.4/sqrt(62)),
logits scaled by dim_model_base/d_model = 256/2560.
"""

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    n_layers = 62
    return ModelConfig(
        name="minicpm3-4b",
        family="mla",
        n_layers=n_layers,
        d_model=2560,
        vocab=73448,
        n_heads=40,
        n_kv_heads=40,
        rope_theta=10000.0,
        d_ff=6400,
        q_lora_rank=768,
        kv_lora_rank=256,
        qk_nope_head_dim=64,
        qk_rope_head_dim=32,
        v_head_dim=64,
        emb_scale=12.0,
        logit_scale=256.0 / 2560.0,
        residual_scale=1.4 / (n_layers ** 0.5),
        norm_eps=1e-6,
        dtype="bfloat16",
    )


def smoke_config() -> ModelConfig:
    n_layers = 2
    return ModelConfig(
        name="minicpm3-smoke",
        family="mla",
        n_layers=n_layers,
        d_model=64,
        vocab=256,
        n_heads=4,
        n_kv_heads=4,
        d_ff=128,
        q_lora_rank=32,
        kv_lora_rank=16,
        qk_nope_head_dim=16,
        qk_rope_head_dim=8,
        v_head_dim=16,
        emb_scale=12.0,
        logit_scale=0.25,
        residual_scale=1.4 / (n_layers ** 0.5),
        dtype="float32",
    )
