"""yi-9b — Yi-9B [arXiv:2403.04652].

48L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000, llama-arch GQA.
"""

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="yi-9b",
        family="dense",
        n_layers=48,
        d_model=4096,
        vocab=64000,
        n_heads=32,
        n_kv_heads=4,
        rope_theta=10000.0,
        d_ff=11008,
        norm_eps=1e-5,
        dtype="bfloat16",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="yi-smoke",
        family="dense",
        n_layers=2,
        d_model=64,
        vocab=256,
        n_heads=8,
        n_kv_heads=2,
        d_ff=128,
        dtype="float32",
    )
