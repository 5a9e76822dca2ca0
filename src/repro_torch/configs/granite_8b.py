"""granite-8b — IBM Granite 8B code [arXiv:2405.04324].

36L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=49152, llama-arch.
"""

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="granite-8b",
        family="dense",
        n_layers=36,
        d_model=4096,
        vocab=49152,
        n_heads=32,
        n_kv_heads=8,
        rope_theta=10_000_000.0,
        d_ff=14336,
        norm_eps=1e-5,
        dtype="bfloat16",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="granite-smoke",
        family="dense",
        n_layers=2,
        d_model=64,
        vocab=256,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        dtype="float32",
    )
