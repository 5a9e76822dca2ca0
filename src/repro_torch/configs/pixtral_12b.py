"""pixtral-12b — Pixtral-12B [hf:mistralai/Pixtral-12B-2409; unverified].

Decoder backbone = Mistral-Nemo-style: 40L d_model=5120 32H (GQA kv=8)
head_dim=128 d_ff=14336 vocab=131072.  The Pixtral ViT vision frontend is a
STUB: ``input_specs()`` provides precomputed patch+text embeddings
(B, S, d_model).
"""

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="pixtral-12b",
        family="dense",
        n_layers=40,
        d_model=5120,
        vocab=131072,
        n_heads=32,
        n_kv_heads=8,
        head_dim=128,
        rope_theta=1_000_000.0,
        d_ff=14336,
        frontend="stub_embeddings",
        norm_eps=1e-5,
        dtype="bfloat16",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="pixtral-smoke",
        family="dense",
        n_layers=2,
        d_model=64,
        vocab=256,
        n_heads=4,
        n_kv_heads=2,
        head_dim=32,
        d_ff=128,
        frontend="stub_embeddings",
        dtype="float32",
    )
