"""musicgen-large — MusicGen-Large decoder backbone [arXiv:2306.05284].

48L d_model=2048 32H d_ff=8192 vocab=2048 (EnCodec codebook), decoder-only
over audio tokens.  The EnCodec frontend (4 codebooks + delay pattern) is a
STUB: ``input_specs()`` provides precomputed frame embeddings (B, S, d_model);
the LM head predicts one 2048-way codebook stream (simplification noted in
DESIGN.md).  LayerNorm + GELU + sinusoidal positions per the paper's
standard-transformer decoder.
"""

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="musicgen-large",
        family="dense",
        n_layers=48,
        d_model=2048,
        vocab=2048,
        n_heads=32,
        n_kv_heads=32,
        d_ff=8192,
        mlp_kind="gelu",
        norm_kind="layernorm",
        pos_kind="sinusoidal",
        frontend="stub_embeddings",
        norm_eps=1e-5,
        dtype="bfloat16",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="musicgen-smoke",
        family="dense",
        n_layers=2,
        d_model=64,
        vocab=128,
        n_heads=4,
        n_kv_heads=4,
        d_ff=128,
        mlp_kind="gelu",
        norm_kind="layernorm",
        pos_kind="sinusoidal",
        frontend="stub_embeddings",
        dtype="float32",
    )
