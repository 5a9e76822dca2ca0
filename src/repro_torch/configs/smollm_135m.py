"""smollm-135m — SmolLM-135M [hf:HuggingFaceTB/SmolLM-135M].

30L d_model=576 9H (GQA kv=3) d_ff=1536 vocab=49152, llama-arch small,
tied embeddings.  Also the end-to-end training example architecture.
"""

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="smollm-135m",
        family="dense",
        n_layers=30,
        d_model=576,
        vocab=49152,
        n_heads=9,
        n_kv_heads=3,
        rope_theta=10000.0,
        d_ff=1536,
        tie_embeddings=True,
        norm_eps=1e-5,
        dtype="bfloat16",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="smollm-smoke",
        family="dense",
        n_layers=2,
        d_model=48,
        vocab=256,
        n_heads=3,
        n_kv_heads=1,
        d_ff=96,
        tie_embeddings=True,
        dtype="float32",
    )
