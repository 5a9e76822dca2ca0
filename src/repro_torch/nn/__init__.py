"""repro_torch.nn — layers of the language models (the port of ``repro.nn``)."""

__all__ = ["attention", "common", "implicit", "layers", "mamba", "moe", "rwkv"]
