"""repro_torch.models — the language models (the port of ``repro.models``)."""
