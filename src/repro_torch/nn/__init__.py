"""repro_torch.nn — layers of the language models (the port of ``repro.nn``)."""
