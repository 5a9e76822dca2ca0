"""repro_torch.launch — entry points run with ``python -m`` (``amg_check``)."""
