"""portbench — the benchmark of the PyTorch/CUDA port (``repro_torch``).

One command runs one cell::

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything that belongs to one configuration, traffic mix, generator,
reference piece or per-layer metric is a file of its own under this folder,
found by the name ``BENCHMARK.json`` gives it (see ``README.md``).
"""
