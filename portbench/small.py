"""Each cell's size for the CPU tests: ``small/<cell>.json`` holds the
overrides that ``harness.run_cell`` merges into the cell's configuration,
traffic and limits, so that a test run on the CPU holds the cell (the
problem cut, the stated sizes dropped).  A new cell brings its own file;
the result, fault and control tests find it by the cell's name."""

from pathlib import Path

from portbench import spec


def path(cell: str, root: Path = spec.ROOT) -> Path:
    return Path(root) / "portbench" / "small" / f"{cell}.json"


def overrides(cell: str, root: Path = spec.ROOT) -> dict:
    return spec.read_json(path(cell, root))
