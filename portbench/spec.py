"""``BENCHMARK.json``: loading, the contract's shape rules, and finding each
cell's files by name.

A cell (an entry of ``workloads``) names a configuration and a traffic mix.
The harness finds, by those names alone:

* ``configs/<config>.json``   — the configuration (problem, program, reference);
* ``traffic/<traffic>.json``  — the traffic mix;
* ``limits/<workload>.json``  — the limits of the numbers ``correct`` compares;
* ``metrics/<metric>.py``     — one reader per metric (end-to-end and per-layer);
* ``generators/<name>.py`` and ``reference/<name>.py`` — named inside a
  configuration.

So a later cell, configuration or metric is new files and new entries only.
"""

from __future__ import annotations

import importlib.util
import json
import re
import sys
from pathlib import Path
from typing import Dict, List

ROOT = Path(__file__).resolve().parent.parent

NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH_RE = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES_E2E = {"host_clock", "device_trace"}
SOURCES = SOURCES_E2E | {"program_span", "program_counter"}

TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}
CONFIG_KEYS = {"name", "source", "file", "reduced", "why"}
WORKLOAD_KEYS = {"name", "config", "traffic", "chips", "why"}
E2E_KEYS = {"name", "unit", "better", "bound", "source"}
LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves"}

#: the contract's check budget: 2 + 14 runs a cell, each run_seconds + 60 s,
#: 2 x 90 s of compilation a cell, 1200 s spare, within 43200 s, at 24 cells
MAX_CELLS = 24


def load(root: Path = ROOT) -> dict:
    with open(Path(root) / "BENCHMARK.json") as f:
        return json.load(f)


def _line(text) -> bool:
    return (isinstance(text, str) and 1 <= len(text) <= 200
            and "\n" not in text and "\t" not in text)


def validate(spec: dict, root: Path = ROOT) -> List[str]:
    """Every breach of the contract's shape rules, as messages (empty: none)."""
    root = Path(root)
    errs: List[str] = []
    if set(spec) != TOP_KEYS:
        errs.append(f"top-level keys {sorted(spec)} != {sorted(TOP_KEYS)}")
        return errs
    cmd, paths = spec["command"], spec["paths"]
    if not (isinstance(cmd, list) and 1 <= len(cmd) <= 32
            and all(_line(w) for w in cmd)):
        errs.append("command must be 1 to 32 one-line words")
    if not (isinstance(paths, list) and 1 <= len(paths) <= 16):
        errs.append("paths must hold 1 to 16 directories")
        paths = []
    for p in paths:
        if (not PATH_RE.match(p) or p.startswith("/") or ".." in p.split("/")
                or not (root / p).is_dir()):
            errs.append(f"bad path {p!r}")
    for w in cmd:
        if w.startswith("/") or ".." in w.split("/"):
            errs.append(f"command word {w!r} leaves the checkout")
        elif (root / w).exists() and not any(
                w == p or w.startswith(p.rstrip("/") + "/") for p in paths):
            errs.append(f"command names {w!r} outside paths")
    rs = spec["run_seconds"]
    if not (isinstance(rs, int) and 1 <= rs <= 51):
        errs.append("run_seconds must be a whole number from 1 to 51")
    elif 2 * MAX_CELLS * 90 + (2 + 14 * MAX_CELLS) * (rs + 60) + 1200 > 43200:
        errs.append(f"run_seconds {rs} does not fit the check with {MAX_CELLS} cells")

    names = {}
    for section, keys in (("configs", CONFIG_KEYS), ("workloads", WORKLOAD_KEYS),
                          ("end_to_end", E2E_KEYS), ("per_layer", LAYER_KEYS)):
        items = spec[section]
        lo, hi = {"configs": (1, 24), "workloads": (1, 24),
                  "end_to_end": (1, 16), "per_layer": (1, 128)}[section]
        if not (isinstance(items, list) and lo <= len(items) <= hi):
            errs.append(f"{section} must hold {lo} to {hi} entries")
            continue
        seen = set()
        allowed = keys | ({"workloads"} if section in ("end_to_end", "per_layer")
                          else set())
        for it in items:
            if not keys <= set(it) <= allowed:
                errs.append(f"{section} entry {it.get('name')!r} has keys {sorted(it)}")
            name = it.get("name", "")
            if not NAME_RE.match(str(name)):
                errs.append(f"bad name {name!r} in {section}")
            if name in seen:
                errs.append(f"duplicate name {name!r} in {section}")
            seen.add(name)
        names[section] = seen
    if errs:
        return errs
    if names["end_to_end"] & names["per_layer"]:
        errs.append("a metric name is both end-to-end and per-layer")

    for c in spec["configs"]:
        if not _line(c["source"]) or not _line(c["why"]):
            errs.append(f"config {c['name']}: source and why are one line of 1-200")
        f = c["file"]
        if not (PATH_RE.match(f) and any(f.startswith(p.rstrip("/") + "/")
                                          for p in paths) and (root / f).is_file()):
            errs.append(f"config {c['name']}: file {f!r} not under paths")
        if not (isinstance(c["reduced"], list) and len(c["reduced"]) <= 16
                and all(NAME_RE.match(k) for k in c["reduced"])):
            errs.append(f"config {c['name']}: bad reduced")
        if not any(w["config"] == c["name"] for w in spec["workloads"]):
            errs.append(f"config {c['name']} is used by no cell")
    if len({c["file"] for c in spec["configs"]}) != len(spec["configs"]):
        errs.append("two configurations share a file")

    pairs = set()
    for w in spec["workloads"]:
        if w["config"] not in names["configs"]:
            errs.append(f"cell {w['name']}: unknown config {w['config']!r}")
        if not NAME_RE.match(str(w["traffic"])):
            errs.append(f"cell {w['name']}: bad traffic name")
        if w["chips"] not in (1, 4):
            errs.append(f"cell {w['name']}: chips must be 1 or 4")
        if not _line(w["why"]):
            errs.append(f"cell {w['name']}: why must be one line of 1-200")
        pair = (w["config"], w["traffic"])
        if pair in pairs:
            errs.append(f"cell {w['name']}: config and traffic pair repeated")
        pairs.add(pair)
    four = sum(w["chips"] == 4 for w in spec["workloads"])
    if four > max(1, len(spec["workloads"]) // 4):
        errs.append("too many four-chip cells")

    cells = names["workloads"]
    e2e_names = names["end_to_end"]
    for m in spec["end_to_end"] + spec["per_layer"]:
        if not UNIT_RE.match(str(m["unit"])):
            errs.append(f"metric {m['name']}: bad unit {m['unit']!r}")
        if m["better"] not in ("lower", "higher"):
            errs.append(f"metric {m['name']}: better must be lower or higher")
        for w in m.get("workloads", []):
            if w not in cells:
                errs.append(f"metric {m['name']}: unknown cell {w!r}")
    for m in spec["end_to_end"]:
        if m["source"] not in SOURCES_E2E:
            errs.append(f"metric {m['name']}: end-to-end source {m['source']!r}")
        b = m["bound"]
        if not (isinstance(b, (int, float)) and 0.01 <= b <= 0.25):
            errs.append(f"metric {m['name']}: bound {b} outside [0.01, 0.25]")
    if "setup_s" not in e2e_names:
        errs.append("setup_s is missing")
    for m in spec["per_layer"]:
        if m["source"] not in SOURCES:
            errs.append(f"metric {m['name']}: source {m['source']!r}")
        if not _line(m["layer"]):
            errs.append(f"metric {m['name']}: layer must be one line of 1-200")
        if m["moves"] not in e2e_names:
            errs.append(f"metric {m['name']}: moves unknown {m['moves']!r}")
    for w in cells:
        e2e = [m for m in spec["end_to_end"] if w in m.get("workloads", cells)]
        if not any(m["name"] == "setup_s" for m in e2e) or len(e2e) < 2:
            errs.append(f"cell {w}: needs setup_s and another end-to-end metric")
        if not any(w in m.get("workloads", cells) for m in spec["per_layer"]):
            errs.append(f"cell {w}: no per-layer metric")
        for m in spec["per_layer"]:
            if w in m.get("workloads", cells) and not any(
                    e["name"] == m["moves"] for e in e2e):
                errs.append(f"cell {w}: {m['name']} moves a metric it lacks")
    if len(json.dumps(spec).encode()) > 64 * 1024:
        errs.append("BENCHMARK.json is over 64 KiB")
    return errs


def workload(spec: dict, name: str) -> dict:
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config_entry(spec: dict, name: str) -> dict:
    for c in spec["configs"]:
        if c["name"] == name:
            return c
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def metrics_for(spec: dict, cell: str, trace: bool) -> List[dict]:
    """The metrics a run of ``cell`` reports: per-layer with ``--trace 1``,
    end-to-end otherwise."""
    section = spec["per_layer"] if trace else spec["end_to_end"]
    return [m for m in section if cell in m.get("workloads", [cell])]


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, tag: str):
    """Import one file of the benchmark by path (names may hold dots)."""
    mod_name = "portbench_" + tag + "_" + re.sub(r"\W", "_", path.stem)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod  # dataclasses look their module up
    spec.loader.exec_module(mod)
    return mod


def cell_files(spec: dict, cell: str, root: Path = ROOT) -> Dict[str, object]:
    """Everything one cell needs, found by name."""
    root = Path(root)
    bench = root / "portbench"
    w = workload(spec, cell)
    cfg = read_json(root / config_entry(spec, w["config"])["file"])
    return {
        "workload": w,
        "config": cfg,
        "traffic": read_json(bench / "traffic" / f"{w['traffic']}.json"),
        "limits": read_json(bench / "limits" / f"{cell}.json"),
        "generator": load_module(
            bench / "generators" / f"{cfg['problem']['generator']}.py", "gen"),
        "reference": {part: load_module(bench / "reference" / f"{name}.py", "ref")
                      for part, name in cfg["reference"].items()},
        "metrics": {m["name"]: load_module(bench / "metrics" / f"{m['name']}.py",
                                           "metric")
                    for m in spec["end_to_end"] + spec["per_layer"]
                    if cell in m.get("workloads", [cell])},
    }
