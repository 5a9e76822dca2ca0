"""Async, atomic, elastic checkpointing: the port of
``repro/checkpoint/manager.py``, with its layout and guarantees.

Layout::

    <dir>/step_00001000.tmp/    (written)
    <dir>/step_00001000/        (atomic rename on commit)
        manifest.json           keys, shapes, dtypes, user metadata
        arrays.npz              flattened leaves keyed by tree path

* **Atomicity** — readers only ever see committed (renamed) directories; a
  preempted writer leaves only a ``.tmp`` that the next run
  garbage-collects.
* **Async** — ``save()`` copies the leaves to host memory synchronously and
  writes them in a background thread; an error there surfaces on the next
  ``wait()`` (which ``save`` and ``restore`` call first).
* **Elasticity** — arrays are stored whole (logical content, keyed by
  :func:`repro_torch.core.tree.flat`'s paths); ``restore(target=...,
  device=...)`` puts them on any device, so a tree saved from the card
  restores on the CPU, and one saved by rank 0 of a world restores in a
  single process.
* **keep_k** — older committed checkpoints are pruned after each commit.

numpy has no bfloat16: a bf16 leaf is stored as its 16-bit patterns
(``view(torch.int16)``), and the manifest records every leaf's torch dtype.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.core import tree as tree_lib

__all__ = ["CheckpointManager"]


def _to_host(leaf):
    """(numpy array, dtype name) of one leaf."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        name = str(t.dtype).replace("torch.", "")
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return t.cpu().numpy().copy(), name
    a = np.asarray(leaf)
    return a, a.dtype.name


def _to_tensor(a: np.ndarray, dtype_name: str) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(a))
    if dtype_name == "bfloat16":
        return t.view(torch.bfloat16)
    return t.to(getattr(torch, dtype_name))


class CheckpointManager:
    def __init__(self, directory: str, keep_k: int = 3):
        self.directory = directory
        self.keep_k = keep_k
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        os.makedirs(directory, exist_ok=True)
        self._gc_tmp()

    # -- public ------------------------------------------------------------------
    def save(self, step: int, tree: Any, metadata: Optional[Dict] = None, *,
             block: bool = False) -> None:
        """Snapshot ``tree`` to host memory and write it asynchronously."""
        self.wait()  # one in-flight save at a time
        flat, dtypes = {}, {}
        for key, leaf in tree_lib.flat(tree).items():
            flat[key], dtypes[key] = _to_host(leaf)
        rank, world = 0, 1
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            rank, world = dist.get_rank(), dist.get_world_size()
        manifest = {
            "step": int(step),
            "keys": sorted(flat),
            "dtypes": dtypes,
            "shapes": {k: list(v.shape) for k, v in flat.items()},
            "metadata": metadata or {},
            "process_count": world,
            "process_index": rank,
        }
        t = threading.Thread(target=self._write, args=(step, flat, manifest),
                             daemon=True)
        self._thread = t
        t.start()
        if block:
            self.wait()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def all_steps(self):
        steps = []
        for name in os.listdir(self.directory):
            if name.startswith("step_") and not name.endswith(".tmp"):
                try:
                    steps.append(int(name[5:]))
                except ValueError:
                    pass
        return sorted(steps)

    def restore(self, step: Optional[int] = None, *, target: Any = None,
                device=None):
        """Restore a checkpoint: (tree, metadata).

        ``target``: a tree prototype (structure and dtypes) to restore into,
        each leaf put on ``device`` (the prototype leaf's device when None).
        Without a target: {path: tensor} on ``device`` (the CPU when
        None)."""
        self.wait()
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        path = self._step_dir(step)
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        dtypes = manifest["dtypes"]
        with np.load(os.path.join(path, "arrays.npz")) as z:
            flat = {k: _to_tensor(z[k], dtypes[k]) for k in z.files}

        if target is None:
            dev = torch.device(device) if device is not None else torch.device("cpu")
            return {k: v.to(dev) for k, v in flat.items()}, manifest["metadata"]

        missing = set(tree_lib.flat(target)) - set(flat)
        if missing:
            raise KeyError(f"checkpoint {step} missing keys: "
                           f"{sorted(missing)[:5]}...")

        def put(path_, proto):
            arr = flat["/".join(path_)]
            if isinstance(proto, torch.Tensor):
                dev = device if device is not None else proto.device
                return arr.to(device=dev, dtype=proto.dtype)
            return arr.to(device=device) if device is not None else arr

        tree = tree_lib.tree_map_with_path(put, target)
        return tree, manifest["metadata"]

    # -- internals ------------------------------------------------------------------
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:08d}")

    def _write(self, step: int, flat, manifest) -> None:
        try:
            final = self._step_dir(step)
            tmp = final + ".tmp"
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
            np.savez(os.path.join(tmp, "arrays.npz"), **flat)
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f, indent=2)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)  # the commit point
            self._prune()
        except Exception as e:  # surfaced on the next wait()
            self._error = e

    def _prune(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep_k] if self.keep_k else []:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    def _gc_tmp(self) -> None:
        for name in os.listdir(self.directory):
            if name.endswith(".tmp"):
                shutil.rmtree(os.path.join(self.directory, name),
                              ignore_errors=True)
