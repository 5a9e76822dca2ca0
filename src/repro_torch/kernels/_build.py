"""Build the CUDA kernels with ``nvcc`` at first use and load them with ctypes.

Every ``csrc/*.cu`` is compiled for ``sm_90a`` by its own ``nvcc -c`` (all
started together), and the objects are linked into one shared library with a
plain C interface, against the shared CUDA runtime.  The library lands in
``kernels/_build/`` (listed in ``.gitignore``) under a name that hashes the
sources and flags, so an edited source builds anew and an unchanged one loads
the library already there.
Nothing here runs at import time: the first kernel launch calls :func:`load`.

``nvcc`` is ``$CUDA_HOME/bin/nvcc``, else ``/usr/local/cuda/bin/nvcc``, else
the one on ``PATH``.  A build that fails raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import torch

__all__ = ["CSRC", "BUILD_DIR", "NVCC_FLAGS", "build", "load", "function",
           "check", "stream_of", "last_build"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

#: link as a shared library against the shared CUDA runtime: the dynamic
#: linker binds the library's runtime calls to the libcudart.so.12 PyTorch
#: has loaded, so the process holds one runtime.  (A static link works too:
#: its runtime copy stays private, exporting no symbol and binding none to
#: PyTorch's; ``loader_check --cudart static`` drives the path that way.)
LINK_FLAGS = ("-shared", "-cudart", "shared")

_LIB: Optional[ctypes.CDLL] = None
_FUNCS: Dict[str, ctypes._CFuncPtr] = {}

#: what the last :func:`build` did: library path, seconds, compiler output
last_build: Dict[str, object] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
            "PATH): the port's CUDA kernels are built from source at first use"
        )
    return found


def _sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"librepro_torch_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile and link the kernels unless the library is already built."""
    out = library_path()
    if out.is_file():
        last_build.update(path=str(out), seconds=0.0, log="(already built)")
        return out
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in _sources():
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        logs, failed = [], []
        for src, _, p in procs:
            text, _ = p.communicate(timeout=900)
            logs.append(f"== {src.name}\n{text}")
            if p.returncode != 0:
                failed.append(src.name)
        log = "\n".join(logs)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{log}")
        staged = Path(tmp) / out.name
        lib64 = Path(nvcc).resolve().parent.parent / "lib64"
        link = [nvcc, *NVCC_FLAGS[:2], *LINK_FLAGS,
                "-Xlinker", f"-rpath,{lib64}", "-o", str(staged),
                *(str(obj) for _, obj, _ in procs)]
        r = subprocess.run(link, capture_output=True, text=True, timeout=900)
        if r.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{r.stdout}{r.stderr}")
        os.replace(staged, out)  # atomic: a reader sees no half-written file
    last_build.update(path=str(out), seconds=time.perf_counter() - t0, log=log)
    return out


def load() -> ctypes.CDLL:
    """The kernels' library, built first if needed."""
    global _LIB
    if _LIB is None:
        _LIB = ctypes.CDLL(str(build()))
        _LIB.repro_error_string.argtypes = [ctypes.c_int]
        _LIB.repro_error_string.restype = ctypes.c_char_p
    return _LIB


def function(name: str, argtypes: Sequence) -> ctypes._CFuncPtr:
    """The C entry ``name`` with its argument types declared; returns int."""
    fn = _FUNCS.get(name)
    if fn is None:
        fn = getattr(load(), name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _FUNCS[name] = fn
    return fn


def check(name: str, status: int) -> None:
    """Raise if a C entry returned a CUDA error (a refused launch never runs
    and a later synchronize would not report it)."""
    if status != 0:
        text = load().repro_error_string(status).decode()
        raise RuntimeError(f"CUDA kernel {name} failed: {text} (code {status})")


def stream_of(t: torch.Tensor) -> int:
    """The current stream of ``t``'s device, as the pointer the C entries take."""
    return torch.cuda.current_stream(t.device).cuda_stream
