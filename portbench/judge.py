"""How ``correct`` is decided: the solves of the window against the plain
reference under ``reference/``.

For each sampled solve (b, and the program's x, iterations and reported
residual norm) the reference, in float64 from the benchmark's own host CSR
arrays, works out:

* ``resid_ratio`` — ``||b - A x|| / (reduction_factor ||b||)``: how far x is
  from the stated stop, by the true residual;
* ``resid_max``  — ``max_i |b - A x|_i / (reduction_factor max_i |b_i|)``:
  the same by the largest row, which a fault confined to a few rows (one
  entry of the format wrong) moves by orders of magnitude where the norm
  over every row barely moves;
* ``resid_gap``  — ``| ||b - A x|| - reported | / (reduction_factor ||b||)``:
  whether the residual the program reports is the one its x has;
* ``x_err``      — ``||x - x_ref|| / ||x_ref||``, x_ref the reference's
  iterate after as many iterations (its own preconditioner, worked out again);
* ``iters_gap``  — ``|k - k_ref| / k_ref``, k_ref where the reference stops.

Over every solve of the window: ``unconverged``, the solves that did not
report convergence.  A cell compares the numbers its ``limits/<cell>.json``
lists, each against its own limit (the worst sampled solve; NaN fails).
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch

DTYPES = {"float64": torch.float64, "float32": torch.float32,
          "bfloat16": torch.bfloat16, "float16": torch.float16}


class Reference:
    """The reference's operator and preconditioner, built once (float64
    arithmetic; the preconditioner stored as the configuration states for
    the working precision ``working``)."""

    def __init__(self, parts: dict, host, config: dict, working: str, device,
                 compute: str = "float64"):
        cdt = DTYPES[compute]
        self.compute = cdt
        self.A = parts["operator"].build(host, dtype=cdt, device=device)
        pc = config["program"]["preconditioner"]
        self.M = parts["preconditioner"].build(
            host, pc.get("opts", {}), working=DTYPES[working], compute_dtype=cdt,
            device=device)
        self.cg = parts["solver"]
        self.stop = config["program"]["stop"]

    def solve(self, b: torch.Tensor, keep_at=None):
        return self.cg.solve(self.A.apply, self.M.apply, b, self.stop,
                             dtype=self.compute, keep_at=keep_at)


def sample_numbers(ref64: Reference, b: torch.Tensor, x: torch.Tensor,
                   iterations: int, reported: float) -> Dict[str, float]:
    """The numbers of one solve against the float64 reference."""
    b64 = b.double()
    thr = float(ref64.stop.get("reduction_factor", 1e-6)) * float(b64.norm())
    thr = max(thr, float(ref64.stop.get("abs_tol", 0.0)))
    x64 = x.double()
    res = b64 - ref64.A.apply(x64)
    true = float(res.norm())
    thr_row = (float(ref64.stop.get("reduction_factor", 1e-6))
               * float(b64.abs().max()))
    resid_max = float(res.abs().max()) / thr_row if thr_row > 0 else math.inf
    ref = ref64.solve(b64, keep_at=iterations)
    if ref.x_kept is None:
        x_err = math.inf
    else:
        x_err = float((x64 - ref.x_kept).norm() / ref.x_kept.norm())
    return {
        "resid_ratio": true / thr,
        "resid_max": resid_max,
        "resid_gap": abs(true - reported) / thr,
        "x_err": x_err,
        "iters_gap": abs(iterations - ref.iterations) / max(ref.iterations, 1),
        "iterations": iterations,
        "ref_iterations": ref.iterations,
    }


def worst(samples: List[Dict[str, float]], unconverged: int) -> Dict[str, float]:
    out = {"unconverged": float(unconverged)}
    for key in ("resid_ratio", "resid_max", "resid_gap", "x_err", "iters_gap"):
        vals = [s[key] for s in samples]
        out[key] = (math.nan if any(math.isnan(v) for v in vals)
                    else max(vals, default=math.nan))
    return out


def verdict(numbers: Dict[str, float], limits: dict):
    """``(correct, checks)``: each number the cell compares beside its limit."""
    checks = {}
    ok = True
    for name, lim in limits["numbers"].items():
        v = numbers[name]
        checks[name] = {"value": v, "limit": lim["limit"]}
        if not v <= lim["limit"]:  # NaN fails
            ok = False
    return ok, checks
