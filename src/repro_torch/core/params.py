"""Hardware parameter tables — the analogue of Ginkgo's per-backend config headers.

One frozen :class:`HardwareParams` per execution target.  The kernel bindings
read it for their launch geometry (subgroup width, threads per block) and the
tuning resolver checks every geometry against ``smem_per_block_bytes``, the
shared memory one CUDA block may claim (the role VMEM plays on a TPU).

The ``h100`` roofline constants are NVIDIA's published numbers for one H100
SXM at its 700 W limit (dense rates, no sparsity).  The CPU targets carry no
roofline constants: nothing in the port measures speed on the CPU.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional


@dataclasses.dataclass(frozen=True)
class HardwareParams:
    """Machine model for one execution target.

    * ``kernel_space``  — the first space the target's executor dispatches into
      (``reference`` / ``torch`` / ``cuda``).
    * ``warp_size``     — lanes that execute in lock step (32 on NVIDIA).
    * ``subgroup_size`` — cooperative-group width inside a warp (Ginkgo's
      subwarp); also the default block-Jacobi block size.
    * ``smem_per_block_bytes`` — shared memory one block may use.
    """

    name: str
    kernel_space: str  # "reference" | "torch" | "cuda"

    warp_size: int = 32
    subgroup_size: int = 8
    smem_per_block_bytes: int = 48 * 1024
    sm_count: Optional[int] = None

    #: roofline constants: HBM bytes/s, f32 (non-tensor-core) flop/s and the
    #: dense bf16 tensor-core flop/s
    hbm_bandwidth: Optional[float] = None
    peak_flops_f32: Optional[float] = None
    peak_flops_bf16: Optional[float] = None
    #: bytes/s one device sends to its peers in one direction over the
    #: device interconnect; None where unknown
    interconnect_bandwidth: Optional[float] = None


H100 = HardwareParams(
    name="h100",
    kernel_space="cuda",
    warp_size=32,
    subgroup_size=8,
    # 227 KB of the SM's 256 KB, reachable as dynamic shared memory
    smem_per_block_bytes=232_448,
    sm_count=132,
    hbm_bandwidth=3.35e12,
    peak_flops_f32=67e12,
    peak_flops_bf16=989e12,
    # NVLink 4: NVIDIA's published 900 GB/s both ways, 450 GB/s a
    # direction; a published figure, not measured on the card
    interconnect_bandwidth=450e9,
)

CPU_TORCH = HardwareParams(name="cpu_torch", kernel_space="torch")

CPU_REFERENCE = dataclasses.replace(
    CPU_TORCH, name="cpu_reference", kernel_space="reference"
)

TARGETS: Mapping[str, HardwareParams] = {
    p.name: p for p in (H100, CPU_TORCH, CPU_REFERENCE)
}


def get_target(name: str) -> HardwareParams:
    try:
        return TARGETS[name]
    except KeyError:
        raise KeyError(
            f"unknown hardware target {name!r}; known: {sorted(TARGETS)}"
        ) from None
