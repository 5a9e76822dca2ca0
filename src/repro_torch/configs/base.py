"""Model configuration: the port's own copy of the JAX package's ``ModelConfig``.

One frozen :class:`ModelConfig` dataclass, every field as in
``repro/configs/base.py``, so that a configuration compares field for field
with the JAX package's.  Each ``repro_torch/configs/<arch>.py`` exports
``config()`` (the published configuration) and ``smoke_config()`` (a reduced
same-family configuration for CPU tests).  The port carries every
architecture of the JAX package; an unknown one raises :class:`KeyError`.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Optional, Tuple

__all__ = ["ARCH_IDS", "ARCH_ALIASES", "PORTED_ARCHS", "ModelConfig",
           "ShapeConfig", "SHAPES", "get_config", "get_smoke_config", "cells"]

ARCH_IDS = (
    "qwen2_moe_a2_7b",
    "olmoe_1b_7b",
    "granite_8b",
    "minicpm3_4b",
    "smollm_135m",
    "yi_9b",
    "rwkv6_3b",
    "musicgen_large",
    "zamba2_2_7b",
    "pixtral_12b",
)

#: architectures whose family the port runs: all of them
PORTED_ARCHS = ARCH_IDS

ARCH_ALIASES = {a.replace("_", "-"): a for a in ARCH_IDS}


def _normalize(arch: str) -> str:
    """Assignment ids (dashes, dots: ``zamba2-2.7b``) -> module names."""
    return arch.replace("-", "_").replace(".", "_")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # "dense" | "moe" | "mla" | "rwkv6" | "hybrid"
    n_layers: int
    d_model: int
    vocab: int
    # attention
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: Optional[int] = None  # default d_model // n_heads
    rope_theta: float = 10000.0
    pos_kind: str = "rope"  # "rope" | "sinusoidal" (musicgen)
    # mlp
    d_ff: int = 0
    mlp_kind: str = "swiglu"  # "swiglu" | "gelu"
    norm_kind: str = "rmsnorm"  # "rmsnorm" | "layernorm"
    norm_eps: float = 1e-6
    # embeddings / head
    tie_embeddings: bool = False
    emb_scale: float = 1.0  # minicpm3 scale_emb
    logit_scale: float = 1.0  # minicpm3 d_model / dim_model_base
    residual_scale: float = 1.0  # minicpm3 scale_depth / sqrt(n_layers)
    # frontends ([audio]/[vlm]: stub embeddings replace the token embedding)
    frontend: str = "tokens"  # "tokens" | "stub_embeddings"
    # MoE
    n_experts: int = 0
    top_k: int = 0
    d_expert: int = 0
    n_experts_padded: int = 0  # 0 = no padding; qwen2: 64 for EP over 16
    shared_expert_ff: int = 0  # total shared-expert hidden (qwen2: 4 x 1408)
    router_aux_weight: float = 0.01
    # expert-parallel dispatch spec: (batch_mesh_axes, expert_mesh_axis),
    # e.g. (("pod","data"), "model"); () = single-device sort dispatch.
    moe_spec: tuple = ()
    moe_capacity_factor: float = 1.25
    # "gather": tokens model-replicated, experts read their copy, psum combine.
    # "a2a":    tokens seq-sharded over the model axis, all_to_all dispatch +
    #           return (no activation all-gather, no output psum) — the
    #           collective-bound §Perf optimization.
    moe_dispatch: str = "gather"
    # MLA (minicpm3)
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0
    # SSM (mamba2 / rwkv6)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_groups: int = 1
    ssm_expand: int = 2
    ssm_conv: int = 4
    rwkv_head_dim: int = 64
    # hybrid (zamba2)
    shared_attn_every: int = 6
    lora_rank: int = 128
    # numerics / impl selection (xla-space attention variant; pallas executor
    # always uses the flash kernel)
    dtype: str = "float32"
    attn_impl: str = "dense"  # "dense" | "chunked"
    # kv-chunk length for the chunked variant; None -> resolved from the
    # executor's launch-configuration table (core/tuning.py)
    attn_chunk: Optional[int] = None
    # sequence-parallel activation sharding between blocks: a 2-tuple
    # (batch_mesh_axes, seq_mesh_axis), e.g. (("pod","data"), "model");
    # () disables (single-device tests).  Set by the launcher per mesh.
    sp_spec: tuple = ()
    remat: str = "none"  # "none" | "block" — activation checkpointing policy
    scan_layers: bool = True

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim is not None:
            return self.head_dim
        return self.d_model // self.n_heads if self.n_heads else 0

    @property
    def is_attention_free(self) -> bool:
        return self.family == "rwkv6"

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic sequence mixing (SSM / hybrid) — gates long_500k."""
        return self.family in ("rwkv6", "hybrid")


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One shape cell: a global batch of ``seq_len`` tokens and the kind of
    step that takes it."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


#: the JAX package's shape cells, field for field
SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def _module(arch: str):
    arch = _normalize(ARCH_ALIASES.get(arch, arch))
    if arch not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCH_IDS)}")
    return importlib.import_module(f"repro_torch.configs.{arch}")


def get_config(arch: str) -> ModelConfig:
    """The published configuration of ``arch``."""
    return _module(arch).config()


def get_smoke_config(arch: str) -> ModelConfig:
    """The reduced same-family configuration of ``arch`` for CPU tests."""
    return _module(arch).smoke_config()


def cells(arch: str) -> Tuple[str, ...]:
    """The live (arch x shape) cells: long_500k only for sub-quadratic archs."""
    names = ["train_4k", "prefill_32k", "decode_32k"]
    if get_config(arch).supports_long_context:
        names.append("long_500k")
    return tuple(names)
