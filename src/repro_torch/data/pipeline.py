"""Deterministic, shard-aware, resumable synthetic LM data pipeline: a copy
of ``repro/data/pipeline.py`` (numpy only), whose arrays are the JAX
package's bit for bit.

Design goals (the ones that matter at cluster scale):

* **Determinism**: batch contents are a pure function of (seed, step, shard) —
  a restarted job resumes mid-epoch with identical batches; no filesystem
  state.
* **Sharding**: each data-parallel shard draws its own slice; the global batch
  is the concatenation over shards (``global_step_batch`` assembles it for
  single-host tests; on a cluster each host materializes only its shard).
* **Resumability**: iterator state is just the integer step — checkpointed
  with the train state.

The token stream is a learnable synthetic process (a noisy modular-offset
Markov chain): next = prev + delta (mod V), delta drawn from a fixed small
set with seed-determined probabilities.  A model that learns p(delta) reaches
~H(delta) nats — visibly below the log(V) random floor — so the end-to-end
example can demonstrate real learning.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np

DELTAS = np.array([1, 2, 3, 5, 8], dtype=np.int64)


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    num_shards: int = 1
    seed: int = 0
    stub_embed_dim: int = 0  # >0: emit "embeds" (stub frontends) besides labels


def _shard_batch(cfg: DataConfig) -> int:
    if cfg.global_batch % cfg.num_shards:
        raise ValueError(
            f"global_batch {cfg.global_batch} not divisible by shards {cfg.num_shards}"
        )
    return cfg.global_batch // cfg.num_shards


def _delta_probs(seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed + 7777)
    p = rng.dirichlet(np.ones(len(DELTAS)) * 2.0)
    return p


def shard_batch_np(cfg: DataConfig, step: int, shard: int) -> Dict[str, np.ndarray]:
    """Pure function (seed, step, shard) -> one shard's batch (numpy)."""
    b = _shard_batch(cfg)
    rng = np.random.default_rng(
        np.random.SeedSequence([cfg.seed, step, shard, 0xD47A])
    )
    probs = _delta_probs(cfg.seed)
    start = rng.integers(0, cfg.vocab, size=(b, 1))
    # seq_len + 1 positions; deltas lead INTO each successive token
    deltas = DELTAS[rng.choice(len(DELTAS), p=probs, size=(b, cfg.seq_len))]
    seq = (start + np.concatenate(
        [np.zeros((b, 1), np.int64), np.cumsum(deltas, axis=1)], axis=1
    )) % cfg.vocab  # (b, seq_len + 1)
    tokens = seq[:, :-1].astype(np.int32)
    labels = seq[:, 1:].astype(np.int32)  # labels[t] == tokens[t+1]
    out = {"tokens": tokens, "labels": labels}
    if cfg.stub_embed_dim:
        # stub modality frontend: embeddings derived deterministically from the
        # token stream (hash -> gaussian), stands in for EnCodec/ViT outputs
        e_rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step, shard, 0xE3BED])
        )
        out["embeds"] = e_rng.normal(
            size=(b, cfg.seq_len, cfg.stub_embed_dim)
        ).astype(np.float32)
        del out["tokens"]
    return out


def global_step_batch(cfg: DataConfig, step: int) -> Dict[str, np.ndarray]:
    """Assemble the full global batch (single-host testing path)."""
    shards = [shard_batch_np(cfg, step, s) for s in range(cfg.num_shards)]
    return {k: np.concatenate([s[k] for s in shards], axis=0) for k in shards[0]}


@dataclasses.dataclass
class DataIterator:
    """Resumable iterator; ``state()``/``restore()`` round-trip through ckpt."""

    cfg: DataConfig
    step: int = 0
    shard: Optional[int] = None  # None = assemble the global batch

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        if self.shard is None:
            batch = global_step_batch(self.cfg, self.step)
        else:
            batch = shard_batch_np(self.cfg, self.step, self.shard)
        self.step += 1
        return batch

    def state(self) -> Dict[str, int]:
        return {"step": self.step}

    def restore(self, state: Dict[str, int]) -> None:
        self.step = int(state["step"])


def entropy_floor(cfg: DataConfig) -> float:
    """H(delta): the loss a perfect model of the chain converges to (nats)."""
    p = _delta_probs(cfg.seed)
    return float(-(p * np.log(p)).sum())
