"""Serving steps: the port of ``make_prefill_step`` / ``make_decode_step``
of ``repro/launch/steps.py`` (the training steps are not ported yet).

Each step returns the last position's logits (the next-token distribution)
and the cache, which the model updates in place.  A batch holds
``tokens``, or ``embeds`` for a stub-frontend model.  The steps are
family-neutral: they serve every family ``models.lm`` carries.
"""

from __future__ import annotations

from repro_torch.models import lm

__all__ = ["make_prefill_step", "make_decode_step"]


def make_prefill_step(cfg, executor=None):
    def prefill_step(params, batch, cache):
        logits, cache = lm.prefill(params, cfg, tokens=batch.get("tokens"),
                                   embeds=batch.get("embeds"), cache=cache,
                                   executor=executor)
        # a copy: the (B, S, vocab) logits are freed on return
        return logits[:, -1, :].contiguous(), cache

    return prefill_step


def make_decode_step(cfg, executor=None):
    def decode_step(params, batch, length, cache):
        logits, cache = lm.decode_step(params, cfg, tokens=batch.get("tokens"),
                                       embeds=batch.get("embeds"),
                                       length=length, cache=cache,
                                       executor=executor)
        return logits[:, -1, :], cache

    return decode_step
