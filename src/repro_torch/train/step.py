"""Prefill and decode step builders for the LM stack (the counterpart of
``repro.train.step``).

- ``make_prefill_step(cfg)``: ``(params, batch) -> next token (B, 1)``,
  the full-sequence forward and the argmax of the last position;
- ``make_decode_step(cfg, expert_stats=False)``: ``(params, caches,
  batch) -> (next token (B,), caches)``, one token through the caches,
  and with ``expert_stats`` also the per-MoE-layer routed-token counts;
- ``make_serve_chunk_step(cfg, expert_stats=False)``: the serving
  engine's fused macro-step, C masked greedy decode micro-steps.

Training steps wait for an attention backward kernel (ROADMAP A4.4);
the federated local step waits for federated training (A6).
"""
from __future__ import annotations

import torch

from repro_torch.models import encdec
from repro_torch.models import transformer as tfm
from repro_torch.models.config import ModelConfig


def model_forward(params, batch, cfg: ModelConfig):
    """Dispatch on architecture family: the encoder-decoder takes
    ``frames``, a VLM the ``patches`` prefix.  Returns (logits, aux,
    labels); a VLM's labels gain -1 (no loss) over the prefix."""
    if cfg.is_encoder_decoder:
        logits, aux = encdec.forward_train(params, batch["frames"],
                                           batch["tokens"], cfg)
        return logits, aux, batch.get("labels")
    prefix = batch.get("patches")
    logits, aux = tfm.forward_train(params, batch["tokens"], cfg,
                                    prefix_embeds=prefix)
    labels = batch.get("labels")
    if prefix is not None and labels is not None:
        labels = torch.as_tensor(labels)
        ignore = torch.full(prefix.shape[:2], -1, dtype=labels.dtype,
                            device=labels.device)
        labels = torch.cat([ignore, labels], dim=1)
    return logits, aux, labels


def make_prefill_step(cfg: ModelConfig):
    def prefill_step(params, batch):
        logits, _aux, _ = model_forward(params, batch, cfg)
        return logits[:, -1:].argmax(dim=-1)

    return prefill_step


def make_decode_step(cfg: ModelConfig, expert_stats: bool = False):
    """The batch carries ``tokens`` (B, 1), ``pos`` as an int (every row
    at the same depth) or a (B,) integer tensor, and an optional (B,)
    bool ``active`` mask: inactive rows run the padded compute but leave
    their caches untouched (decoder-only models; the encoder-decoder
    refuses it).  ``expert_stats=True`` (decoder-only models) makes the
    step return ``(next token, caches, counts (num_moe_layers, E))``:
    what a serving edge's expert cache resolves activated experts
    from."""

    def decode_step(params, caches, batch):
        tokens, pos = batch["tokens"], batch["pos"]
        active = batch.get("active")
        if cfg.is_encoder_decoder:
            if active is not None:
                raise NotImplementedError(
                    "active-slot masking targets decoder-only archs")
            logits, caches = encdec.forward_decode(params, caches, tokens,
                                                   pos, cfg)
        elif expert_stats:
            logits, caches, stats = tfm.forward_decode(
                params, caches, tokens, pos, cfg, expert_stats=True,
                write_mask=active)
            return logits[:, -1].argmax(dim=-1), caches, stats
        else:
            logits, caches = tfm.forward_decode(params, caches, tokens, pos,
                                                cfg, write_mask=active)
        return logits[:, -1].argmax(dim=-1), caches

    return decode_step


def make_serve_chunk_step(cfg: ModelConfig, expert_stats: bool = False):
    """The serving engine's fused macro-step (``tfm.forward_serve_chunk``):
    one call runs C engine ticks, prefilling slots chunk-consuming their
    prompts while decoding slots keep generating.

    batch: ``tokens`` (B, C), ``start`` (B,) (last generated token per
    slot), ``pos`` (B,), ``lengths`` (B,) (prompt columns consumed),
    ``adv`` (B,) (micro-steps the slot advances at all; 0 = idle
    padding), integer arrays or tensors.  Returns (out_tokens (C, B)
    int32, caches[, stats]) on the parameters' device."""
    if cfg.is_encoder_decoder:
        raise NotImplementedError("serve chunk drives decoder-only archs")

    def serve_chunk_step(params, caches, batch):
        return tfm.forward_serve_chunk(
            params, caches, batch["tokens"], batch["start"], batch["pos"],
            batch["lengths"], batch["adv"], cfg, expert_stats=expert_stats)

    return serve_chunk_step
