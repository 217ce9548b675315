"""Prefill and decode step builders for the LM stack (the counterpart of
``repro.train.step``).

- ``make_prefill_step(cfg)``: ``(params, batch) -> next token (B, 1)``,
  the full-sequence forward and the argmax of the last position;
- ``make_decode_step(cfg)``: ``(params, caches, batch) -> (next token
  (B,), caches)``, one token through the caches.

Training steps wait for an attention backward kernel (ROADMAP A4.4);
the federated local step waits for federated training (A6).
"""
from __future__ import annotations

from repro_torch.models import transformer as tfm
from repro_torch.models.config import ModelConfig


def model_forward(params, batch, cfg: ModelConfig):
    """Dispatch on architecture family.  Returns (logits, aux, labels)."""
    if cfg.is_encoder_decoder:
        raise NotImplementedError("encoder-decoder models are not ported "
                                  "yet: ROADMAP A4.3")
    prefix = batch.get("patches")
    logits, aux = tfm.forward_train(params, batch["tokens"], cfg,
                                    prefix_embeds=prefix)
    return logits, aux, batch.get("labels")


def make_prefill_step(cfg: ModelConfig):
    def prefill_step(params, batch):
        logits, _aux, _ = model_forward(params, batch, cfg)
        return logits[:, -1:].argmax(dim=-1)

    return prefill_step


def make_decode_step(cfg: ModelConfig, expert_stats: bool = False):
    """The batch carries ``tokens`` (B, 1), ``pos`` as an int (every row
    at the same depth) or a (B,) integer tensor, and an optional (B,)
    bool ``active`` mask: inactive rows run the padded compute but leave
    their caches untouched."""
    if expert_stats:
        raise NotImplementedError("expert_stats needs LM MoE layers: "
                                  "ROADMAP A4.2")
    if cfg.is_encoder_decoder:
        raise NotImplementedError("encoder-decoder models are not ported "
                                  "yet: ROADMAP A4.3")

    def decode_step(params, caches, batch):
        logits, caches = tfm.forward_decode(
            params, caches, batch["tokens"], batch["pos"], cfg,
            write_mask=batch.get("active"))
        return logits[:, -1].argmax(dim=-1), caches

    return decode_step
