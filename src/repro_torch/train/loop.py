"""Model initialisation (the counterpart of ``repro.train.loop``; the
training loop itself waits for LM training, ROADMAP A4.4)."""
from __future__ import annotations

from repro_torch.models import encdec
from repro_torch.models import transformer as tfm
from repro_torch.models.builder import materialize
from repro_torch.models.config import ModelConfig


def init_model(cfg: ModelConfig, seed: int = 0, device=None):
    """Random float32 parameters for ``cfg`` from ``seed``, drawn on
    ``device`` (``None``: the CUDA device)."""
    decl = (encdec.encdec_decl(cfg) if cfg.is_encoder_decoder
            else tfm.model_decl(cfg))
    return materialize(decl, seed, device)
