"""Model initialisation (the counterpart of ``repro.train.loop``; the
training loop itself waits for LM training, ROADMAP A4.4)."""
from __future__ import annotations

from repro_torch.models import transformer as tfm
from repro_torch.models.builder import materialize
from repro_torch.models.config import ModelConfig


def init_model(cfg: ModelConfig, seed: int = 0, device=None):
    """Random float32 parameters for ``cfg`` from ``seed``, drawn on
    ``device`` (``None``: the CUDA device)."""
    if cfg.is_encoder_decoder:
        raise NotImplementedError("encoder-decoder models are not ported "
                                  "yet: ROADMAP A4.3")
    return materialize(tfm.model_decl(cfg), seed, device)
