"""Model initialisation and the training loop (the counterpart of
``repro.train.loop``)."""
from __future__ import annotations

import time
from typing import Callable, Iterator, Optional

import torch

from repro_torch.models import encdec
from repro_torch.models import transformer as tfm
from repro_torch.models.builder import materialize
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw
from repro_torch.sharding import place_leaf
from repro_torch.train.step import make_train_step


def init_model(cfg: ModelConfig, seed: int = 0, device=None, mesh=None):
    """Random float32 parameters for ``cfg`` from ``seed``, drawn on
    ``device`` (``None``: the CUDA device).  Under ``mesh`` this rank's
    tree (``sharding.shard_params`` of the one-device tree, each expert
    leaf cut as it is drawn)."""
    decl = (encdec.encdec_decl(cfg) if cfg.is_encoder_decoder
            else tfm.model_decl(cfg))
    return materialize(decl, seed, device, place=place_leaf(cfg, mesh))


def train(cfg: ModelConfig, batches: Iterator[dict], steps: int, *,
          opt_cfg: Optional[adamw.AdamWConfig] = None, seed: int = 0,
          mesh=None, log_every: int = 10, remat=False,
          callback: Optional[Callable] = None, device=None):
    """Returns (params, history).  ``batches`` yields dicts with tokens
    and labels (and frames or patches by family), host or device
    tensors, moved to the parameters' device.  The model is
    ``init_model(cfg, seed, device, mesh)`` (``device`` ``None``: the
    CUDA device).  ``history`` holds a record every ``log_every`` steps
    and at the last: the step's metrics (loss, aux_loss, grad_norm, lr)
    as floats, ``step`` and ``wall_s``, as in the JAX package; reading
    them is the loop's only host sync.  Under ``mesh``
    (``launch.mesh.LMMesh``) every rank of the world calls ``train``
    alike: ``batches`` yields the global batches, the parameters are this
    rank's, and the metrics (the global batch's) are the same on every
    rank."""
    opt_cfg = opt_cfg or adamw.AdamWConfig(total_steps=steps)
    params = (init_model(cfg, seed, device) if mesh is None
              else init_model(cfg, seed, device, mesh=mesh))
    dev = params["embed"].device
    opt_state = adamw.init(params)
    step_fn = make_train_step(cfg, opt_cfg, mesh, remat=remat)
    history = []
    t0 = time.time()
    for step in range(steps):
        batch = {k: torch.as_tensor(v).to(dev) for k, v in
                 next(batches).items()}
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        if step % log_every == 0 or step == steps - 1:
            m = {k: float(v) for k, v in metrics.items()}
            m["step"] = step
            m["wall_s"] = time.time() - t0
            history.append(m)
            if callback:
                callback(m)
    return params, history
