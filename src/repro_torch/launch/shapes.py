"""Assigned input shapes and their abstract stand-ins per architecture
(the counterpart of ``repro.launch.shapes``).

INPUT SHAPES (assigned):
  train_4k       seq_len=  4,096  global_batch= 256  (training)
  prefill_32k    seq_len= 32,768  global_batch=  32  (inference-prefill)
  decode_32k     seq_len= 32,768  global_batch= 128  (inference-decode)
  long_500k      seq_len=524,288  global_batch=   1  (long-context-decode)

``input_specs`` returns meta tensors (no memory) for every model input:
tokens and labels for training; frame or patch embeddings for the stubbed
audio and vision frontends; KV caches and one token for decode, with each
input's partition spec (a tuple per dimension of mesh axis names, tuples
of names or None: ``sharding.Sharder.spec``'s form) where JAX gives a
``NamedSharding``.  ``applicable`` encodes the documented skip: long_500k
only for sub-quadratic architectures.

A mesh here is any object with ``axis_names`` and ``shape`` (an
``LMMesh``, abstract or not): the rules read nothing else, so no process
group is needed.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from repro_torch.models import encdec as encdec_lib
from repro_torch.models import transformer as tfm
from repro_torch.models.builder import abstract, partition_specs
from repro_torch.models.config import ModelConfig
from repro_torch.sharding import logical_rules, use_fsdp

SHAPES = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="decode", seq=524288, batch=1),
}

# encoder memory length used for enc-dec decode shapes (frames already
# encoded at prefill time; cross-KV precomputed in the cache)
ENCDEC_DECODE_MEMORY = 4096


def applicable(cfg: ModelConfig, shape_name: str) -> Tuple[bool, str]:
    if shape_name == "long_500k" and not cfg.subquadratic:
        return False, ("pure full-attention KV cache at 500k has no native "
                       "sub-quadratic variant (DESIGN.md §6 skip)")
    return True, ""


def shape_info(shape) -> dict:
    """A ``SHAPES`` entry by name, or the dict itself."""
    return SHAPES[shape] if isinstance(shape, str) else shape


def shape_config(cfg: ModelConfig, shape) -> ModelConfig:
    """Per-shape config adjustments (decode-cache sharding axes)."""
    info = shape_info(shape)
    if info["kind"] == "decode":
        axes = ("data", "model") if info["batch"] == 1 else ("model",)
        return dataclasses.replace(cfg, cache_seq_axes=axes,
                                   batch_shardable=info["batch"] > 1)
    return cfg


def _tok(batch, seq):
    return torch.empty((batch, seq), dtype=torch.int32, device="meta")


def input_specs(cfg: ModelConfig, shape, *, mesh=None,
                dtype: torch.dtype = torch.bfloat16):
    """Returns (args: tuple of abstract step inputs (after params),
    specs: the matching tree of partition specs, or None without a
    mesh).  ``shape`` is a ``SHAPES`` name or such a dict."""
    info = shape_info(shape)
    B, S = info["batch"], info["seq"]
    rules = logical_rules(mesh, cfg)
    bspec = rules.get("batch")

    def ns(spec):
        return spec if mesh is not None else None

    def emb(n):
        return torch.empty((B, n, cfg.d_model), dtype=dtype, device="meta")

    if info["kind"] in ("train", "prefill"):
        if cfg.is_encoder_decoder:
            batch = {"frames": emb(S), "tokens": _tok(B, S)}
            shard = {"frames": ns((bspec, None, None)),
                     "tokens": ns((bspec, None))}
        elif cfg.frontend == "vision":
            ptoks = min(cfg.frontend_tokens, S // 2)
            batch = {"patches": emb(ptoks), "tokens": _tok(B, S - ptoks)}
            shard = {"patches": ns((bspec, None, None)),
                     "tokens": ns((bspec, None))}
        else:
            batch = {"tokens": _tok(B, S)}
            shard = {"tokens": ns((bspec, None))}
        if info["kind"] == "train":
            batch["labels"] = _tok(B, batch["tokens"].shape[1])
            shard["labels"] = ns((bspec, None))
        return (batch,), (shard,)

    # ---- decode: caches + one token
    if cfg.is_encoder_decoder:
        cdecl = encdec_lib.encdec_cache_decl(cfg, B, S, ENCDEC_DECODE_MEMORY)
    else:
        cdecl = tfm.cache_decl(cfg, B, S)
    caches = abstract(cdecl, dtype)
    cache_shard = partition_specs(cdecl, rules) if mesh is not None else None
    batch = {"tokens": _tok(B, 1),
             "pos": torch.empty((), dtype=torch.int32, device="meta")}
    bshard = {"tokens": ns((bspec, None)), "pos": ns(())}
    return (caches, batch), (cache_shard, bshard)


def param_decl(cfg: ModelConfig):
    return (encdec_lib.encdec_decl(cfg) if cfg.is_encoder_decoder
            else tfm.model_decl(cfg))


def abstract_params(cfg: ModelConfig, *, mesh=None,
                    dtype: torch.dtype = torch.bfloat16,
                    kind: str = "train"):
    """(abstract params, partition-spec tree or None).  The specs are
    JAX's: FSDP parameter rules, ``embed`` left whole unless
    ``use_fsdp`` says the step needs it."""
    decl = param_decl(cfg)
    params = abstract(decl, dtype)
    if mesh is None:
        return params, None
    rules = logical_rules(mesh, cfg, params=True)   # FSDP param rules
    if not use_fsdp(cfg, kind, mesh.shape[-1]):
        rules["embed"] = None                       # replicate over data
    return params, partition_specs(decl, rules)


def abstract_opt_state(params_abs, params_shard, mesh=None):
    """AdamW state stand-ins: m, v shaped (and specified) like params,
    float32; the step an int32 scalar."""
    from repro_torch.core.ledger import tree_flatten, tree_unflatten
    from repro_torch.optim.adamw import AdamWState
    leaves, _ = tree_flatten(params_abs)

    def f32():
        return tree_unflatten(params_abs, [
            torch.empty(t.shape, dtype=torch.float32, device="meta")
            for t in leaves])

    state = AdamWState(step=torch.empty((), dtype=torch.int32,
                                        device="meta"), m=f32(), v=f32())
    if mesh is None:
        return state, None
    return state, AdamWState(step=(), m=params_shard, v=params_shard)
