"""Train, prefill and decode step builders for the LM stack (the
counterpart of ``repro.train.step``).

- ``make_train_step(cfg, opt_cfg, remat=True)``: ``(params, opt_state,
  batch) -> (params, opt_state, metrics)``, the loss (``lm_loss`` plus
  the MoE aux loss), its gradients over ``train_microbatches``
  microbatches and one AdamW update, in place;
- ``make_loss_and_grads(cfg, remat=True)``: ``(params, batch) -> (loss,
  aux, grads)``, the step without the update;
- ``make_prefill_step(cfg)``: ``(params, batch) -> next token (B, 1)``,
  the full-sequence forward and the argmax of the last position;
- ``make_decode_step(cfg, expert_stats=False)``: ``(params, caches,
  batch) -> (next token (B,), caches)``, one token through the caches,
  and with ``expert_stats`` also the per-MoE-layer routed-token counts;
- ``make_serve_chunk_step(cfg, expert_stats=False)``: the serving
  engine's fused macro-step, C masked greedy decode micro-steps;
- ``make_step(cfg, kind)``: one of the first three by name;
- ``make_fed_local_step(num_experts, top_k, lr, apply_all)``: a federated
  edge's SGD step on the B-MoE gate and expert bank (``repro_torch.fed``).

On the card the training step's attention, RG-LRU, SSD and MoE products
run their kernels forward and backward (``kernels.ops``); the federated
step's dense mixture is plain products, as in the JAX package.  A mesh
(ROADMAP A7b) is not ported.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import experts as ex
from repro_torch.core.ledger import tree_flatten, tree_unflatten
from repro_torch.models import encdec
from repro_torch.models import transformer as tfm
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw

# the parameter subtrees whose leaves stack layers on their leading axis
_STACKED = ("blocks", "enc_blocks", "dec_blocks")


def _refuse_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError("a device mesh is not ported yet (ROADMAP "
                                  "A7b): the port trains on one device")


def model_forward(params, batch, cfg: ModelConfig, remat: bool = False):
    """Dispatch on architecture family: the encoder-decoder takes
    ``frames``, a VLM the ``patches`` prefix.  Returns (logits, aux,
    labels); a VLM's labels gain -1 (no loss) over the prefix.
    ``remat`` checkpoints each stacked block (the training step's
    choice; prefill and decode have no backward)."""
    if cfg.is_encoder_decoder:
        logits, aux = encdec.forward_train(params, batch["frames"],
                                           batch["tokens"], cfg,
                                           remat=remat)
        return logits, aux, batch.get("labels")
    prefix = batch.get("patches")
    logits, aux = tfm.forward_train(params, batch["tokens"], cfg,
                                    prefix_embeds=prefix, remat=remat)
    labels = batch.get("labels")
    if prefix is not None and labels is not None:
        labels = torch.as_tensor(labels)
        ignore = torch.full(prefix.shape[:2], -1, dtype=labels.dtype,
                            device=labels.device)
        labels = torch.cat([ignore, labels], dim=1)
    return logits, aux, labels


def _layer_leaves(params, grads):
    """The tree the training forward reads: every leaf a detached tensor
    that requires a gradient and whose ``.grad`` is preset to the matching
    view of ``grads``; a stacked leaf becomes a list of its layers, which
    the forward indexes as it indexes the stacked tensor.  Autograd then
    accumulates each layer's gradient in place into its slice of
    ``grads`` (a preset ``.grad`` is added to, not replaced), with no
    full-size gradient of a stacked leaf per layer."""
    def leaf(p, g):
        t = p.detach().requires_grad_(True)
        t.grad = g
        return t

    def walk(p, g, stacked):
        if isinstance(p, dict):
            return {k: walk(p[k], g[k], stacked or k in _STACKED)
                    for k in p}
        if isinstance(p, list):
            return [walk(a, b, stacked) for a, b in zip(p, g)]
        if stacked:
            return [leaf(p[i], g[i]) for i in range(p.shape[0])]
        return leaf(p, g)

    return walk(params, grads, False)


def make_loss_and_grads(cfg: ModelConfig, remat: bool = True):
    """``(params, batch) -> (loss, aux, grads)``: the training loss
    (``lm_loss`` + aux) and its gradients, a tree shaped like ``params``
    (float32, as ``init_model`` draws them).  With ``train_microbatches`` K > 1
    the batch is cut into K along its first axis and the microbatches run in
    order, each adding its gradient / K into the accumulator (the backward of
    loss / K, JAX's ``acc + g / K`` exactly when K is a power of two) and its
    loss and aux / K into theirs, as JAX's ``scan`` does.  The parameters are
    not modified."""
    K = max(cfg.train_microbatches, 1)

    def loss_and_grads(params, batch):
        flat, _ = tree_flatten(params)
        grads = tree_unflatten(params, [torch.zeros_like(p) for p in flat])
        leaves = _layer_leaves(params, grads)
        micro = [batch] if K == 1 else [
            {k: v[i * (v.shape[0] // K):(i + 1) * (v.shape[0] // K)]
             for k, v in batch.items()} for i in range(K)]
        loss_acc = aux_acc = None
        for mb in micro:
            logits, aux, labels = model_forward(leaves, mb, cfg, remat)
            loss = tfm.lm_loss(logits, labels) + aux
            del logits
            (loss if K == 1 else loss / K).backward()
            loss, aux = loss.detach(), aux.detach()
            if K == 1:
                loss_acc, aux_acc = loss, aux
            else:
                loss_acc = (loss / K if loss_acc is None
                            else loss_acc + loss / K)
                aux_acc = aux / K if aux_acc is None else aux_acc + aux / K
        return loss_acc, aux_acc, grads

    return loss_and_grads


def make_train_step(cfg: ModelConfig, opt_cfg: adamw.AdamWConfig,
                    mesh=None, remat: bool = True):
    """``(params, opt_state, batch) -> (params, opt_state, metrics)``:
    ``make_loss_and_grads`` then ``adamw.update``, which overwrites the
    parameters and the moments in place.  Metrics: loss, aux_loss,
    grad_norm, lr (0-dim float32 tensors on the device).  ``mesh`` must be
    None (ROADMAP A7b).  The update is a ``torch.profiler`` region named
    ``adamw.update``, so a profiled step shows the optimizer's share of
    the device time (a few microseconds of host time a step otherwise)."""
    _refuse_mesh(mesh)
    loss_and_grads = make_loss_and_grads(cfg, remat)

    def train_step(params, opt_state, batch):
        loss, aux, grads = loss_and_grads(params, batch)
        with torch.profiler.record_function("adamw.update"):
            params, opt_state, om = adamw.update(opt_cfg, grads, opt_state,
                                                 params)
        return params, opt_state, {"loss": loss, "aux_loss": aux, **om}

    return train_step


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


def make_step(cfg: ModelConfig, kind: str, mesh=None,
              opt_cfg: Optional[adamw.AdamWConfig] = None,
              remat: bool = True):
    """The step of ``kind``: "train", "prefill" or "decode"."""
    _refuse_mesh(mesh)
    if kind == "train":
        return make_train_step(cfg, opt_cfg or adamw.AdamWConfig(),
                               remat=remat)
    if kind == "prefill":
        return make_prefill_step(cfg)
    if kind == "decode":
        return make_decode_step(cfg)
    raise ValueError(kind)


# ------------------------------------------------------- federated edge
def make_fed_local_step(num_experts: int, top_k: int, lr: float,
                        apply_all):
    """Local SGD update for one federated edge (``repro_torch.fed``).

    The edge runs the full-bank dense MoE forward (gate top-k mixture
    over ``apply_all``'s (N, B, C) outputs) but its gradient is masked
    to the experts it OWNS: unowned experts receive exactly zero update,
    so the edge's published delta is zero (and chunk-dedups away) off
    its expert subset.  The gate is trained by every edge.

    Returns ``step(params, x, y, owned) -> (params, loss)`` where
    ``params = {"gate", "experts"}`` (tensors on one device), ``x`` is
    (B, in_dim), ``y`` (B,) int64 labels and ``owned`` a float (N,)
    ownership mask, all on that device.  The step is functional: it
    returns new tensors and leaves ``params`` as they were (the
    coordinator's global state and round snapshots are shared by every
    edge), and its loss stays a 0-dim tensor on the device (no host
    sync).
    """

    def moe_loss(params, x, y):
        logits = ex.gate_apply(params["gate"], x)
        w, _ = ex.sparse_gate_weights(logits, top_k)
        outs = apply_all(params["experts"], x)        # (N, B, C)
        mix = torch.einsum("bn,nbc->bc", w, outs)
        logp = torch.log_softmax(mix, dim=-1)
        return -logp.gather(1, y[:, None]).mean()

    def local_step(params, x, y, owned):
        leaves, _ = tree_flatten(params)
        live = [p.detach().requires_grad_(True) for p in leaves]
        tree = tree_unflatten(params, live)
        with torch.enable_grad():
            loss = moe_loss(tree, x, y)
            grads = torch.autograd.grad(loss, live)
        g = tree_unflatten(params, list(grads))

        def mask_expert(gr):
            return gr * owned.reshape((num_experts,) + (1,) * (gr.ndim - 1))

        with torch.no_grad():
            new = {
                "gate": {k: params["gate"][k] - lr * g["gate"][k]
                         for k in params["gate"]},
                "experts": {k: params["experts"][k]
                            - lr * mask_expert(g["experts"][k])
                            for k in params["experts"]},
            }
        return new, loss.detach()

    return local_step
