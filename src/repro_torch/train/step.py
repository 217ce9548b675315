"""Train, prefill and decode step builders for the LM stack (the
counterpart of ``repro.train.step``).

- ``make_train_step(cfg, opt_cfg, mesh=None, attack=None, remat=True)``:
  ``(params, opt_state, batch) -> (params, opt_state, metrics)``, the
  loss (``lm_loss`` plus the MoE aux loss), its gradients over
  ``train_microbatches`` microbatches and one AdamW update, in place;
- ``make_loss_and_grads(cfg, remat=True, mesh=None, attack=None)``:
  ``(params, batch) -> (loss, aux, grads)``, the step without the update,
  and ``apply_update``, the update;
- ``make_prefill_step(cfg, mesh=None, attack=None)``: ``(params, batch)
  -> next token (B, 1)``, the full-sequence forward and the argmax of the
  last position;
- ``make_decode_step(cfg, expert_stats=False, mesh=None)``: ``(params,
  caches, batch) -> (next token (B,), caches)``, one token through the
  caches, and with ``expert_stats`` also the per-MoE-layer routed-token
  counts;
- ``make_serve_chunk_step(cfg, expert_stats=False, mesh=None)``: the
  serving engine's fused macro-step, C masked greedy decode micro-steps;
- ``make_step(cfg, kind, mesh=None)``: one of the first three by name;
- ``make_fed_local_step(num_experts, top_k, lr, apply_all)``: a federated
  edge's SGD step on the B-MoE gate and expert bank (``repro_torch.fed``).

On the card the training step's attention, RG-LRU, SSD and MoE products
run their kernels forward and backward (``kernels.ops``); the federated
step's dense mixture is plain products, as in the JAX package.

Under a mesh (``launch.mesh.LMMesh``) every rank runs the same step
(SPMD): it is given the whole global batch and keeps its rows of each
microbatch (split over pod x data); ``params`` is this rank's tree
(``sharding.shard_params`` or ``init_model(mesh=)``: every leaf
placed as the JAX package's specs say, FSDP's
``embed`` over pod x data for training and for inference where
``use_fsdp`` asks for it, tensor and expert parallelism over ``model``;
either placement runs in any step).  The layers gather FSDP leaves per
block and run tensor-parallel (``models.transformer``,
``models.encdec``).  MoE layers run
expert-parallel (``moe_impl="ep"``) or with the B-MoE vote hook
(``core.trusted_moe.make_trust``, built when the config's redundancy is
on).  Each rank's objective is its rows' mean cross-entropy over the
batch ranks plus the aux loss (the global batch's, from summed routing
statistics); an FSDP leaf's gradient is reduce-scattered over the batch
ranks by its gather's backward, every other leaf's is all-reduced over
them after the backward, so every rank holds its part of the global
batch's gradient; replicas and model ranks are not reduced (a leaf
split over ``model`` holds its own part, a replicated one the same
gradient on every model rank, by the layers' f/g exchanges).  The
reported loss is the global batch's.
Decode and the serving chunk take the global batch too and keep its rows
(all of them when the config is not ``batch_shardable``: batch-1
long-context decode); their caches are this rank's
(``sharding.shard_caches``), and the next tokens they return, gathered
over the batch ranks, are the global batch's on every rank.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import experts as ex
from repro_torch.core.ledger import tree_flatten, tree_unflatten
from repro_torch.core.trusted_moe import make_trust
from repro_torch.models import encdec
from repro_torch.models import transformer as tfm
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw
from repro_torch.sharding import leaf_splits, step_sharder

# the parameter subtrees whose leaves stack layers on their leading axis
_STACKED = ("blocks", "enc_blocks", "dec_blocks")


def _mesh_hooks(cfg: ModelConfig, mesh, attack, kind: str):
    """(sharder, trust hook) of a step of ``kind`` on ``mesh``; (None,
    None) without one.  The hook is built for training only, as in the
    JAX package."""
    if mesh is None:
        return None, None
    shard = step_sharder(cfg, mesh, kind, attack)
    trust = None
    if kind == "train" and cfg.redundancy.mode != "off":
        expert_sharded = cfg.num_experts % mesh.shape[-1] == 0
        trust = make_trust(mesh, cfg.redundancy, expert_sharded, attack)
    return shard, trust


def _local_rows(batch, mesh, cfg=None):
    """This rank's rows of every tensor of a global ``batch`` (a decode
    batch's scalar ``pos`` is every row's)."""
    if mesh is None:
        return batch
    n = next(v.shape[0] for v in batch.values() if getattr(v, "ndim", 0))
    lo, hi = mesh.batch_rows(n, cfg)
    return {k: (v[lo:hi] if getattr(v, "ndim", 0) else v)
            for k, v in batch.items()}


def _gather_rows(t, mesh, cfg, dim: int = 0):
    """The global batch's ``t`` from this rank's rows along ``dim``
    (gathered over the batch ranks; ``t`` itself when the batch is not
    split)."""
    if mesh is None or not mesh.batch_split(cfg):
        return t
    parts = mesh.batch.all_gather(t, "next_tokens")
    return torch.cat(list(parts), dim=dim)


def model_forward(params, batch, cfg: ModelConfig, remat: bool = False,
                  shard=None, trust=None):
    """Dispatch on architecture family: the encoder-decoder takes
    ``frames``, a VLM the ``patches`` prefix.  Returns (logits, aux,
    labels); a VLM's labels gain -1 (no loss) over the prefix.
    ``remat`` checkpoints each stacked block (the training step's
    choice; prefill and decode have no backward).  ``shard`` and
    ``trust``: a mesh's sharder and vote hook (``tfm.forward_train``;
    ``encdec.forward_train`` takes the sharder alone); ``batch`` is then
    this rank's rows."""
    if cfg.is_encoder_decoder:
        logits, aux = encdec.forward_train(params, batch["frames"],
                                           batch["tokens"], cfg,
                                           shard=shard, remat=remat)
        return logits, aux, batch.get("labels")
    prefix = batch.get("patches")
    logits, aux = tfm.forward_train(params, batch["tokens"], cfg,
                                    shard=shard, trust=trust,
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


def make_loss_and_grads(cfg: ModelConfig, remat: bool = True, mesh=None,
                        attack=None):
    """``(params, batch) -> (loss, aux, grads)``: the training loss
    (``lm_loss`` + aux) and its gradients, a tree shaped like ``params``
    (float32, as ``init_model`` draws them).  With ``train_microbatches`` K > 1
    the batch is cut into K along its first axis and the microbatches run in
    order, each adding its gradient / K into the accumulator (the backward of
    loss / K, JAX's ``acc + g / K`` exactly when K is a power of two) and its
    loss and aux / K into theirs, as JAX's ``scan`` does.  The parameters are
    not modified.  Under ``mesh`` (see the module's docstring) the batch is
    the global one, ``params`` and ``grads`` this rank's trees, and the
    loss the global batch's."""
    K = max(cfg.train_microbatches, 1)
    shard, trust = _mesh_hooks(cfg, mesh, attack, "train")
    nb = mesh.batch.shards if mesh is not None else 1

    def loss_and_grads(params, batch):
        flat, _ = tree_flatten(params)
        grads = tree_unflatten(params, [torch.zeros_like(p) for p in flat])
        leaves = _layer_leaves(params, grads)
        micro = [batch] if K == 1 else [
            {k: v[i * (v.shape[0] // K):(i + 1) * (v.shape[0] // K)]
             for k, v in batch.items()} for i in range(K)]
        loss_acc = aux_acc = None
        for mb in micro:
            logits, aux, labels = model_forward(
                leaves, _local_rows(mb, mesh), cfg, remat, shard, trust)
            ce = tfm.lm_loss(logits, labels, shard=shard)
            del logits
            if nb > 1:
                ce = ce / nb
            loss = ce + aux
            (loss if K == 1 else loss / K).backward()
            loss, aux = loss.detach(), aux.detach()
            if nb > 1:
                loss = mesh.batch.all_reduce(ce.detach().clone(),
                                             "loss") + aux
            if K == 1:
                loss_acc, aux_acc = loss, aux
            else:
                loss_acc = (loss / K if loss_acc is None
                            else loss_acc + loss / K)
                aux_acc = aux / K if aux_acc is None else aux_acc + aux / K
        if nb > 1:                  # FSDP leaves: reduce-scattered
            for g, (_, fsdp) in zip(tree_flatten(grads)[0],
                                    leaf_splits(grads, cfg, mesh)):
                if not fsdp:
                    mesh.batch.all_reduce(g, "grads")
        return loss_acc, aux_acc, grads

    return loss_and_grads


def _global_norm(grads, cfg: ModelConfig, mesh) -> torch.Tensor:
    """The global norm of the whole gradient tree from this rank's part:
    ``adamw.global_norm``'s sum in flatten order, each leaf's squares
    summed over every group that splits it (``model``, the batch ranks)
    and a leaf replicated over a group counted once (on its first
    rank)."""
    splits = leaf_splits(grads, cfg, mesh)
    if not any(m or b for m, b in splits):
        return adamw.global_norm(grads)
    flat, _ = tree_flatten(grads)
    sq = torch.stack([torch.sum(torch.square(g.float())) for g in flat])
    once = torch.tensor([(m or mesh.model.shard == 0)
                         and (b or mesh.batch.shard == 0)
                         for m, b in splits], device=sq.device)
    sq = torch.where(once, sq, torch.zeros((), device=sq.device))
    if any(m for m, _ in splits):
        sq = mesh.model.all_reduce(sq.contiguous(), "grad_norm")
    if any(b for _, b in splits):
        sq = mesh.batch.all_reduce(sq.contiguous(), "grad_norm")
    total = sq[0]
    for i in range(1, len(flat)):
        total = total + sq[i]
    return torch.sqrt(total)


def make_train_step(cfg: ModelConfig, opt_cfg: adamw.AdamWConfig,
                    mesh=None, attack=None, remat: bool = True):
    """``(params, opt_state, batch) -> (params, opt_state, metrics)``:
    ``make_loss_and_grads`` then ``adamw.update``, which overwrites the
    parameters and the moments in place.  Metrics: loss, aux_loss,
    grad_norm, lr (0-dim float32 tensors on the device).  Under ``mesh``
    every rank applies the update to its tree, so the replicated leaves
    stay equal on every rank; ``attack`` (``core.trusted_moe.LMAttack``)
    corrupts the malicious replicas' expert outputs before the vote.  The
    update is a ``torch.profiler`` region named ``adamw.update``, so a
    profiled step shows the optimizer's share of the device time (a few
    microseconds of host time a step otherwise)."""
    loss_and_grads = make_loss_and_grads(cfg, remat, mesh, attack)

    def train_step(params, opt_state, batch):
        loss, aux, grads = loss_and_grads(params, batch)
        params, opt_state, om = apply_update(opt_cfg, cfg, params,
                                             opt_state, grads, mesh)
        return params, opt_state, {"loss": loss, "aux_loss": aux, **om}

    return train_step


def apply_update(opt_cfg: adamw.AdamWConfig, cfg: ModelConfig, params,
                 opt_state, grads, mesh=None):
    """The training step's update of ``make_loss_and_grads``' gradients:
    ``adamw.update`` in place, under a mesh on this rank's parts with the
    global gradient norm; a ``torch.profiler`` region named
    ``adamw.update``.  Returns (params, opt_state, {grad_norm, lr})."""
    kw = {} if mesh is None else {"gnorm": _global_norm(grads, cfg, mesh)}
    with torch.profiler.record_function("adamw.update"):
        return adamw.update(opt_cfg, grads, opt_state, params, **kw)


def make_prefill_step(cfg: ModelConfig, mesh=None, attack=None):
    """``(params, batch) -> next token (B, 1)``.  Under ``mesh`` every rank
    is given the global batch, runs its rows and returns the global
    batch's next tokens (gathered over the batch ranks); MoE layers run
    expert-parallel where the config says so, and the vote runs inside
    them when its redundancy is on (``attack`` then corrupts the
    malicious replicas), as in the JAX package, whose prefill builds no
    trust hook for the other MoE layers."""
    shard, _ = _mesh_hooks(cfg, mesh, attack, "prefill")

    def prefill_step(params, batch):
        logits, _aux, _ = model_forward(params, _local_rows(batch, mesh),
                                        cfg, shard=shard)
        nxt = tfm.vocab_argmax(logits[:, -1:], shard)
        if mesh is not None and mesh.batch.shards > 1:
            nxt = mesh.batch.all_gather(nxt, "next_tokens").reshape(
                -1, nxt.shape[1])
        return nxt

    return prefill_step


def make_decode_step(cfg: ModelConfig, expert_stats: bool = False,
                     mesh=None):
    """The batch carries ``tokens`` (B, 1), ``pos`` as an int (every row
    at the same depth) or a (B,) integer tensor, and an optional (B,)
    bool ``active`` mask: inactive rows run the padded compute but leave
    their caches untouched (decoder-only models; the encoder-decoder
    refuses it).  ``expert_stats=True`` (decoder-only models) makes the
    step return ``(next token, caches, counts (num_moe_layers, E))``:
    what a serving edge's expert cache resolves activated experts
    from.  Under ``mesh`` (see the module's docstring) the batch is the
    global one, ``params`` and ``caches`` this rank's, the returned caches
    this rank's too, and the next tokens and counts the global batch's;
    MoE layers run expert-parallel where the config says so, without the
    vote (the JAX package's decode builds no trust hook)."""
    shard, _ = _mesh_hooks(cfg, mesh, None, "decode")

    def decode_step(params, caches, batch):
        batch = _local_rows(batch, mesh, cfg)
        tokens, pos = batch["tokens"], batch["pos"]
        active = batch.get("active")
        stats = None
        if cfg.is_encoder_decoder:
            if active is not None:
                raise NotImplementedError(
                    "active-slot masking targets decoder-only archs")
            logits, caches = encdec.forward_decode(params, caches, tokens,
                                                   pos, cfg, shard=shard)
        elif expert_stats:
            logits, caches, stats = tfm.forward_decode(
                params, caches, tokens, pos, cfg, shard=shard,
                expert_stats=True, write_mask=active)
        else:
            logits, caches = tfm.forward_decode(
                params, caches, tokens, pos, cfg, shard=shard,
                write_mask=active)
        nxt = _gather_rows(tfm.vocab_argmax(logits[:, -1], shard), mesh,
                           cfg)
        return (nxt, caches) if stats is None else (nxt, caches, stats)

    return decode_step


def make_serve_chunk_step(cfg: ModelConfig, expert_stats: bool = False,
                          mesh=None):
    """The serving engine's fused macro-step (``tfm.forward_serve_chunk``):
    one call runs C engine ticks, prefilling slots chunk-consuming their
    prompts while decoding slots keep generating.

    batch: ``tokens`` (B, C), ``start`` (B,) (last generated token per
    slot), ``pos`` (B,), ``lengths`` (B,) (prompt columns consumed),
    ``adv`` (B,) (micro-steps the slot advances at all; 0 = idle
    padding), integer arrays or tensors.  Returns (out_tokens (C, B)
    int32, caches[, stats]) on the parameters' device.  Under ``mesh``
    as ``make_decode_step``: the global batch in, this rank's caches in
    and out, the global batch's tokens and counts out."""
    if cfg.is_encoder_decoder:
        raise NotImplementedError("serve chunk drives decoder-only archs")
    shard, _ = _mesh_hooks(cfg, mesh, None, "decode")

    def serve_chunk_step(params, caches, batch):
        batch = _local_rows(batch, mesh, cfg)
        out = tfm.forward_serve_chunk(
            params, caches, batch["tokens"], batch["start"], batch["pos"],
            batch["lengths"], batch["adv"], cfg, shard=shard,
            expert_stats=expert_stats)
        return (_gather_rows(out[0], mesh, cfg, dim=1), *out[1:])

    return serve_chunk_step


def make_step(cfg: ModelConfig, kind: str, mesh=None,
              opt_cfg: Optional[adamw.AdamWConfig] = None,
              remat: bool = True, attack=None):
    """The step of ``kind``: "train", "prefill" or "decode"."""
    if kind == "train":
        return make_train_step(cfg, opt_cfg or adamw.AdamWConfig(), mesh,
                               attack, remat=remat)
    if kind == "prefill":
        return make_prefill_step(cfg, mesh, attack)
    if kind == "decode":
        return make_decode_step(cfg, mesh=mesh)
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
