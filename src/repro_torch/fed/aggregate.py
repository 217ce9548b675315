"""Deterministic federated aggregation — the committed computation (a
copy of ``repro.fed.aggregate``).

Everything here is plain float32/float64 numpy on the host: the
aggregation an executor commits must be bit-reproducible by any auditor
holding the same inputs (the per-edge delta manifests retained in the
chunk store), in either package, so no device math and no wall-clock
anywhere on this path.  Trees flatten through ``core.ledger``'s
``tree_flatten`` (the JAX package's sorted-key leaf order); a leaf may
be a numpy array or a tensor on any device (copied to the host).

Two rules:

- ``fedavg``: the undefended baseline — sample-count-weighted average of
  every received delta.  One gradient-scaled poison is enough to wreck
  the global model.
- ``defended``: median-norm clipping (a delta's global scale is bounded
  by ``clip_mult`` x the received median norm — caps gradient-scaling
  influence) followed by a coordinate-median cosine screen (a delta
  pointing *against* the received median direction — the sign-flip
  attack — is rejected outright).  The surviving set is fedavg'd with
  renormalized weights.

Conservation invariant (property-tested): the aggregated delta is a
convex combination of the accepted (clipped) deltas — the mixing
coefficients always sum to 1 over the accepted subset, whatever subset
of edges actually arrived.  An empty accepted set aggregates to the
zero delta (the round is a no-op, never a crash).

``commit_rows`` flattens an aggregated parameter set into the
``(num_experts + 1, P)`` tensor the aggregator commits through
``commit_outputs`` (row ``e`` = expert ``e``'s parameters, last row =
the gate, zero-padded): Merkle leaves are contiguous parameter chunks,
and a fraud proof pinpoints the expert whose aggregated weights were
tampered with.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np

from repro_torch.core.ledger import (as_numpy, digest_bytes, tree_flatten,
                                     tree_unflatten)
from repro_torch.trust.commitments import MerkleTree


def tree_to_flat(tree) -> np.ndarray:
    """Flatten a tree of arrays into one float32 vector (``tree_flatten``
    order — deterministic for a fixed tree structure)."""
    leaves, _ = tree_flatten(tree)
    return np.concatenate(
        [np.asarray(as_numpy(leaf), np.float32).ravel() for leaf in leaves])


def flat_to_tree(flat: np.ndarray, like):
    """Inverse of ``tree_to_flat`` against a template tree."""
    leaves, _ = tree_flatten(like)
    out, off = [], 0
    for leaf in leaves:
        shape = tuple(leaf.shape)
        n = int(np.prod(shape)) if shape else 1
        out.append(np.asarray(flat[off:off + n],
                              np.float32).reshape(shape))
        off += n
    if off != len(flat):
        raise ValueError(f"flat vector has {len(flat)} entries, template "
                         f"needs {off}")
    return tree_unflatten(like, out)


@dataclasses.dataclass
class AggregationInfo:
    """What the rule decided, for the round block and the attack bench."""
    accepted: List[int]                # indices into the received list
    rejected: List[int]                # screened out (cosine test)
    clip: List[float]                  # per-delta scale factor applied
    coeffs: List[float]                # mixing weight per received delta
    #                                    (0 for rejected; sums to 1 over
    #                                     accepted unless all rejected)
    norms: List[float]                 # pre-clip delta norms


def aggregate(base, deltas: Sequence, weights: Sequence[float], *,
              rule: str = "defended", clip_mult: float = 3.0,
              cos_min: float = 0.0) -> Tuple[Dict, AggregationInfo]:
    """Aggregate ``deltas`` (trees matching ``base``) onto ``base``.

    Returns ``(new_params, info)`` with ``new_params`` an all-float32
    numpy tree.  Deterministic: float64 accumulation, float32 result.
    """
    if not deltas:
        flat = tree_to_flat(base).astype(np.float64)
        return flat_to_tree(flat.astype(np.float32), base), AggregationInfo(
            accepted=[], rejected=[], clip=[], coeffs=[], norms=[])
    if len(deltas) != len(weights):
        raise ValueError(f"{len(deltas)} deltas, {len(weights)} weights")
    flats = np.stack([tree_to_flat(d) for d in deltas]).astype(np.float64)
    w = np.asarray(weights, np.float64)
    m = len(deltas)
    norms = np.linalg.norm(flats, axis=1)
    if rule == "fedavg":
        clip = np.ones(m)
        accepted = list(range(m))
    elif rule == "defended":
        med = float(np.median(norms))
        clip = np.ones(m)
        if med > 0:
            clip = np.minimum(1.0, clip_mult * med
                              / np.maximum(norms, 1e-12))
        clipped = flats * clip[:, None]
        mu = np.median(clipped, axis=0)
        mu_norm = float(np.linalg.norm(mu))
        accepted = []
        for i in range(m):
            ni = float(np.linalg.norm(clipped[i]))
            if ni == 0.0 or mu_norm == 0.0:
                cos = 1.0              # a zero delta (or degenerate
                #                        median) carries no direction to
                #                        screen against — keep it
            else:
                cos = float(clipped[i] @ mu) / (ni * mu_norm)
            if cos >= cos_min:
                accepted.append(i)
        flats = clipped
    else:
        raise ValueError(f"unknown aggregation rule {rule!r}")
    coeffs = np.zeros(m)
    if accepted:
        wa = w[accepted]
        total = float(wa.sum())
        coeffs[accepted] = (wa / total if total > 0
                            else np.full(len(accepted),
                                         1.0 / len(accepted)))
    agg = (coeffs[:, None] * flats).sum(axis=0)
    new_flat = tree_to_flat(base).astype(np.float64) + agg
    info = AggregationInfo(
        accepted=accepted,
        rejected=[i for i in range(m) if i not in accepted],
        clip=[float(c) for c in clip],
        coeffs=[float(c) for c in coeffs],
        norms=[float(n) for n in norms])
    return flat_to_tree(new_flat.astype(np.float32), base), info


# ------------------------------------------------------- commitment view
def commit_rows(params, num_experts: int) -> np.ndarray:
    """The aggregated result as the ``(N + 1, P)`` float32 tensor the
    aggregator commits: row ``e`` is expert ``e``'s flattened parameters,
    the last row is the flattened gate, both zero-padded to the common
    width ``P``.  Chunking the P axis gives Merkle leaves that are
    contiguous parameter slices of one object — a fraud proof names the
    expert (or the gate) whose aggregated weights are wrong."""
    eleaves = [np.asarray(as_numpy(leaf), np.float32)
               for leaf in tree_flatten(params["experts"])[0]]
    expert_rows = [np.concatenate([leaf[e].ravel() for leaf in eleaves])
                   for e in range(num_experts)]
    gate_row = tree_to_flat(params["gate"])
    width = max(len(expert_rows[0]), len(gate_row))
    rows = np.zeros((num_experts + 1, width), np.float32)
    for e, row in enumerate(expert_rows):
        rows[e, :len(row)] = row
    rows[num_experts, :len(gate_row)] = gate_row
    return rows


def make_recompute(store, base, records, like, num_experts: int, *,
                   rule: str, clip_mult: float, cos_min: float):
    """Eager ``RecomputeFn`` for auditing one aggregation round: fetch
    every participant's delta by its COMMITTED manifest CID (retained for
    the challenge window), re-run the rule, and serve the requested slice
    of the recomputed ``commit_rows``.  The full recompute is cached —
    per-leaf audit cost after the first sampled leaf is a slice."""
    cache: Dict[str, np.ndarray] = {}

    def recompute(e: int, sl: slice) -> np.ndarray:
        rows = cache.get("rows")
        if rows is None:
            deltas = [store.fetch_manifest(
                store.manifest_by_cid(rec.manifest_cid), like)
                for rec in records]
            new, _ = aggregate(base, deltas,
                               [rec.num_samples for rec in records],
                               rule=rule, clip_mult=clip_mult,
                               cos_min=cos_min)
            rows = commit_rows(new, num_experts)
            cache["rows"] = rows
        return rows[e, sl]

    return recompute


def aggregation_root(participants: Sequence[int],
                     manifest_cids: Sequence[str],
                     result_root: str) -> str:
    """The on-chain aggregation commitment: one Merkle root over
    (participant set, per-edge delta manifest CIDs, aggregated-result
    commitment root) — anyone holding the round block can check that an
    auditor's inputs are exactly the committed ones."""
    leaves = [digest_bytes(b"fed-participants:"
                           + ",".join(str(p) for p in participants).encode())]
    leaves += [digest_bytes(b"fed-delta:" + cid.encode())
               for cid in manifest_cids]
    leaves.append(digest_bytes(b"fed-result:" + result_root.encode()))
    return MerkleTree(leaves).root


def aggregation_task_digest(round_id: int, participants: Sequence[int],
                            manifest_cids: Sequence[str], rule: str,
                            clip_mult: float, cos_min: float,
                            base_digest: str) -> str:
    """Binds the committed computation: which deltas, which rule, which
    base parameters.  Travels in the result commitment's task digest."""
    blob = "|".join([
        f"round={round_id}", f"rule={rule}", f"clip={clip_mult!r}",
        f"cos={cos_min!r}", f"base={base_digest}",
        "participants=" + ",".join(str(p) for p in participants),
        "cids=" + ",".join(manifest_cids)])
    return digest_bytes(b"fed-task:" + blob.encode())
