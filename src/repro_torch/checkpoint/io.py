"""Checkpointing (the counterpart of ``repro.checkpoint.io``): a local
npz file, or content-addressed storage through the B-MoE storage layer
with the CID recorded on a ledger when one is given: the paper's Step 5
expert-storage flow applied to whole checkpoints.

A tree is serialized by ``storage.chunks.serialize_tree`` (host copies of
the leaves, dict keys in the JAX package's order, its treedef string), so
the same arrays give the same bytes, digest and CID in both packages: a
checkpoint saved by either restores in the other.  ``restore`` puts each
leaf back as ``like``'s leaf is: a tensor on its device and in its dtype,
or a numpy array.
"""
from __future__ import annotations

import os
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core.ledger import (Block, Ledger, digest_bytes,
                                     tree_flatten, tree_unflatten)
from repro_torch.storage.chunks import deserialize_tree, serialize_tree
from repro_torch.storage.network import StorageNetwork


def _like(tree, like):
    """``tree``'s numpy leaves placed as ``like``'s leaves are."""
    got, _ = tree_flatten(tree)
    want, _ = tree_flatten(like)
    out = [torch.from_numpy(np.array(g)).to(w.device, w.dtype)
           if isinstance(w, torch.Tensor) else g for g, w in zip(got, want)]
    return tree_unflatten(like, out)


def save(path: str, tree: Any) -> str:
    """Save a tree to ``path`` (npz).  Returns the content digest."""
    data = serialize_tree(tree)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(data)
    return digest_bytes(data)


def restore(path: str, like: Any) -> Any:
    with open(path, "rb") as f:
        data = f.read()
    return _like(deserialize_tree(data, like), like)


def save_to_storage(storage: StorageNetwork, tree: Any,
                    ledger: Optional[Ledger] = None,
                    meta: Optional[dict] = None) -> str:
    """Store a checkpoint in the decentralized storage layer; optionally
    record its CID on-chain (a ``{"kind": "checkpoint", "cid"}`` block
    carrying ``meta``).  Returns the CID."""
    cid = storage.put(serialize_tree(tree))
    if ledger is not None:
        payload = dict(meta or {})
        payload.update({"kind": "checkpoint", "cid": cid})
        ledger.append(Block(index=len(ledger.blocks),
                            prev_hash=ledger.head.hash, payload=payload))
    return cid


def restore_from_storage(storage: StorageNetwork, cid: str, like: Any) -> Any:
    return _like(deserialize_tree(storage.get(cid), like), like)
