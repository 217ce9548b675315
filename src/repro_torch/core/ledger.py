"""Hash-linked ledger (the blockchain layer's data structure).

Each block packages, per the paper's Step 6: the round's task id, the
trusted (majority-agreed) expert-output digests, the CIDs of the updated
experts (training only), the final MoE output digest, and the gating
network digest.  Blocks are linked by SHA-256; ``verify_chain`` detects
any tampering (the paper's tamper-proofing property).

Parameter trees here are nested dicts (lists/tuples also accepted) of
arrays or tensors.  ``tree_flatten`` orders dict keys the way the JAX
package's pytrees do and prints the same treedef string, so a tree
digest (and every storage CID built on it) is byte-identical across the
two packages for the same array bytes.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Any, Dict, List, Optional, Tuple

import numpy as np


def as_numpy(x) -> np.ndarray:
    """Host numpy view of an array or tensor (device tensors are copied
    to the host first)."""
    if hasattr(x, "detach"):                      # torch.Tensor
        return x.detach().cpu().numpy()
    return np.asarray(x)


def tree_flatten(tree) -> Tuple[List[Any], str]:
    """(leaves, treedef string): dicts flatten in sorted-key order, and
    the treedef prints as ``PyTreeDef({'b': *, 'w': *})`` — the string
    the JAX package records for the same structure."""
    leaves: List[Any] = []

    def walk(node) -> str:
        if isinstance(node, dict):
            return "{" + ", ".join(f"{k!r}: {walk(node[k])}"
                                   for k in sorted(node)) + "}"
        if isinstance(node, list):
            return "[" + ", ".join(walk(v) for v in node) + "]"
        if isinstance(node, tuple):
            inner = ", ".join(walk(v) for v in node)
            return f"({inner},)" if len(node) == 1 else f"({inner})"
        if node is None:
            return "None"
        leaves.append(node)
        return "*"

    return leaves, f"PyTreeDef({walk(tree)})"


def tree_unflatten(like, leaves) -> Any:
    """Rebuild ``like``'s structure with ``leaves`` in flatten order."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        if node is None:
            return None
        return next(it)

    return build(like)


def digest_bytes(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def digest_array(x) -> str:
    a = as_numpy(x)
    return digest_bytes(a.tobytes() + str(a.shape).encode() +
                        str(a.dtype).encode())


def digest_tree(tree) -> str:
    """Deterministic digest of a tree of arrays (expert params, etc.)."""
    leaves, treedef = tree_flatten(tree)
    h = hashlib.sha256(treedef.encode())
    for leaf in leaves:
        h.update(digest_array(leaf).encode())
    return h.hexdigest()


@dataclasses.dataclass
class Block:
    index: int
    prev_hash: str
    payload: Dict[str, Any]          # JSON-serializable record
    nonce: int = 0
    timestamp: float = 0.0
    miner: int = -1

    def header_bytes(self) -> bytes:
        return json.dumps(
            {"index": self.index, "prev": self.prev_hash,
             "payload": self.payload, "nonce": self.nonce,
             "miner": self.miner},
            sort_keys=True).encode()

    @property
    def hash(self) -> str:
        return digest_bytes(self.header_bytes())


class Ledger:
    """Append-only chain with integrity verification."""

    def __init__(self):
        genesis = Block(0, "0" * 64, {"genesis": True})
        self.blocks: List[Block] = [genesis]

    @property
    def head(self) -> Block:
        return self.blocks[-1]

    def append(self, block: Block) -> None:
        if block.prev_hash != self.head.hash:
            raise ValueError("block does not extend the chain head")
        if block.index != len(self.blocks):
            raise ValueError("bad block index")
        self.blocks.append(block)

    def verify_chain(self) -> bool:
        for i in range(1, len(self.blocks)):
            if self.blocks[i].prev_hash != self.blocks[i - 1].hash:
                return False
            if self.blocks[i].index != i:
                return False
        return True

    def find(self, **kv) -> Optional[Block]:
        for b in reversed(self.blocks):
            if all(b.payload.get(k) == v for k, v in kv.items()):
                return b
        return None

    def find_all(self, **kv) -> List[Block]:
        """All blocks whose payload matches, chain order."""
        return [b for b in self.blocks
                if all(b.payload.get(k) == v for k, v in kv.items())]
