"""One federated edge device: local shard, local expert subset, deltas
(the counterpart of ``repro.fed.edge``).

An edge holds a fixed Dirichlet shard of the training set
(``data.synthetic.dirichlet_shards``), on its device, and OWNS a small
subset of the expert bank.  Each round it takes the coordinator's global
parameters, runs a few steps of local SGD with the gradient masked to
its owned experts (``train.step.make_fed_local_step``), and publishes
the resulting weight **delta** — not the weights — as one versioned
object ``fed/delta/{edge}`` through ``ExpertStore.put_version``.  The
masked delta is zero off the edge's expert subset, so the all-zero
chunks dedup against every other edge's upload and the per-round
network cost scales with experts-per-edge, not bank size.

Poisoning attacks live HERE (the adversary is an edge, or an
aggregator colluding with one): ``attack="grad_scale"`` multiplies the
honest delta by ``scale`` (magnitude poisoning), ``"sign_flip"``
negates and scales it (directed poisoning).  Attacks only perturb the
published delta, in float32 numpy on the host as the JAX package does
— local training itself is always honest, so the defended aggregation
rule is the only thing standing between a poison and the global model.

Host traffic per ``local_update``: one upload of the round's batch
indices (drawn up front from the same numpy stream, in the same order),
one download of the delta (every leaf in one flat copy) and one read of
the final loss; the local steps between them never wait on the device.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.ledger import tree_flatten, tree_unflatten
from repro_torch.kernels.ops import resolve_device


@dataclasses.dataclass
class DeltaRecord:
    """What the aggregator knows about one received delta.  The manifest
    CID is what gets committed on-chain — auditors re-fetch the delta by
    CID, so a record is exactly one aggregation input."""
    edge: int
    round_id: int                  # round the delta arrived in
    base_round: int                # global version it was computed against
    manifest_cid: str
    num_samples: int               # FedAvg weight (shard size)
    arrival_s: float               # modeled arrival offset within round
    loss: float                    # edge's final local training loss


def _to_device(tree, device: torch.device):
    """``tree``'s leaves as float32 tensors on ``device`` (numpy arrays
    are copied there; tensors already there are used as they are)."""
    leaves, _ = tree_flatten(tree)
    return tree_unflatten(tree, [
        torch.as_tensor(leaf, dtype=torch.float32, device=device)
        for leaf in leaves])


class FedEdge:
    """Local trainer for one edge, on ``device`` (``None``: the CUDA
    device)."""

    def __init__(self, edge_id: int, x, y, owned: np.ndarray, store,
                 local_step, *, local_steps: int, local_batch: int,
                 seed: int, device=None):
        self.edge_id = edge_id
        self.device = resolve_device(device)
        self.x = torch.as_tensor(np.asarray(x, np.float32),
                                 device=self.device)
        self.y = torch.as_tensor(np.asarray(y, np.int64),
                                 device=self.device)
        self.owned = torch.as_tensor(np.asarray(owned, np.float32),
                                     device=self.device)      # (N,) mask
        self.store = store
        self.local_step = local_step
        self.local_steps = local_steps
        self.local_batch = local_batch
        self.seed = seed

    @property
    def num_samples(self) -> int:
        return len(self.x)

    def local_update(self, global_params, round_id: int, *,
                     attack: Optional[str] = None,
                     attack_scale: float = 1.0) -> Tuple[dict, float]:
        """Train locally from ``global_params`` (numpy arrays or tensors;
        never modified); return ``(delta_tree, final_loss)`` with the
        delta a float32 numpy tree.  Seeded by (seed, edge, round) only —
        a rollback replay that re-runs this round reproduces the delta
        bit-for-bit."""
        start = _to_device(global_params, self.device)
        # every step's batch rows drawn up front, in the JAX package's
        # order, and uploaded once
        rng = np.random.default_rng([self.seed, 3, self.edge_id, round_id])
        n = self.num_samples
        idx = torch.from_numpy(np.stack([
            rng.integers(0, n, size=min(self.local_batch, n))
            for _ in range(self.local_steps)])).to(self.device)
        params, loss = start, torch.zeros((), device=self.device)
        for s in range(self.local_steps):
            params, loss = self.local_step(params, self.x[idx[s]],
                                           self.y[idx[s]], self.owned)
        new, _ = tree_flatten(params)
        old, _ = tree_flatten(start)
        flat = torch.cat([(a - b).reshape(-1) for a, b in zip(new, old)])
        flat = flat.cpu().numpy()
        out, off = [], 0
        for leaf in old:
            size = leaf.numel()
            out.append(flat[off:off + size].reshape(tuple(leaf.shape)))
            off += size
        delta = tree_unflatten(start, out)
        if attack == "grad_scale":
            delta = tree_unflatten(start, [
                np.asarray(d * attack_scale, np.float32) for d in out])
        elif attack == "sign_flip":
            delta = tree_unflatten(start, [
                np.asarray(-attack_scale * d, np.float32) for d in out])
        elif attack is not None and attack != "none":
            raise ValueError(f"unknown update attack {attack!r}")
        return delta, float(loss)

    def publish(self, delta, round_id: int):
        """Upload the round's delta as ``fed/delta/{edge}`` version
        ``round_id`` (chunk-dedup path; zero chunks are shared across
        all edges).  Returns the chunk manifest."""
        return self.store.put_version(
            f"fed/delta/{self.edge_id}", delta, round_id)
