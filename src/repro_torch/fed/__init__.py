"""repro_torch.fed — federated B-MoE edge training with verified
aggregation (the counterpart of ``repro.fed``).

Edges train local expert subsets on non-IID Dirichlet shards and
publish weight deltas through the chunk-dedup store; a bonded
aggregator commits a Merkle root over (participants, delta manifest
CIDs, aggregated result) and the trust layer's auditors recompute the
aggregation off-path — dishonest aggregation becomes a fraud proof,
slash and chained rollback.  Rounds tolerate stragglers (deadline +
carry/evict), dropouts (quorum aggregation) and poisoned updates
(median-norm clip + cosine screen).  See ``fed/coordinator.py`` for the
round lifecycle.  Local training runs on the coordinator's device; the
aggregation, its commitment and its audits stay numpy on the host, so
their bytes match the JAX package's.
"""
from repro_torch.fed.aggregate import (AggregationInfo, aggregate,
                                       aggregation_root,
                                       aggregation_task_digest, commit_rows,
                                       flat_to_tree, make_recompute,
                                       tree_to_flat)
from repro_torch.fed.coordinator import FedAttack, FedConfig, FedCoordinator
from repro_torch.fed.edge import DeltaRecord, FedEdge

__all__ = [
    "AggregationInfo", "aggregate", "aggregation_root",
    "aggregation_task_digest", "commit_rows", "flat_to_tree",
    "make_recompute", "tree_to_flat",
    "FedAttack", "FedConfig", "FedCoordinator",
    "DeltaRecord", "FedEdge",
]
