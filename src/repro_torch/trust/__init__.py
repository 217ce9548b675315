"""Optimistic commit-challenge-audit trust layer (ported from
``repro.trust``).

One executor edge computes, commits a Merkle root over its per-expert
output chunks, and the result is accepted optimistically; a verifier
pool spot-checks sampled leaves during an asynchronous challenge window.
A mismatch yields a compact fraud proof (Merkle path + recomputed leaf)
checkable against the on-chain root; a confirmed proof slashes the
executor's stake, feeds the reputation ledger, and escalates the round
to the paper's full redundancy vote, the dispute court (on the card,
one launch of the fused vote kernel).

Modules
-------
- ``commitments``: Merkle trees over per-expert output chunks.
- ``audit``: the verifier pool — leaf sampling, recompute, fraud-proof
  construction and verification.
- ``slashing``: stake accounting, reputation feedback and the court.
- ``protocol``: the round state machine (commit -> optimistic accept ->
  async challenge window -> finalize/rollback).
- ``da`` (import directly, as in the JAX package): data-availability
  challenges holding storage replica nodes to the chunks they store.
- ``session``: the serving engine's batched per-tick commitments (one
  Merkle root over every token a tick emits) and each session's
  inclusion paths into them.
"""
from repro_torch.trust.audit import (AuditPlan, AuditReport,
                                     BatchRecomputeFn, FraudProof,
                                     MultiBatchRecomputeFn, VerifierPool,
                                     verify_fraud_proof)
from repro_torch.trust.commitments import (MerklePath, MerkleTree,
                                           RoundCommitment, commit_outputs,
                                           leaf_digest, leaf_digest_batch)
from repro_torch.trust.protocol import (AuditJob, ChallengeWindow,
                                        OptimisticProtocol, RollbackRecord,
                                        RoundPhase, RoundState, TrustConfig)
from repro_torch.trust.session import (SessionLeafRef, TickCommitment,
                                       commit_tick, verify_session_inclusion)
from repro_torch.trust.slashing import DisputeCourt, StakeBook

__all__ = [
    "AuditPlan", "AuditReport", "BatchRecomputeFn", "FraudProof",
    "MultiBatchRecomputeFn", "VerifierPool", "verify_fraud_proof",
    "MerklePath", "MerkleTree", "RoundCommitment", "commit_outputs",
    "leaf_digest", "leaf_digest_batch",
    "AuditJob", "ChallengeWindow", "OptimisticProtocol", "RollbackRecord",
    "RoundPhase", "RoundState", "TrustConfig", "SessionLeafRef",
    "TickCommitment", "commit_tick", "verify_session_inclusion",
    "DisputeCourt", "StakeBook",
]
