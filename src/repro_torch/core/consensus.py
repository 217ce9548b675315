"""Blockchain-layer consensus (paper §IV-A Step 3, §IV-B).

Two mechanisms:

- ``majority_vote``: the off-chain redundancy consensus — given the R
  copies of an expert's result published by the edges, accept the most
  consistent one.  Honest edges publish bit-identical results; colluding
  malicious edges publish identical *manipulated* results; the larger
  coalition wins (threshold 50%, paper §IV-B scenario 2).

- ``ProofOfWork``: on-chain block generation.  Difficulty is reduced vs
  real chains (this is a single-process simulation); the hash-target
  semantics match Bitcoin-style PoW, and mining power per node is
  configurable so the >50% on-chain attack (scenario 1) is testable.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np

from repro_torch.core.ledger import Block, digest_array


# ----------------------------------------------------- majority vote
@dataclasses.dataclass
class VoteResult:
    winner: int                 # index of an edge in the majority coalition
    support: int                # size of the majority coalition
    total: int
    digests: List[str]
    accepted: bool              # support > total/2 (paper's threshold)


def majority_vote(results: Sequence[np.ndarray], atol: float = 0.0) -> VoteResult:
    """Pick the most consistent result among ``results`` (one per edge).

    Equality is digest-based when ``atol == 0`` (the paper's setting:
    honest results are bit-identical), else within-tolerance agreement
    counting (robust to nondeterministic accelerators).
    """
    n = len(results)
    if atol == 0.0:
        digests = [digest_array(r) for r in results]
        counts = {}
        for d in digests:
            counts[d] = counts.get(d, 0) + 1
        best = max(counts, key=counts.get)
        winner = digests.index(best)
        support = counts[best]
    else:
        digests = []
        agree = np.zeros((n, n), dtype=np.int32)
        for i in range(n):
            for j in range(n):
                agree[i, j] = np.allclose(results[i], results[j], atol=atol)
        support_per = agree.sum(axis=1)
        winner = int(support_per.argmax())
        support = int(support_per[winner])
    return VoteResult(winner=winner, support=int(support), total=n,
                      digests=digests, accepted=support * 2 > n)


# ------------------------------------------------------------- PoW
class ProofOfWork:
    """Simulated PoW over the blockchain nodes.

    ``mining_power[i]`` = relative hash rate of node i.  ``mine`` picks
    the winning miner proportionally to power (the expected outcome of
    the race) and then *actually* grinds a nonce meeting the difficulty
    target, so block hashes are verifiable.
    """

    def __init__(self, num_nodes: int, difficulty_bits: int = 12,
                 mining_power: Sequence[float] | None = None, seed: int = 0):
        self.num_nodes = num_nodes
        self.difficulty_bits = difficulty_bits
        power = np.asarray(mining_power if mining_power is not None
                           else np.ones(num_nodes), dtype=np.float64)
        self.power = power / power.sum()
        self._rng = np.random.default_rng(seed)

    def _meets_target(self, block_hash: str) -> bool:
        return int(block_hash, 16) >> (256 - self.difficulty_bits) == 0

    def mine(self, index: int, prev_hash: str, payload: dict) -> Block:
        miner = int(self._rng.choice(self.num_nodes, p=self.power))
        block = Block(index=index, prev_hash=prev_hash, payload=payload,
                      miner=miner)
        nonce = 0
        while True:
            block.nonce = nonce
            if self._meets_target(block.hash):
                return block
            nonce += 1

    def verify(self, block: Block) -> bool:
        return self._meets_target(block.hash)
