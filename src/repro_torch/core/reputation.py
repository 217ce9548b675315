"""Paper §VI future directions, implemented:

- §VI-B **reputation-aided hybrid consensus**: each blockchain/edge node
  carries a reputation score updated from consensus outcomes (agreeing
  with the accepted majority raises it; publishing rejected results
  slashes it).  Block-generation difficulty is inversely proportional to
  reputation — high-reputation nodes mine with fewer expected hashes
  (modeled as a reputation-scaled effective hash rate), which both
  speeds consensus and incentivizes honesty.

- §VI-C **workload balance**: an auxiliary-free gate-bias controller
  (DeepSeek-V3-style): experts with below-average load get a positive
  routing bias next round, pulling the activation distribution toward
  uniform without touching the loss.

- §VI-D **incentive mechanism**: per-round rewards for majority-consistent
  results, slashing for rejected ones; edges whose reputation falls below
  an exclusion threshold are dropped from task assignment (their expert
  is served by re-assignment), bounding the damage a persistent attacker
  can do even below the 50% coalition threshold.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np


@dataclasses.dataclass
class ReputationConfig:
    init: float = 0.5
    gain: float = 0.05           # reward for majority-consistent result
    slash: float = 0.20          # penalty for rejected result
    floor: float = 0.0
    ceil: float = 1.0
    exclusion_threshold: float = 0.15
    difficulty_scale: int = 4    # max difficulty-bit reduction at rep=1


class ReputationLedger:
    """Per-edge reputation from consensus outcomes (paper §VI-B/D)."""

    def __init__(self, num_edges: int, cfg: ReputationConfig = ReputationConfig()):
        self.cfg = cfg
        self.rep = np.full(num_edges, cfg.init)
        self.rewards = np.zeros(num_edges)
        self.history: List[np.ndarray] = []

    def update_from_flags(self, flags: np.ndarray):
        """flags: (E, M) 1 where edge m's copy of expert e's result matched
        the accepted majority."""
        agree_frac = np.asarray(flags, dtype=np.float64).mean(axis=0)  # (M,)
        delta = np.where(agree_frac >= 0.5,
                         self.cfg.gain * agree_frac,
                         -self.cfg.slash * (1.0 - agree_frac))
        self.rep = np.clip(self.rep + delta, self.cfg.floor, self.cfg.ceil)
        self.rewards += np.where(agree_frac >= 0.5, agree_frac, -1.0)
        self.history.append(self.rep.copy())

    @property
    def excluded(self) -> np.ndarray:
        return self.rep < self.cfg.exclusion_threshold

    def active_edges(self) -> List[int]:
        return [i for i, x in enumerate(self.excluded) if not x]

    def effective_power(self, base_power: Optional[Sequence[float]] = None):
        """Reputation-scaled mining power: difficulty inversely
        proportional to reputation == hash rate scaled by
        2**(difficulty_scale * rep)."""
        base = np.asarray(base_power if base_power is not None
                          else np.ones_like(self.rep), dtype=np.float64)
        return base * np.exp2(self.cfg.difficulty_scale * self.rep)


class WorkloadBalancer:
    """Auxiliary-free gate-bias controller (paper §VI-C).

    bias_i <- bias_i + eta * (mean_load - load_i); the bias is added to
    the gate logits before top-K, steering under-used experts into
    activation without gradient interference."""

    def __init__(self, num_experts: int, eta: float = 0.5):
        self.eta = eta
        self.bias = np.zeros(num_experts, dtype=np.float32)

    def update(self, activation_counts: np.ndarray):
        load = np.asarray(activation_counts, dtype=np.float64)
        total = load.sum()
        if total <= 0:
            return self.bias
        frac = load / total
        self.bias = (self.bias +
                     self.eta * (frac.mean() - frac)).astype(np.float32)
        return self.bias
