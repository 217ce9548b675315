"""Data-manipulation attacks (paper §III, §V-A(5)).

The paper's adversary: malicious edges "inject random Gaussian noise into
the employed experts in each round", attacking with probability 0.2 per
round; in B-MoE the malicious edges *collude* — they publish identical
manipulated results to maximize their coalition's vote weight (§V-B).

The port draws from seeded ``torch.Generator``s, not JAX's threefry keys,
so its draws differ from the JAX package's for the same seed.  The draw
is kept apart from the arithmetic: ``BMoESystem`` draws the round's
attack mask and noise here, and the forward takes them as tensors, so a
test can hand both packages the same numbers.  Every stream is a CPU
generator, so a draw does not depend on the device the model runs on.
"""
from __future__ import annotations

import dataclasses
import hashlib

import torch


@dataclasses.dataclass(frozen=True)
class AttackConfig:
    malicious_edges: tuple = ()       # edge indices controlled by adversary
    attack_prob: float = 0.2          # per-round attack probability (paper)
    noise_std: float = 5.0            # Gaussian manipulation magnitude
    colluding: bool = True            # identical manipulated results (paper)
    poison_params: bool = False       # also corrupt uploaded expert params

    @property
    def num_malicious(self) -> int:
        return len(self.malicious_edges)


def stream(*parts) -> torch.Generator:
    """A CPU generator seeded from ``parts`` (e.g. seed, round, tag): the
    same parts give the same stream, different parts independent ones."""
    key = "/".join(str(p) for p in parts).encode()
    seed = int.from_bytes(hashlib.sha256(key).digest()[:8], "little")
    return torch.Generator(device="cpu").manual_seed(seed & (2**63 - 1))


def round_attack_mask(atk: AttackConfig, num_edges: int,
                      gen: torch.Generator) -> torch.Tensor:
    """(num_edges,) float32 mask on the CPU: 1.0 where the edge attacks
    this round."""
    mal = torch.zeros(num_edges)
    if atk.malicious_edges:
        mal[list(atk.malicious_edges)] = 1.0
    if atk.colluding:
        # coalition attacks together (one coin flip per round)
        flip = torch.rand((), generator=gen) < atk.attack_prob
        return mal * flip.float()
    flips = torch.rand(num_edges, generator=gen) < atk.attack_prob
    return mal * flips.float()


def edge_noise(atk: AttackConfig, num_edges: int, shape: tuple,
               *stream_parts) -> torch.Tensor:
    """(num_edges, *shape) standard normal draws, one stream per edge.
    A colluding coalition shares fold id 0, so its copies are identical
    (the JAX package's ``fold_in(key, where(colluding, 0, m))``)."""
    shape = tuple(shape)
    if atk.colluding:
        shared = torch.randn(shape, generator=stream(*stream_parts, 0))
        return shared.expand((num_edges,) + shape).clone()
    return torch.stack([torch.randn(shape, generator=stream(*stream_parts, m))
                        for m in range(num_edges)])
