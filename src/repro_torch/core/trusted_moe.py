"""B-MoE at LM scale: redundant expert execution and a consensus vote
inside the MoE transformer (the counterpart of
``repro.core.trusted_moe``).

Mesh layout (``launch.mesh.LMMesh``): (data, replica, model).  The
``replica`` axis carries the paper's "edges that all compute the
activated experts": the batch is split over data only, so every replica
holds the same tokens and computes the routed experts redundantly, and
the vote communicates only across ``replica``:

- mode="faithful" (the paper): all-gather the expert-output buffer over
  the replicas and vote per expert (one ``ops.redundancy_vote_masked``
  launch over (rows, r, C*d), every replica active).  Each rank sends
  (r-1)/r of r copies of its buffer.
- mode="digest" (beyond the paper): all-gather one digest per expert row
  (its projection on a fixed direction), elect per row the
  lowest-indexed replica of the largest agreeing coalition, and recover
  the trusted value with one masked all-reduce in which only the
  elected replica's copy is not zero.  The JAX package divides the
  agreeing copies' sum by their count instead: the same value (honest
  copies are equal bit for bit), which rounds where that count is not a
  power of two (three honest replicas of four), where the port's sum of
  one copy and zeros is exact.

The backward of either vote passes each rank's cotangent straight into
its own copy.  Under SPMD the elected copy may sit on another rank, so
sending the gradient to the winner's copy (``ops._Vote``'s backward) would
let the replicas' parameters drift apart; the straight-through gradient
is every replica's single-device gradient, as the JAX package's mesh
step gives (the clean forward is the same on every replica).

``LMAttack`` injects Gaussian noise into the buffers of the malicious
replicas before the vote, drawn from a ``torch.Generator`` seeded
``seed`` (colluding: the same noise on every malicious replica) or from
``seed`` and the replica's index.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.kernels import ops

DIGEST_SEED = 0xB30E


@dataclasses.dataclass(frozen=True)
class LMAttack:
    """In-graph adversary for LM-scale robustness tests."""
    malicious_replicas: tuple = ()
    noise_std: float = 1.0
    colluding: bool = True
    seed: int = 0


def _inject(y: torch.Tensor, attack: Optional[LMAttack], mesh
            ) -> torch.Tensor:
    """``y`` plus the attack's noise when this rank is a malicious
    replica (its gradient is the identity)."""
    rid = mesh.replica.shard
    if attack is None or rid not in attack.malicious_replicas:
        return y
    seed = attack.seed if attack.colluding else (
        attack.seed * 1_000_003 + rid)
    gen = _generator(y.device, seed)
    noise = torch.randn(y.shape, generator=gen, dtype=torch.float32,
                        device=y.device).to(y.dtype)
    return y + attack.noise_std * noise


def _faithful(y: torch.Tensor, mesh) -> torch.Tensor:
    """y (n, C, d): gather the replicas' copies and vote per row."""
    n = y.shape[0]
    ys = mesh.replica.all_gather(y, "vote_gather")       # (r, n, C, d)
    pub = ys.reshape(ys.shape[0], n, -1).transpose(0, 1).contiguous()
    active = torch.ones(pub.shape[1], dtype=torch.float32, device=y.device)
    trusted, _support, _flags = ops.redundancy_vote_masked(pub, active)
    return trusted.reshape(y.shape)


def _generator(device, seed: int) -> torch.Generator:
    """A generator on ``device`` seeded ``seed`` (the meta device has
    none: a dry run's draws take the CPU's and make no values)."""
    device = torch.device(device)
    return torch.Generator(
        device="cpu" if device.type == "meta" else device).manual_seed(seed)


def _digest_direction(C: int, d: int, device) -> torch.Tensor:
    gen = _generator(device, DIGEST_SEED)
    return torch.randn((C, d), generator=gen, dtype=torch.float32,
                       device=device)


def _digest(y: torch.Tensor, mesh) -> torch.Tensor:
    """y (n, C, d): digest vote and masked all-reduce recovery."""
    n, C, d = y.shape
    v = _digest_direction(C, d, y.device)
    dig = torch.tensordot(y.float(), v, dims=2)           # (n,)
    digs = mesh.replica.all_gather(dig, "digest_gather")  # (r, n)
    agree = (digs[:, None, :] - digs[None, :, :]).abs() <= 0.0
    support = agree.sum(dim=1)                            # (r, n)
    majority = support.max(dim=0).values
    # the lowest-indexed replica of the largest coalition
    winner = (support == majority[None, :]).int().argmax(dim=0)
    elected = (winner == mesh.replica.shard).to(y.dtype)
    return mesh.replica.all_reduce(y * elected[:, None, None], "digest_sum")


class _StraightVote(torch.autograd.Function):
    """The vote's value forward; its backward passes the cotangent
    straight into this rank's own copy."""

    @staticmethod
    def forward(ctx, y, mesh, mode):
        with torch.no_grad():
            return (_faithful if mode == "faithful" else _digest)(y, mesh)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def vote(y: torch.Tensor, mode: str, mesh,
         attack: Optional[LMAttack] = None) -> torch.Tensor:
    """The consensus over ``mesh``'s replicas of this rank's expert
    outputs ``y`` (rows, C, d), after the attack's noise: the trusted
    rows, the same on every replica.  Differentiable, straight
    through."""
    y = _inject(y, attack, mesh)
    return _StraightVote.apply(y.contiguous(), mesh, mode)


def make_trust(mesh, rcfg, expert_sharded: bool,
               attack: Optional[LMAttack] = None):
    """The ``trust`` hook for ``models.moe.moe_mlp``: the vote over the
    (B, E, C, d) expert output buffer this rank holds, one row a (batch
    row, expert).  None without a mesh or with redundancy off; raises
    when the mesh has no ``replica`` axis.  ``expert_sharded`` (whether
    JAX shards the buffer's expert axis over ``model``) only changes how
    JAX splits the vote's work: a rank here votes on its whole buffer."""
    if mesh is None or rcfg.mode == "off":
        return None
    if "replica" not in mesh.axis_names:
        raise ValueError("trusted mode needs a 'replica' mesh axis")
    mode = rcfg.mode

    def trust(y):
        B, E, C, d = y.shape
        return vote(y.reshape(B * E, C, d), mode, mesh, attack).reshape(
            B, E, C, d)

    return trust


def make_trusted_mesh(r: int, *, data: int = 16, model: int = 16,
                      multi_pod: bool = False, device=None):
    """(data/r, replica=r, model) mesh: the production geometry's rank
    count, the data axis split into replica groups."""
    from repro_torch.launch.mesh import LM_AXES, make_lm_mesh
    if data % r:
        raise ValueError(f"redundancy r={r} must divide data={data}")
    if multi_pod:
        return make_lm_mesh((2, data // r, r, model), LM_AXES, device=device)
    return make_lm_mesh((data // r, r, model), ("data", "replica", "model"),
                        device=device)
