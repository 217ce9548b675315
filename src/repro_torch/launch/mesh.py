"""The B-MoE edge mesh over ``torch.distributed`` (the counterpart of
``repro.launch.mesh.make_edge_mesh``).

The JAX package runs one controller over a mesh of devices; the port runs
SPMD instead: one process (a rank) per edge shard, every rank running the
same script.  ``make_edge_mesh`` reads the process group the caller set up
and returns an ``EdgeMesh``: the ``model`` axis is the edge-shard axis
(rank ``r`` is edge shard ``r % shards`` and owns a contiguous
``num_experts / shards`` slice of the expert bank), and leftover ranks
fold into a replicated ``data`` axis (``data = world // shards``) whose
replicas repeat the same work.  Without a process group, or in a world of
one, the mesh is one shard and its exchanges are the identity, as JAX's
edge mesh is on one device.

The exchanges are ``EdgeMesh`` methods over the model-axis group:
``all_to_all`` (differentiable: its backward is the reverse all-to-all),
``gather_rows`` (rows sliced per rank in, the whole tensor on every rank
out; differentiable for a loss every rank computes alike: the backward
takes this rank's rows of the cotangent, it does not sum over ranks),
``slice_rows`` (a replicated tensor's rows for this rank; its backward
all-gathers the disjoint cotangent slices) and ``all_gather`` (no
gradient).  ``wire_bytes`` counts, per exchange, the bytes this rank sends
to the other ranks of its group.

``spawn_edges`` starts a world of ranks on one host (``torch.
multiprocessing`` with a ``file://`` rendezvous, so concurrent worlds
cannot collide on a port) and fails when any rank fails or overruns.
The backend is NCCL only when every rank has a card of its own; ranks
that share a card (or the CPU) use gloo.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import time
import uuid
from typing import Callable, Dict, Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch.kernels.ops import resolve_device


def _model_width(n: int, divides: Optional[int] = None,
                 cap: Optional[int] = None) -> int:
    """Largest divisor of ``n`` that also divides ``divides`` (when
    given) and is <= ``cap`` (when given).  Always >= 1 — leftover
    devices fold into the data axis instead of failing."""
    for m in range(min(n, cap or n), 0, -1):
        if n % m == 0 and (divides is None or divides % m == 0):
            return m
    return 1


def edge_backend(device: str, world: int) -> str:
    """NCCL when every rank has a card of its own, else gloo (NCCL
    refuses two ranks on one card)."""
    if (torch.device(device).type == "cuda"
            and torch.cuda.device_count() >= world):
        return "nccl"
    return "gloo"


class _AllToAll(torch.autograd.Function):
    """Chunk j of dim 0 goes to rank j of the group; the backward sends
    the cotangent's chunks back the same way."""

    @staticmethod
    def forward(ctx, x, mesh, kind):
        ctx.mesh, ctx.kind = mesh, kind
        return mesh._all_to_all(x, kind)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh._all_to_all(g, ctx.kind + "_bwd"), None, None


class _GatherRows(torch.autograd.Function):
    """(rows of this rank) -> (n, ...) on every rank; the backward keeps
    this rank's rows of the (replicated) cotangent."""

    @staticmethod
    def forward(ctx, x, mesh, n, per):
        ctx.lo, ctx.hi = mesh.row_range(n, per)
        return mesh._gather_padded(x, per, "gather").reshape(
            (-1,) + tuple(x.shape[1:]))[:n]

    @staticmethod
    def backward(ctx, g):
        return g[ctx.lo:ctx.hi].contiguous(), None, None, None


class _SliceRows(torch.autograd.Function):
    """A replicated (n, ...) tensor -> this rank's rows; the backward
    all-gathers the ranks' cotangent slices (disjoint support) into the
    whole cotangent on every rank."""

    @staticmethod
    def forward(ctx, x, mesh, per):
        ctx.mesh, ctx.n, ctx.per = mesh, x.shape[0], per
        lo, hi = mesh.row_range(x.shape[0], per)
        return x[lo:hi].clone()

    @staticmethod
    def backward(ctx, g):
        full = ctx.mesh._gather_padded(g.contiguous(), ctx.per, "slice_bwd")
        return (full.reshape((-1,) + tuple(g.shape[1:]))[:ctx.n], None,
                None)


@dataclasses.dataclass
class EdgeMesh:
    """One rank's view of the edge mesh: ``shard`` is its edge index on
    the ``model`` axis (``shards`` wide, ``data`` replicas of it);
    ``group`` is its model-axis process group (None in a one-shard mesh)
    and ``device`` where its bank slice lives."""
    rank: int
    world: int
    shards: int
    data: int
    shard: int
    group: Optional[object]
    device: torch.device
    wire_bytes: Dict[str, int] = dataclasses.field(default_factory=dict)

    # ---------------------------------------------------------- layout
    def expert_range(self, num_experts: int):
        """[lo, hi) of the experts this rank's shard owns."""
        e_l = num_experts // self.shards
        return self.shard * e_l, (self.shard + 1) * e_l

    def row_range(self, n: int, per: int):
        """[lo, hi) of this rank's rows when ``n`` rows are dealt ``per``
        to a shard (the last shards may hold fewer, or none)."""
        return min(self.shard * per, n), min((self.shard + 1) * per, n)

    # -------------------------------------------------------- exchanges
    def _count(self, kind: str, nbytes: int) -> None:
        sent = nbytes * (self.shards - 1) // self.shards
        self.wire_bytes[kind] = self.wire_bytes.get(kind, 0) + sent

    def _all_to_all(self, x: torch.Tensor, kind: str) -> torch.Tensor:
        x = x.contiguous()
        if self.shards == 1:
            return x.clone()
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=self.group)
        self._count(kind, x.numel() * x.element_size())
        return out

    def _gather_padded(self, x: torch.Tensor, per: int,
                       kind: str) -> torch.Tensor:
        """(k <= per, ...) on each rank -> (shards * per, ...), rank j's
        rows at [j*per, j*per + k_j) and zeros after them."""
        if x.shape[0] < per:
            x = torch.cat([x, x.new_zeros((per - x.shape[0],)
                                          + tuple(x.shape[1:]))])
        return self.all_gather(x, kind).reshape((-1,) + tuple(x.shape[1:]))

    def all_gather(self, x: torch.Tensor, kind: str = "gather"
                   ) -> torch.Tensor:
        """(...) on each rank -> (shards, ...) on every rank, in shard
        order.  No gradient."""
        x = x.detach().contiguous()
        if self.shards == 1:
            return x[None].clone()
        parts = [torch.empty_like(x) for _ in range(self.shards)]
        dist.all_gather(parts, x, group=self.group)
        self._count(kind, x.numel() * x.element_size() * self.shards)
        return torch.stack(parts)

    def all_to_all(self, x: torch.Tensor, kind: str) -> torch.Tensor:
        """(shards, ...) -> (shards, ...): chunk j goes to shard j, and
        chunk i of the result came from shard i.  Differentiable."""
        return _AllToAll.apply(x, self, kind)

    def gather_rows(self, x: torch.Tensor, n: int, per: int
                    ) -> torch.Tensor:
        """This rank's rows of ``row_range(n, per)`` -> all ``n`` rows on
        every rank.  Differentiable for a replicated loss."""
        return _GatherRows.apply(x, self, n, per)

    def slice_rows(self, x: torch.Tensor, per: int) -> torch.Tensor:
        """A replicated tensor's rows of ``row_range(len(x), per)``.
        Differentiable: the cotangent comes back whole on every rank."""
        return _SliceRows.apply(x, self, per)


def _model_group(world: int, shards: int):
    """This rank's model-axis group: ranks [d*shards, (d+1)*shards) for
    its replica d.  Every rank creates every replica's group, in order
    (``new_group`` is collective over the whole world)."""
    if shards == world:
        return dist.group.WORLD
    groups = [dist.new_group(list(range(d * shards, (d + 1) * shards)))
              for d in range(world // shards)]
    return groups[dist.get_rank() // shards]


def local_mesh(device=None) -> EdgeMesh:
    """The one-device system's mesh: one shard, no process group (even
    inside a world), exchanges the identity, on ``resolve_device(device)``."""
    return EdgeMesh(rank=0, world=1, shards=1, data=1, shard=0, group=None,
                    device=resolve_device(device))


def make_edge_mesh(num_experts: int, *, shards: Optional[int] = None,
                   device=None) -> EdgeMesh:
    """B-MoE edge mesh: ``model`` is the edge-shard axis — each edge
    owns a contiguous ``num_experts/shards`` expert slice, dispatch
    crosses shards by all-to-all, and commitments and audits are
    shard-local (see ``repro_torch.core.bmoe``).  Leftover ranks fold
    into a replicated ``data`` axis.  ``shards=None`` picks the widest
    edge axis the world size and the expert count allow.  The rank's
    device is ``cuda:{rank % device_count}`` (``device=None``; raises
    without a card) unless the caller asks for ``device="cpu"``."""
    on = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if on else 1
    rank = dist.get_rank() if on else 0
    if shards is None:
        shards = _model_width(world, divides=num_experts)
    if shards < 1 or world % shards:
        raise ValueError(
            f"mesh_shards={shards} must divide the device count ({world})")
    if num_experts % shards:
        raise ValueError(
            f"num_experts ({num_experts}) % mesh_shards ({shards}) != 0 — "
            f"each edge shard must own a whole expert slice; pick shards "
            f"from the divisors of {num_experts}")
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    group = _model_group(world, shards) if shards > 1 else None
    return EdgeMesh(rank=rank, world=world, shards=shards,
                    data=world // shards, shard=rank % shards, group=group,
                    device=dev)


def _edge_main(rank: int, fn: Callable, world: int, device: str,
               store: str, timeout_s: float, args: Sequence) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(
        edge_backend(device, world), init_method=f"file://{store}",
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=timeout_s))
    try:
        fn(rank, world, *args)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def spawn_edges(fn: Callable, world: int, *, args: Sequence = (),
                device: str = "cuda", rendezvous_dir: str,
                timeout_s: float = 300.0) -> None:
    """Run ``fn(rank, world, *args)`` on ``world`` ranks of one host,
    each a spawned process with the process group set up (a ``file://``
    rendezvous in ``rendezvous_dir``, collectives timing out after
    ``timeout_s``), and wait for all of them.  ``fn`` must be importable
    by name (spawned children cannot import a test file).  Raises when a
    rank raises or exits non-zero, and ``TimeoutError`` (having killed
    every rank) when the world is not done within ``timeout_s``."""
    import torch.multiprocessing as mp
    os.makedirs(rendezvous_dir, exist_ok=True)
    store = os.path.join(rendezvous_dir, f"edges-{uuid.uuid4().hex}")
    ctx = mp.start_processes(
        _edge_main, args=(fn, world, device, store, timeout_s, tuple(args)),
        nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout_s
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f"edge world of {world} ranks not done "
                                   f"after {timeout_s} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()
        if os.path.exists(store):
            os.remove(store)
