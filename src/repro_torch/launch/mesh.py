"""Meshes over ``torch.distributed``: the B-MoE edge mesh (the counterpart
of ``repro.launch.mesh.make_edge_mesh``) and the LM meshes (``make_lm_mesh``,
``make_host_mesh``, ``make_trusted_mesh``, ``make_production_mesh``).

The JAX package runs one controller over a mesh of devices; the port runs
SPMD instead: one process (a rank) per device, every rank running the
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
all-gathers the disjoint cotangent slices), ``all_gather`` and
``all_reduce`` (no gradient) and ``psum`` (a sum whose backward passes
the cotangent through: for a quantity each rank adds once into a loss
whose gradients are then summed over the same ranks).  ``wire_bytes``
counts, per exchange, the bytes this rank sends to the other ranks of its
group, and each exchange also books them with ``launch.opanalysis``
under JAX's op name (all-to-all, all-gather, all-reduce).

An ``LMMesh`` is the LM stack's mesh, axes ``(pod, data, replica,
model)`` (any of them may be absent), ranks laid out row-major as
``jax.make_mesh`` orders devices.  Each rank holds its coordinates and an
``EdgeMesh`` view over each of three groups: ``model`` (expert
parallelism's exchanges), ``replica`` (the B-MoE vote) and ``batch``
(pod x data at equal replica and model: the batch split, the gradient
sum and the routing statistics); the three share one ``wire_bytes``.  The
factories derive the widths from the world size exactly as the JAX
package's derive them from the device count.  ``abstract_lm_mesh`` is
one rank's view of a mesh of any shape with no process group, on the
meta device (the dry run's, ``launch.dryrun``): its exchanges return meta
tensors of the shapes the real ones return, through the same
differentiable ``Function``s, and count ``wire_bytes`` by the same code.

``spawn_edges`` starts a world of ranks on one host (``torch.
multiprocessing`` with a ``file://`` rendezvous, so concurrent worlds
cannot collide on a port) and fails when any rank fails or overruns; it
starts the ranks of an LM mesh too.  The backend is NCCL only when every
rank has a card of its own; ranks that share a card (or the CPU) use
gloo.
"""
from __future__ import annotations

import dataclasses
import datetime
import math
import os
import time
import uuid
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.kernels.ops import resolve_device
from repro_torch.launch import opanalysis


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


class _PSum(torch.autograd.Function):
    """The sum over the group; the backward passes the cotangent through
    unchanged (every rank then holds the gradient of its own share)."""

    @staticmethod
    def forward(ctx, x, mesh, kind):
        return mesh.all_reduce(x.detach().contiguous().clone(), kind)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


@dataclasses.dataclass
class EdgeMesh:
    """One rank's view of the edge mesh: ``shard`` is its edge index on
    the ``model`` axis (``shards`` wide, ``data`` replicas of it);
    ``group`` is its model-axis process group (None in a one-shard mesh)
    and ``device`` where its bank slice lives.  ``abstract``: no group
    and meta tensors; an exchange makes its result's shape and counts
    its bytes."""
    rank: int
    world: int
    shards: int
    data: int
    shard: int
    group: Optional[object]
    device: torch.device
    wire_bytes: Dict[str, int] = dataclasses.field(default_factory=dict)
    abstract: bool = False

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
    def _count(self, kind: str, op: str, nbytes: int) -> None:
        sent = nbytes * (self.shards - 1) // self.shards
        self.wire_bytes[kind] = self.wire_bytes.get(kind, 0) + sent
        opanalysis.book_collective(op, kind, sent)

    def _all_to_all(self, x: torch.Tensor, kind: str) -> torch.Tensor:
        x = x.contiguous()
        if self.shards == 1:
            return x.clone()
        out = torch.empty_like(x)
        if not self.abstract:
            dist.all_to_all_single(out, x, group=self.group)
        self._count(kind, "all-to-all", x.numel() * x.element_size())
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
        self._count(kind, "all-gather",
                    x.numel() * x.element_size() * self.shards)
        if self.abstract:
            return x.new_empty((self.shards,) + tuple(x.shape))
        parts = [torch.empty_like(x) for _ in range(self.shards)]
        dist.all_gather(parts, x, group=self.group)
        return torch.stack(parts)

    def all_reduce(self, x: torch.Tensor, kind: str = "reduce"
                   ) -> torch.Tensor:
        """Sums the contiguous ``x`` over the group in place, on every
        rank, and returns it.  No gradient.  Every rank holds the same
        bits (the ring sums each element once and sends it on)."""
        if self.shards > 1:
            if not self.abstract:
                dist.all_reduce(x, group=self.group)
            self._count(kind, "all-reduce", 2 * x.numel() * x.element_size())
        return x

    def psum(self, x: torch.Tensor, kind: str = "reduce") -> torch.Tensor:
        """``all_reduce`` whose backward passes the cotangent through."""
        return _PSum.apply(x, self, kind)

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


LM_AXES = ("pod", "data", "replica", "model")


@dataclasses.dataclass
class LMMesh:
    """One rank's view of an LM mesh: ``axis_names`` (in ``LM_AXES``
    order) and their widths ``shape``, this rank's coordinate on each,
    and an ``EdgeMesh`` over each group: ``model``, ``replica`` and
    ``batch`` (pod x data), whose ``shards`` is the group's width and
    ``shard`` this rank's index in it.  A mesh of one rank is the
    identity for every exchange."""
    axis_names: Tuple[str, ...]
    shape: Tuple[int, ...]
    rank: int
    coords: Dict[str, int]
    device: torch.device
    model: EdgeMesh
    replica: EdgeMesh
    batch: EdgeMesh
    wire_bytes: Dict[str, int]

    @property
    def axes(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.shape))

    @property
    def world(self) -> int:
        return math.prod(self.shape)

    def size(self, name: str) -> int:
        """The width of axis ``name`` (1 when the mesh lacks it)."""
        return self.axes.get(name, 1)

    def batch_rows(self, n: int):
        """[lo, hi) of this rank's rows of a global batch of ``n`` rows
        (split over pod x data, as a batch dimension sharded over
        ``("pod", "data")`` is)."""
        if n % self.batch.shards:
            raise ValueError(f"batch of {n} rows does not split over "
                             f"{self.batch.shards} batch ranks")
        per = n // self.batch.shards
        return self.batch.shard * per, (self.batch.shard + 1) * per


def _axis_groups(names, shape, members, rank):
    """This rank's process group over the axes ``members``: the ranks
    that share every other coordinate.  Every rank creates every such
    group, in one order (``new_group`` is collective over the world)."""
    width = math.prod(w for n, w in zip(names, shape) if n in members)
    world = math.prod(shape)
    if width == 1:
        return None
    if width == world:
        return dist.group.WORLD
    strides = [math.prod(shape[i + 1:]) for i in range(len(shape))]
    others = [i for i, n in enumerate(names) if n not in members]
    inside = [i for i, n in enumerate(names) if n in members]
    mine = None
    for o in _coords([shape[i] for i in others]):
        base = sum(c * strides[i] for c, i in zip(o, others))
        ranks = sorted(base + sum(c * strides[i] for c, i in zip(m, inside))
                       for m in _coords([shape[i] for i in inside]))
        group = dist.new_group(ranks)
        if rank in ranks:
            mine = group
    return mine


def _coords(widths):
    """Every coordinate tuple of ``widths``, row-major."""
    out = [()]
    for w in widths:
        out = [c + (i,) for c in out for i in range(w)]
    return out


def make_lm_mesh(shape: Sequence[int], axis_names: Optional[Sequence[str]]
                 = None, *, device=None) -> LMMesh:
    """The LM mesh of ``shape`` over the process group the caller set up
    (``jax.make_mesh(shape, axis_names)``'s counterpart).  ``axis_names``
    defaults to ("data", "model"), ("data", "replica", "model") or
    ``LM_AXES`` by the number of axes; names keep ``LM_AXES``' order.  The
    world size must be the product of the widths; without a process group
    the world is one rank.  The rank's device is ``cuda:{rank %
    device_count}`` (``device=None``; raises without a card) unless the
    caller asks for ``device="cpu"``."""
    shape, axis_names = _check_axes(shape, axis_names)
    on = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if on else 1
    rank = dist.get_rank() if on else 0
    if math.prod(shape) != world or min(shape) < 1:
        raise ValueError(f"mesh {dict(zip(axis_names, shape))} needs "
                         f"{math.prod(shape)} ranks, the world has {world}")
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    return _lm_mesh(shape, axis_names, rank, dev, on, abstract=False)


def _check_axes(shape, axis_names):
    shape = tuple(int(w) for w in shape)
    if axis_names is None:
        axis_names = {2: ("data", "model"), 3: ("data", "replica", "model"),
                      4: LM_AXES}.get(len(shape))
    axis_names = tuple(axis_names or ())
    if (len(axis_names) != len(shape)
            or list(axis_names) != [a for a in LM_AXES if a in axis_names]):
        raise ValueError(f"axes {axis_names} for shape {shape}: want a "
                         f"subsequence of {LM_AXES}, one name a width")
    return shape, axis_names


def _lm_mesh(shape, axis_names, rank: int, dev, on: bool,
             abstract: bool) -> LMMesh:
    """Rank ``rank``'s view; its groups are made when ``on`` (every rank
    of the world makes every group)."""
    world = math.prod(shape)
    coords = dict(zip(axis_names, _coords(shape)[rank]))
    wire: Dict[str, int] = {}

    def view(members):
        width = math.prod(w for n, w in zip(axis_names, shape)
                          if n in members)
        index = 0
        for n, w in zip(axis_names, shape):
            if n in members:
                index = index * w + coords[n]
        group = (_axis_groups(axis_names, shape, members, rank)
                 if on else None)
        return EdgeMesh(rank=rank, world=world, shards=width,
                        data=world // width, shard=index, group=group,
                        device=dev, wire_bytes=wire, abstract=abstract)

    return LMMesh(axis_names=axis_names, shape=shape, rank=rank,
                  coords=coords, device=dev, model=view(("model",)),
                  replica=view(("replica",)), batch=view(("pod", "data")),
                  wire_bytes=wire)


def abstract_lm_mesh(shape: Sequence[int],
                     axis_names: Optional[Sequence[str]] = None, *,
                     rank: int = 0) -> LMMesh:
    """Rank ``rank``'s view of the LM mesh of ``shape`` (axis names as
    ``make_lm_mesh`` defaults them) with no process group, on the meta
    device: every exchange returns a meta tensor of the real exchange's
    shape and counts this rank's ``wire_bytes``, so the training and
    prefill steps take it unchanged and a meta run of them books the
    bytes a real world's rank ``rank`` sends."""
    shape, axis_names = _check_axes(shape, axis_names)
    if not 0 <= rank < math.prod(shape):
        raise ValueError(f"rank {rank} outside a mesh of "
                         f"{math.prod(shape)} ranks")
    return _lm_mesh(shape, axis_names, rank, torch.device("meta"), False,
                    abstract=True)


def _world() -> int:
    on = dist.is_available() and dist.is_initialized()
    return dist.get_world_size() if on else 1


def production_mesh_shape(multi_pod: bool = False):
    """(shape, axis names) of the production mesh: (data=16, model=16),
    or (pod=2, data=16, model=16) multi-pod."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False, device=None) -> LMMesh:
    """Single pod: (data=16, model=16), 256 ranks; multi-pod: (pod=2,
    data=16, model=16), 512 ranks (the pod axis folds into the batch).
    A fixed geometry: raises unless the world is that size."""
    shape, axes = production_mesh_shape(multi_pod)
    if _world() != math.prod(shape):
        raise ValueError(f"the production mesh needs {math.prod(shape)} "
                         f"ranks, the world has {_world()}")
    return make_lm_mesh(shape, axes, device=device)


def trusted_mesh_shape(n: int, r: int, *, multi_pod: bool = False):
    """(shape, axis names) of the B-MoE redundancy mesh over ``n`` ranks,
    as the JAX package derives it from the device count: the replica
    axis first, the model axis the widest divisor up to 16 of what is
    left, every leftover rank in the data axis."""
    pods = 2 if multi_pod else 1
    if n % pods:
        raise ValueError(f"multi_pod needs an even device count, got {n}")
    per_pod = n // pods
    if r < 1 or per_pod % r:
        raise ValueError(
            f"redundancy r={r} must divide the per-pod device count "
            f"{per_pod} ({n} devices / {pods} pod(s))")
    rest = per_pod // r
    model = _model_width(rest, cap=16)
    data = rest // model
    if multi_pod:
        return (2, data, r, model), LM_AXES
    return (data, r, model), ("data", "replica", "model")


def make_trusted_mesh(r: int, *, multi_pod: bool = False,
                      device=None) -> LMMesh:
    """B-MoE redundancy mesh: (data/r groups, r replicas, model), widths
    from the world size (``trusted_mesh_shape``)."""
    shape, axes = trusted_mesh_shape(_world(), r, multi_pod=multi_pod)
    return make_lm_mesh(shape, axes, device=device)


def host_mesh_shape(n: int, num_experts: Optional[int] = None):
    """(data, model) over ``n`` ranks: with ``num_experts`` the model axis
    is the widest divisor of ``n`` that also divides the expert count
    (what ``moe_mlp_ep`` needs), leftover ranks in data."""
    model = _model_width(n, divides=num_experts)
    return (n // model, model)


def make_host_mesh(num_experts: Optional[int] = None, *,
                   device=None) -> LMMesh:
    """(data, model) over the whole world (``host_mesh_shape``); a world
    of one is (1, 1)."""
    return make_lm_mesh(host_mesh_shape(_world(), num_experts),
                        ("data", "model"), device=device)


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
