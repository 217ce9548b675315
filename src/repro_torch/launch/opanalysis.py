"""Counting a step while it runs: dot FLOPs, collective bytes and the
live memory of a meta run (the counterpart of ``repro.launch.
hloanalysis``, which reads the same totals out of optimized HLO).

Eager PyTorch has no HLO and no scan to correct for: ``count()`` counts
what runs, on any device (meta, CPU or CUDA), and yields an ``OpRecord``
with the JAX package's keys, ``dot_flops``, ``collective_bytes``,
``collective_counts`` and ``total_collective_bytes``:

- **Library products** (``torch.matmul``, ``F.linear``, convolutions):
  counted by a ``TorchDispatchMode`` with ``torch.utils.flop_counter``'s
  formulas, under the route of their operands' dtype (``library_fp32``:
  float32, run with TF32 off; ``library_bf16``).
- **The port's kernels**: each wrapper in ``kernels.ops`` books its own
  work by formula (``book_kernel``) and pauses the library counting
  inside itself (``paused``), so a step counts the same integer whether
  the kernel launched (CUDA), its plain version ran (CPU) or only shapes
  were made (meta): the plain versions run other products than the
  kernels (the attention reference forms the whole score matrix).
  Kernel FLOPs are booked under ``kernel_3xtf32`` (float32 operands) or
  ``kernel_bf16``, so a roofline divides each route by its own peak
  (``costmodel.ROUTE_PEAK``).
- **Collectives**: each ``launch.mesh.EdgeMesh`` exchange books what
  this rank sends to the other ranks of its group (``wire_bytes``' count:
  (n-1)/n of an all-to-all's buffer or of the gathered tensor, twice
  that of an all-reduce's), under JAX's op name.  JAX's HLO count is the
  output shape's bytes instead, with a factor 2 on all-reduce applied in
  its roofline; the port's roofline uses these bytes as they are.

With ``track_memory=True`` the record also estimates the step's peak:
the bytes of the storages that ops made and that are alive at once
(tracked by weak references, swept whenever the running sum would set a
new peak).  On the meta device that is an estimate of the card's
``max_memory_allocated`` minus the inputs: it knows nothing of the
caching allocator's rounding or of a kernel's scratch.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List

import torch
from torch.utils._python_dispatch import TorchDispatchMode

COLLECTIVE_OPS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                  "collective-permute")

_ACTIVE: List["OpRecord"] = []   # the records being counted into
_PAUSE = [0]                     # > 0: library products are not counted


@dataclasses.dataclass
class OpRecord:
    """What one counted run did on this rank."""
    dot_flops_by_route: Dict[str, int] = dataclasses.field(
        default_factory=dict)
    kernel_flops: Dict[str, int] = dataclasses.field(default_factory=dict)
    kernel_calls: Dict[str, int] = dataclasses.field(default_factory=dict)
    collective_bytes: Dict[str, int] = dataclasses.field(
        default_factory=lambda: {op: 0 for op in COLLECTIVE_OPS})
    collective_counts: Dict[str, int] = dataclasses.field(
        default_factory=lambda: {op: 0 for op in COLLECTIVE_OPS})
    wire_bytes: Dict[str, int] = dataclasses.field(default_factory=dict)
    peak_live_bytes: int = 0

    @property
    def dot_flops(self) -> int:
        return sum(self.dot_flops_by_route.values())

    @property
    def total_collective_bytes(self) -> int:
        return sum(self.collective_bytes.values())

    def as_dict(self) -> dict:
        return {"dot_flops": self.dot_flops,
                "dot_flops_by_route": dict(self.dot_flops_by_route),
                "kernel_flops": dict(self.kernel_flops),
                "kernel_calls": dict(self.kernel_calls),
                "collective_bytes": dict(self.collective_bytes),
                "collective_counts": dict(self.collective_counts),
                "total_collective_bytes": self.total_collective_bytes,
                "wire_bytes": dict(self.wire_bytes)}


def _add(d: Dict[str, int], key: str, n: int) -> None:
    d[key] = d.get(key, 0) + n


def counting() -> bool:
    """Is a ``count()`` open?"""
    return bool(_ACTIVE)


def book_kernel(name: str, flops: int, dtype: torch.dtype) -> None:
    """One call of the port's kernel ``name`` doing ``flops`` products'
    FLOPs on operands of ``dtype``."""
    route = "kernel_bf16" if dtype == torch.bfloat16 else "kernel_3xtf32"
    for rec in _ACTIVE:
        _add(rec.dot_flops_by_route, route, int(flops))
        _add(rec.kernel_flops, name, int(flops))
        _add(rec.kernel_calls, name, 1)


def book_collective(op: str, kind: str, sent: int) -> None:
    """One exchange of JAX op name ``op`` (the port's ``kind``) sending
    ``sent`` bytes from this rank."""
    for rec in _ACTIVE:
        rec.collective_bytes[op] += sent
        rec.collective_counts[op] += 1
        _add(rec.wire_bytes, kind, sent)


@contextlib.contextmanager
def paused():
    """Library products inside are not counted (a kernel wrapper's own
    count stands for them)."""
    _PAUSE[0] += 1
    try:
        yield
    finally:
        _PAUSE[0] -= 1


def _library_route(args) -> str:
    for a in args:
        if isinstance(a, torch.Tensor):
            if a.dtype == torch.float32:
                return "library_fp32"
            if a.dtype == torch.bfloat16:
                return "library_bf16"
            return "library_other"
    return "library_other"


class _Live:
    """Bytes of the storages ops made that are still alive, and the most
    alive at once."""

    def __init__(self):
        from torch.multiprocessing.reductions import StorageWeakRef
        self._ref = StorageWeakRef
        self.tracked: Dict[int, tuple] = {}
        self.live = 0
        self.peak = 0

    def _sweep(self) -> None:
        for key in [k for k, (r, _) in self.tracked.items() if r.expired()]:
            self.live -= self.tracked.pop(key)[1]

    def add(self, out, args, kwargs) -> None:
        """``out``'s storages that are new (a view or an in-place result
        shares an input's storage, which was counted where it was made,
        or was there before the count began)."""
        from torch.utils._pytree import tree_leaves
        inputs = {a.untyped_storage()._cdata
                  for a in tree_leaves((args, kwargs))
                  if isinstance(a, torch.Tensor)}
        for t in tree_leaves(out):
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            key = st._cdata
            if key in inputs:
                continue
            old = self.tracked.get(key)
            if old is not None and not old[0].expired():
                continue                       # a view of a tracked one
            if old is not None:
                self.live -= old[1]
            self.tracked[key] = (self._ref(st), st.nbytes())
            self.live += st.nbytes()
        if self.live > self.peak:
            self._sweep()
            self.peak = max(self.peak, self.live)


class _Counter(TorchDispatchMode):
    def __init__(self, rec: OpRecord, live: "_Live" = None):
        super().__init__()
        from torch.utils.flop_counter import FlopCounterMode
        self.registry = FlopCounterMode(display=False).flop_registry
        self.rec, self.live = rec, live

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        if not _PAUSE[0] and packet in self.registry:
            flops = self.registry[packet](*args, **kwargs, out_val=out)
            _add(self.rec.dot_flops_by_route, _library_route(args),
                 int(flops))
        if self.live is not None:
            self.live.add(out, args, kwargs)
        return out


@contextlib.contextmanager
def count(track_memory: bool = False):
    """Counts everything the block runs on this rank into the yielded
    ``OpRecord`` (see the module's docstring)."""
    rec = OpRecord()
    live = _Live() if track_memory else None
    _ACTIVE.append(rec)
    try:
        with _Counter(rec, live):
            yield rec
    finally:
        _ACTIVE.remove(rec)
        if live is not None:
            rec.peak_live_bytes = live.peak
