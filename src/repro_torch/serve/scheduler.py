"""Slot scheduler for the serving engine (a copy of
``repro.serve.scheduler``, which the port does not import): request
queue, slot lifecycle, and the admission policy.  Host code only.

Two policies:

- ``"continuous"`` (default): continuous batching.  Every tick, finished
  slots are evicted and free slots admit from the queue immediately —
  a request never waits for the rest of its batch to drain.  Admitted
  requests enter the PREFILL phase (their prompt is chunk-consumed by
  the engine's fused serve step while co-batched slots keep decoding)
  and hand off to DECODE at the prompt boundary.
- ``"fixed"``: the legacy fixed-slot baseline.  Requests are admitted
  batch-synchronously — only when every slot is idle — and prompts are
  fed token-by-token through the decode step (no chunk prefill), which
  is exactly the engine this repo shipped before continuous batching.
  Kept as the benchmark baseline and the trust-equivalence oracle.

A slot's request lifecycle (as in the JAX package):

    queued -> prefill -> decode -> finished -> challenge window
                                                -> finalized | revoked

The scheduler owns everything up to "finished"; the trust layer
(challenge windows, audits, revocation) lives in the engine.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, Iterable, List, Optional, Tuple

import numpy as np

POLICIES = ("continuous", "fixed")


@dataclasses.dataclass
class SlotState:
    """One batch slot.  ``request_id < 0`` means the slot is free."""
    request_id: int = -1
    pos: int = 0                         # tokens written into this slot's cache
    prompt: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, np.int32))
    cursor: int = 0                      # next prompt token to consume
    to_generate: int = 0
    generated: List[int] = dataclasses.field(default_factory=list)
    admitted_tick: int = -1
    first_token_tick: int = -1

    @property
    def active(self) -> bool:
        return self.request_id >= 0

    @property
    def prefilling(self) -> bool:
        return self.active and self.cursor < len(self.prompt)

    @property
    def decoding(self) -> bool:
        return self.active and not self.prefilling


class SlotScheduler:
    """Admission/eviction over a fixed set of batch slots.

    The engine drives it once per tick: ``admit(tick)`` fills free slots
    from the queue (policy-dependent), the engine runs its prefill and
    decode steps against ``slots``, and ``release(i)`` evicts a finished
    slot so the *next* tick can admit into it."""

    def __init__(self, num_slots: int, policy: str = "continuous"):
        if policy not in POLICIES:
            raise ValueError(f"policy {policy!r} not in {POLICIES}")
        self.policy = policy
        self.slots = [SlotState() for _ in range(num_slots)]
        self.queue: Deque[dict] = deque()
        self.submit_order: List[int] = []
        self.meta: Dict[int, Dict[str, int]] = {}   # rid -> tick milestones

    # ------------------------------------------------------------ intake
    def submit(self, requests: Iterable[dict], tick: int = 0) -> None:
        for r in requests:
            if r["id"] < 0:
                raise ValueError(f"request id {r['id']} < 0 "
                                 "(negative ids mark free slots)")
            self.queue.append(r)
            self.submit_order.append(r["id"])
            self.meta[r["id"]] = {"submitted_tick": tick,
                                  "admitted_tick": -1,
                                  "first_token_tick": -1,
                                  "finished_tick": -1}

    # --------------------------------------------------------- admission
    def admit(self, tick: int) -> List[Tuple[int, SlotState]]:
        """Admit queued requests into free slots; returns the newly
        filled ``(slot_index, slot)`` pairs (whose caches the engine must
        reset).  Continuous policy admits whenever a slot is free; fixed
        policy only refills a fully drained batch."""
        if not self.queue:
            return []
        if self.policy == "fixed" and any(s.active for s in self.slots):
            return []
        admitted = []
        for i, slot in enumerate(self.slots):
            if slot.active or not self.queue:
                continue
            r = self.queue.popleft()
            slot.request_id = r["id"]
            slot.pos = 0
            slot.prompt = np.asarray(r["prompt"], np.int32).reshape(-1)
            slot.cursor = 0
            slot.to_generate = int(r["max_new_tokens"])
            slot.generated = []
            slot.admitted_tick = tick
            slot.first_token_tick = -1
            self.meta[r["id"]]["admitted_tick"] = tick
            admitted.append((i, slot))
        return admitted

    def release(self, index: int, tick: int) -> int:
        """Evict a finished slot; returns the request id it held."""
        slot = self.slots[index]
        rid = slot.request_id
        self.meta[rid]["finished_tick"] = tick
        slot.request_id = -1
        return rid

    def preempt(self, index: int, tick: int) -> int:
        """Page a RUNNING slot out: free the slot and requeue its
        request at the queue FRONT, so it resumes before newly queued
        work.  The engine owns the resume state (cache rows sealed to
        the KV store, generated tokens, positions) — the scheduler only
        re-enqueues the original request.  Returns the request id."""
        slot = self.slots[index]
        if not slot.active:
            raise ValueError(f"slot {index} is not active")
        rid = slot.request_id
        self.queue.appendleft({"id": rid, "prompt": slot.prompt,
                               "max_new_tokens": slot.to_generate})
        meta = self.meta[rid]
        meta["preemptions"] = meta.get("preemptions", 0) + 1
        slot.request_id = -1
        return rid

    # ------------------------------------------------------------- views
    @property
    def num_slots(self) -> int:
        return len(self.slots)

    @property
    def any_active(self) -> bool:
        return any(s.active for s in self.slots)

    @property
    def num_active(self) -> int:
        return sum(1 for s in self.slots if s.active)

    def active_requests(self) -> List[int]:
        return [s.request_id for s in self.slots if s.active]

    def occupancy(self) -> float:
        return self.num_active / max(self.num_slots, 1)

    def depth(self) -> int:
        """Requests waiting in the queue (not yet admitted)."""
        return len(self.queue)

    def prefill_lengths(self, chunk: int, cache_len: int,
                        fresh: Optional[set] = None) -> np.ndarray:
        """Per-slot prompt tokens to consume this tick, capped by the
        chunk size, the remaining prompt, and the slot's cache headroom.
        ``fresh``: slot indices admitted *this* tick (continuous policy
        prefills them immediately); 0 for slots not prefilling."""
        n = np.zeros(self.num_slots, np.int32)
        for i, s in enumerate(self.slots):
            if not s.prefilling:
                continue
            room = cache_len - 1 - s.pos
            n[i] = max(0, min(chunk, len(s.prompt) - s.cursor, room))
        return n
