"""Smart-contract layer (paper §II-B, §IV-A; a copy of
``repro.core.contracts``): condition -> action rules
that fire automatically as workflow events occur, without a central
operator.  Contracts here bind the paper's cross-layer interactions:
task download / result upload (edge <-> chain), expert download / upload
(edge <-> storage), and CID registration (storage -> chain).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List


@dataclasses.dataclass
class Contract:
    name: str
    condition: Callable[[Dict[str, Any]], bool]
    action: Callable[[Dict[str, Any]], Any]
    fired: int = 0


class ContractEngine:
    """Event bus + automatic contract execution (transparent log)."""

    def __init__(self):
        self.contracts: List[Contract] = []
        self.log: List[Dict[str, Any]] = []

    def register(self, name: str, condition, action) -> Contract:
        c = Contract(name, condition, action)
        self.contracts.append(c)
        return c

    def emit(self, event: Dict[str, Any]):
        """Publish an event; every contract whose condition holds executes
        its action immediately (no human intervention, per the paper)."""
        results = []
        for c in self.contracts:
            if c.condition(event):
                out = c.action(event)
                c.fired += 1
                self.log.append({"contract": c.name, "event": event.get("type"),
                                 "round": event.get("round")})
                results.append((c.name, out))
        return results


def standard_bmoe_contracts(engine: ContractEngine, system) -> None:
    """The paper's cross-layer triggers wired to a BMoESystem."""
    engine.register(
        "task_published->record_on_chain",
        lambda e: e.get("type") == "task_published",
        lambda e: e)
    engine.register(
        "results_uploaded->consensus",
        lambda e: e.get("type") == "results_uploaded",
        lambda e: e)
    engine.register(
        "experts_updated->store_cid",
        lambda e: e.get("type") == "experts_updated",
        lambda e: system.storage.put(e["payload"]) if "payload" in e else None)
