"""repro_torch.serve — continuous-batching serving with prefill/decode
disaggregation and optimistic per-session trust (the counterpart of
``repro.serve``)."""
from repro_torch.serve.engine import (EdgeStorageConfig, ServingEngine,
                                      SessionRecord)
from repro_torch.serve.scheduler import POLICIES, SlotScheduler, SlotState

__all__ = ["EdgeStorageConfig", "POLICIES", "ServingEngine",
           "SessionRecord", "SlotScheduler", "SlotState"]
