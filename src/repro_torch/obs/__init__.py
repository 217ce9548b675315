"""repro_torch.obs — tracing + metrics (a copy of ``repro.obs``)."""
from repro_torch.obs.metrics import (Counter, CounterGroup, Gauge, Histogram,
                                     MetricsRegistry, DEFAULT_TIME_BUCKETS,
                                     canonical_name, exp_buckets,
                                     merge_namespaced)
from repro_torch.obs.trace import (NOOP_SPAN, Observability, Span, Tracer,
                                   annotate, annotations_enabled,
                                   set_annotations)

__all__ = [
    "Counter", "CounterGroup", "Gauge", "Histogram", "MetricsRegistry",
    "DEFAULT_TIME_BUCKETS", "canonical_name", "exp_buckets",
    "merge_namespaced", "NOOP_SPAN", "Observability", "Span", "Tracer",
    "annotate", "annotations_enabled", "set_annotations",
]
