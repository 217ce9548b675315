"""Structured span tracer for the B-MoE stack.

The paper's blockchain layer exists to "trace, verify, and record" the
experts' computation; this module is the *trace* third: nested wall-
clock spans with per-span attributes (round id, expert id, session id,
block hash, CID), exported as Chrome-trace/Perfetto JSON or a JSONL
event log, and feeding the same ``MetricsRegistry`` the legacy reports
read — a span is both a trace event and (optionally) a phase-seconds
metric.

Three execution modes, chosen per span:

- **no-op** — tracer disabled and the span carries no metric: a shared
  singleton context manager is returned; nothing is timed, nothing is
  allocated (the zero-overhead mode);
- **metric-only** — tracer disabled but the span feeds a phase counter
  (``metric="bmoe.consensus_s"``): the span is timed and participates
  in off-path accounting but records no trace event — this is the
  always-on replacement for the old ad-hoc ``_timers`` arithmetic and
  costs what the ``time.perf_counter()`` pairs it replaced cost;
- **recording** — tracer enabled: the span is timed, stacked, and
  appended to the event log with its attributes for export.

Off-path accounting replaces the manual audit-seconds subtraction the
pre-obs ``BMoESystem`` did by hand: a span opened with
``off_path=True`` (e.g. a pipelined audit drain — verifier-pool work
that deployment overlaps with later rounds) reports its full duration
to its own metric, while every enclosing span's metric records
*on-path* time — duration minus off-path descendants — natively, so
``parent.metric + off_path_child.metric == parent wall``.

A copy of the JAX package's ``repro.obs.trace``; only ``annotate``
differs: it names regions on the ``torch.profiler`` timeline.
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Optional

from repro_torch.obs.metrics import MetricsRegistry

_pc = time.perf_counter


class _NoopSpan:
    """Shared do-nothing span (disabled tracer, no metric)."""
    __slots__ = ()
    span_id = 0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        return self


NOOP_SPAN = _NoopSpan()


class Span:
    """One timed region.  Use via ``with tracer.span(...) as sp:``."""
    __slots__ = ("tracer", "name", "metric", "off_path", "attrs", "span_id",
                 "parent_id", "t0", "dur_s", "off_child_s", "_record")

    def __init__(self, tracer: "Tracer", name: str, metric: Optional[str],
                 off_path: bool, record: bool, attrs: Dict):
        self.tracer = tracer
        self.name = name
        self.metric = metric
        self.off_path = off_path
        self.attrs = attrs
        self._record = record
        self.span_id = 0
        self.parent_id = 0
        self.t0 = 0.0
        self.dur_s = 0.0
        self.off_child_s = 0.0

    def set(self, **attrs) -> "Span":
        """Attach attributes discovered mid-span (block hash, verdicts)."""
        self.attrs.update(attrs)
        return self

    def __enter__(self) -> "Span":
        tr = self.tracer
        self.span_id = tr._next_id
        tr._next_id += 1
        stack = tr._stack
        self.parent_id = stack[-1].span_id if stack else 0
        stack.append(self)
        self.t0 = _pc()
        return self

    def __exit__(self, *exc) -> bool:
        end = _pc()
        tr = self.tracer
        self.dur_s = end - self.t0
        stack = tr._stack
        if stack and stack[-1] is self:
            stack.pop()
        parent = stack[-1] if stack else None
        # off-path propagation: an off-path span's WHOLE duration is
        # off its ancestors' path; an on-path span passes through only
        # what its own off-path descendants accumulated
        if parent is not None:
            parent.off_child_s += (self.dur_s if self.off_path
                                   else self.off_child_s)
        if self.metric is not None:
            # an on-path phase metric counts self time minus off-path
            # descendants; an off-path metric counts its full duration
            on_path = self.dur_s - (0.0 if self.off_path
                                    else self.off_child_s)
            tr.metrics.counter(self.metric).add(on_path)
        if self._record:
            tr._events.append({
                "name": self.name, "span_id": self.span_id,
                "parent_id": self.parent_id, "trace_id": tr.trace_id,
                "ts_s": self.t0 - tr._origin, "dur_s": self.dur_s,
                "off_path": self.off_path, "metric": self.metric,
                "attrs": self.attrs,
            })
        return False


class Tracer:
    """Span factory + event log.  ``enabled=False`` records nothing but
    still drives metric-bearing spans (the phase timers)."""

    _next_trace_id = 1

    def __init__(self, enabled: bool = False,
                 metrics: Optional[MetricsRegistry] = None):
        self.enabled = bool(enabled)
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.trace_id = Tracer._next_trace_id
        Tracer._next_trace_id += 1
        self._origin = _pc()
        self._events: List[Dict] = []
        self._stack: List[Span] = []
        self._next_id = 1

    # ------------------------------------------------------------- spans
    def span(self, name: str, *, metric: Optional[str] = None,
             off_path: bool = False, **attrs):
        """Open a span.  ``metric``: phase counter fed on exit (seconds,
        off-path descendants excluded).  ``off_path=True``: this work is
        concurrent with the critical path in deployment — its seconds are
        excluded from every enclosing span's metric."""
        if not self.enabled and metric is None and not off_path:
            return NOOP_SPAN
        return Span(self, name, metric, off_path, self.enabled, attrs)

    def current_span_id(self) -> int:
        """Innermost open span id (0 outside any span) — what hosts bind
        into artifacts (ledger blocks) for block -> trace correlation."""
        return self._stack[-1].span_id if self._stack else 0

    # ----------------------------------------------------------- exports
    @property
    def events(self) -> List[Dict]:
        return list(self._events)

    def clear(self) -> None:
        self._events.clear()

    def chrome_trace(self) -> Dict:
        """Chrome-trace (Perfetto-loadable) JSON object: one complete
        ("ph": "X") event per span, microsecond timestamps, span/parent
        ids and attributes under ``args``."""
        events = []
        for ev in self._events:
            args = {"span_id": ev["span_id"], "parent_id": ev["parent_id"],
                    "off_path": ev["off_path"]}
            if ev["metric"]:
                args["metric"] = ev["metric"]
            args.update(ev["attrs"])
            events.append({
                "name": ev["name"], "cat": "repro",
                "ph": "X", "ts": ev["ts_s"] * 1e6,
                "dur": ev["dur_s"] * 1e6,
                "pid": 1, "tid": ev["trace_id"],
                "args": args,
            })
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def export_chrome(self, path: str) -> Dict:
        trace = self.chrome_trace()
        with open(path, "w") as f:
            json.dump(trace, f)
        return trace

    def export_jsonl(self, path: str) -> int:
        """One JSON object per completed span, append-order."""
        with open(path, "w") as f:
            for ev in self._events:
                f.write(json.dumps(ev) + "\n")
        return len(self._events)


# --------------------------------------------------- kernel annotations
# torch.profiler.record_function hooks around the kernel wrappers: when a
# torch profile is being captured, the annotation names the kernel region
# on the timeline.  Off by default (REPRO_OBS_ANNOTATE=1 or
# set_annotations(True) enables) so the hot path pays nothing.
_annotate_enabled = os.environ.get("REPRO_OBS_ANNOTATE", "") not in ("", "0")


def set_annotations(enabled: bool) -> None:
    global _annotate_enabled
    _annotate_enabled = bool(enabled)


def annotations_enabled() -> bool:
    return _annotate_enabled


def annotate(name: str):
    """Context manager naming a region on the torch profiler timeline
    (no-op unless annotations are enabled)."""
    if not _annotate_enabled:
        return NOOP_SPAN
    from torch.profiler import record_function
    return record_function(name)


class Observability:
    """The per-system bundle: one tracer + one metrics registry.

    ``Observability()`` (default) keeps tracing off — spans that carry
    phase metrics still time themselves (the legacy reports depend on
    them); everything else is a shared no-op.  ``enabled=True`` records
    every span for export.
    """

    def __init__(self, enabled: bool = False,
                 metrics: Optional[MetricsRegistry] = None):
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.trace = Tracer(enabled=enabled, metrics=self.metrics)

    @property
    def enabled(self) -> bool:
        return self.trace.enabled

    def span(self, name: str, **kw):
        return self.trace.span(name, **kw)

    def report(self) -> Dict:
        return {"metrics": self.metrics.snapshot()}
