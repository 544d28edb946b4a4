"""Span tracing: where did a simulator call's wall time go?

A :class:`Tracer` records *spans* -- named wall-clock intervals with
nesting -- from any thread (the overlapped refresh solve runs on a
worker; its spans land in the same trace with their own thread id), in
a bounded in-memory ring: ``capacity`` completed spans; overflow drops
the OLDEST spans and counts them in ``dropped``, so a long run can keep
a tracer attached without unbounded memory.

This module started as a copy of the reference's ``repro/obs/trace.py``
and differs from it in two ways:

* While a ``torch.profiler`` is recording on the calling thread, every
  ``span(name)`` also opens ``torch.profiler.record_function(name)``
  around its body -- for a disabled tracer too, so code that defaults to
  a ``Tracer(enabled=False)`` still names its ranges. The span then
  sits among the trace's host events, on the clock of the device's
  kernels, and the profiler's own Chrome export shows it beside them.
  With no profiler recording, a span costs one C call
  (``torch._C._autograd._profiler_enabled``) and opens no range.
* It has no exporters (no JSONL sink, no Perfetto events): the
  profiler's trace is where spans are seen on a timeline; the ring is
  what the run report (``RunReport.add_spans``) and the drivers read.

No span opens inside a captured CUDA-graph body: a body's Python runs
only at its warm-up and its capture, so a range there would describe
those two runs and no replay.

The spans the port records, and who reads them:

* ``sim.prepare`` (``train/trainer.run_classification``): the call's
  staging before its first segment -- the stacked node data, the model,
  the segment runner and its carries, the mixing operands, the
  minibatch indices and the test set on the device. Read by the
  benchmark's ``prepare_s.sim``.
* ``sim.segment`` (``run_mean_estimation``, ``run_classification``,
  ``faults/runner.py``): one segment's bodies and the host copy of its
  per-step outputs. Read by the benchmark's ``rollout_ms_per_step.sim``
  and ``chip_smoke.py``'s phase 6b timings.
* ``graph.warmup`` / ``graph.capture`` (``graphs.GraphRunner``, inside
  ``sim.segment``): a body's first, eager run and its second run (the
  capture on the card; on the CPU the eager run counted as one), with
  attributes ``runner`` (its name) and ``what`` (the body). Read by
  ``capture_s.sim``.
* ``sim.eval`` (``run_classification``): one evaluation -- the test-set
  forward, the accuracies' host copy and the consensus distance. Read by
  ``eval_s.sim``.
* ``sim.release`` (``run_classification``): dropping the call's bodies,
  their graphs and the graphs' memory pools. Read by ``release_s.sim``.
  The benchmark's ``idle_host_work.sim`` reads the device's idle time
  inside the union of these five host-work kinds.
* ``faults.stream`` (``faults/plan.py``), ``refresh.solve`` and the
  instants ``refresh.submit`` / ``refresh.collect`` / ``refresh.abandon``
  (``online/refresh.py``), ``segment.rollout`` / ``segment.checkpoint``
  / ``segment.restage`` (``train/lm_trainer.run_segments``): read by the
  tests and the run report.

Clocks are monotonic (``time.perf_counter``): span durations are
immune to wall-clock adjustments, and all spans of one tracer share a
single origin so they compose into one timeline. ``wall_unix`` on each
record anchors that timeline to the epoch once, at tracer creation.

Usage::

    tracer = Tracer()
    with tracer.span("segment.rollout", t0=0, k=64):
        ...
        with tracer.span("segment.checkpoint"):
            ...
    tracer.instant("refresh.submit", t=63)
    tracer.summary()

Spans nest per-thread: the ``depth`` and ``parent`` fields record the
enclosing span at *entry* time, and the ring orders records by
*completion* (the parent closes after its children).
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from collections import deque

import torch

__all__ = ["SpanRecord", "Tracer"]

# true while a profiler records on the calling thread: one C call, no allocation
_profiling = torch._C._autograd._profiler_enabled
_NO_RANGE = contextlib.nullcontext()


@dataclasses.dataclass(frozen=True)
class SpanRecord:
    """One completed span (or instant event, where ``t1 == t0``).

    ``t0``/``t1`` are seconds on the tracer's monotonic clock (shared
    origin across threads); ``wall_unix`` is the epoch time of that
    origin, so ``wall_unix + t0`` is an absolute timestamp.
    """

    name: str
    t0: float
    t1: float
    tid: int
    depth: int
    parent: str | None
    attrs: dict
    wall_unix: float

    @property
    def duration_s(self) -> float:
        return self.t1 - self.t0


class Tracer:
    """Thread-safe span recorder with a bounded ring.

    Args:
      capacity: max completed spans held in memory. Overflow evicts the
        oldest records (counted in :attr:`dropped`).
      enabled: ``Tracer(enabled=False)`` records nothing -- every
        ``span()`` still runs its body, and still opens its profiler
        range while a profiler records. Lets instrumented code take an
        always-on ``tracer`` argument with a disabled default instead of
        ``if tracer is not None`` forests.
    """

    def __init__(self, capacity: int = 4096, enabled: bool = True):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self.enabled = bool(enabled)
        self.dropped = 0
        self._ring: deque[SpanRecord] = deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self._local = threading.local()
        # one shared origin: all threads' spans land on one timeline
        self._origin = time.perf_counter()
        self._wall_unix = time.time()

    # -- recording ----------------------------------------------------------

    def _stack(self) -> list[str]:
        if not hasattr(self._local, "stack"):
            self._local.stack = []
        return self._local.stack

    def _now(self) -> float:
        return time.perf_counter() - self._origin

    def _commit(self, rec: SpanRecord) -> None:
        with self._lock:
            if len(self._ring) == self.capacity:
                self.dropped += 1
            self._ring.append(rec)

    @contextlib.contextmanager
    def span(self, name: str, **attrs):
        """Record ``name`` around the with-body, and open the profiler range
        ``name`` while a profiler records. Exceptions propagate; the span
        still completes (with ``attrs["error"]`` set)."""
        with torch.profiler.record_function(name) if _profiling() else _NO_RANGE:
            if not self.enabled:
                yield self
                return
            stack = self._stack()
            parent = stack[-1] if stack else None
            depth = len(stack)
            stack.append(name)
            t0 = self._now()
            try:
                yield self
            except BaseException as exc:
                attrs = dict(attrs)
                attrs["error"] = repr(exc)
                raise
            finally:
                stack.pop()
                self._commit(SpanRecord(
                    name=name, t0=t0, t1=self._now(),
                    tid=threading.get_ident(), depth=depth, parent=parent,
                    attrs=dict(attrs), wall_unix=self._wall_unix,
                ))

    def instant(self, name: str, **attrs) -> None:
        """Record a zero-duration event (submit/abandon markers)."""
        if not self.enabled:
            return
        stack = self._stack()
        t = self._now()
        self._commit(SpanRecord(
            name=name, t0=t, t1=t,
            tid=threading.get_ident(), depth=len(stack),
            parent=stack[-1] if stack else None,
            attrs=dict(attrs), wall_unix=self._wall_unix,
        ))

    # -- views --------------------------------------------------------------

    def spans(self, name: str | None = None) -> list[SpanRecord]:
        """Ring contents in completion order (oldest first); optionally
        filtered by exact name."""
        with self._lock:
            recs = list(self._ring)
        if name is not None:
            recs = [r for r in recs if r.name == name]
        return recs

    def total_s(self, name: str) -> float:
        """Summed duration of all in-ring spans named ``name``."""
        return sum(r.duration_s for r in self.spans(name))

    def summary(self) -> dict:
        """Per-name count/total seconds (the run report's span table)."""
        table: dict[str, dict] = {}
        for r in self.spans():
            row = table.setdefault(r.name, {"count": 0, "total_s": 0.0})
            row["count"] += 1
            row["total_s"] += r.duration_s
        return {
            "capacity": self.capacity,
            "dropped": self.dropped,
            "recorded": len(self.spans()),
            "by_name": table,
        }
