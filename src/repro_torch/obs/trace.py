"""Span tracing: where did a segment's wall time go?

A :class:`Tracer` records *spans* -- named wall-clock intervals with
nesting -- from any thread (the overlapped refresh solve runs on a
worker; its spans land in the same trace with their own thread id).
Three sinks, all cheap enough to leave on in production runs:

* a bounded in-memory ring (``capacity`` completed spans; overflow
  drops the OLDEST spans and counts them in ``dropped``, so a long run
  can keep a tracer attached without unbounded memory),
* an optional append-only JSONL file (``sink_path``): every completed
  span is written immediately, so the on-disk trace is complete even
  when the ring has wrapped, and survives a crash mid-run,
* a Chrome/Perfetto trace-event export (:meth:`to_perfetto` /
  :meth:`write_perfetto`): load the JSON in ``chrome://tracing`` or
  https://ui.perfetto.dev and see the rollout, the overlapped solve,
  the restage, and the checkpoint on one timeline.

Clocks are monotonic (``time.perf_counter``): span durations are
immune to wall-clock adjustments, and all spans of one tracer share a
single origin so they compose into one timeline. ``wall_unix`` on each
record anchors that timeline to the epoch once, at tracer creation.

Usage::

    tracer = Tracer(sink_path="trace.jsonl")
    with tracer.span("segment.rollout", t0=0, k=64):
        ...
        with tracer.span("segment.checkpoint"):
            ...
    tracer.instant("refresh.submit", t=63)
    tracer.write_perfetto("trace_perfetto.json")

Spans nest per-thread: the ``depth`` and ``parent`` fields record the
enclosing span at *entry* time, and the ring orders records by
*completion* (the parent closes after its children -- the Perfetto
"X" events reconstruct the nesting from timestamps, which is why the
exporter never needs the parent pointers).
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from contextlib import contextmanager
from collections import deque

__all__ = ["SpanRecord", "Tracer", "read_jsonl"]


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

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "t0": self.t0,
            "t1": self.t1,
            "tid": self.tid,
            "depth": self.depth,
            "parent": self.parent,
            "attrs": self.attrs,
            "wall_unix": self.wall_unix,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "SpanRecord":
        return cls(
            name=str(d["name"]),
            t0=float(d["t0"]),
            t1=float(d["t1"]),
            tid=int(d["tid"]),
            depth=int(d["depth"]),
            parent=d.get("parent"),
            attrs=dict(d.get("attrs") or {}),
            wall_unix=float(d.get("wall_unix", 0.0)),
        )


def _json_default(x):
    # attrs may carry numpy scalars / 0-d arrays from instrumented code;
    # coerce instead of crashing the sink mid-run
    try:
        return x.item()
    except AttributeError:
        return repr(x)


def read_jsonl(path: str) -> list[SpanRecord]:
    """Load a JSONL span sink back into records (the round-trip half)."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(SpanRecord.from_dict(json.loads(line)))
    return out


class Tracer:
    """Thread-safe span recorder with a bounded ring and optional sinks.

    Args:
      capacity: max completed spans held in memory. Overflow evicts the
        oldest records (counted in :attr:`dropped`); the JSONL sink, if
        configured, still holds everything.
      sink_path: append-mode JSONL file; one completed span per line,
        flushed per span (crash-honest).
      enabled: ``Tracer(enabled=False)`` is a no-op recorder -- every
        ``span()`` still runs its body, nothing is stored. Lets
        instrumented code take an always-on ``tracer`` argument with a
        disabled default instead of ``if tracer is not None`` forests.
    """

    def __init__(
        self,
        capacity: int = 4096,
        sink_path: str | None = None,
        enabled: bool = True,
    ):
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
        self._sink = None
        self.sink_path = sink_path
        if sink_path is not None and self.enabled:
            os.makedirs(os.path.dirname(os.path.abspath(sink_path)), exist_ok=True)
            self._sink = open(sink_path, "a")

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
            if self._sink is not None:
                self._sink.write(
                    json.dumps(rec.to_dict(), default=_json_default) + "\n"
                )
                self._sink.flush()

    @contextmanager
    def span(self, name: str, **attrs):
        """Record ``name`` around the with-body. Exceptions propagate;
        the span still completes (with ``attrs["error"]`` set)."""
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

    # -- views / export -----------------------------------------------------

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

    def to_perfetto(self) -> list[dict]:
        """Chrome trace-event list (``ph: "X"`` complete events, us).

        Instants become ``ph: "i"`` thread-scoped events. One metadata
        event per thread names it by its first span. Load the dumped
        JSON array in chrome://tracing or ui.perfetto.dev.
        """
        events: list[dict] = []
        named_tids: set[int] = set()
        for r in self.spans():
            if r.tid not in named_tids:
                named_tids.add(r.tid)
                events.append({
                    "ph": "M", "pid": 1, "tid": r.tid,
                    "name": "thread_name",
                    "args": {"name": f"thread-{r.tid % 100000}"},
                })
            base = {
                "name": r.name, "pid": 1, "tid": r.tid,
                "ts": r.t0 * 1e6, "cat": "repro",
                "args": dict(r.attrs),
            }
            if r.t1 == r.t0:
                events.append({**base, "ph": "i", "s": "t"})
            else:
                events.append({**base, "ph": "X", "dur": r.duration_s * 1e6})
        return events

    def write_perfetto(self, path: str) -> str:
        events = self.to_perfetto()
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            json.dump(events, f, default=_json_default)
        return path

    def write_jsonl(self, path: str) -> str:
        """Dump the ring to a JSONL file (distinct from the live sink:
        this is a one-shot export of what is currently in memory)."""
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            for r in self.spans():
                f.write(json.dumps(r.to_dict(), default=_json_default) + "\n")
        return path

    def close(self) -> None:
        if self._sink is not None:
            self._sink.close()
            self._sink = None

    def __enter__(self) -> "Tracer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
