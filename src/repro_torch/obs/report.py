"""Run reports and the retrace guard.

Two pieces the rest of the repo reports through:

* :class:`RetraceGuard` -- a first-class jit cache-miss counter. Every
  driver and bench in this repo re-implements the same bookkeeping (a
  ``nonlocal n_traces`` bumped inside a jitted wrapper's Python body)
  to assert the load-bearing invariant: schedule hot-swaps, staleness,
  compression, and health probes are all VALUE changes, so a compiled
  rollout traces exactly once. The guard centralizes that: ``wrap`` a
  function before jitting (or hand it an already-scanned body),
  declare how many compiles you *expect* per name, and ``excess()``
  is the number of unexplained retraces -- the quantity that must be
  zero in CI.

* :class:`RunReport` -- one registry that aggregates what a run
  produced: the ``MetricLogger`` history, ``CommMeter`` byte fates,
  refresh / fault / staleness events, health-probe series, tracer
  span summaries, and the retrace-guard table, into a versioned JSON
  document (``repro.run_report/v1``) plus a human-readable markdown
  rendering. ``benchmarks/run.py --smoke`` emits one and CI validates
  it with :func:`validate_report`.
"""

from __future__ import annotations

import json
import os
from typing import Any, Callable

import numpy as np

__all__ = [
    "RetraceGuard",
    "RunReport",
    "REPORT_SCHEMA",
    "validate_report",
]

REPORT_SCHEMA = "repro.run_report/v1"


class RetraceGuard:
    """Counts XLA compiles per named function and audits them.

    ``wrap(fn, name)`` returns a function whose *Python body* bumps the
    counter and calls ``fn`` -- jit the wrapper (not ``fn``) and every
    cache miss executes the body once, so ``counts[name]`` is exactly
    the number of traces. This generalizes the ``nonlocal n_traces``
    idiom scattered through the drivers; ``record(name)`` serves code
    that already has a counting site and just wants the ledger.

    ``expect(name, n)`` declares the compile budget (usually 1 per
    distinct rollout shape); ``excess()`` sums traces beyond budget --
    the number that must be 0 for the hot-swap invariant to hold.
    Names never expected (pure ``record`` streams) budget at their
    first-seen count only if declared; undeclared names count fully
    toward ``total()`` but not ``excess()`` -- budget what you audit.
    """

    def __init__(self):
        self.counts: dict[str, int] = {}
        self.expected: dict[str, int] = {}

    def record(self, name: str, k: int = 1) -> None:
        self.counts[name] = self.counts.get(name, 0) + int(k)

    def wrap(self, fn: Callable, name: str) -> Callable:
        """Return ``fn`` with a trace-counting Python body; jit the result."""

        def counted(*args, **kwargs):
            self.record(name)
            return fn(*args, **kwargs)

        counted.__name__ = getattr(fn, "__name__", name)
        return counted

    def expect(self, name: str, n: int = 1) -> None:
        """Declare that ``name`` is budgeted ``n`` compiles."""
        self.expected[name] = int(n)

    def count(self, name: str) -> int:
        return self.counts.get(name, 0)

    def total(self) -> int:
        return sum(self.counts.values())

    def excess(self) -> int:
        """Traces beyond budget across all *declared* names (>= 0 each)."""
        return sum(
            max(self.counts.get(name, 0) - n, 0)
            for name, n in self.expected.items()
        )

    def snapshot(self) -> dict:
        return {
            "counts": dict(self.counts),
            "expected": dict(self.expected),
            "total": self.total(),
            "excess": self.excess(),
        }


def _scrub(x: Any) -> Any:
    """Make a nested structure json.dump-safe (numpy/jax scalars, arrays)."""
    if isinstance(x, dict):
        return {str(k): _scrub(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_scrub(v) for v in x]
    if isinstance(x, (str, int, float, bool)) or x is None:
        return x
    if isinstance(x, np.ndarray):
        return _scrub(x.tolist())
    item = getattr(x, "item", None)
    if callable(item):
        try:
            return _scrub(item())
        except (TypeError, ValueError):
            pass
    return repr(x)


class RunReport:
    """Aggregates one run's telemetry into a versioned JSON/markdown doc.

    Feed it whatever the run produced -- every section is optional --
    then ``write(dir)`` for the artifact pair (``run_report.json`` +
    ``run_report.md``). The JSON always carries ``schema`` and
    ``meta``; :func:`validate_report` checks the structural contract
    CI relies on.
    """

    def __init__(self, name: str, **meta):
        self.name = str(name)
        self.meta = _scrub(dict(meta))
        self._metrics: list[dict] = []
        self._metrics_aux: dict = {}
        self._comm: dict | None = None
        self._events: dict[str, list] = {}
        self._health: dict[str, list] = {}
        self._spans: dict | None = None
        self._retraces: dict | None = None
        self._quarantine: dict | None = None

    # -- ingestion (each accepts the repo's native object OR plain data) ----

    def add_metrics(self, logger) -> "RunReport":
        """A ``MetricLogger`` (or any object with .history/.aux)."""
        self._metrics = _scrub(list(logger.history))
        self._metrics_aux = _scrub(dict(logger.aux))
        return self

    def add_comm(self, meter) -> "RunReport":
        """A ``CommMeter`` (or any object with .summary() -> dict)."""
        self._comm = _scrub(meter.summary())
        return self

    def add_events(self, kind: str, events) -> "RunReport":
        """Append refresh/fault/staleness event dicts under ``kind``."""
        self._events.setdefault(str(kind), []).extend(_scrub(list(events)))
        return self

    def add_health(self, series: dict) -> "RunReport":
        """Per-probe value series, e.g. ``{"consensus": [...], ...}``."""
        for k, v in series.items():
            self._health.setdefault(str(k), []).extend(
                _scrub(np.asarray(v).reshape(-1).tolist())
            )
        return self

    def add_spans(self, tracer) -> "RunReport":
        """A ``Tracer`` -- stores its per-name summary, not raw spans
        (the raw trace ships as its own JSONL artifact)."""
        self._spans = _scrub(tracer.summary())
        return self

    def add_retraces(self, guard: RetraceGuard) -> "RunReport":
        self._retraces = guard.snapshot()
        return self

    def add_quarantine(self, summary: dict) -> "RunReport":
        """A ``QuarantineController.summary()`` dict (or plain data).

        Stored as its own versioned block: the section is OPTIONAL in
        the ``repro.run_report/v1`` document (absent = the run had no
        corruption defense -- every pre-existing report stays valid),
        and when present it carries its own ``version`` tag so the
        block can evolve without bumping the whole report schema.
        """
        s = _scrub(dict(summary))
        self._quarantine = {
            "version": 1,
            "n_quarantines": int(s.get("n_quarantines", 0)),
            "n_readmissions": int(s.get("n_readmissions", 0)),
            "quarantined_now": list(s.get("quarantined_now", [])),
            "events": list(s.get("events", [])),
        }
        return self

    # -- emission -----------------------------------------------------------

    def to_dict(self) -> dict:
        doc = {
            "schema": REPORT_SCHEMA,
            "name": self.name,
            "meta": self.meta,
            "metrics": {"history": self._metrics, "aux": self._metrics_aux},
            "comm": self._comm,
            "events": self._events,
            "health": self._health,
            "spans": self._spans,
            "retraces": self._retraces,
        }
        # optional block: only emitted when a defense actually ran, so
        # documents round-trip byte-compatibly with pre-quarantine readers
        if self._quarantine is not None:
            doc["quarantine"] = self._quarantine
        return doc

    def to_json(self, indent: int = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent, allow_nan=False)

    def to_markdown(self) -> str:
        d = self.to_dict()
        lines = [f"# Run report: {self.name}", ""]
        if self.meta:
            lines.append("## Meta")
            for k, v in sorted(self.meta.items()):
                lines.append(f"- **{k}**: {v}")
            lines.append("")
        if self._retraces is not None:
            r = self._retraces
            lines += [
                "## Retraces",
                f"- total compiles: {r['total']}  |  "
                f"excess beyond budget: **{r['excess']}**",
            ]
            for name in sorted(r["counts"]):
                exp = r["expected"].get(name)
                budget = f" (expected {exp})" if exp is not None else ""
                lines.append(f"- `{name}`: {r['counts'][name]}{budget}")
            lines.append("")
        if self._comm is not None:
            c = self._comm
            lines += [
                "## Communication",
                "| fate | bytes |",
                "|---|---|",
                f"| delivered | {c.get('total_bytes', 0)} |",
                f"| dropped | {c.get('dropped_bytes', 0)} |",
                f"| deferred (late, subset of delivered) | "
                f"{c.get('deferred_bytes', 0)} |",
                f"| quarantined (isolated, subset of delivered) | "
                f"{c.get('quarantined_bytes', 0)} |",
                f"| retransmitted | {c.get('retransmit_bytes', 0)} |",
                "",
                f"{c.get('steps', 0)} steps at {c.get('per_step_bytes', 0)} "
                f"bytes/node/step.",
                "",
            ]
        if self._health:
            lines += ["## Health series", "| probe | points | last | max |",
                      "|---|---|---|---|"]
            for k in sorted(self._health):
                v = self._health[k]
                last = f"{v[-1]:.6g}" if v else "-"
                vmax = f"{max(v):.6g}" if v else "-"
                lines.append(f"| {k} | {len(v)} | {last} | {vmax} |")
            lines.append("")
        if self._spans is not None:
            lines += [
                "## Spans",
                f"{self._spans.get('recorded', 0)} recorded, "
                f"{self._spans.get('dropped', 0)} dropped from the ring.",
                "| span | count | total s |",
                "|---|---|---|",
            ]
            by = self._spans.get("by_name", {})
            for k in sorted(by):
                lines.append(
                    f"| `{k}` | {by[k]['count']} | {by[k]['total_s']:.4f} |"
                )
            lines.append("")
        if self._quarantine is not None:
            q = self._quarantine
            lines += [
                "## Quarantine",
                f"- quarantines: {q['n_quarantines']}  |  re-admissions: "
                f"{q['n_readmissions']}  |  isolated at end: "
                f"{q['quarantined_now'] or 'none'}",
                f"- {len(q['events'])} lifecycle events",
                "",
            ]
        if self._events:
            lines.append("## Events")
            for kind in sorted(self._events):
                lines.append(f"- **{kind}**: {len(self._events[kind])} events")
            lines.append("")
        if self._metrics:
            lines += [
                "## Metrics",
                f"{len(self._metrics)} logged rows; aux keys: "
                f"{sorted(self._metrics_aux) or 'none'}.",
                "",
            ]
        return "\n".join(lines)

    def write(self, out_dir: str, stem: str = "run_report") -> dict[str, str]:
        """Write ``<stem>.json`` + ``<stem>.md`` into ``out_dir``."""
        os.makedirs(out_dir, exist_ok=True)
        paths = {
            "json": os.path.join(out_dir, f"{stem}.json"),
            "md": os.path.join(out_dir, f"{stem}.md"),
        }
        with open(paths["json"], "w") as f:
            f.write(self.to_json() + "\n")
        with open(paths["md"], "w") as f:
            f.write(self.to_markdown() + "\n")
        return paths


def validate_report(doc: dict) -> None:
    """Structural validation of a run-report dict; raises ValueError.

    The contract CI enforces on the smoke artifact: schema tag, name,
    all sections present with the right container types, health series
    all-finite floats, and the retrace table internally consistent.
    """
    if not isinstance(doc, dict):
        raise ValueError(f"report must be a dict, got {type(doc).__name__}")
    if doc.get("schema") != REPORT_SCHEMA:
        raise ValueError(
            f"schema mismatch: expected {REPORT_SCHEMA!r}, "
            f"got {doc.get('schema')!r}"
        )
    if not isinstance(doc.get("name"), str) or not doc["name"]:
        raise ValueError("report.name must be a non-empty string")
    for key, typ in [
        ("meta", dict), ("metrics", dict), ("events", dict), ("health", dict),
    ]:
        if not isinstance(doc.get(key), typ):
            raise ValueError(f"report.{key} must be a {typ.__name__}")
    m = doc["metrics"]
    if not isinstance(m.get("history"), list) or not isinstance(
        m.get("aux"), dict
    ):
        raise ValueError("report.metrics needs 'history' list and 'aux' dict")
    for kind, events in doc["events"].items():
        if not isinstance(events, list):
            raise ValueError(f"report.events[{kind!r}] must be a list")
    for probe, series in doc["health"].items():
        if not isinstance(series, list):
            raise ValueError(f"report.health[{probe!r}] must be a list")
        arr = np.asarray(series, dtype=np.float64)
        if arr.size and not np.all(np.isfinite(arr)):
            raise ValueError(f"report.health[{probe!r}] has non-finite values")
    comm = doc.get("comm")
    if comm is not None:
        for k in ("total_bytes", "dropped_bytes", "deferred_bytes", "steps"):
            if not isinstance(comm.get(k), int) or comm[k] < 0:
                raise ValueError(f"report.comm[{k!r}] must be a non-neg int")
        if comm["deferred_bytes"] > comm["total_bytes"]:
            raise ValueError(
                "report.comm: deferred_bytes exceeds total_bytes (deferred "
                "is a subset of delivered)"
            )
        # optional fate -- absent in pre-quarantine reports
        qb = comm.get("quarantined_bytes")
        if qb is not None:
            if not isinstance(qb, int) or qb < 0:
                raise ValueError(
                    "report.comm['quarantined_bytes'] must be a non-neg int"
                )
            if qb > comm["total_bytes"]:
                raise ValueError(
                    "report.comm: quarantined_bytes exceeds total_bytes "
                    "(quarantined is a subset of delivered)"
                )
    spans = doc.get("spans")
    if spans is not None:
        if not isinstance(spans.get("by_name"), dict):
            raise ValueError("report.spans.by_name must be a dict")
        for name, row in spans["by_name"].items():
            if not (isinstance(row.get("count"), int) and row["count"] >= 1):
                raise ValueError(f"report.spans.by_name[{name!r}] bad count")
            if not (
                isinstance(row.get("total_s"), (int, float))
                and row["total_s"] >= 0.0
            ):
                raise ValueError(f"report.spans.by_name[{name!r}] bad total_s")
    rt = doc.get("retraces")
    if rt is not None:
        for k in ("counts", "expected"):
            if not isinstance(rt.get(k), dict):
                raise ValueError(f"report.retraces[{k!r}] must be a dict")
        if rt.get("total") != sum(rt["counts"].values()):
            raise ValueError("report.retraces.total inconsistent with counts")
        excess = sum(
            max(rt["counts"].get(name, 0) - n, 0)
            for name, n in rt["expected"].items()
        )
        if rt.get("excess") != excess:
            raise ValueError("report.retraces.excess inconsistent")
    # OPTIONAL versioned block: absent in every pre-quarantine report
    # (PR 9 documents validate unchanged); when present, checked fully
    q = doc.get("quarantine")
    if q is not None:
        if not isinstance(q, dict):
            raise ValueError("report.quarantine must be a dict")
        if not isinstance(q.get("version"), int) or q["version"] < 1:
            raise ValueError("report.quarantine.version must be an int >= 1")
        for k in ("n_quarantines", "n_readmissions"):
            if not isinstance(q.get(k), int) or q[k] < 0:
                raise ValueError(f"report.quarantine[{k!r}] must be a non-neg int")
        if not isinstance(q.get("events"), list):
            raise ValueError("report.quarantine.events must be a list")
        for ev in q["events"]:
            if not isinstance(ev, dict) or "t" not in ev or "node" not in ev:
                raise ValueError(
                    "report.quarantine.events entries need 't' and 'node'"
                )
            if ev.get("event") not in ("quarantine", "probation", "readmitted"):
                raise ValueError(
                    f"report.quarantine.events: unknown event {ev.get('event')!r}"
                )


def load_report(path: str) -> dict:
    """Read + validate a run-report JSON file."""
    with open(path) as f:
        doc = json.load(f)
    validate_report(doc)
    return doc
