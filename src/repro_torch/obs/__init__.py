"""Run telemetry: span tracing and run reports (copies of the reference's
pure-Python ``obs/trace.py`` and ``obs/report.py``).

* :mod:`repro_torch.obs.trace`  -- :class:`Tracer`: nestable wall-clock
  spans, a bounded ring + JSONL sink, and a Chrome trace exporter. The
  simulator drivers record a ``sim.segment`` span per rollout segment,
  the refresh controller its solves.
* :mod:`repro_torch.obs.report` -- :class:`RunReport` and
  :class:`RetraceGuard`. In the port the guard counts CUDA-graph captures
  of the rollout (``train/rollout.py``) where the reference counts jit
  traces, under the reference's names (``"mean_estimation.roll"``,
  ``"classification.roll"``).

The reference's in-rollout health probes (``obs/probes.py``) are not
ported yet.
"""

from .report import (
    REPORT_SCHEMA,
    RetraceGuard,
    RunReport,
    load_report,
    validate_report,
)
from .trace import SpanRecord, Tracer, read_jsonl

__all__ = [
    "Tracer",
    "SpanRecord",
    "read_jsonl",
    "RunReport",
    "RetraceGuard",
    "REPORT_SCHEMA",
    "validate_report",
    "load_report",
]
