"""Run telemetry: span tracing, in-rollout health probes and run reports
(``obs/trace.py`` and ``obs/report.py`` are copies of the reference's
pure-Python modules).

* :mod:`repro_torch.obs.trace`  -- :class:`Tracer`: nestable wall-clock
  spans, a bounded ring + JSONL sink, and a Chrome trace exporter. The
  simulator drivers record a ``sim.segment`` span per rollout segment,
  the refresh controller its solves.
* :mod:`repro_torch.obs.probes` -- :class:`HealthProbes`: consensus
  distance, gradient deviation and Prop. 2's tau_bar at the live Pi_hat,
  computed inside the captured rollout body as extra per-step outputs
  (no extra capture, the run itself unchanged).
* :mod:`repro_torch.obs.report` -- :class:`RunReport` and
  :class:`RetraceGuard`. In the port the guard counts CUDA-graph captures
  of the rollout (``train/rollout.py``) where the reference counts jit
  traces, under the reference's names (``"mean_estimation.roll"``,
  ``"classification.roll"``).
"""

from .probes import (
    HealthProbes,
    compute_probes,
    consensus_sq,
    grad_deviation_sq,
    mix_pi_arrays,
    tau_bar_arrays,
    w_frobenius_sq,
    w_minus_j_frobenius_sq,
)
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
    "HealthProbes",
    "compute_probes",
    "consensus_sq",
    "grad_deviation_sq",
    "mix_pi_arrays",
    "tau_bar_arrays",
    "w_frobenius_sq",
    "w_minus_j_frobenius_sq",
    "RunReport",
    "RetraceGuard",
    "REPORT_SCHEMA",
    "validate_report",
    "load_report",
]
