"""Run telemetry: span tracing, in-rollout health probes and run reports
(``obs/report.py`` is a copy of the reference's pure-Python module;
``obs/trace.py`` began as one).

* :mod:`repro_torch.obs.trace`  -- :class:`Tracer`: nestable wall-clock
  spans in a bounded ring. Unlike the reference's copy, each span is also
  a ``torch.profiler.record_function`` range while a profiler records
  (so it lands on the device trace's clock), and there are no exporters
  (no JSONL sink, no Perfetto events). The port records
  ``sim.prepare``, ``sim.segment``, ``sim.eval`` and ``sim.release``
  around a simulator call's phases, ``graph.warmup`` / ``graph.capture``
  around a body's first two runs (``graphs.GraphRunner``), and its
  refresh solves, fault streams and LM segments; the module docstring
  names each span's reader.
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
from .trace import SpanRecord, Tracer

__all__ = [
    "Tracer",
    "SpanRecord",
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
