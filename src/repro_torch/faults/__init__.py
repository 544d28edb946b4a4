"""Fault injection and graceful degradation for decentralized training.

* :class:`FaultPlan` / :class:`FaultInjector` -- deterministic fault
  traces (crash/rejoin windows, per-edge message drops, bounded-delay
  stragglers, overlap-worker failures, wire corruption) from a single
  seed, identical across processes and checkpoint resumes (a numpy copy
  of the reference's ``faults/plan.py``).
* :class:`FlakyRefresher` -- wraps a ``TopologyRefresher`` so its solves
  raise or hang per the plan.
* :class:`ScreenPolicy` / :class:`QuarantineController` -- the defense
  against nodes that lie: receiver-side screens thresholded from the
  run's own probes, streak-confirmed quarantine with a doubly stochastic
  repair, probation re-admission (a numpy copy of the reference's
  ``faults/quarantine.py``).
* :func:`run_faulty_mean_estimation` -- the mean-estimation simulator
  under faults as a captured rollout: degraded mixing, the staleness
  ring, wire corruption and screening, and crash recovery from
  ``train.checkpoints``, with one capture for the whole run.
"""

from .plan import FaultInjector, FaultPlan, FlakyRefresher
from .quarantine import QuarantineController, ScreenPolicy, false_quarantines
from .runner import run_faulty_mean_estimation

__all__ = [
    "FaultPlan",
    "FaultInjector",
    "FlakyRefresher",
    "ScreenPolicy",
    "QuarantineController",
    "false_quarantines",
    "run_faulty_mean_estimation",
]
