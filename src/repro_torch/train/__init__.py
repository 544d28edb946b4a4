"""The n-node D-SGD simulator, its captured rollout and its metrics."""

from . import metrics, rollout, trainer
from .metrics import CommMeter, MetricLogger, consensus_distance, mix_bytes_per_step, node_spread
from .trainer import StackedClassifier, run_classification, run_mean_estimation

__all__ = [
    "metrics",
    "rollout",
    "trainer",
    "CommMeter",
    "MetricLogger",
    "consensus_distance",
    "mix_bytes_per_step",
    "node_spread",
    "StackedClassifier",
    "run_classification",
    "run_mean_estimation",
]
