"""The n-node D-SGD simulator and its metrics."""

from . import metrics, trainer
from .metrics import MetricLogger, consensus_distance, node_spread
from .trainer import StackedClassifier, run_classification, run_mean_estimation

__all__ = [
    "metrics",
    "trainer",
    "MetricLogger",
    "consensus_distance",
    "node_spread",
    "StackedClassifier",
    "run_classification",
    "run_mean_estimation",
]
