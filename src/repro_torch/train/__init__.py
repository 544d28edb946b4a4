"""The n-node D-SGD simulator, its captured rollout, its metrics and its
checkpoints."""

from . import checkpoints, metrics, rollout, trainer
from .checkpoints import CheckpointManager, restore_checkpoint, save_checkpoint
from .metrics import CommMeter, MetricLogger, consensus_distance, mix_bytes_per_step, node_spread
from .trainer import StackedClassifier, run_classification, run_mean_estimation

__all__ = [
    "checkpoints",
    "CheckpointManager",
    "restore_checkpoint",
    "save_checkpoint",
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
