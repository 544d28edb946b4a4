"""Data substrate: copies of the reference's numpy partitioners, synthetic
sets, drift scenarios and domain-skew LM token streams."""

from . import drift, partition, synthetic, tokens
from .drift import (
    AbruptLabelSwap,
    ConceptShift,
    FeatureDrift,
    GradualDirichlet,
    NodeChurn,
    features_stream,
    labels_stream,
    partition_from_pi,
)
from .partition import (
    cluster_partition,
    dirichlet_partition,
    proportions_from_labels,
    shard_partition,
)
from .synthetic import MeanEstimationTask, gaussian_blobs, mean_estimation_clusters
from .tokens import DomainSkewCorpus, TokenBatcher

__all__ = [
    "drift",
    "partition",
    "synthetic",
    "tokens",
    "AbruptLabelSwap",
    "ConceptShift",
    "FeatureDrift",
    "GradualDirichlet",
    "NodeChurn",
    "features_stream",
    "labels_stream",
    "partition_from_pi",
    "cluster_partition",
    "dirichlet_partition",
    "proportions_from_labels",
    "shard_partition",
    "MeanEstimationTask",
    "gaussian_blobs",
    "mean_estimation_clusters",
    "DomainSkewCorpus",
    "TokenBatcher",
]
