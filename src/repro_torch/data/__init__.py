"""Data substrate: copies of the reference's numpy partitioners and synthetic sets."""

from . import partition, synthetic
from .partition import (
    cluster_partition,
    dirichlet_partition,
    proportions_from_labels,
    shard_partition,
)
from .synthetic import MeanEstimationTask, gaussian_blobs, mean_estimation_clusters

__all__ = [
    "partition",
    "synthetic",
    "cluster_partition",
    "dirichlet_partition",
    "proportions_from_labels",
    "shard_partition",
    "MeanEstimationTask",
    "gaussian_blobs",
    "mean_estimation_clusters",
]
