"""Heterogeneous data partitioners for decentralized learning.

Implements the label-skew partitioning schemes the paper uses:

* ``shard_partition`` -- the McMahan et al. (2017) scheme used in Section 6.2:
  sort by label, split into ``2n`` equal shards, deal 2 shards per node. Most
  nodes see 2 classes; label-boundary shards can carry up to 4.
* ``dirichlet_partition`` -- Dirichlet(alpha) label-skew (common FL benchmark,
  provided for the "beyond label skew" extension suggested in the paper's
  conclusion).
* ``cluster_partition`` -- one class per node group (the Section 6.1 synthetic
  setup: n nodes, K clusters, n/K nodes per cluster).

All partitioners return ``(indices_per_node, Pi)`` where ``Pi[i, k]`` is the
empirical class proportion of node i -- exactly the matrix STL-FW consumes.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "shard_partition",
    "dirichlet_partition",
    "cluster_partition",
    "proportions_from_labels",
]


def proportions_from_labels(
    labels: np.ndarray, indices_per_node: list[np.ndarray], num_classes: int
) -> np.ndarray:
    """Empirical per-node class proportions Pi from a partition.

    Empty nodes (churn, extreme skew) get the uniform row -- the
    agnostic prior, which also keeps every row on the simplex so
    ``learn_topology``'s input contract holds under drift resampling.
    """
    labels = np.asarray(labels)
    n = len(indices_per_node)
    Pi = np.zeros((n, num_classes))
    for i, idx in enumerate(indices_per_node):
        if len(idx) == 0:
            Pi[i] = 1.0 / num_classes
            continue
        node_labels = labels[idx]
        if node_labels.min() < 0 or node_labels.max() >= num_classes:
            # out-of-range labels would silently widen bincount and
            # break the (n, K) shape contract downstream
            raise ValueError(
                f"node {i} has labels outside [0, {num_classes}); pass the "
                "task's true num_classes"
            )
        counts = np.bincount(node_labels, minlength=num_classes)
        Pi[i] = counts / counts.sum()
    return Pi


def _resolve_num_classes(labels: np.ndarray, num_classes: int | None) -> int:
    """K for a partitioner: explicit wins; else inferred from the labels.

    Under drift resampling a class can be temporarily absent from the
    observed labels -- inferring K from ``labels.max()`` then silently
    *shrinks Pi's width* between resamples, which breaks every consumer
    that compares or warm-starts across time (the streaming estimator,
    the refresh controller). Callers that resample over time must pass
    the task's true ``num_classes``.
    """
    if num_classes is not None:
        if num_classes < 1:
            raise ValueError(f"num_classes must be >= 1, got {num_classes}")
        if labels.size and labels.max() >= num_classes:
            raise ValueError(
                f"labels contain class {int(labels.max())} >= num_classes={num_classes}"
            )
        return int(num_classes)
    if labels.size == 0:
        raise ValueError("cannot infer num_classes from empty labels; pass it")
    return int(labels.max()) + 1


def shard_partition(
    labels: np.ndarray,
    n_nodes: int,
    shards_per_node: int = 2,
    seed: int = 0,
    num_classes: int | None = None,
) -> tuple[list[np.ndarray], np.ndarray]:
    """McMahan-style shard partition (sort by label, deal shards).

    Args:
      labels: (N,) integer labels.
      n_nodes: number of agents.
      shards_per_node: shards dealt to each node (2 in the paper).
      seed: shard-dealing rng seed.
      num_classes: fixed K for the returned Pi; pass it when resampling
        under drift (see ``_resolve_num_classes``), else inferred.
    """
    labels = np.asarray(labels)
    num_classes = _resolve_num_classes(labels, num_classes)
    order = np.argsort(labels, kind="stable")
    n_shards = n_nodes * shards_per_node
    shards = np.array_split(order, n_shards)
    rng = np.random.default_rng(seed)
    shard_ids = rng.permutation(n_shards)
    indices_per_node = []
    for i in range(n_nodes):
        mine = shard_ids[i * shards_per_node : (i + 1) * shards_per_node]
        idx = np.concatenate([shards[s] for s in mine])
        indices_per_node.append(np.sort(idx))
    Pi = proportions_from_labels(labels, indices_per_node, num_classes)
    return indices_per_node, Pi


def dirichlet_partition(
    labels: np.ndarray,
    n_nodes: int,
    alpha: float = 0.5,
    seed: int = 0,
    num_classes: int | None = None,
) -> tuple[list[np.ndarray], np.ndarray]:
    """Dirichlet(alpha) label-skew partition (lower alpha = more skew).

    Robust to the drift-resampling edge cases: a class absent from
    ``labels`` contributes empty chunks (pass ``num_classes`` so Pi
    keeps its width), and nodes that end up with zero samples get the
    uniform Pi row from ``proportions_from_labels``.
    """
    labels = np.asarray(labels)
    num_classes = _resolve_num_classes(labels, num_classes)
    rng = np.random.default_rng(seed)
    idx_by_class = [np.nonzero(labels == k)[0] for k in range(num_classes)]
    node_lists: list[list[np.ndarray]] = [[] for _ in range(n_nodes)]
    for k in range(num_classes):
        idx = rng.permutation(idx_by_class[k])
        props = rng.dirichlet(alpha * np.ones(n_nodes))
        cuts = (np.cumsum(props) * len(idx)).astype(int)[:-1]
        for i, chunk in enumerate(np.split(idx, cuts)):
            node_lists[i].append(chunk)
    indices_per_node = [
        np.sort(np.concatenate(chunks)) if chunks else np.array([], dtype=np.int64)
        for chunks in node_lists
    ]
    Pi = proportions_from_labels(labels, indices_per_node, num_classes)
    return indices_per_node, Pi


def cluster_partition(
    labels: np.ndarray, n_nodes: int, seed: int = 0, num_classes: int | None = None
) -> tuple[list[np.ndarray], np.ndarray]:
    """One class per node (Section 6.1): node i gets class ``i % K`` data."""
    labels = np.asarray(labels)
    num_classes = _resolve_num_classes(labels, num_classes)
    rng = np.random.default_rng(seed)
    idx_by_class = [rng.permutation(np.nonzero(labels == k)[0]) for k in range(num_classes)]
    counters = [0] * num_classes
    nodes_of_class = [np.nonzero(np.arange(n_nodes) % num_classes == k)[0] for k in range(num_classes)]
    indices_per_node: list[np.ndarray] = [None] * n_nodes  # type: ignore
    for k in range(num_classes):
        chunks = np.array_split(idx_by_class[k], max(len(nodes_of_class[k]), 1))
        for node, chunk in zip(nodes_of_class[k], chunks):
            indices_per_node[node] = np.sort(chunk)
    for i in range(n_nodes):
        if indices_per_node[i] is None:
            indices_per_node[i] = np.array([], dtype=np.int64)
    Pi = proportions_from_labels(labels, indices_per_node, num_classes)
    return indices_per_node, Pi
