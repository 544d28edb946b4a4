"""The simulator cells' inputs, made from the seed: an MNIST-shaped blob
set, its shard partition over the nodes, the linear model's initial
parameters and the minibatch indices. Both sides -- the port and the plain reference --
are handed these same arrays.

Frozen here so that a change to the port cannot move the yardstick: the
blobs follow ``repro_torch/data/synthetic.py``'s ``gaussian_blobs`` (class
means are random unit directions times ``sep``, unit Gaussian noise), drawn
on the device in a few large calls instead of numpy's; the partition is a
copy of ``repro_torch/data/partition.py``'s ``shard_partition``.
"""

from __future__ import annotations

import numpy as np
import torch


def blobs(seed: int, n_samples: int, num_classes: int, dim: int, sep: float, noise: float,
          device: torch.device) -> tuple[np.ndarray, np.ndarray]:
    """Features (n_samples, dim) float32 and labels (n_samples,) int32."""
    gen = torch.Generator(device=device).manual_seed(seed)
    means = torch.randn((num_classes, dim), generator=gen, device=device)
    means = sep * means / means.norm(dim=1, keepdim=True)
    y = torch.randint(0, num_classes, (n_samples,), generator=gen, device=device)
    X = means[y] + noise * torch.randn((n_samples, dim), generator=gen, device=device)
    return X.cpu().numpy(), y.to(torch.int32).cpu().numpy()


def proportions(labels: np.ndarray, indices_per_node: list[np.ndarray],
                num_classes: int) -> np.ndarray:
    """Pi: (n_nodes, K) label proportions of each node's samples."""
    Pi = np.zeros((len(indices_per_node), num_classes))
    for i, idx in enumerate(indices_per_node):
        counts = np.bincount(labels[idx], minlength=num_classes).astype(np.float64)
        Pi[i] = counts / counts.sum()
    return Pi


def shard_partition(labels: np.ndarray, n_nodes: int, shards_per_node: int, seed: int,
                    num_classes: int) -> tuple[list[np.ndarray], np.ndarray]:
    """McMahan's shards: sort by label, cut into ``n_nodes * shards_per_node``
    shards, deal ``shards_per_node`` of them to each node at random."""
    order = np.argsort(labels, kind="stable")
    n_shards = n_nodes * shards_per_node
    shards = np.array_split(order, n_shards)
    shard_ids = np.random.default_rng(seed).permutation(n_shards)
    indices = [np.sort(np.concatenate([shards[s] for s in
                                       shard_ids[i * shards_per_node:(i + 1) * shards_per_node]]))
               for i in range(n_nodes)]
    return indices, proportions(labels, indices, num_classes)


def linear_params0(seed: int, dim: int, num_classes: int,
                   device: torch.device) -> dict[str, np.ndarray]:
    """One node's linear model (every node starts from it): normal weights
    scaled by 0.01 and zero biases, as the paper's simulator draws them."""
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    w = torch.randn((dim, num_classes), generator=gen, device=device) * 0.01
    return {"w": w.cpu().numpy(), "b": np.zeros(num_classes, np.float32)}


def batch_pool(seed: int, steps: int, lengths: np.ndarray, batch: int,
               device: torch.device) -> torch.Tensor:
    """(steps, n, batch) int64 minibatch indices, node i's below
    ``lengths[i]``, drawn on the device and kept on the host (pinned where
    there is a card), so that a call's slice crosses to the card at the
    copy engine's rate."""
    gen = torch.Generator(device=device).manual_seed(seed + 2)
    n = len(lengths)
    u = torch.rand((steps, n, batch), generator=gen, device=device, dtype=torch.float64)
    lens = torch.as_tensor(np.asarray(lengths), dtype=torch.float64, device=device)
    idx = torch.floor(u * lens[None, :, None]).long()
    idx = torch.minimum(idx, (lens.long() - 1)[None, :, None])
    host = torch.empty(idx.shape, dtype=torch.int64, pin_memory=device.type == "cuda")
    host.copy_(idx)
    return host
