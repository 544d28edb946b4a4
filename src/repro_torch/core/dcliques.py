"""D-Cliques baseline (Bellet et al., 2022) -- the paper's data-dependent
competitor.

Builds a topology of sparsely inter-connected cliques such that the union of
local label distributions within each clique approximates the global
distribution. We implement the greedy construction:

1. Partition nodes into cliques of size ``clique_size`` by greedily adding
   the node whose label histogram most reduces the clique's distance to the
   global distribution ("skew" greedy).
2. Fully connect nodes within a clique.
3. Inter-connect cliques with a ring over cliques (one random edge between
   consecutive cliques per inter-edge budget).
4. Apply Metropolis-Hastings weights for double stochasticity.

This matches the behaviour the paper compares against: low bias (clique
unions are representative) but mediocre mixing (1 - p stays large).
"""

from __future__ import annotations

import numpy as np

from .topology import metropolis_hastings

__all__ = ["d_cliques"]


def _greedy_cliques(Pi: np.ndarray, clique_size: int, rng: np.random.Generator) -> list[list[int]]:
    n = Pi.shape[0]
    global_dist = Pi.mean(axis=0)
    remaining = list(rng.permutation(n))
    cliques: list[list[int]] = []
    while remaining:
        clique = [remaining.pop(0)]
        while len(clique) < clique_size and remaining:
            acc = Pi[clique].sum(axis=0)
            # pick the remaining node whose addition brings the clique mean
            # closest to the global distribution
            best_j, best_d = None, np.inf
            for idx, cand in enumerate(remaining):
                mean = (acc + Pi[cand]) / (len(clique) + 1)
                d = float(np.sum((mean - global_dist) ** 2))
                if d < best_d:
                    best_d, best_j = d, idx
            clique.append(remaining.pop(best_j))
        cliques.append(clique)
    return cliques


def d_cliques(
    Pi: np.ndarray,
    clique_size: int | None = None,
    inter_edges: int = 1,
    seed: int = 0,
) -> np.ndarray:
    """Build a D-Cliques mixing matrix from per-node class proportions.

    Args:
      Pi: (n, K) class proportions.
      clique_size: nodes per clique (default: K, one node per class-slot).
      inter_edges: number of ring edges between consecutive cliques.
      seed: rng seed for node ordering / edge endpoints.

    Returns:
      (n, n) doubly-stochastic mixing matrix (MH weights).
    """
    Pi = np.asarray(Pi, dtype=np.float64)
    n, K = Pi.shape
    if clique_size is None:
        clique_size = K
    rng = np.random.default_rng(seed)
    cliques = _greedy_cliques(Pi, clique_size, rng)

    A = np.zeros((n, n), dtype=bool)
    for clique in cliques:
        for a_i in clique:
            for b_i in clique:
                if a_i != b_i:
                    A[a_i, b_i] = True
    # ring over cliques
    C = len(cliques)
    if C > 1:
        for c in range(C):
            nxt = (c + 1) % C
            for _ in range(inter_edges):
                a_i = int(rng.choice(cliques[c]))
                b_i = int(rng.choice(cliques[nxt]))
                A[a_i, b_i] = A[b_i, a_i] = True
    return metropolis_hastings(A)
