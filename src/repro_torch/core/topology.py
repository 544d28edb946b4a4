"""Communication topologies (mixing matrices) for decentralized SGD.

A topology is represented by a doubly-stochastic mixing matrix
``W in [0, 1]^{n x n}`` (paper, Section 3): ``W @ 1 = 1`` and ``1^T @ W = 1^T``.
``W[i, j] > 0`` means node ``i`` receives (and weights) messages from ``j``.

This module provides the static topologies used by the paper as baselines
(complete graph, ring, random d-regular, deterministic exponential graph,
star, torus) together with mixing-matrix utilities:

* ``mixing_parameter``     -- the ``p`` of Assumption 3, ``p = 1 - lambda_2(W^T W)``
* ``in_degrees/out_degrees/max_degree`` -- communication complexity (Eq. 2)
* ``is_doubly_stochastic`` -- validation
* ``metropolis_hastings``  -- MH weights for an arbitrary undirected graph

Everything here is plain numpy (topology construction is host-side
pre-processing, exactly as in the paper); the resulting ``W`` is consumed by
the JAX trainers.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "complete",
    "ring",
    "alternating_ring",
    "random_d_regular",
    "exponential_graph",
    "star",
    "torus",
    "disconnected",
    "mixing_parameter",
    "spectral_gap",
    "in_degrees",
    "out_degrees",
    "max_in_degree",
    "max_out_degree",
    "max_degree",
    "is_doubly_stochastic",
    "metropolis_hastings",
    "self_loop_lazy",
]

_EPS = 1e-12


# ---------------------------------------------------------------------------
# Validation / measurement utilities
# ---------------------------------------------------------------------------

def is_doubly_stochastic(W: np.ndarray, atol: float = 1e-8) -> bool:
    """Check ``W 1 = 1``, ``1^T W = 1^T`` and ``W >= 0``."""
    W = np.asarray(W, dtype=np.float64)
    if W.ndim != 2 or W.shape[0] != W.shape[1]:
        return False
    n = W.shape[0]
    ones = np.ones(n)
    return (
        bool(np.all(W >= -atol))
        and bool(np.allclose(W @ ones, ones, atol=atol))
        and bool(np.allclose(ones @ W, ones, atol=atol))
    )


def mixing_parameter(W: np.ndarray) -> float:
    """The ``p`` of Assumption 3: ``p = 1 - lambda_2(W^T W)``.

    Always valid (Boyd et al., 2006); the returned value is clipped to
    ``[0, 1]`` against numerical noise.
    """
    W = np.asarray(W, dtype=np.float64)
    n = W.shape[0]
    gram = W.T @ W
    # Deflate the top eigenpair (eigvec 1/sqrt(n), eigval 1) then take the max.
    gram_defl = gram - np.ones((n, n)) / n
    eig = np.linalg.eigvalsh(gram_defl)
    lam2 = float(eig[-1])
    return float(np.clip(1.0 - lam2, 0.0, 1.0))


def spectral_gap(W: np.ndarray) -> float:
    """``1 - |lambda_2(W)|`` for symmetric W (classical connectivity measure)."""
    W = np.asarray(W, dtype=np.float64)
    eig = np.linalg.eigvals(W)
    mags = np.sort(np.abs(eig))[::-1]
    return float(1.0 - (mags[1] if len(mags) > 1 else 0.0))


def in_degrees(W: np.ndarray, include_self: bool = False) -> np.ndarray:
    """Number of in-neighbors per node (Eq. 2, without the self edge)."""
    W = np.asarray(W)
    mask = W > _EPS
    if not include_self:
        mask = mask & ~np.eye(W.shape[0], dtype=bool)
    return mask.sum(axis=1)


def out_degrees(W: np.ndarray, include_self: bool = False) -> np.ndarray:
    return in_degrees(W.T, include_self=include_self)


def max_in_degree(W: np.ndarray) -> int:
    return int(in_degrees(W).max())


def max_out_degree(W: np.ndarray) -> int:
    return int(out_degrees(W).max())


def max_degree(W: np.ndarray) -> int:
    """``d_max = max(d_max_in, d_max_out)`` -- the communication budget."""
    return max(max_in_degree(W), max_out_degree(W))


# ---------------------------------------------------------------------------
# Static topologies
# ---------------------------------------------------------------------------

def complete(n: int) -> np.ndarray:
    """Fully-connected uniform topology: ``W = 11^T / n`` (C-PSGD)."""
    return np.full((n, n), 1.0 / n)


def disconnected(n: int) -> np.ndarray:
    """No communication: ``W = I`` (pure local SGD)."""
    return np.eye(n)


def ring(n: int, self_weight: float = 0.5) -> np.ndarray:
    """Symmetric ring: each node averages itself and its two ring neighbors.

    Default weights follow Example 1 of the paper: diagonal 1/2 and
    off-diagonal 1/4 each.
    """
    if n == 1:
        return np.eye(1)
    if n == 2:
        return np.array([[self_weight, 1 - self_weight], [1 - self_weight, self_weight]])
    W = np.zeros((n, n))
    side = (1.0 - self_weight) / 2.0
    for i in range(n):
        W[i, i] = self_weight
        W[i, (i + 1) % n] = side
        W[i, (i - 1) % n] = side
    return W


def alternating_ring(n: int) -> np.ndarray:
    """Example 1's ring: ring over nodes ordered so neighbors alternate parity.

    With nodes laid out 0, 1, ..., n-1 the natural ring already alternates
    odd/even, matching the paper's construction (diag 1/2, neighbors 1/4).
    ``n`` must be even.
    """
    if n % 2 != 0:
        raise ValueError("alternating_ring requires an even number of nodes")
    return ring(n, self_weight=0.5)


def star(n: int) -> np.ndarray:
    """Server-like star topology (node 0 = hub), MH weights, doubly stochastic."""
    A = np.zeros((n, n), dtype=bool)
    A[0, 1:] = True
    A[1:, 0] = True
    return metropolis_hastings(A)


def torus(rows: int, cols: int) -> np.ndarray:
    """2-D torus with Metropolis-Hastings weights."""
    n = rows * cols
    A = np.zeros((n, n), dtype=bool)

    def idx(r: int, c: int) -> int:
        return (r % rows) * cols + (c % cols)

    for r in range(rows):
        for c in range(cols):
            i = idx(r, c)
            for dr, dc in ((1, 0), (-1, 0), (0, 1), (0, -1)):
                A[i, idx(r + dr, c + dc)] = True
    np.fill_diagonal(A, False)
    return metropolis_hastings(A)


def random_d_regular(n: int, d: int, seed: int = 0, max_tries: int = 200) -> np.ndarray:
    """Random undirected d-regular graph with uniform weights 1/(d+1).

    This is the paper's data-independent competitor (Section 6): every node
    has exactly ``d`` neighbors, self-weight and neighbor weights all equal
    to ``1/(d+1)``. Built by the pairing model with rejection.
    """
    if d >= n:
        raise ValueError(f"need d < n, got d={d}, n={n}")
    if (n * d) % 2 != 0:
        raise ValueError("n*d must be even for a d-regular graph")
    try:
        import networkx as nx

        g = nx.random_regular_graph(d, n, seed=seed)
        A = np.zeros((n, n), dtype=bool)
        for a, b in g.edges:
            A[a, b] = A[b, a] = True
    except ImportError:  # pragma: no cover - networkx ships in the image
        rng = np.random.default_rng(seed)
        for _ in range(max_tries):
            stubs = np.repeat(np.arange(n), d)
            rng.shuffle(stubs)
            A = np.zeros((n, n), dtype=bool)
            ok = True
            for a, b in zip(stubs[0::2], stubs[1::2]):
                if a == b or A[a, b]:
                    ok = False
                    break
                A[a, b] = A[b, a] = True
            if ok:
                break
        else:
            raise RuntimeError(f"failed to sample a {d}-regular graph on {n} nodes")
    W = np.where(A, 1.0 / (d + 1), 0.0)
    np.fill_diagonal(W, 1.0 / (d + 1))
    return W


def exponential_graph(n: int, undirected: bool = True) -> np.ndarray:
    """Deterministic exponential graph (Ying et al., 2021).

    Node ``i`` connects to ``(i + 2^k) mod n`` for ``k = 0, 1, ...``.
    With ``undirected=True`` edges are symmetrized (the setting used in the
    paper's experiments, giving d_max = 14 at n = 100), and MH weights make
    W doubly stochastic. With ``undirected=False`` the classical directed
    uniform-weight variant is returned (row-stochastic and column-stochastic
    by the circulant structure, hence doubly stochastic).
    """
    hops = []
    k = 0
    while (1 << k) < n:
        hops.append(1 << k)
        k += 1
    A = np.zeros((n, n), dtype=bool)
    for i in range(n):
        for h in hops:
            j = (i + h) % n
            if j != i:
                A[i, j] = True
    if undirected:
        A = A | A.T
        return metropolis_hastings(A)
    # Directed circulant: every row has the same out-neighbor offsets, so
    # uniform weights 1/(len(hops)+1) are doubly stochastic.
    w = 1.0 / (len(hops) + 1)
    W = np.where(A, w, 0.0)
    np.fill_diagonal(W, w)
    return W


def metropolis_hastings(adjacency: np.ndarray) -> np.ndarray:
    """Metropolis-Hastings weights for an undirected adjacency matrix.

    ``W[i, j] = 1 / (1 + max(deg_i, deg_j))`` for edges, diagonal absorbs the
    remainder. Produces a symmetric doubly-stochastic matrix for any
    connected or disconnected undirected graph.
    """
    A = np.asarray(adjacency, dtype=bool).copy()
    if not np.array_equal(A, A.T):
        raise ValueError("metropolis_hastings requires an undirected adjacency")
    np.fill_diagonal(A, False)
    n = A.shape[0]
    deg = A.sum(axis=1)
    W = np.zeros((n, n))
    for i in range(n):
        for j in np.nonzero(A[i])[0]:
            W[i, j] = 1.0 / (1.0 + max(deg[i], deg[j]))
        W[i, i] = 1.0 - W[i].sum()
    return W


def self_loop_lazy(W: np.ndarray, laziness: float = 0.5) -> np.ndarray:
    """Lazy version ``(1 - a) W + a I`` (preserves double stochasticity)."""
    n = W.shape[0]
    return (1.0 - laziness) * np.asarray(W, dtype=np.float64) + laziness * np.eye(n)
