"""Synthetic datasets reproducing the paper's experimental setups.

The container is offline (no MNIST/CIFAR download), so the Section 6.2
experiments run on statistically analogous synthetic classification tasks;
the substitution is recorded in DESIGN.md / EXPERIMENTS.md.

* ``mean_estimation_clusters`` -- Section 6.1: K Gaussian clusters with means
  evenly spread over [-m, m], variance sigma~^2 = 1; the "pointwise loss" is
  ``F(theta, z) = (theta - z)^2`` so all constants of the theory are known in
  closed form (B = 4 m_spread^2-ish; see ``mean_estimation_constants``).
* ``gaussian_blobs`` -- an MNIST-like stand-in: K classes, class-conditional
  Gaussians in q dims with fixed class means (shared across nodes =>
  P(X|Y) fixed, only P_i(Y) varies: pure label skew, matching Section 5.1).
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = [
    "MeanEstimationTask",
    "mean_estimation_clusters",
    "gaussian_blobs",
]


@dataclasses.dataclass
class MeanEstimationTask:
    """Section 6.1 task. Node i observes Z ~ N(mu_{c(i)}, sigma~^2), c(i) = i % K.

    Loss ``F(theta, Z) = (theta - Z)^2`` (d = 1). Closed-form constants:

    * grad F(theta, z) = 2 (theta - z);  grad f_i(theta) = 2 (theta - mu_i)
    * global optimum theta* = mean(mu), f* analytic
    * L = 2, sigma_i^2 = 4 sigma~^2 for all i
    * zeta_bar^2 = 4 Var(mu) ; B (Prop. 2, class level) = max_k 4 (mu_k - mu_bar)^2-ish
    """

    n_nodes: int
    K: int
    cluster_means: np.ndarray  # (K,)
    sigma_tilde2: float

    @property
    def node_means(self) -> np.ndarray:
        return self.cluster_means[np.arange(self.n_nodes) % self.K]

    @property
    def theta_star(self) -> float:
        return float(self.node_means.mean())

    @property
    def L(self) -> float:
        return 2.0

    @property
    def sigma_i2(self) -> float:
        """E||grad F - grad f_i||^2 = 4 sigma~^2 (exact)."""
        return 4.0 * self.sigma_tilde2

    @property
    def zeta_bar2(self) -> float:
        mu = self.node_means
        return float(4.0 * np.mean((mu - mu.mean()) ** 2))

    @property
    def B(self) -> float:
        """Class-level heterogeneity constant of Proposition 2.

        ||E[gF|Y=k] - mean_k' E[gF|Y=k']||^2 = 4 (mu_k - mu_bar)^2 <= B.
        """
        mu = self.cluster_means
        return float(4.0 * np.max((mu - mu.mean()) ** 2))

    @property
    def Pi(self) -> np.ndarray:
        """One-hot class proportions: node i holds only class i % K."""
        Pi = np.zeros((self.n_nodes, self.K))
        Pi[np.arange(self.n_nodes), np.arange(self.n_nodes) % self.K] = 1.0
        return Pi

    def sample(self, batch: int, rng: np.random.Generator) -> np.ndarray:
        """(n_nodes, batch) draws, one row per node."""
        return rng.normal(
            self.node_means[:, None], np.sqrt(self.sigma_tilde2), size=(self.n_nodes, batch)
        )

    def grad(self, theta: np.ndarray, z: np.ndarray) -> np.ndarray:
        """Stochastic gradient 2(theta - mean_batch(z)) per node."""
        return 2.0 * (theta - z.mean(axis=-1))

    def expected_grads(self, theta: float) -> np.ndarray:
        """(n, 1) expected local gradients at a common scalar theta."""
        return (2.0 * (theta - self.node_means))[:, None]


def mean_estimation_clusters(
    n_nodes: int = 100, K: int = 10, m: float = 5.0, sigma_tilde2: float = 1.0
) -> MeanEstimationTask:
    """Section 6.1 generalization of Example 1: K cluster means evenly spread
    over [-m, m] (m controls heterogeneity)."""
    means = np.linspace(-m, m, K) if K > 1 else np.zeros(1)
    return MeanEstimationTask(n_nodes=n_nodes, K=K, cluster_means=means, sigma_tilde2=sigma_tilde2)


def gaussian_blobs(
    n_samples: int = 20000,
    num_classes: int = 10,
    dim: int = 64,
    sep: float = 3.0,
    noise: float = 1.0,
    seed: int = 0,
) -> tuple[np.ndarray, np.ndarray]:
    """MNIST-like synthetic classification set: shared P(X|Y), K classes.

    Returns (X, y): features (N, dim) float32, labels (N,) int32. Class means
    are random unit directions scaled by ``sep`` (fixed by seed so every node
    shares P(X|Y), and heterogeneity is purely label skew).
    """
    rng = np.random.default_rng(seed)
    means = rng.normal(size=(num_classes, dim))
    means = sep * means / np.linalg.norm(means, axis=1, keepdims=True)
    y = rng.integers(0, num_classes, size=n_samples)
    X = means[y] + noise * rng.normal(size=(n_samples, dim))
    return X.astype(np.float32), y.astype(np.int32)
