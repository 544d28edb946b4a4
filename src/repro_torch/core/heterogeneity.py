"""Heterogeneity quantities from the paper (Section 4 / Appendix A & C).

All functions are host-side analysis utilities operating on numpy arrays:

* ``neighborhood_bias``        -- bias term of Eq. (4) at a given set of
                                  local gradients.
* ``local_heterogeneity``      -- the classical ``zeta_bar^2`` (Assumption 5).
* ``variance_term``            -- ``sigma_max^2/n ||W - 11^T/n||_F^2``.
* ``tau_bar_label_skew``       -- Proposition 2's closed-form ``tau_bar^2``.
* ``label_skew_bias``          -- the (un-scaled) label-skew bias
                                  ``sum_{k,i} (sum_j W_ij pi_jk - mean_k)^2 / n``
                                  used in the experiment tables.
* ``tau_from_prop1``           -- Proposition 1: tau^2 = (1-p)(zeta^2+sigma^2).
* ``prop3_bounds``             -- sandwich of ``||W - 11^T/n||_F^2`` by
                                  ``(1-p)`` and ``(n-1)(1-p)`` (Proposition 3).
* ``neighborhood_heterogeneity_mc`` -- Monte-Carlo estimate of H(theta)
                                  (Assumption 4 LHS) from a stochastic
                                  gradient sampler, used in tests to verify
                                  Example 1 end-to-end.
"""

from __future__ import annotations

from typing import Callable

import numpy as np

from .topology import mixing_parameter

__all__ = [
    "neighborhood_bias",
    "local_heterogeneity",
    "variance_term",
    "label_skew_bias",
    "tau_bar_label_skew",
    "tau_from_prop1",
    "prop3_bounds",
    "neighborhood_heterogeneity_mc",
    "classes_in_neighborhood",
]


def neighborhood_bias(W: np.ndarray, local_grads: np.ndarray) -> float:
    """Bias term of Eq. (4): ``(1/n) sum_i ||sum_j W_ij grad_j - grad_bar||^2``.

    Args:
      W: (n, n) mixing matrix.
      local_grads: (n, d) matrix of local *expected* gradients at a common
        parameter point theta.
    """
    W = np.asarray(W, dtype=np.float64)
    G = np.asarray(local_grads, dtype=np.float64)
    n = G.shape[0]
    mixed = W @ G                      # (n, d): neighborhood-aggregated grads
    gbar = G.mean(axis=0, keepdims=True)
    return float(np.sum((mixed - gbar) ** 2) / n)


def local_heterogeneity(local_grads: np.ndarray) -> float:
    """``zeta_bar^2`` sample: ``(1/n) sum_i ||grad_i - grad_bar||^2``."""
    G = np.asarray(local_grads, dtype=np.float64)
    gbar = G.mean(axis=0, keepdims=True)
    return float(np.sum((G - gbar) ** 2) / G.shape[0])


def variance_term(W: np.ndarray, sigma_max2: float) -> float:
    """``sigma_max^2 / n * ||W - 11^T/n||_F^2`` (second term of Eq. 4/7)."""
    W = np.asarray(W, dtype=np.float64)
    n = W.shape[0]
    return float(sigma_max2 / n * np.linalg.norm(W - np.ones((n, n)) / n, "fro") ** 2)


def label_skew_bias(W: np.ndarray, Pi: np.ndarray) -> float:
    """Label-skew bias: ``(1/n) sum_k sum_i (sum_j W_ij pi_jk - pibar_k)^2``.

    This is Proposition 2's first term without the ``K B`` scaling; it is the
    "Bias" column of the paper's Tables 1-3 (up to their per-node averaging).
    """
    W = np.asarray(W, dtype=np.float64)
    Pi = np.asarray(Pi, dtype=np.float64)
    n = Pi.shape[0]
    resid = W @ Pi - Pi.mean(axis=0, keepdims=True)
    return float(np.sum(resid**2) / n)


def tau_bar_label_skew(
    W: np.ndarray, Pi: np.ndarray, B: float, sigma_max2: float
) -> float:
    """Proposition 2's closed-form ``tau_bar^2`` under label skew.

    tau^2 = K B / n * sum_{k,i} (sum_j W_ij pi_jk - pibar_k)^2
            + sigma_max^2 / n * ||W - 11^T/n||_F^2
    """
    K = Pi.shape[1]
    return K * B * label_skew_bias(W, Pi) + variance_term(W, sigma_max2)


def tau_from_prop1(p: float, zeta2: float, sigma_bar2: float) -> float:
    """Proposition 1: any (p, zeta, sigma) system satisfies Assumption 4 with

    ``tau^2 = (1 - p)(zeta^2 + sigma^2)``.
    """
    return (1.0 - p) * (zeta2 + sigma_bar2)


def prop3_bounds(W: np.ndarray) -> tuple[float, float, float]:
    """Proposition 3 sandwich: returns ``(lo, value, hi)`` with

    lo = (1 - p) <= ||W - 11^T/n||_F^2 <= (n - 1)(1 - p) = hi.
    """
    W = np.asarray(W, dtype=np.float64)
    n = W.shape[0]
    p = mixing_parameter(W)
    val = float(np.linalg.norm(W - np.ones((n, n)) / n, "fro") ** 2)
    return (1.0 - p), val, (n - 1) * (1.0 - p)


def neighborhood_heterogeneity_mc(
    W: np.ndarray,
    grad_sampler: Callable[[np.random.Generator], np.ndarray],
    n_samples: int = 256,
    seed: int = 0,
) -> float:
    """Monte-Carlo estimate of H(theta) (LHS of Assumption 4).

    Args:
      W: (n, n) mixing matrix.
      grad_sampler: maps an rng to an (n, d) draw of *stochastic* local
        gradients ``nabla F_j(theta, Z_j)`` at a common theta.
      n_samples: MC repetitions.

    Returns:
      ``(1/n) sum_i E ||sum_j W_ij gF_j - mean_j gF_j||^2`` estimate.
    """
    W = np.asarray(W, dtype=np.float64)
    rng = np.random.default_rng(seed)
    n = W.shape[0]
    acc = 0.0
    for _ in range(n_samples):
        G = np.asarray(grad_sampler(rng), dtype=np.float64)  # (n, d)
        mixed = W @ G
        gbar = G.mean(axis=0, keepdims=True)
        acc += float(np.sum((mixed - gbar) ** 2) / n)
    return acc / n_samples


def classes_in_neighborhood(W: np.ndarray, Pi: np.ndarray, tol: float = 1e-9) -> np.ndarray:
    """Number of distinct classes present in each node's in-neighborhood.

    Matches the "Classes in neighborhood" column of Tables 1-3: a class k
    counts for node i if any in-neighbor j (including i itself) has
    ``pi_jk > 0``.
    """
    W = np.asarray(W)
    Pi = np.asarray(Pi)
    present = (W > tol).astype(np.float64) @ (Pi > tol).astype(np.float64)
    return (present > 0).sum(axis=1)
