"""Convergence-rate bounds from the paper (Theorems 1 & 2, explicit constants).

The explicit numerical constants come from the proofs in Appendix B:

Convex (Lemma 4 path):
    T >= 36 sigma^2 r0 / (n eps^2) + 89 sqrt(L) tau r0 / (p eps^{3/2})
         + 24 L r0 / (p eps)

Non-convex (Lemma 5 path):
    T >= 288 L sigma^2 f0 / (n eps^2) + 576 L tau f0 / (p eps^{3/2})
         + 96 L f0 / (p eps)

plus the anytime error bounds of Lemmas 4/5 and the stepsize tuning of
Lemma 6. These are used by the benchmark harness to check the theory against
measured D-SGD behaviour and to compare topologies analytically.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = [
    "RateInputs",
    "iterations_to_eps_convex",
    "iterations_to_eps_nonconvex",
    "error_bound_convex",
    "error_bound_nonconvex",
    "tuned_stepsize",
    "koloskova_iterations_convex",
]


@dataclasses.dataclass
class RateInputs:
    """Problem constants entering Theorem 1.

    Attributes:
      L: smoothness constant (Assumption 1).
      sigma_bar2: average gradient variance ``(1/n) sum_i sigma_i^2``.
      tau_bar2: neighborhood-heterogeneity bound (Assumption 4).
      p: mixing parameter (Assumption 3).
      n: number of nodes.
      r0: ``||theta_0 - theta*||^2`` (convex) .
      f0: ``f(theta_0) - f*`` (non-convex).
    """

    L: float
    sigma_bar2: float
    tau_bar2: float
    p: float
    n: int
    r0: float = 1.0
    f0: float = 1.0


def iterations_to_eps_convex(c: RateInputs, eps: float) -> float:
    """Theorem 1 (convex), explicit constants from Appendix B.1 step 5."""
    if c.p <= 0.0:
        return float("inf")
    tau = np.sqrt(max(c.tau_bar2, 0.0))
    return float(
        36.0 * c.sigma_bar2 * c.r0 / (c.n * eps**2)
        + 89.0 * np.sqrt(c.L) * tau * c.r0 / (c.p * eps**1.5)
        + 24.0 * c.L * c.r0 / (c.p * eps)
    )


def iterations_to_eps_nonconvex(c: RateInputs, eps: float) -> float:
    """Theorem 1 (non-convex), explicit constants from Appendix B.1."""
    if c.p <= 0.0:
        return float("inf")
    tau = np.sqrt(max(c.tau_bar2, 0.0))
    return float(
        288.0 * c.L * c.sigma_bar2 * c.f0 / (c.n * eps**2)
        + 576.0 * c.L * tau * c.f0 / (c.p * eps**1.5)
        + 96.0 * c.L * c.f0 / (c.p * eps)
    )


def tuned_stepsize(r0: float, b: float, e: float, d: float, T: int) -> float:
    """Lemma 6's stepsize: ``min{ (r0/b(T+1))^{1/2}, (r0/e(T+1))^{1/3}, 1/d }``."""
    cands = [1.0 / d if d > 0 else np.inf]
    if b > 0:
        cands.append(np.sqrt(r0 / (b * (T + 1))))
    if e > 0:
        cands.append((r0 / (e * (T + 1))) ** (1.0 / 3.0))
    return float(min(cands))


def error_bound_convex(c: RateInputs, T: int) -> float:
    """Lemma 4 anytime bound on ``(1/T+1) sum_t E f(theta_bar_t) - f*``."""
    if c.p <= 0.0:
        return float("inf")  # disconnected topology: no consensus guarantee
    b = c.sigma_bar2 / c.n
    e = 36.0 * c.L * c.tau_bar2 / c.p**2
    d = 8.0 * c.L / c.p
    return float(
        2.0 * np.sqrt(b * c.r0 / (T + 1))
        + 2.0 * e ** (1.0 / 3.0) * (c.r0 / (T + 1)) ** (2.0 / 3.0)
        + d * c.r0 / (T + 1)
    )


def error_bound_nonconvex(c: RateInputs, T: int) -> float:
    """Lemma 5 anytime bound on ``(1/T+1) sum_t E ||grad f(theta_bar_t)||^2``."""
    if c.p <= 0.0:
        return float("inf")
    b = 2.0 * c.L * c.sigma_bar2 / c.n
    e = 96.0 * c.L**2 * c.tau_bar2 / c.p**2
    d = 8.0 * c.L / c.p
    return float(
        2.0 * np.sqrt(4.0 * b * c.f0 / (T + 1))
        + 2.0 * e ** (1.0 / 3.0) * (4.0 * c.f0 / (T + 1)) ** (2.0 / 3.0)
        + 4.0 * d * c.f0 / (T + 1)
    )


def koloskova_iterations_convex(
    L: float, sigma_bar2: float, zeta_bar2: float, p: float, n: int, r0: float, eps: float
) -> float:
    """Prior-work rate (Koloskova et al., 2020) under Assumption 5, for
    comparison: ``O(sigma^2/n eps^2 + sqrt(L(1-p))(zeta + sigma sqrt(p)) /
    (p eps^{3/2}) + L/(p eps))`` (constants set to 1 inside O)."""
    zeta = np.sqrt(zeta_bar2)
    sigma = np.sqrt(sigma_bar2)
    return float(
        sigma_bar2 * r0 / (n * eps**2)
        + np.sqrt(L * (1 - p)) * (zeta + sigma * np.sqrt(p)) * r0 / (p * eps**1.5)
        + L * r0 / (p * eps)
    )
