"""STL-FW (the paper's Algorithm 2) in plain NumPy, with scipy's
``linear_sum_assignment`` as the linear minimisation oracle.

The reference side works the topology out again from Pi with this copy,
so that a change to the port's ``core/stl_fw.py`` cannot move the
yardstick. It keeps the port's arithmetic, step for step: the objective's
Gram factors (G = Pi Pi^T, W Pi and W G carried through the rank-one
update) and the gradient snapped to a 1e-12-relative grid before each
assignment. A label-skewed Pi has exactly tied optima, and which of them
the oracle returns can turn on the last bit of the gradient: the textbook
evaluation, ``(W Pi - 11^T Pi / n) Pi^T``, picks other atoms than the
carried one on some shard partitions (seen at n = 8), and D-SGD on them
is another run.
"""

from __future__ import annotations

import numpy as np
from scipy.optimize import linear_sum_assignment

REL_GRID = 1e-12


def assignment(cost: np.ndarray) -> np.ndarray:
    """``col_of_row`` minimising the snapped cost."""
    scale = float(np.max(np.abs(cost)))
    if scale > 0.0:
        g = scale * REL_GRID
        cost = np.round(cost / g) * g
    rows, cols = linear_sum_assignment(cost)
    out = np.empty(cost.shape[0], dtype=np.int64)
    out[rows] = cols
    return out


def learn(Pi: np.ndarray, budget: int,
          lam: float = 0.1) -> tuple[list[float], list[np.ndarray], np.ndarray]:
    """``budget`` Frank-Wolfe steps from the identity on
    g(W) = ||W Pi - 11^T Pi / n||^2 / n + lam ||W - 11^T / n||^2 / n, each
    with the exact line search. Returns the atoms' coefficients, their
    permutations (``col_of_row``; a re-picked atom is merged) and W."""
    Pi = np.asarray(Pi, dtype=np.float64)
    n, _ = Pi.shape
    pibar = Pi.mean(axis=0)
    G = Pi @ Pi.T
    b = Pi @ pibar  # every row of pibar Pi^T
    rows = np.arange(n)
    W, WPi, M, nW2 = np.eye(n), Pi.copy(), G.copy(), float(n)
    coeffs, perms = [1.0], [rows.copy()]
    for _ in range(budget):
        grad = M.copy()
        grad -= b[None, :]
        grad += lam * W
        grad -= lam / n
        grad *= 2.0 / n
        col = assignment(grad)
        PiP = np.take(Pi, col, axis=0)
        DPi = PiP - WPi
        num_bias = float(np.einsum("k,ik->", pibar, DPi) - np.einsum("ik,ik->", WPi, DPi))
        dpi2 = float(np.einsum("ik,ik->", DPi, DPi))
        s_wp = float(W[rows, col].sum())
        num_var = -lam * (s_wp - nW2)
        denom = dpi2 + lam * (n - 2.0 * s_wp + nW2)
        gamma = 0.0 if denom <= 0.0 else float(np.clip((num_bias + num_var) / denom, 0.0, 1.0))
        if gamma <= 0.0:
            continue
        nW2 = (1.0 - gamma) ** 2 * nW2 + 2.0 * gamma * (1.0 - gamma) * s_wp + gamma * gamma * n
        W *= 1.0 - gamma
        W[rows, col] += gamma
        WPi *= 1.0 - gamma
        WPi += gamma * PiP
        M *= 1.0 - gamma
        M += gamma * G[col]
        coeffs = [c * (1.0 - gamma) for c in coeffs]
        for k, p in enumerate(perms):
            if np.array_equal(p, col):
                coeffs[k] += gamma
                break
        else:
            perms.append(col)
            coeffs.append(gamma)
    return coeffs, perms, W


def matrix(coeffs: list[float], perms: list[np.ndarray]) -> np.ndarray:
    """W = sum_l c_l P_l over the atoms of weight above 1e-12."""
    n = len(perms[0])
    W = np.zeros((n, n))
    for c, p in zip(coeffs, perms):
        if c > 1e-12:
            W[np.arange(n), p] += c
    return W
