"""STL-FW: Sparse Topology Learning with Frank-Wolfe (paper, Algorithm 2).

Host-side numpy, copied from ``repro.core.stl_fw`` with the compiled
``auction_jit`` LMO backend removed: that backend runs on JAX, and this
package imports none of it. ``"auction_jit"`` resolves to the numpy
``"auction"`` here, as the reference does when jax is missing.

Learns a sparse doubly-stochastic mixing matrix ``W`` minimizing the
neighborhood-heterogeneity surrogate (paper, Eq. 8)

    g(W) = (1/n) || W Pi - 11^T/n Pi ||_F^2  +  (lambda/n) || W - 11^T/n ||_F^2

over the Birkhoff polytope ``S`` of doubly-stochastic matrices, starting from
the identity. Each Frank-Wolfe step adds one permutation atom (Hungarian
LMO), so after ``l`` iterations ``d_max_in, d_max_out <= l`` (Theorem 2) and

    g(W^(l)) <= 16/(l+2) * (lambda + nuclear_term) <= 16/(l+2) * (lambda + 1).

Because every iterate is an explicit convex combination of permutation
matrices, the learned topology comes with its own Birkhoff decomposition --
which the simulator executes directly as a Birkhoff gather schedule (see
``repro_torch.core.mixing``).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from .assignment import (
    AUCTION_REL_GRID,
    _quantize,
    assignment_to_permutation,
    auction_assignment,
    hungarian,
    linear_assignment,
)

__all__ = [
    "stl_fw_objective",
    "stl_fw_gradient",
    "line_search_gamma",
    "learn_topology",
    "STLFWResult",
    "fw_upper_bound",
    "nuclear_term",
    "resolve_lmo_backend",
    "LMOSolver",
]


def _pi_bar(Pi: np.ndarray) -> np.ndarray:
    """``11^T/n Pi`` -- each row is the global class-proportion vector."""
    n = Pi.shape[0]
    return np.broadcast_to(Pi.mean(axis=0, keepdims=True), (n, Pi.shape[1]))


def stl_fw_objective(W: np.ndarray, Pi: np.ndarray, lam: float) -> float:
    """The paper's Eq. (8): bias + lambda * variance, both /n."""
    n = Pi.shape[0]
    bias = np.linalg.norm(W @ Pi - _pi_bar(Pi), ord="fro") ** 2
    var = np.linalg.norm(W - np.ones((n, n)) / n, ord="fro") ** 2
    return float((bias + lam * var) / n)


def stl_fw_gradient(W: np.ndarray, Pi: np.ndarray, lam: float) -> np.ndarray:
    """Closed-form gradient (paper, Section 5.2):

    (2/n) sum_k (W Pi_k - mean(Pi_k) 1) Pi_k^T + (2 lam / n)(W - 11^T/n).
    """
    n = Pi.shape[0]
    resid = W @ Pi - _pi_bar(Pi)          # (n, K)
    grad_bias = resid @ Pi.T              # == sum_k (W Pi_k - ...) Pi_k^T
    grad_var = W - np.ones((n, n)) / n
    return (2.0 / n) * (grad_bias + lam * grad_var)


def line_search_gamma(W: np.ndarray, P: np.ndarray, Pi: np.ndarray, lam: float) -> float:
    """Closed-form exact line search (paper, Appendix C.2).

    gamma* = [ sum_k (mean(Pi_k) 1 - W Pi_k)^T (P - W) Pi_k
               - lam tr((W - 11^T/n)^T (P - W)) ]
             / ( ||(P - W) Pi||_F^2 + lam ||P - W||_F^2 ),  clipped to [0, 1].
    """
    n = Pi.shape[0]
    D = P - W
    DPi = D @ Pi
    num_bias = float(np.sum((_pi_bar(Pi) - W @ Pi) * DPi))
    num_var = -lam * float(np.sum((W - np.ones((n, n)) / n) * D))
    denom = float(np.linalg.norm(DPi, ord="fro") ** 2 + lam * np.linalg.norm(D, ord="fro") ** 2)
    if denom <= 0.0:
        return 0.0
    return float(np.clip((num_bias + num_var) / denom, 0.0, 1.0))


def nuclear_term(Pi: np.ndarray) -> float:
    """``(1/n) || sum_k (Pi_k - mean(Pi_k) 1) Pi_k^T ||_*`` of Theorem 2."""
    n = Pi.shape[0]
    M = (Pi - _pi_bar(Pi)) @ Pi.T
    sv = np.linalg.svd(M, compute_uv=False)
    return float(sv.sum() / n)


def fw_upper_bound(l: int, lam: float, Pi: np.ndarray | None = None) -> float:
    """Theorem 2: ``g(W^(l)) <= 16/(l+2) (lambda + nuclear_term)``.

    With ``Pi=None`` the looser, n-independent bound ``16/(l+2)(lambda+1)``
    is returned.
    """
    extra = 1.0 if Pi is None else min(1.0, nuclear_term(Pi))
    return 16.0 / (l + 2) * (lam + extra)


@dataclasses.dataclass
class STLFWResult:
    """Learned topology together with its Birkhoff decomposition.

    Attributes:
      W: final (n, n) doubly-stochastic mixing matrix.
      coeffs: convex-combination coefficients, one per atom (sum to 1).
      perms: per-atom permutations as ``col_of_row`` index arrays; atom 0 is
        the identity when the solve started cold (the FW initialization) --
        a warm solve (``init=``) inherits the previous result's atoms.
      objective_trace: ``g(W^(l))`` for l = 0..L (L may be < budget when
        the FW-gap early stop fired, see ``learn_topology(stop_tol=...)``).
      gamma_trace: line-search step sizes per iteration.
      bias_trace / variance_trace: the two terms of Eq. (8) per iteration.
      lmo_backend: the resolved LMO solver that produced the atoms
        (``"scipy"``, ``"hungarian"`` or ``"auction"``).
      gap_trace: Frank-Wolfe duality gap ``<grad, W - P>`` per iteration
        (an upper bound on ``g(W) - g*``). The last entry always
        certifies the RETURNED W: a full-budget solve spends one extra
        LMO call measuring the final iterate's gap (the in-loop entries
        are pre-update), while an early-stopped solve's last in-loop
        entry already is the final iterate's.
      lam: the Eq. (8) trade-off this solve optimized -- recorded so
        downstream consumers (the online refresher's gap target) can
        refuse to compare gaps across different objectives.
    """

    W: np.ndarray
    coeffs: np.ndarray
    perms: list[np.ndarray]
    objective_trace: np.ndarray
    gamma_trace: np.ndarray
    bias_trace: np.ndarray
    variance_trace: np.ndarray
    lmo_backend: str = ""
    gap_trace: np.ndarray | None = None
    lam: float | None = None

    @property
    def n_atoms(self) -> int:
        return len(self.perms)

    def active_atoms(self, tol: float = 1e-12) -> list[tuple[float, np.ndarray]]:
        """(coefficient, col_of_row) pairs with non-negligible weight."""
        return [
            (float(c), p)
            for c, p in zip(self.coeffs, self.perms)
            if c > tol
        ]

    def rebuild_W(self) -> np.ndarray:
        """Reconstruct W from the Birkhoff atoms (for validation)."""
        n = len(self.perms[0])
        W = np.zeros((n, n))
        for c, perm in zip(self.coeffs, self.perms):
            W[np.arange(n), perm] += c
        return W


def _terms(W: np.ndarray, Pi: np.ndarray) -> tuple[float, float]:
    n = Pi.shape[0]
    bias = float(np.linalg.norm(W @ Pi - _pi_bar(Pi), ord="fro") ** 2 / n)
    var = float(np.linalg.norm(W - np.ones((n, n)) / n, ord="fro") ** 2 / n)
    return bias, var


def learn_topology(
    Pi: np.ndarray,
    budget: int,
    lam: float = 0.1,
    dedup_atoms: bool = True,
    method: str = "incremental",
    lmo: "str | LMOSolver" = "auto",
    init: "STLFWResult | tuple | None" = None,
    stop_tol: float | None = None,
    stop_gap: float | None = None,
) -> STLFWResult:
    """Run STL-FW (Algorithm 2) for ``budget`` Frank-Wolfe iterations.

    Args:
      Pi: (n, K) class proportions per node, rows sum to 1.
      budget: number of FW iterations L == communication budget d_max.
      lam: bias/variance trade-off (paper uses 0.1 on real data; exact
        correspondence to Prop. 2 is lam = sigma_max^2 / (K B)).
      dedup_atoms: merge coefficients of re-selected atoms (FW may re-pick a
        permutation; merging keeps the decomposition minimal).
      method: ``"incremental"`` (default) precomputes the Gram factors of
        the objective once and maintains ``W Pi`` / ``W Pi Pi^T`` through the
        rank-one FW update, so each iteration costs ``O(n^2)`` plus the LMO
        instead of repeated dense ``(n, K)`` products and full objective
        recomputation. ``"reference"`` is the direct textbook evaluation;
        both produce the same traces to ~1e-12 (fp reassociation only).
      lmo: assignment solver for the linear minimization oracle.
        ``"auto"`` (default) resolves to the measured winner for
        ``(n, budget)`` -- see :func:`resolve_lmo_backend`. ``"scipy"``
        / ``"hungarian"`` are the cold exact references; ``"auction"``
        is the warm-started epsilon-scaling numpy auction, carrying dual
        prices across FW iterations (contracted by ``1 - gamma``
        alongside W); ``"auction_jit"`` is accepted and runs it.
        All backends solve the same 1e-12-quantized gradient exactly,
        so ``<P, G>`` objective values agree to far better than 1e-9;
        assignments (and hence trajectories) may only differ where the
        LMO has exactly tied optima.
      init: warm start for online topology refresh. ``None`` (default)
        starts from the identity (Algorithm 2). An ``STLFWResult`` (or a
        ``(coeffs, perms)`` pair) restarts Frank-Wolfe from that W --
        expressed through its Birkhoff atoms, so the refreshed result's
        decomposition stays explicit. Passing a *persistent*
        ``LMOSolver`` instance via ``lmo=`` additionally carries the
        auction backends' dual prices across refreshes (the
        online refresh of the reference package does both).
      stop_tol: optional early stop relative to *this solve's* initial
        Frank-Wolfe gap: iteration halts once ``gap <= stop_tol *
        gap_trace[0]`` where ``gap = <grad, W - P>`` upper-bounds
        ``g(W) - g*``.
      stop_gap: optional *absolute* gap target: halt once
        ``gap <= stop_gap``. This is the online-refresh criterion --
        the controller records the cold solve's final gap and refreshes
        only until the warm iterate is certifiably as converged, which
        is what makes a refresh cost a few FW steps instead of a full
        budget. Both stops may be combined (first to fire wins);
        ``None``/``None`` always runs ``budget`` iterations (the
        paper's fixed-budget Algorithm 2).

    Returns:
      STLFWResult with the learned W, its Birkhoff decomposition and traces.
    """
    Pi = np.asarray(Pi, dtype=np.float64)
    if Pi.ndim != 2:
        raise ValueError("Pi must be (n, K)")
    if not np.allclose(Pi.sum(axis=1), 1.0, atol=1e-6):
        raise ValueError("rows of Pi must sum to 1 (class proportions)")
    solver = lmo if isinstance(lmo, LMOSolver) else LMOSolver(lmo)
    solver.resolve(n=Pi.shape[0], budget=budget)
    atoms = _normalize_init(init, Pi.shape[0])
    if method == "incremental":
        return _learn_topology_incremental(
            Pi, budget, lam, dedup_atoms, solver, atoms, stop_tol, stop_gap
        )
    if method == "reference":
        return _learn_topology_reference(
            Pi, budget, lam, dedup_atoms, solver, atoms, stop_tol, stop_gap
        )
    raise ValueError(f"unknown method {method!r}")


def _gap_stop(
    gap: float, gap0: float, stop_tol: float | None, stop_gap: float | None
) -> bool:
    """First-to-fire early-stop test shared by both method implementations."""
    if stop_gap is not None and gap <= stop_gap:
        return True
    return stop_tol is not None and gap <= stop_tol * (gap0 + 1e-18)


def _normalize_init(
    init: "STLFWResult | tuple | None", n: int
) -> tuple[list[float], list[np.ndarray]] | None:
    """Canonicalize a warm start into (coeffs, perms) Birkhoff atoms."""
    if init is None:
        return None
    if isinstance(init, STLFWResult):
        pairs = init.active_atoms()
        coeffs = [float(c) for c, _ in pairs]
        perms = [np.asarray(p, dtype=np.int64).copy() for _, p in pairs]
    else:
        raw_coeffs, raw_perms = init
        coeffs = [float(c) for c in raw_coeffs]
        perms = [np.asarray(p, dtype=np.int64).copy() for p in raw_perms]
    if not coeffs or len(coeffs) != len(perms):
        raise ValueError("init needs matching, non-empty coeffs and perms")
    ref = np.arange(n)
    for p in perms:
        if p.shape != (n,) or not np.array_equal(np.sort(p), ref):
            raise ValueError(f"init perm is not a permutation of {n} elements")
    if min(coeffs) < 0.0:
        raise ValueError("init coeffs must be non-negative")
    total = sum(coeffs)
    if total <= 0.0:
        raise ValueError("init coeffs must have positive mass")
    # renormalize: any convex combination of permutations is a valid
    # (doubly stochastic) FW iterate, so a slightly-off sum (fp residue
    # from a previous solve or a truncated schedule) just gets snapped
    coeffs = [c / total for c in coeffs]
    return coeffs, perms


def _merge_atom(
    coeffs: list[float],
    perms: list[np.ndarray],
    col_of_row: np.ndarray,
    gamma: float,
    dedup_atoms: bool,
) -> None:
    """Fold the FW update into the Birkhoff bookkeeping (in place)."""
    for k in range(len(coeffs)):
        coeffs[k] *= 1.0 - gamma
    if dedup_atoms:
        for k, perm in enumerate(perms):
            if np.array_equal(perm, col_of_row):
                coeffs[k] += gamma
                return
    perms.append(col_of_row.copy())
    coeffs.append(gamma)


def resolve_lmo_backend(lmo: str, n: int | None = None, budget: int | None = None) -> str:
    """Resolve the ``lmo=`` argument of :func:`learn_topology`.

    ``"auto"`` is ``"scipy"`` when scipy is importable, else the
    warm-started numpy ``"auction"`` (which beats the pure python
    ``"hungarian"`` by ~2 orders of magnitude at n >= 128). ``n`` and
    ``budget`` are accepted for signature parity with the reference,
    whose ``"auto"`` may pick the compiled auction by problem shape.

    An explicit ``"scipy"`` without scipy installed resolves to
    ``"hungarian"`` -- that is what ``linear_assignment`` would actually
    run, and the resolved name is what ``STLFWResult.lmo_backend``
    reports, so the result never claims a solver that did not execute.
    An explicit ``"auction_jit"`` resolves to ``"auction"`` for the same
    reason: the compiled auction is not part of this package.
    """
    from . import assignment as _assignment

    have_scipy = _assignment._scipy_lsa is not None
    if lmo == "auto":
        return "scipy" if have_scipy else "auction"
    if lmo == "scipy" and not have_scipy:
        return "hungarian"
    if lmo == "auction_jit":
        return "auction"
    if lmo in ("scipy", "hungarian", "auction"):
        return lmo
    raise ValueError(
        f"unknown LMO backend {lmo!r}; expected auto|scipy|hungarian|auction|auction_jit"
    )


class LMOSolver:
    """Canonicalizing LMO with per-backend dispatch and warm-start state.

    Quantization: FW atom selection must not depend on ~1e-16 reassociation
    noise in the gradient: on structured Pi (e.g. one-hot classes) the
    assignment problem has exactly tied optima, and which tie the solver
    returns would otherwise differ between algebraically-equal gradient
    evaluations (Gram form vs direct form). Snapping to a 1e-12-relative
    grid collapses fp noise while preserving every preference larger than
    the grid, so all evaluation orders select identical atoms and produce
    identical traces. The same grid doubles as the auction backend's
    exactness certificate (see ``repro_torch.core.assignment``).

    Warm start: with ``backend="auction"`` the dual prices of each solve
    seed the next one. The FW update contracts the
    gradient by ``(1 - gamma)`` before adding the new atom's
    contribution; :meth:`contract` applies the matching contraction to
    the carried prices (eps-CS is invariant under joint positive
    scaling), so only the genuinely-changed entries force re-bidding.

    Auto resolution: ``backend="auto"`` is resolved against the problem
    shape -- either eagerly via :meth:`resolve` (``learn_topology`` calls
    it with ``(n, budget)``) or lazily at the first gradient.
    """

    def __init__(self, backend: str = "auto"):
        # validate eagerly (unknown names must fail fast) but keep "auto"
        # unresolved until a problem shape is known
        self.backend = backend if backend == "auto" else resolve_lmo_backend(backend)
        self.state = None  # AuctionState for the auction backend

    def resolve(self, n: int | None = None, budget: int | None = None) -> str:
        """Finalize an ``"auto"`` backend for the given problem shape."""
        if self.backend == "auto":
            self.backend = resolve_lmo_backend("auto", n=n, budget=budget)
        return self.backend

    def __call__(self, grad: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        grad = np.asarray(grad, dtype=np.float64)
        if self.backend == "auto":
            self.resolve(n=grad.shape[0] if grad.ndim == 2 else None)
        # Same grid the auction derives its exactness certificate from:
        # quantizing here makes the snap a no-op inside auction_assignment
        # and keeps every backend solving the identical matrix.
        grad, _ = _quantize(grad, AUCTION_REL_GRID)
        if self.backend == "auction":
            col_of_row, self.state = auction_assignment(grad, self.state)
        elif self.backend == "hungarian":
            col_of_row = hungarian(grad)
        else:
            col_of_row = linear_assignment(grad)
        return assignment_to_permutation(col_of_row), col_of_row

    def contract(self, factor: float) -> None:
        """Rescale carried dual prices after ``W <- (1-gamma) W + gamma P``."""
        if self.state is not None:
            self.state = self.state.scaled(factor)


def _learn_topology_reference(
    Pi: np.ndarray,
    budget: int,
    lam: float,
    dedup_atoms: bool,
    solver: LMOSolver,
    atoms: tuple[list[float], list[np.ndarray]] | None = None,
    stop_tol: float | None = None,
    stop_gap: float | None = None,
) -> STLFWResult:
    """Direct evaluation of Algorithm 2 (dense recomputation per iteration)."""
    n = Pi.shape[0]
    identity = np.arange(n)
    rows = np.arange(n)
    if atoms is None:
        W = np.eye(n)
        coeffs: list[float] = [1.0]
        perms: list[np.ndarray] = [identity.copy()]
    else:
        coeffs, perms = list(atoms[0]), [p.copy() for p in atoms[1]]
        W = np.zeros((n, n))
        for c, p in zip(coeffs, perms):
            W[rows, p] += c
    obj_trace = [stl_fw_objective(W, Pi, lam)]
    bias0, var0 = _terms(W, Pi)
    bias_trace, var_trace = [bias0], [var0]
    gamma_trace: list[float] = []
    gap_trace: list[float] = []

    for _ in range(budget):
        grad = stl_fw_gradient(W, Pi, lam)
        P, col_of_row = solver(grad)
        gap = float(np.sum(grad * W) - grad[rows, col_of_row].sum())
        gap_trace.append(gap)
        if _gap_stop(gap, gap_trace[0], stop_tol, stop_gap):
            break
        gamma = line_search_gamma(W, P, Pi, lam)
        gamma_trace.append(gamma)
        if gamma > 0.0:
            W = (1.0 - gamma) * W + gamma * P
            _merge_atom(coeffs, perms, col_of_row, gamma, dedup_atoms)
            solver.contract(1.0 - gamma)
        obj_trace.append(stl_fw_objective(W, Pi, lam))
        b, v = _terms(W, Pi)
        bias_trace.append(b)
        var_trace.append(v)

    if budget > 0 and len(gamma_trace) == budget:
        # the loop records gaps *before* each update, so a full-budget run
        # would otherwise certify only the penultimate iterate; one extra
        # LMO call measures the gap of the W actually returned (an early
        # stop needs nothing -- it breaks before updating, so its last
        # recorded gap already belongs to the final W).
        grad = stl_fw_gradient(W, Pi, lam)
        _, col_of_row = solver(grad)
        gap_trace.append(float(np.sum(grad * W) - grad[rows, col_of_row].sum()))

    return STLFWResult(
        W=W,
        coeffs=np.asarray(coeffs),
        perms=perms,
        objective_trace=np.asarray(obj_trace),
        gamma_trace=np.asarray(gamma_trace),
        bias_trace=np.asarray(bias_trace),
        variance_trace=np.asarray(var_trace),
        lmo_backend=solver.backend,
        gap_trace=np.asarray(gap_trace),
        lam=lam,
    )


def _learn_topology_incremental(
    Pi: np.ndarray,
    budget: int,
    lam: float,
    dedup_atoms: bool,
    solver: LMOSolver,
    atoms: tuple[list[float], list[np.ndarray]] | None = None,
    stop_tol: float | None = None,
    stop_gap: float | None = None,
) -> STLFWResult:
    """Algorithm 2 with Gram precomputation and rank-update state.

    Precomputed once (``O(n^2 K)``):
      G = Pi Pi^T                     (n, n)
      b = pibar_row Pi^T              (n,)   -- ``pi_bar Pi^T`` is rank one:
                                               every row equals ``b``
      c_pi2 = ||pibar||_F^2           scalar

    Maintained through the FW update ``W <- (1-gamma) W + gamma P`` (each
    ``O(n K)`` / ``O(n^2)`` gathers and AXPYs, no matmuls):
      WPi = W Pi                      (n, K)  -> WPi = (1-g) WPi + g Pi[perm]
      M   = W G                       (n, n)  -> M   = (1-g) M   + g G[perm]
      nW2 = ||W||_F^2                 scalar  -> closed-form update

    With these, per iteration:
      gradient  (2/n)(M - b 1^T + lam (W - J/n))            O(n^2)
      line search: all terms from WPi, Pi[perm], nW2, traces O(n K)
      objective: O(1) -- the bias recurrence below reuses the line-search
        inner products (``||WPi_new - pibar||^2 = ||WPi - pibar||^2
        - 2 gamma <pibar - WPi, DPi> + gamma^2 ||DPi||^2``), and the
        variance identity uses double stochasticity (``sum(W) = n`` exactly
        for any convex combination of permutations, so
        ``||W - J/n||_F^2 = ||W||_F^2 - 1``).
    """
    n, K = Pi.shape
    pibar_row = Pi.mean(axis=0)               # (K,)
    G = Pi @ Pi.T                             # (n, n)
    b = Pi @ pibar_row                        # (n,); (pibar Pi^T)[i, j] =
    # pibar_row . Pi[j] = b[j] -- rank one with constant columns.
    identity = np.arange(n)
    rows = np.arange(n)
    if atoms is None:
        W = np.eye(n)
        WPi = Pi.copy()                       # W = I
        M = G.copy()                          # W G = G
        nW2 = float(n)                        # ||I||_F^2
        init_coeffs: list[float] = [1.0]
        init_perms: list[np.ndarray] = [identity.copy()]
    else:
        # warm start: rebuild the maintained quantities once from the
        # carried atoms (O(L n K) gathers + two BLAS matmuls); every
        # iteration after that costs the same as a cold one.
        init_coeffs, init_perms = list(atoms[0]), [p.copy() for p in atoms[1]]
        W = np.zeros((n, n))
        for c, p in zip(init_coeffs, init_perms):
            W[rows, p] += c
        WPi = W @ Pi
        M = W @ G
        nW2 = float(np.einsum("ij,ij->", W, W))
    d_init = WPi - pibar_row[None, :]
    bias = float(np.einsum("ik,ik->", d_init, d_init) / n)
    # scratch buffers: the loop below does no O(nK)/O(n^2) allocations
    grad = np.empty((n, n))
    PiP = np.empty((n, K))
    DPi = np.empty((n, K))

    def var_of(nW2_):
        return float((nW2_ - 1.0) / n)

    coeffs: list[float] = init_coeffs
    perms: list[np.ndarray] = init_perms
    obj_trace = [bias + lam * var_of(nW2)]
    bias_trace, var_trace = [bias], [var_of(nW2)]
    gamma_trace: list[float] = []
    gap_trace: list[float] = []

    for _ in range(budget):
        # gradient: (2/n) ((W Pi - pibar) Pi^T + lam (W - J/n))
        #         = (2/n) (M - 1 b^T + lam W - lam/n J)
        np.copyto(grad, M)
        grad -= b[None, :]
        grad += lam * W
        grad -= lam / n
        grad *= 2.0 / n
        _, col_of_row = solver(grad)
        gap = float(np.einsum("ij,ij->", grad, W) - grad[rows, col_of_row].sum())
        gap_trace.append(gap)
        if _gap_stop(gap, gap_trace[0], stop_tol, stop_gap):
            break

        # line search, all in the maintained quantities:
        #   DPi = P Pi - W Pi = Pi[perm] - WPi
        #   num_bias = sum((pibar - WPi) * DPi)
        #   num_var  = -lam (sum(W o P) - ||W||^2 - (sum P - sum W)/n)
        #            = -lam (s_wp - nW2)            [sum P = sum W = n exactly]
        #   denom    = ||DPi||^2 + lam (n - 2 s_wp + nW2)
        np.take(Pi, col_of_row, axis=0, out=PiP)  # rows of P Pi
        np.subtract(PiP, WPi, out=DPi)
        num_bias = float(np.einsum("k,ik->", pibar_row, DPi) - np.einsum("ik,ik->", WPi, DPi))
        dpi2 = float(np.einsum("ik,ik->", DPi, DPi))
        s_wp = float(W[rows, col_of_row].sum())
        num_var = -lam * (s_wp - nW2)
        denom = dpi2 + lam * (n - 2.0 * s_wp + nW2)
        gamma = 0.0 if denom <= 0.0 else float(np.clip((num_bias + num_var) / denom, 0.0, 1.0))
        gamma_trace.append(gamma)

        if gamma > 0.0:
            # rank update of every maintained quantity (no matmuls)
            nW2 = (1.0 - gamma) ** 2 * nW2 + 2.0 * gamma * (1.0 - gamma) * s_wp + gamma * gamma * n
            bias = bias + (-2.0 * gamma * num_bias + gamma * gamma * dpi2) / n
            W *= 1.0 - gamma
            W[rows, col_of_row] += gamma
            WPi *= 1.0 - gamma
            WPi += gamma * PiP
            M *= 1.0 - gamma
            M += gamma * G[col_of_row]
            _merge_atom(coeffs, perms, col_of_row, gamma, dedup_atoms)
            solver.contract(1.0 - gamma)
            if bias < 1e-12:
                # the recurrence carries ~eps residue; near the elbow (bias
                # -> 0 exactly, e.g. one-hot Pi at l = K-1) recompute it
                # directly from the updated WPi so exact zeros stay exact.
                np.subtract(WPi, pibar_row[None, :], out=DPi)
                bias = float(np.einsum("ik,ik->", DPi, DPi) / n)

        var_l = var_of(nW2)
        obj_trace.append(bias + lam * var_l)
        bias_trace.append(bias)
        var_trace.append(var_l)

    if budget > 0 and len(gamma_trace) == budget:
        # final-iterate gap; see the reference implementation's comment
        np.copyto(grad, M)
        grad -= b[None, :]
        grad += lam * W
        grad -= lam / n
        grad *= 2.0 / n
        _, col_of_row = solver(grad)
        gap_trace.append(
            float(np.einsum("ij,ij->", grad, W) - grad[rows, col_of_row].sum())
        )

    return STLFWResult(
        W=W,
        coeffs=np.asarray(coeffs),
        perms=perms,
        objective_trace=np.asarray(obj_trace),
        gamma_trace=np.asarray(gamma_trace),
        bias_trace=np.asarray(bias_trace),
        variance_trace=np.asarray(var_trace),
        lmo_backend=solver.backend,
        gap_trace=np.asarray(gap_trace),
        lam=lam,
    )
