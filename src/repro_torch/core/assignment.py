"""Linear assignment (the Frank-Wolfe LMO over the Birkhoff polytope).

The linear minimization oracle of STL-FW (Algorithm 2) is

    P* = argmin_{P in A} <P, G>

over the set ``A`` of permutation matrices -- the classical assignment
problem. Three interchangeable solvers:

1. ``linear_assignment`` -- ``scipy.optimize.linear_sum_assignment``
   (Jonker-Volgenant) when scipy is importable, falling back to the
   self-contained ``hungarian`` below. Cold O(n^3) solve per call; the
   equivalence reference for everything else.
2. ``hungarian``         -- O(n^3) shortest-augmenting-path Hungarian in
   plain numpy (no scipy dependency). Python-loop bound: fine for tests
   and small n, slow beyond n ~ 200.
3. ``auction_assignment`` -- vectorized forward auction with epsilon
   scaling (Bertsekas). The interesting solver: it exposes its dual
   prices, so a caller whose cost matrix changes only slightly between
   solves (exactly the Frank-Wolfe LMO, where each step perturbs the
   gradient by a gamma-weighted rank-one-ish update) can warm-start the
   next solve from the previous prices and re-bid only the rows whose
   epsilon-complementary-slackness was violated by the change. Cold
   solves pay the full epsilon-scaling schedule; warm solves typically
   touch a handful of rows.

Exactness. Auction guarantees the assignment is within ``n * eps`` of
optimal. We quantize the cost matrix onto the grid
``g = max|cost| * rel_grid`` (``rel_grid = 1e-12``, matching the LMO
canonicalization in ``repro_torch.core.stl_fw``) and run the final phase at
``eps_final = g / (n + 1)``: every assignment's total cost is then a sum
of near-multiples of ``g``, so being within ``n * eps_final < g`` of
optimal pins the auction to an exactly optimal assignment of the
quantized problem (up to ~1e-16-relative float summation noise).
Assignments may still differ from scipy's under exact ties, but the
achieved objective ``<P, G>`` agrees to far better than 1e-9.

Forbidden pairs. ``+inf`` cost marks a forbidden edge (all solvers); if
no feasible assignment avoids the forbidden edges, ``ValueError`` is
raised. ``-inf`` and ``NaN`` costs are rejected.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = [
    "linear_assignment",
    "assignment_to_permutation",
    "solve_lmo",
    "hungarian",
    "auction_assignment",
    "AuctionState",
    "AUCTION_REL_GRID",
]

try:  # pragma: no cover - exercised implicitly
    from scipy.optimize import linear_sum_assignment as _scipy_lsa
except Exception:  # pragma: no cover
    _scipy_lsa = None

# Relative quantization grid shared with repro_torch.core.stl_fw.LMOSolver:
# costs are snapped to multiples of max|cost| * AUCTION_REL_GRID before the
# auction runs, which is what makes the epsilon-optimal auction *exactly*
# optimal (see module docstring).
AUCTION_REL_GRID = 1e-12

# Epsilon-scaling factor: each phase divides eps by this until eps_final.
_EPS_SCALING = 6.0


def hungarian(cost: np.ndarray) -> np.ndarray:
    """O(n^3) Hungarian algorithm (shortest augmenting path / JV variant).

    Returns ``col_of_row`` such that ``sum(cost[i, col_of_row[i]])`` is
    minimal. Self-contained numpy implementation. ``+inf`` entries are
    forbidden pairs; raises ``ValueError`` when no feasible assignment
    exists (or on ``-inf``/``NaN`` input).
    """
    cost = np.asarray(cost, dtype=np.float64)
    if cost.ndim != 2 or cost.shape[0] != cost.shape[1]:
        raise ValueError(f"hungarian expects a square cost matrix, got {cost.shape}")
    cost, forbidden = _substitute_forbidden(cost)
    n = cost.shape[0]
    INF = np.inf
    # Standard potentials formulation, 1-indexed internally.
    u = np.zeros(n + 1)
    v = np.zeros(n + 1)
    p = np.zeros(n + 1, dtype=np.int64)  # p[j] = row matched to column j
    way = np.zeros(n + 1, dtype=np.int64)
    for i in range(1, n + 1):
        p[0] = i
        j0 = 0
        minv = np.full(n + 1, INF)
        used = np.zeros(n + 1, dtype=bool)
        while True:
            used[j0] = True
            i0 = p[j0]
            delta = INF
            j1 = -1
            for j in range(1, n + 1):
                if used[j]:
                    continue
                cur = cost[i0 - 1, j - 1] - u[i0] - v[j]
                if cur < minv[j]:
                    minv[j] = cur
                    way[j] = j0
                if minv[j] < delta:
                    delta = minv[j]
                    j1 = j
            for j in range(n + 1):
                if used[j]:
                    u[p[j]] += delta
                    v[j] -= delta
                else:
                    minv[j] -= delta
            j0 = j1
            if p[j0] == 0:
                break
        while j0 != 0:
            j1 = way[j0]
            p[j0] = p[j1]
            j0 = j1
    col_of_row = np.zeros(n, dtype=np.int64)
    for j in range(1, n + 1):
        if p[j] > 0:
            col_of_row[p[j] - 1] = j - 1
    _check_feasible(forbidden, col_of_row)
    return col_of_row


def linear_assignment(cost: np.ndarray) -> np.ndarray:
    """``col_of_row`` minimizing ``sum_i cost[i, col_of_row[i]]``.

    The reference solver: scipy's Jonker-Volgenant when available, the
    numpy ``hungarian`` otherwise.
    """
    cost = np.asarray(cost, dtype=np.float64)
    if _scipy_lsa is not None:
        if cost.ndim != 2 or cost.shape[0] != cost.shape[1]:
            raise ValueError(
                f"linear_assignment expects a square cost matrix, got {cost.shape}"
            )
        if np.isnan(cost).any() or np.isneginf(cost).any():
            raise ValueError("cost matrix may not contain NaN or -inf")
        try:
            rows, cols = _scipy_lsa(cost)
        except ValueError as e:  # scipy phrases infeasibility its own way
            raise ValueError(f"no feasible assignment: {e}") from e
        out = np.empty(cost.shape[0], dtype=np.int64)
        out[rows] = cols
        return out
    return hungarian(cost)


def assignment_to_permutation(col_of_row: np.ndarray) -> np.ndarray:
    """Permutation matrix ``P`` with ``P[i, col_of_row[i]] = 1``."""
    n = len(col_of_row)
    P = np.zeros((n, n))
    P[np.arange(n), col_of_row] = 1.0
    return P


# ---------------------------------------------------------------------------
# Auction solver
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class AuctionState:
    """Warm-start state threaded between ``auction_assignment`` calls.

    Attributes:
      prices: (n,) object prices -- the auction's dual variables for the
        *maximization* form on ``benefit = -cost``. A pair ``(i, j)``
        satisfies eps-complementary-slackness when
        ``benefit[i, j] - prices[j] >= max_k(benefit[i, k] - prices[k]) - eps``.
      col_of_row: the assignment those prices certified.
      n_phases / n_rounds / n_rebid_rows: counters from the solve that
        produced this state (cold solves run the full epsilon-scaling
        schedule; warm solves report how many rows actually re-bid).

    Callers whose cost matrix is rescaled between solves (e.g. the FW
    update ``cost' = (1 - gamma) * cost + gamma * delta``) should rescale
    ``prices`` by the same factor -- eps-CS is invariant under joint
    positive scaling, so the carried prices stay near-feasible and only
    the ``gamma * delta`` perturbation has to be re-bid.
    """

    prices: np.ndarray
    col_of_row: np.ndarray
    n_phases: int = 0
    n_rounds: int = 0
    n_rebid_rows: int = 0

    def scaled(self, factor: float) -> "AuctionState":
        """State with prices scaled by ``factor`` (FW contraction step)."""
        return AuctionState(
            prices=self.prices * float(factor),
            col_of_row=self.col_of_row,
        )


def _substitute_forbidden(cost: np.ndarray) -> tuple[np.ndarray, np.ndarray | None]:
    """Replace ``+inf`` (forbidden) entries by a finite sentinel.

    The sentinel exceeds any feasible assignment's possible advantage, so
    the optimum uses a forbidden edge only when the problem is infeasible
    -- which ``_check_feasible`` then reports.
    """
    if np.isnan(cost).any() or np.isneginf(cost).any():
        raise ValueError("cost matrix may not contain NaN or -inf")
    forbidden = np.isposinf(cost)
    if not forbidden.any():
        return cost, None
    if forbidden.all(axis=1).any() or forbidden.all(axis=0).any():
        raise ValueError("no feasible assignment: a row/column is fully forbidden")
    finite = cost[~forbidden]
    lo, hi = float(finite.min()), float(finite.max())
    n = cost.shape[0]
    sentinel = hi + n * (hi - lo) + max(abs(hi), 1.0)
    out = cost.copy()
    out[forbidden] = sentinel
    return out, forbidden


def _check_feasible(forbidden: np.ndarray | None, col_of_row: np.ndarray) -> None:
    if forbidden is not None and forbidden[np.arange(len(col_of_row)), col_of_row].any():
        raise ValueError("no feasible assignment avoids the forbidden (+inf) entries")


def _quantize(
    cost: np.ndarray,
    rel_grid: float,
    scale_source: np.ndarray | None = None,
) -> tuple[np.ndarray, float]:
    """Snap ``cost`` to multiples of ``g = max|cost| * rel_grid``.

    Identical formula to ``repro_torch.core.stl_fw.LMOSolver``: quantizing
    an already-quantized matrix is a no-op, and the grid is what turns the
    auction's ``n * eps``-suboptimality bound into exact optimality.

    ``scale_source`` overrides the array the grid scale is taken from --
    used to exclude forbidden-pair sentinel values, whose magnitude is
    ~(n+1)x the real costs and would otherwise coarsen the grid by the
    same factor.
    """
    src = cost if scale_source is None else scale_source
    scale = float(np.max(np.abs(src))) if src.size else 0.0
    if scale <= 0.0 or rel_grid <= 0.0:
        return cost, 0.0
    g = scale * rel_grid
    return np.round(cost / g) * g, g


def _row_slack(
    benefit: np.ndarray,
    prices: np.ndarray,
    col_of_row: np.ndarray,
) -> np.ndarray:
    """Per-row complementary-slackness gap, ``>= 0``, for assigned rows.

    ``slack_i = max_j(benefit[i,j] - p[j]) - (benefit[i,c_i] - p[c_i])``.
    Because the assignment is a permutation, ``sum(slack)`` equals the
    duality gap ``D(p) - V(assignment)`` (the ``sum_j p_j`` terms cancel),
    which is the engine of both the warm fast path and early ladder exit:
    once the gap drops below the quantization grid, the assignment is
    exactly optimal for the quantized costs and no further phases run.
    One O(n^2) pass. Unassigned rows (col -1) get slack ``+inf``.
    """
    maxprof = (benefit - prices[None, :]).max(axis=1)
    n = benefit.shape[0]
    slack = np.full(n, np.inf)
    assigned = np.flatnonzero(col_of_row >= 0)
    if assigned.size:
        cols = col_of_row[assigned]
        slack[assigned] = maxprof[assigned] - (benefit[assigned, cols] - prices[cols])
    return slack


# Below this many active bidders a python Gauss-Seidel drain beats the
# vectorized Jacobi round: the auction endgame is long serialized eviction
# chains of 1-4 bidders, where per-round numpy dispatch overhead (~100us)
# dwarfs the O(n) row scan (~3us).
_GS_THRESHOLD = 64


def _gs_drain(
    benefit: np.ndarray,
    prices: np.ndarray,
    col_of_row: np.ndarray,
    owner: np.ndarray,
    eps: float,
    max_bids: int,
) -> int:
    """Gauss-Seidel auction: bid one row at a time with immediate price
    updates until no row is unassigned. Mutates in place, returns #bids."""
    stack = [int(i) for i in np.flatnonzero(col_of_row < 0)]
    bids = 0
    buf = np.empty_like(prices)
    neg_inf = -np.inf
    while stack:
        bids += 1
        if bids > max_bids:
            raise RuntimeError(
                f"auction did not converge in {max_bids} bids "
                f"(eps={eps:.3e}); cost matrix may be adversarial"
            )
        i = stack.pop()
        np.subtract(benefit[i], prices, out=buf)
        j = buf.argmax()
        v_best = buf[j]
        buf[j] = neg_inf
        v_second = buf.max()
        prices[j] += v_best - v_second + eps
        evicted = int(owner[j])
        owner[j] = i
        col_of_row[i] = j
        if evicted >= 0:
            col_of_row[evicted] = -1
            stack.append(evicted)
    return bids


def _bid_rounds(
    benefit: np.ndarray,
    prices: np.ndarray,
    col_of_row: np.ndarray,
    eps: float,
    max_rounds: int,
) -> int:
    """Bidding until every row is assigned. Mutates in place.

    Vectorized Jacobi rounds while many rows are unassigned: every
    unassigned row bids ``best - second_best + eps`` above the current
    price of its best object; contested objects go to the highest bidder
    and evict the previous owner. Once the active set falls below
    ``_GS_THRESHOLD`` a Gauss-Seidel drain finishes the phase. Prices
    only rise, by at least ``eps`` per awarded object, so termination is
    guaranteed for feasible problems.
    """
    n = benefit.shape[0]
    owner = np.full(n, -1, dtype=np.int64)  # owner[j] = row holding object j
    held = np.flatnonzero(col_of_row >= 0)
    owner[col_of_row[held]] = held
    rounds = 0
    # ~10x above the worst legitimately-observed phase (a full warm
    # reshuffle at n=512 peaks around 20k GS bids).
    max_bids = 200 * n + 100_000
    while True:
        unassigned = np.flatnonzero(col_of_row < 0)
        if unassigned.size == 0:
            return rounds
        if unassigned.size <= _GS_THRESHOLD:
            return rounds + _gs_drain(benefit, prices, col_of_row, owner, eps, max_bids)
        rounds += 1
        if rounds > max_rounds:
            raise RuntimeError(
                f"auction did not converge in {max_rounds} bidding rounds "
                f"(eps={eps:.3e}); cost matrix may be adversarial"
            )
        vals = benefit[unassigned] - prices[None, :]  # (U, n)
        u = np.arange(unassigned.size)
        j_best = np.argmax(vals, axis=1)
        v_best = vals[u, j_best]
        vals[u, j_best] = -np.inf
        v_second = vals.max(axis=1)
        # new price for object j_best: benefit - v_second + eps
        bid_price = v_best + prices[j_best] - v_second + eps
        # Highest bid per object wins: ascending sort + scatter (later
        # writes win) implements an argmax-by-group in two passes.
        order = np.argsort(bid_price, kind="stable")
        win_row = np.full(n, -1, dtype=np.int64)
        win_price = np.empty(n)
        win_row[j_best[order]] = unassigned[order]
        win_price[j_best[order]] = bid_price[order]
        contested = np.flatnonzero(win_row >= 0)
        # evict current owners, install winners, raise prices
        evicted = owner[contested]
        col_of_row[evicted[evicted >= 0]] = -1
        owner[contested] = win_row[contested]
        col_of_row[win_row[contested]] = contested
        prices[contested] = win_price[contested]


def auction_assignment(
    cost: np.ndarray,
    warm: AuctionState | None = None,
    *,
    rel_grid: float = AUCTION_REL_GRID,
    scaling: float = _EPS_SCALING,
    max_rounds_per_phase: int | None = None,
) -> tuple[np.ndarray, AuctionState]:
    """Forward auction with epsilon scaling; optionally warm-started.

    Args:
      cost: (n, n) cost matrix; ``+inf`` marks forbidden pairs.
      warm: ``AuctionState`` from a previous solve on a nearby cost
        matrix. Its prices seed the duals and its assignment is kept
        wherever eps-CS still holds, so only perturbed rows re-bid. Pass
        ``state.scaled(1 - gamma)`` when the cost was contracted by
        ``(1 - gamma)`` in between (the Frank-Wolfe update).
      rel_grid: quantization grid, relative to ``max|cost|``. The final
        epsilon is ``grid / (n + 1)``, which makes the result exactly
        optimal for the quantized matrix. Must match any quantization the
        caller already applied (``repro_torch.core.stl_fw`` uses the same 1e-12).
      scaling: factor between epsilon-scaling phases.
      max_rounds_per_phase: safety valve; default ``200 * n + 10_000``.

    Returns:
      ``(col_of_row, state)`` -- the assignment and the dual state to
      thread into the next call.
    """
    cost = np.asarray(cost, dtype=np.float64)
    if cost.ndim != 2 or cost.shape[0] != cost.shape[1]:
        raise ValueError(
            f"auction_assignment expects a square cost matrix, got {cost.shape}"
        )
    n = cost.shape[0]
    if n == 0:
        return np.empty(0, dtype=np.int64), AuctionState(np.empty(0), np.empty(0, np.int64))
    cost, forbidden = _substitute_forbidden(cost)
    if n == 1:
        col = np.zeros(1, dtype=np.int64)
        _check_feasible(forbidden, col)
        return col, AuctionState(prices=np.zeros(1), col_of_row=col)
    cost, grid = _quantize(
        cost, rel_grid,
        scale_source=None if forbidden is None else cost[~forbidden],
    )
    benefit = -cost
    spread = float(benefit.max() - benefit.min())
    scale = float(np.max(np.abs(benefit)))
    if spread <= 0.0:
        # all costs equal: every assignment is optimal; skip the auction
        # entirely (Jacobi bidding degenerates to one assignment per round
        # on fully tied values).
        col = (
            warm.col_of_row.copy()
            if warm is not None and _is_permutation(warm.col_of_row, n)
            else np.arange(n, dtype=np.int64)
        )
        _check_feasible(forbidden, col)
        return col, AuctionState(prices=np.zeros(n), col_of_row=col)
    eps_final = max(grid, np.finfo(np.float64).tiny) / (n + 1)
    # Exactness certificate: assignment values are sums of grid multiples,
    # so a duality gap below the grid pins the assignment to the exact
    # optimum of the quantized costs (no more ladder phases needed).
    gap_tol = 0.5 * grid
    if max_rounds_per_phase is None:
        max_rounds_per_phase = 200 * n + 10_000

    n_phases = 0
    n_rounds = 0
    n_rebid = n
    warm_ok = (
        warm is not None
        and warm.prices.shape == (n,)
        and np.all(np.isfinite(warm.prices))
        # A usable warm state has price *spread* commensurate with the
        # benefit spread (only relative prices matter -- eps-CS is shift
        # invariant). Prices carried from a differently-scaled problem
        # (e.g. a caller skipped the documented `.scaled(1-gamma)`
        # contraction) would take ~price_spread/eps bids to unwind;
        # a cold solve is strictly cheaper, so fall back to it.
        and float(warm.prices.max() - warm.prices.min()) <= 8.0 * spread
        and _is_permutation(warm.col_of_row, n)
    )
    if warm_ok:
        prices = warm.prices.astype(np.float64).copy()
        col_of_row = warm.col_of_row.astype(np.int64).copy()
        # Measure how far the carried duals are from complementary
        # slackness on the *new* matrix. Rows below tolerance never re-bid
        # at all, and if the total gap is still under the grid the old
        # assignment is provably optimal for the new costs: return with
        # zero bidding.
        slack = _row_slack(benefit, prices, col_of_row)
        gap = float(slack.sum())
        n_rebid = int(np.count_nonzero(slack > eps_final))
        if gap_tol > 0.0 and gap <= gap_tol:
            _check_feasible(forbidden, col_of_row)
            return col_of_row.copy(), AuctionState(
                prices=prices, col_of_row=col_of_row, n_phases=0, n_rounds=0,
                n_rebid_rows=0,
            )
        eps = max(min(float(slack.max()), spread) / scaling, eps_final)
        col_of_row[slack > eps] = -1
    else:
        prices = np.zeros(n)
        col_of_row = np.full(n, -1, dtype=np.int64)
        eps = max(spread / scaling, eps_final)

    while True:
        n_phases += 1
        # Floor the working epsilon at what float64 can register against
        # the current price magnitude: a bid of +eps on a price p only
        # moves p when eps >~ p * 2^-52. Without the floor, tiny-eps
        # phases on matrices whose optimal prices dwarf the quantization
        # grid stagnate (prices stop rising, bid wars never end). The
        # floor costs at most ~n * max|p| * 2^-48 objective slack --
        # float-summation noise, far below the 1e-12-relative grid's
        # meaningful differences -- and the duality-gap certificate
        # still reports exact optimality whenever it fires.
        price_mag = float(np.max(np.abs(prices))) if prices.size else 0.0
        eps_run = max(eps, price_mag * 2.0 ** -48)
        n_rounds += _bid_rounds(
            benefit, prices, col_of_row, eps_run, max_rounds_per_phase
        )
        slack = _row_slack(benefit, prices, col_of_row)
        gap = float(slack.sum())
        if (gap_tol > 0.0 and gap <= gap_tol) or eps_run <= eps_final:
            break
        if eps_run > eps:
            # already at the fp floor: tightening eps further cannot
            # change any bid; accept the eps_run-optimal assignment.
            break
        eps = max(eps_final, eps / scaling)
        col_of_row[slack > eps] = -1

    _check_feasible(forbidden, col_of_row)
    state = AuctionState(
        prices=prices,
        col_of_row=col_of_row.copy(),
        n_phases=n_phases,
        n_rounds=n_rounds,
        n_rebid_rows=n_rebid if warm is not None else n,
    )
    return col_of_row, state


def _is_permutation(col_of_row: np.ndarray, n: int) -> bool:
    return (
        col_of_row.shape == (n,)
        and np.all(col_of_row >= 0)
        and np.all(col_of_row < n)
        and len(np.unique(col_of_row)) == n
    )


def solve_lmo(
    grad: np.ndarray,
    *,
    backend: str = "scipy",
    device=None,
) -> tuple[np.ndarray, np.ndarray]:
    """Frank-Wolfe LMO over the Birkhoff polytope (single cold solve).

    Returns ``(P, col_of_row)`` where ``P = argmin_{P perm} <P, grad>``.

    ``backend`` selects the solver: ``"scipy"`` (the reference
    ``linear_assignment``), ``"hungarian"`` (numpy O(n^3)),
    ``"auction"`` (epsilon-scaling auction), or ``"auction_jit"`` (the
    device auction, ``repro_torch.core.assignment_jit``, on ``device``:
    None = CUDA, ``"cpu"`` for its plain version). This function is
    stateless; for the warm-started auctions that carry dual prices
    across FW iterations, use ``repro_torch.core.stl_fw.LMOSolver`` (or
    ``learn_topology(lmo=...)``), or call ``auction_assignment`` /
    ``auction_assignment_jit`` directly and thread the returned state
    yourself.
    """
    if backend == "auction":
        col_of_row, _ = auction_assignment(grad)
    elif backend == "auction_jit":
        from .assignment_jit import auction_assignment_jit

        col_of_row, _ = auction_assignment_jit(grad, device=device)
    elif backend == "hungarian":
        col_of_row = hungarian(grad)
    elif backend == "scipy":
        col_of_row = linear_assignment(grad)
    else:
        raise ValueError(f"unknown LMO backend {backend!r}")
    return assignment_to_permutation(col_of_row), col_of_row
