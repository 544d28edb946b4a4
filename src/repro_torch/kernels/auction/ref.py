"""Plain PyTorch version of the device auction (``csrc/auction.cu``).

A port of the reference's compiled engine, ``_compiled_core`` in
``src/repro/core/assignment_jit.py:184`` (a ``lax.while_loop``), on
float64 tensors with a host ``while`` loop: the same epsilon ladder and
stagnation rescue, the same Jacobi rounds over a bucket of
``min(n, 64)`` bidders (highest bid wins, ties to the largest row), the
same Gauss-Seidel drain below ``gs_threshold``, the same
forward-reverse variant, floating-point floor and duality-gap
certificate. The kernel repeats this arithmetic operation for operation,
so the two return the same assignment: every bid is the same float64
expression, max and min reductions are exact in any order, and the
certificate's slack sum is taken in the fixed pairwise order of
:func:`tree_sum`, which the kernel mirrors.

It runs on the tensors' device; every branch reads a scalar back to the
host, so on the card it is the kernel's yardstick, not a solver.
"""

from __future__ import annotations

import math

import torch

__all__ = ["auction_ref", "tree_sum", "STATS", "BUCKET"]

BUCKET = 64  # bidders in one Jacobi round (fewer when n < 64)
MAX_OUTER = 256  # phases + rescues
REVERSE_ROUND_CAP = 64  # reverse rounds in one phase, forward_reverse only
FP_FLOOR = 2.0 ** -48  # a bid of eps on a price p registers only for eps >~ p 2^-52
EPS_SCALING = 6.0  # the classic ladder factor the rescue relaxes toward
# the int64 stats vector both versions return, in this order
STATS = ("bad", "blocked", "n_forbidden", "tied", "converged", "phases", "rounds", "rebid",
         "outer")


def tree_sum(x: torch.Tensor) -> float:
    """Sum of ``x`` in a fixed pairwise order: padded with zeros to a power
    of two N, then ``x = x[:h] + x[h:]`` until one value is left."""
    n = x.shape[0]
    buf = torch.zeros(1 << max(0, (n - 1).bit_length()), dtype=x.dtype, device=x.device)
    buf[:n] = x
    while buf.shape[0] > 1:
        h = buf.shape[0] // 2
        buf = buf[:h] + buf[h:]
    return float(buf[0])


def _best_second(vals: torch.Tensor, iota: torch.Tensor):
    """Per row: the max, the smallest index reaching it, and the max over
    the other indices."""
    n = vals.shape[1]
    v_best = vals.max(dim=1).values
    j_best = torch.where(vals == v_best[:, None], iota[None, :], n).min(dim=1).values
    v_second = torch.where(iota[None, :] == j_best[:, None], -math.inf, vals).max(dim=1).values
    return v_best, j_best, v_second


def _winners(key: torch.Tensor, value: torch.Tensor, tag: torch.Tensor) -> torch.Tensor:
    """Which entries win their ``key``: the highest ``value``, ties to the
    largest ``tag``."""
    same = key[:, None] == key[None, :]
    beaten = same & ((value[None, :] > value[:, None])
                     | ((value[None, :] == value[:, None]) & (tag[None, :] > tag[:, None])))
    return ~beaten.any(dim=1)


class _State:
    def __init__(self, benefit, prices, col, pi, eps_run, forward_reverse):
        self.benefit = benefit
        self.prices = prices
        self.col = col
        self.pi = pi
        n = benefit.shape[0]
        self.iota = torch.arange(n, device=benefit.device)
        self.owner = torch.full((n,), -1, dtype=torch.long, device=benefit.device)
        self.rebuild_owner()
        self.n_un = int((col < 0).sum())
        self.eps_run = eps_run
        self.forward_reverse = forward_reverse
        self.bucket = min(n, BUCKET)

    def rebuild_owner(self) -> None:
        self.owner.fill_(-1)
        held = self.col >= 0
        self.owner[self.col[held]] = self.iota[held]

    def forward_round(self) -> None:
        idx = torch.nonzero(self.col < 0).flatten()[: self.bucket]
        vals = self.benefit[idx] - self.prices[None, :]
        v_best, j_best, v_second = _best_second(vals, self.iota)
        bid = v_best + self.prices[j_best] - v_second + self.eps_run
        win = _winners(j_best, bid, idx)
        j, rows = j_best[win], idx[win]
        evicted = self.owner[j]
        evicted = evicted[evicted >= 0]
        self.col[evicted] = -1
        self.col[rows] = j
        self.owner[j] = rows
        self.prices[j] = bid[win]
        self.n_un += evicted.shape[0] - j.shape[0]
        if self.forward_reverse:
            self.pi[rows] = v_second[win] - self.eps_run

    def reverse_round(self) -> None:
        jdx = torch.nonzero(self.owner < 0).flatten()[: self.bucket]
        rvals = (self.benefit[:, jdx] - self.pi[:, None]).T
        b_best, i_best, b_second = _best_second(rvals, self.iota)
        win = _winners(i_best, b_best, jdx)
        rows, j = i_best[win], jdx[win]
        self.n_un -= int((self.col[rows] < 0).sum())
        self.prices[j] = torch.minimum(self.prices[j], b_second[win] - self.eps_run)
        freed = self.col[rows]
        self.owner[freed[freed >= 0]] = -1
        self.owner[j] = rows
        self.col[rows] = j
        self.pi[rows] = self.benefit[rows, j] - self.prices[j]

    def gs_bid(self, last: int) -> int:
        """One Gauss-Seidel bid of row ``last`` (or of the smallest
        unassigned row); returns the evicted row, or -1."""
        i = last if last >= 0 else int(torch.nonzero(self.col < 0)[0, 0])
        row = self.benefit[i] - self.prices
        # the two largest values are the max and the max over the other
        # indices; the bid goes to the smallest index reaching the max
        v_best, v_second = torch.topk(row, 2).values.tolist()
        j = int(torch.nonzero(row == v_best)[0, 0])
        self.prices[j] += (v_best - v_second) + self.eps_run
        old = int(self.owner[j])
        if old >= 0:
            self.col[old] = -1
        self.col[i] = j
        self.owner[j] = i
        self.n_un += -1 + (old >= 0)
        return old


def auction_ref(
    cost: torch.Tensor,
    warm_prices: torch.Tensor,
    warm_col: torch.Tensor,
    *,
    warm_scale: float,
    have_warm: bool,
    rel_grid: float,
    scaling: float,
    forward_reverse: bool,
    validate: bool,
    gs_threshold: int,
    max_iters: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One solve of ``max sum_i benefit[i, col[i]]`` on ``benefit = -cost``
    snapped to the ``max|cost| * rel_grid`` grid.

    ``cost`` is (n, n) float64 with n >= 2 (``+inf`` marks a forbidden
    pair when ``validate``); ``warm_prices`` (n,) float64 and
    ``warm_col`` (n,) int32 are read only when ``have_warm``.

    Returns ``(col_of_row int32 (n,), prices float64 (n,), stats int64
    (len(STATS),))``; a stats entry ``converged`` of 0 means the round
    cap ``max_iters`` or the phase cap stopped the solve.
    """
    dev = cost.device
    n = cost.shape[0]
    if validate:
        bad = bool(torch.isnan(cost).any() or torch.isneginf(cost).any())
        forbidden = torch.isposinf(cost)
        n_forb = int(forbidden.sum())
        blocked = bool(forbidden.all(dim=1).any() or forbidden.all(dim=0).any())
        hi = float(torch.where(forbidden, -math.inf, cost).max())
        lo = float(torch.where(forbidden, math.inf, cost).min())
        sentinel = hi + n * (hi - lo) + max(abs(hi), 1.0)
        filled = torch.where(forbidden, sentinel, cost)
        scale = float(torch.where(forbidden, 0.0, cost).abs().max())
    else:
        bad = blocked = False
        n_forb = 0
        filled = cost
        scale = float(cost.abs().max())
    grid = scale * rel_grid
    quantized = torch.round(filled / grid) * grid if grid > 0.0 else filled
    benefit = -quantized
    spread = float(benefit.max()) - float(benefit.min())
    tied = spread <= 0.0
    eps_final = max(grid, 2.2250738585072014e-308) / (n + 1)
    gap_tol = 0.5 * grid

    wp = warm_prices.to(torch.float64) * warm_scale
    warm_ok = (have_warm and bool(torch.isfinite(wp).all())
               and (float(wp.max()) - float(wp.min())) <= 8.0 * spread)
    prices = wp.clone() if warm_ok else torch.zeros(n, dtype=torch.float64, device=dev)
    col = (warm_col.to(torch.long).clone() if warm_ok
           else torch.full((n,), -1, dtype=torch.long, device=dev))
    eps = math.inf if warm_ok else max(spread / scaling, eps_final)
    pi = ((benefit - prices[None, :]).max(dim=1).values if forward_reverse
          else torch.zeros(n, dtype=torch.float64, device=dev))
    price_mag = float(prices.abs().max())
    st = _State(benefit, prices, col, pi,
                eps if math.isinf(eps) else max(eps, price_mag * FP_FLOOR), forward_reverse)
    s = scaling
    budget = 8.0 * n + 2048.0
    done = tied or bad or blocked
    phases = rounds = outer = 0
    rebid = n

    while not done and outer < MAX_OUTER and rounds < max_iters:
        bids, phase_rounds = 0.0, 0
        while st.n_un > gs_threshold and bids < budget and rounds < max_iters:
            st.forward_round()
            if forward_reverse and st.eps_run > eps_final and phase_rounds < REVERSE_ROUND_CAP:
                st.reverse_round()
            rounds += 1
            bids += float(st.bucket)
            phase_rounds += 1
        last = -1
        while st.n_un > 0 and bids < budget and rounds < max_iters:
            last = st.gs_bid(last)
            rounds += 1
            bids += 1.0
        if st.n_un > 0:  # stalled: raise eps back, relax the factor, grow the budget
            eps = min(eps * s, spread / EPS_SCALING)
            s = max(math.sqrt(s), EPS_SCALING)
            st.eps_run = max(eps, float(st.prices.abs().max()) * FP_FLOOR)
            budget *= 4.0
        else:  # phase check: the certificate, then the next eps
            maxprof = (benefit - st.prices[None, :]).max(dim=1).values
            slack = maxprof - (benefit[st.iota, st.col] - st.prices[st.col])
            gap = tree_sum(slack)
            certified = gap_tol > 0.0 and gap <= gap_tol
            if math.isinf(eps):  # the first check of a warm start
                done = certified
                rebid = 0 if done else int((slack > eps_final).sum())
                eps_new = max(min(float(slack.max()), spread) / s, eps_final)
            else:
                done = certified or st.eps_run <= eps_final or st.eps_run > eps
                eps_new = max(eps / s, eps_final)
            eps_run_new = max(eps_new, float(st.prices.abs().max()) * FP_FLOOR)
            drop = (slack > eps_new) if not done else torch.zeros_like(slack, dtype=torch.bool)
            st.col[drop] = -1
            st.rebuild_owner()
            st.pi = maxprof
            st.n_un = int(drop.sum())
            eps, st.eps_run = eps_new, eps_run_new
            phases += 0 if done else 1
        outer += 1

    if tied:
        col_out = warm_col.to(torch.long) if have_warm else st.iota.clone()
        prices_out = torch.zeros(n, dtype=torch.float64, device=dev)
    else:
        col_out, prices_out = st.col, st.prices
    stats = torch.tensor([bad, blocked, n_forb, tied, done or tied, phases, rounds,
                          rebid if warm_ok else n, outer], dtype=torch.int64, device=dev)
    return col_out.to(torch.int32), prices_out, stats
