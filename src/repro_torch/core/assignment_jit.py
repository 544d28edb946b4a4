"""Device auction LMO: the port of ``repro.core.assignment_jit``.

The reference compiles its eps-scaling forward(-reverse) auction into one
``lax.while_loop``, so a Frank-Wolfe LMO solve is one device computation
with no host round trip per bidding round. The port does the same with
one launch of a hand-written CUDA kernel
(``repro_torch.kernels.auction``, ``csrc/auction.cu``): the epsilon
ladder with its stagnation rescue, Jacobi rounds over a bucket of
``min(n, 64)`` bidders, the Gauss-Seidel drain, the forward-reverse
variant, the float64 1e-12-relative grid and the duality-gap
certificate, all inside the kernel. On the CPU the same solve runs in
its plain PyTorch version (``kernels/auction/ref.py``).

Exactness is the reference's: costs are snapped to the shared grid, the
final epsilon is ``grid / (n + 1)`` and the certificate proves the
assignment optimal for the snapped costs, so every LMO backend reaches
the same ``<P, G>`` objective, and the same ``learn_topology`` trajectory
wherever the snapped optimum is unique (generic Pi).

Warm start. :class:`AuctionJitState` carries the dual prices as a
float64 tensor on the solve's device; ``scaled()`` defers the FW
contraction into ``pending_scale`` and the next solve applies it inside
the kernel, as the reference does. On the card a solve uses an
:class:`AuctionWorkspace` -- device buffers, pinned staging and a stream
of its own, made once per size -- and allocates nothing: the cost goes
up through the pinned buffer, one kernel launch solves, and only
``col_of_row`` and a few counters come back. The prices stay in the
workspace. ``stl_fw.LMOSolver`` owns one workspace for its size (made by
its ``prepare``) and passes it to every solve, so a warm state's prices
are the workspace's own and the next solve overwrites them, like the
reference's donated buffer. A call given no workspace makes one for
itself.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.graphs import device_work
from repro_torch.kernels.auction import ops as auction_ops
from repro_torch.kernels.auction.ref import STATS

from .assignment import AUCTION_REL_GRID, _check_feasible, _is_permutation, _substitute_forbidden

__all__ = [
    "auction_assignment_jit",
    "AuctionJitState",
    "AuctionWorkspace",
    "AUCTION_JIT_GS_THRESHOLD",
    "AUCTION_JIT_JACOBI_THRESHOLD",
]

# Active-bidder count above which bidding runs as bucketed Jacobi rounds;
# None resolves per device (see _default_gs_threshold).
AUCTION_JIT_GS_THRESHOLD = None

# The threshold wherever the Jacobi stage must run: on the card, and for
# the forward_reverse variant on any device (its reverse rounds live
# inside the Jacobi stage).
AUCTION_JIT_JACOBI_THRESHOLD = 64

# The initial epsilon-ladder factor (the reference's measured default;
# the stagnation rescue relaxes it toward 6 on price-warring instances).
_JIT_DEFAULT_SCALING = 3000.0


def _default_gs_threshold(n: int, device: torch.device) -> int:
    """``n`` (Gauss-Seidel always) on the CPU, 64 on the card, as the
    reference resolves it per backend."""
    return AUCTION_JIT_JACOBI_THRESHOLD if device.type == "cuda" else n


@dataclasses.dataclass
class AuctionJitState:
    """Warm-start state threaded between ``auction_assignment_jit`` calls.

    ``prices`` is a float64 tensor on the solve's device (it never comes
    back to the host between FW iterations); ``col_of_row`` is the host
    assignment those prices certified. ``scaled(factor)`` folds
    ``factor`` into ``pending_scale`` and the next solve applies it.
    """

    prices: torch.Tensor | np.ndarray
    col_of_row: np.ndarray
    pending_scale: float = 1.0
    n_phases: int = 0
    n_rounds: int = 0
    n_rebid_rows: int = 0

    def scaled(self, factor: float) -> "AuctionJitState":
        """State with prices scaled by ``factor`` (FW contraction step)."""
        return dataclasses.replace(self, pending_scale=self.pending_scale * float(factor))


class AuctionWorkspace:
    """Everything a solve of size ``n`` on a CUDA ``device`` uses, made
    once: the benefit matrix, the prices (the warm state), the kernel's
    outputs and scratch, pinned host staging for the cost going up and
    ``col_of_row`` and the counters coming back, and a stream of its own.

    Make it on the thread that drives the device, before any CUDA graph
    is captured; a solve on another thread then makes no allocation.
    """

    def __init__(self, n: int, device: torch.device | str | None = None):
        device = resolve_device(device)
        if device.type != "cuda":
            raise ValueError("an AuctionWorkspace is for a CUDA device; the CPU needs none")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        self.n = int(n)
        self.device = device
        f64, i32 = torch.float64, torch.int32
        self.benefit = torch.empty((n, n), dtype=f64, device=device)
        self.prices = torch.zeros(n, dtype=f64, device=device)
        self.col = torch.empty(n, dtype=i32, device=device)
        self.warm_col = torch.full((n,), -1, dtype=i32, device=device)
        self.stats = torch.empty(len(STATS), dtype=torch.int64, device=device)
        nf, ni = auction_ops.work_sizes(n)
        self.work = (torch.empty(nf, dtype=f64, device=device),
                     torch.empty(ni, dtype=i32, device=device))
        self.host_cost = torch.empty((n, n), dtype=f64, pin_memory=True)
        self.host_warm_col = torch.empty(n, dtype=i32, pin_memory=True)
        self.host_col = torch.empty(n, dtype=i32, pin_memory=True)
        self.host_stats = torch.empty(len(STATS), dtype=torch.int64, pin_memory=True)
        self.stream = torch.cuda.Stream(device)

    def fits(self, n: int, device: torch.device) -> bool:
        return self.n == n and device.type == "cuda" and (
            device.index is None or device.index == self.device.index)

    @property
    def buffers(self) -> dict:
        """``kernels.auction.ops.auction``'s card buffers: the benefit
        scratch, the outputs (``col``, ``prices``, ``stats``) and the work."""
        return dict(benefit=self.benefit, out=(self.col, self.prices, self.stats),
                    work=self.work)

    def solve(self, cost: np.ndarray, warm: AuctionJitState | None, have_warm: bool,
              **kw) -> tuple[np.ndarray, np.ndarray]:
        """One kernel launch on this workspace's stream; returns the host
        ``col_of_row`` (int64) and stats. The prices stay in ``prices``."""
        with device_work():
            np.copyto(self.host_cost.numpy(), cost)
            if have_warm:
                self.host_warm_col.numpy()[:] = warm.col_of_row
                # the workspace's own prices as they are; others copied over
                wp = torch.as_tensor(warm.prices, dtype=torch.float64,
                                     device=self.device).contiguous()
            else:
                wp = self.prices  # not read
            self.stream.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(self.stream):
                self.benefit.copy_(self.host_cost, non_blocking=True)
                if have_warm:
                    self.warm_col.copy_(self.host_warm_col, non_blocking=True)
                auction_ops.auction(self.benefit, wp, self.warm_col, have_warm=have_warm,
                                    **self.buffers, **kw)
                self.host_col.copy_(self.col, non_blocking=True)
                self.host_stats.copy_(self.stats, non_blocking=True)
            self.stream.synchronize()
            return self.host_col.numpy().astype(np.int64), self.host_stats.numpy().copy()


def auction_assignment_jit(
    cost: np.ndarray,
    warm: AuctionJitState | None = None,
    *,
    rel_grid: float = AUCTION_REL_GRID,
    scaling: float | None = None,
    variant: str = "forward",
    gs_threshold: int | None = AUCTION_JIT_GS_THRESHOLD,
    max_iters: int | None = None,
    validate: bool = True,
    device: torch.device | str | None = None,
    workspace: AuctionWorkspace | None = None,
) -> tuple[np.ndarray, AuctionJitState]:
    """Forward(-reverse) auction with adaptive epsilon scaling, one kernel
    launch per solve on the card.

    The reference's host contract: a square cost matrix; ``+inf`` marks
    forbidden pairs (replaced by a finite sentinel inside the solve);
    NaN and ``-inf`` are rejected; costs snap to the shared
    1e-12-relative grid; n == 0, n == 1 and all-tied input take their
    shortcuts; a malformed warm state is ignored.

    Args:
      cost: (n, n) cost matrix (host array); ``+inf`` marks forbidden pairs.
      warm: state of a previous solve on a nearby cost matrix (pass
        ``state.scaled(1 - gamma)`` across FW steps).
      rel_grid: quantization grid relative to ``max|cost|``.
      scaling: initial epsilon-ladder factor; None = 3000.
      variant: ``"forward"`` or ``"forward_reverse"``.
      gs_threshold: active-bidder count below which bidding turns
        Gauss-Seidel. None: n on the CPU, 64 on the card, and 64 for
        ``forward_reverse`` everywhere.
      max_iters: round cap; default ``500 n + 200_000``. A solve that
        reaches it raises ``RuntimeError``.
      validate: check NaN / -inf and handle ``+inf`` inside the solve;
        the FW LMO, whose gradient is finite, passes False.
      device: where the solve runs (None = CUDA; ``"cpu"`` runs the plain
        version). Ignored when ``workspace`` is given.
      workspace: the card's buffers for this n (``LMOSolver`` passes its
        own; made for this call when not given). The reference has no
        such argument.

    Returns:
      ``(col_of_row, state)``: the host int64 assignment and the dual
      state for the next warm call.
    """
    cost = np.asarray(cost, dtype=np.float64)
    if cost.ndim != 2 or cost.shape[0] != cost.shape[1]:
        raise ValueError(
            f"auction_assignment_jit expects a square cost matrix, got {cost.shape}"
        )
    if variant not in ("forward", "forward_reverse"):
        raise ValueError(f"unknown auction variant {variant!r}")
    scaling = _JIT_DEFAULT_SCALING if scaling is None else float(scaling)
    if scaling <= 1.0:
        raise ValueError(f"scaling must exceed 1, got {scaling}")
    n = cost.shape[0]
    dev = workspace.device if workspace is not None else resolve_device(device)
    if gs_threshold is None:
        gs_threshold = (AUCTION_JIT_JACOBI_THRESHOLD if variant == "forward_reverse"
                        else _default_gs_threshold(n, dev))
    if n == 0:
        return (np.empty(0, dtype=np.int64),
                AuctionJitState(torch.empty(0, dtype=torch.float64, device=dev),
                                np.empty(0, np.int64)))
    if n == 1:
        _, forbidden = _substitute_forbidden(cost)
        col = np.zeros(1, dtype=np.int64)
        _check_feasible(forbidden, col)
        return col, AuctionJitState(prices=torch.zeros(1, dtype=torch.float64, device=dev),
                                    col_of_row=col)
    if max_iters is None:
        max_iters = 500 * n + 200_000
    # O(n) host vetting of the warm state; its prices are checked inside
    # the solve (finite, spread), never read back here
    have_warm = (
        warm is not None
        and getattr(warm.prices, "shape", None) == (n,)
        and np.isfinite(warm.pending_scale)
        and _is_permutation(np.asarray(warm.col_of_row), n)
    )
    kw = dict(warm_scale=warm.pending_scale if have_warm else 1.0, rel_grid=rel_grid,
              scaling=scaling, forward_reverse=variant == "forward_reverse",
              validate=validate, gs_threshold=int(gs_threshold), max_iters=int(max_iters))
    if dev.type == "cuda":
        if workspace is None:
            workspace = AuctionWorkspace(n, dev)
        elif not workspace.fits(n, dev):
            raise ValueError(f"workspace is for n = {workspace.n}, the cost has n = {n}")
        col, stats = workspace.solve(cost, warm, have_warm, **kw)
        prices = workspace.prices
    else:
        if have_warm:
            wp = torch.as_tensor(warm.prices, dtype=torch.float64, device="cpu").contiguous()
            wc = torch.as_tensor(np.asarray(warm.col_of_row), dtype=torch.int32)
        else:
            wp = torch.zeros(n, dtype=torch.float64)
            wc = torch.full((n,), -1, dtype=torch.int32)
        col_t, prices, stats_t = auction_ops.auction(
            torch.from_numpy(cost), wp, wc, have_warm=have_warm, **kw)
        col, stats = col_t.numpy().astype(np.int64), stats_t.numpy()
    flags = dict(zip(STATS, (int(v) for v in stats)))
    if flags["bad"]:
        raise ValueError("cost matrix may not contain NaN or -inf")
    if flags["blocked"]:
        raise ValueError("no feasible assignment: a row/column is fully forbidden")
    if not flags["converged"]:
        raise RuntimeError(
            f"auction_jit did not converge in {max_iters} bidding rounds "
            f"(n={n}); cost matrix may be adversarial"
        )
    forbidden = np.isposinf(cost) if validate and flags["n_forbidden"] else None
    _check_feasible(forbidden, col)
    if flags["tied"]:  # fully tied input: any permutation, prices reset
        return col, AuctionJitState(prices=prices, col_of_row=col.copy())
    return col, AuctionJitState(
        prices=prices, col_of_row=col.copy(), n_phases=flags["phases"],
        n_rounds=flags["rounds"], n_rebid_rows=flags["rebid"],
    )
