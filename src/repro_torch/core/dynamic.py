"""Time-varying mixing matrices (paper Sec. 3 + App. C.1 extensions).

The paper's analysis allows a different doubly-stochastic ``W^(t)`` per
iteration (and random ``W ~ W^(t)`` with the expectations of App. C.1).
This module provides the useful schedules:

* ``PeriodicGossip``   -- W on every k-th step, I otherwise ("local SGD"
  flavored D-SGD): amortizes communication by 1/k. Assumption 3/4 hold per
  window with the k-step composite matrix.
* ``RandomMatching``   -- a random perfect matching each step (classic
  pairwise gossip): d_max = 1 per step, satisfies Assumption 3 in
  expectation with p = 1/2 * (pairing probability) -- App. C.1 setting.
* ``AtomCycling``      -- cycles through the Birkhoff atoms of a learned
  STL-FW topology one atom per step: per-step communication cost of ONE
  permutation while the k-step composite approximates the full W. This is
  the beyond-paper schedule evaluated in EXPERIMENTS.md §Perf.
* ``OnlineSchedule``   -- composes any of the above with a *refreshing* W
  (the ``repro.online`` subsystem): each topology refresh pushes a new
  payload, a fresh inner schedule is built from it, and ``matrix(t)``
  delegates to the segment active at ``t``. Every per-step matrix is a
  doubly-stochastic ``W^(t)``, so refresh boundaries stay inside the
  paper's changing-topology analysis (Sec. 3 / Koloskova et al. 2020).

All schedules expose ``matrix(t) -> np.ndarray`` and are directly usable
with the simulator (`run_mean_estimation(..., W=schedule)` accepts a
callable) and convertible per-step to Birkhoff ppermute schedules.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np

from .mixing import BirkhoffSchedule
from .stl_fw import STLFWResult

__all__ = [
    "PeriodicGossip",
    "RandomMatching",
    "AtomCycling",
    "OnlineSchedule",
    "composite_matrix",
]


@dataclasses.dataclass
class PeriodicGossip:
    """W every ``period`` steps, identity otherwise."""

    W: np.ndarray
    period: int = 2

    def matrix(self, t: int) -> np.ndarray:
        n = self.W.shape[0]
        return self.W if t % self.period == 0 else np.eye(n)

    def amortized_comm_atoms(self, schedule: BirkhoffSchedule) -> float:
        return schedule.n_communication_atoms / self.period


@dataclasses.dataclass
class RandomMatching:
    """Random perfect matching per step with weight 1/2 per edge.

    W^(t) = (I + P_match)/2 with P_match a random involutive permutation:
    doubly stochastic, symmetric, d_max = 1.
    """

    n: int
    seed: int = 0

    def matrix(self, t: int) -> np.ndarray:
        rng = np.random.default_rng(
            np.random.SeedSequence(entropy=self.seed, spawn_key=(t,))
        )
        perm = rng.permutation(self.n)
        W = np.eye(self.n) * 0.5
        # pair consecutive entries of the random order
        for a, b in zip(perm[0::2], perm[1::2]):
            W[a, b] = W[b, a] = 0.5
        # odd node count: the unpaired node keeps weight 1 on itself
        if self.n % 2 == 1:
            W[perm[-1], perm[-1]] = 1.0
        return W


@dataclasses.dataclass
class AtomCycling:
    """Cycle through a learned topology's Birkhoff atoms, one per step.

    Step t applies ``(1 - g) I + g P_{atoms[t mod L]}`` where ``g`` is the
    atom's renormalized weight -- per-step cost of a single ppermute.
    """

    result: STLFWResult

    def __post_init__(self) -> None:
        n = self.result.W.shape[0]
        identity = np.arange(n)
        self._atoms = [
            (float(c), perm)
            for c, perm in self.result.active_atoms()
            if not np.array_equal(perm, identity)
        ]
        if not self._atoms:
            self._atoms = [(0.0, identity)]
        total = sum(c for c, _ in self._atoms)
        self._gammas = [min(0.5, c / total) if total > 0 else 0.0 for c, _ in self._atoms]

    def matrix(self, t: int) -> np.ndarray:
        n = self.result.W.shape[0]
        gamma, perm = self._atoms[t % len(self._atoms)][0], self._atoms[t % len(self._atoms)][1]
        g = self._gammas[t % len(self._atoms)]
        W = np.eye(n) * (1.0 - g)
        W[np.arange(n), perm] += g
        return W


class OnlineSchedule:
    """Time-varying schedule whose underlying W refreshes online.

    Bridges the refresh controller to the per-step schedules above: a
    ``factory`` maps a refresh payload (an ``STLFWResult``, a dense W,
    whatever the factory expects) to an inner schedule exposing
    ``matrix(t)``; each topology refresh appends a segment via
    :meth:`push`. ``matrix(t)`` delegates to the segment active at
    ``t`` with *segment-local* time, so phase-dependent inners
    (``AtomCycling``'s ``t mod L``, ``PeriodicGossip``'s ``t mod k``)
    restart cleanly at each refresh boundary instead of inheriting an
    arbitrary phase from the previous topology's clock.

    Example::

        online = OnlineSchedule(AtomCycling, initial=result0)
        ...                       # refresh fires at step 120:
        online.push(120, result1)
        W_t = online.matrix(t)    # pre-120 cycles result0's atoms,
                                  # post-120 cycles result1's

    Every emitted matrix is one of the inner schedules' matrices --
    doubly stochastic whenever the inners are (asserted across refresh
    boundaries in tests/test_dynamic_and_compression.py).
    """

    def __init__(self, factory: Callable[[Any], Any], initial: Any):
        self._factory = factory
        self._segments: list[tuple[int, Any]] = [(0, factory(initial))]

    @property
    def n_segments(self) -> int:
        return len(self._segments)

    def push(self, t: int, payload: Any) -> None:
        """Refresh at step ``t``: steps >= t use a schedule built on payload."""
        t = int(t)
        if t <= self._segments[-1][0]:
            raise ValueError(
                f"refresh at t={t} is not after the last boundary "
                f"t={self._segments[-1][0]}"
            )
        self._segments.append((t, self._factory(payload)))

    def segment_at(self, t: int) -> tuple[int, Any]:
        """(start_step, inner_schedule) of the segment covering step t."""
        if t < 0:
            raise ValueError("t must be >= 0")
        active = self._segments[0]
        for seg in self._segments[1:]:
            if seg[0] <= t:
                active = seg
            else:
                break
        return active

    def matrix(self, t: int) -> np.ndarray:
        start, inner = self.segment_at(t)
        return inner.matrix(t - start)


def composite_matrix(schedule, steps: int) -> np.ndarray:
    """Product W^(k-1) ... W^(0) -- the effective k-step mixing matrix."""
    W = schedule.matrix(0)
    for t in range(1, steps):
        W = schedule.matrix(t) @ W
    return W
