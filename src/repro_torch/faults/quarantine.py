"""Receiver-side corruption screening, quarantine, and re-admission.

The fault layer's answer to nodes that LIE (wire corruption) rather
than disappear. Three pieces, split across the trace boundary so the
compiled rollout never retraces:

* In-graph (``repro.core.mixing.mix_schedule_arrays_screened``): the
  hard non-finite guard plus cheap per-edge reductions
  (:class:`~repro.core.mixing.ScreenStats`) riding the scan as outputs.
* Host-side (:class:`ScreenPolicy`): norm and deviation screens
  thresholded from the run's OWN live heterogeneity probes. This is the
  paper-aware part -- under label skew a legitimately heterogeneous
  neighbor is statistically indistinguishable from a corrupted one to a
  fixed-threshold distance screen, so the allowance must be derived
  from the measured consensus spread and gradient deviation, not from a
  constant.
* :class:`QuarantineController`: streak-confirmed quarantine, cooldown,
  probation re-admission, and the plumbing into the rest of the stack
  (``FaultInjector.set_quarantine`` for the doubly-stochastic repair,
  ``StreamingPiEstimator`` absence masking, an inner
  ``OnlineTopologyController`` chained through ``on_segment``).

Zero false quarantines, by construction
---------------------------------------
Honest same-step payloads obey the triangle inequality against the
fleet mean: with ``C = max_i ||p_i - p_bar||^2`` (the consensus probe),

    ||p_j - p_i|| <= ||p_j - p_bar|| + ||p_bar - p_i|| <= 2 sqrt(C).

Both screens test statistics bounded by ``||p_j - p_i||`` (the norm
screen by the reverse triangle inequality), so any allowance
``dev_allow >= 2 sqrt(C)`` can never flag an honest same-step edge --
whatever the label skew, because C is measured on the actual run.
``slack >= 1`` times the bound plus an absolute floor keeps the
guarantee with margin; under bounded delay ``tau_max > 0`` the payload
may be ``tau`` steps old, and the bound gains a window-max over the
trailing ``tau_max + 1`` probes plus a mean-drift term
``lr (tau_max + 2) (sqrt(max ||g_bar||^2) + sqrt(max_i ||g_i -
g_bar||^2))`` covering how far the fleet mean can travel while the
payload was in flight. The false-quarantine rate across every
``data/drift.py`` scenario is pinned at 0 in tests and the CI smoke.
"""

from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np

from repro_torch.core.mixing import ScreenStats
from repro_torch.online.streaming import mask_absent

__all__ = ["ScreenPolicy", "QuarantineController", "false_quarantines"]


@dataclasses.dataclass(frozen=True)
class ScreenPolicy:
    """Threshold and lifecycle policy for the corruption screen.

    Attributes:
      slack: multiplier on the probe-derived honest-deviation bound
        (>= 1 preserves the zero-false-positive guarantee; the margin
        absorbs f32-vs-f64 probe rounding).
      abs_floor: absolute allowance floor -- keeps near-consensus fleets
        (bound ~ 0) from flagging honest f32 rounding noise.
      confirm_streak: consecutive flagged steps required before a node
        is quarantined (a single-step glitch -- one bad batch, one
        transient -- never quarantines).
      cooldown_steps: steps a quarantined node stays isolated before it
        is offered probation.
      probation_steps: steps a re-admitted node must screen clean
        before it is fully trusted; any flag during probation
        re-quarantines with the cooldown DOUBLED (exponential backoff
        for chronic liars).
      tau_term: optional additive allowance per unit of the controller's
        live ``tau_bar`` proxy (0 disables). ``tau_bar`` rises exactly
        when the topology tolerates more neighborhood heterogeneity, so
        an operator can trade screen sharpness for fewer probation
        round-trips on very skewed fleets.
    """

    slack: float = 1.25
    abs_floor: float = 1e-4
    confirm_streak: int = 2
    cooldown_steps: int = 32
    probation_steps: int = 16
    tau_term: float = 0.0

    def __post_init__(self) -> None:
        if self.slack < 1.0:
            raise ValueError(
                f"slack must be >= 1 (the zero-false-positive bound), "
                f"got {self.slack}"
            )
        if self.abs_floor < 0.0:
            raise ValueError(f"abs_floor must be >= 0, got {self.abs_floor}")
        if self.confirm_streak < 1:
            raise ValueError(
                f"confirm_streak must be >= 1, got {self.confirm_streak}"
            )
        if self.cooldown_steps < 1 or self.probation_steps < 0:
            raise ValueError(
                f"bad cooldown_steps={self.cooldown_steps} / "
                f"probation_steps={self.probation_steps}"
            )
        if self.tau_term < 0.0:
            raise ValueError(f"tau_term must be >= 0, got {self.tau_term}")

    def dev_allow(
        self,
        consensus_sq: float,
        gdev_sq: float,
        gbar_sq: float,
        *,
        lr: float,
        tau_max: int = 0,
        tau_bar: float = 0.0,
    ) -> float:
        """Honest-deviation allowance from (window-max) probe values.

        ``consensus_sq`` is ``max_i ||p_i - p_bar||^2`` over the
        staleness window, ``gdev_sq`` / ``gbar_sq`` the matching
        gradient-deviation and mean-gradient maxima (only consulted
        when ``tau_max > 0``).
        """
        bound = 2.0 * float(np.sqrt(max(consensus_sq, 0.0)))
        if tau_max > 0:
            drift = float(np.sqrt(max(gbar_sq, 0.0))) + float(
                np.sqrt(max(gdev_sq, 0.0))
            )
            bound += lr * (tau_max + 2) * drift
        return self.abs_floor + self.slack * bound + self.tau_term * tau_bar


def _edge_flags(
    stats: ScreenStats,
    gammas: np.ndarray,
    perms: np.ndarray,
    allow: np.ndarray,
) -> tuple[np.ndarray, np.ndarray]:
    """Per-step per-sender (flagged, exposed) bool arrays, both (k, n).

    A sender is *exposed* at a step if at least one active non-self
    edge carries its payload (gamma > 0); it is *flagged* if any such
    edge fails the non-finite, norm, or deviation screen. Receivers
    never vote on their own self-loop (no wire payload there).
    """
    sq_own = np.asarray(stats.sq_own, np.float64)  # (k, n)
    sq_recv = np.asarray(stats.sq_recv, np.float64)  # (k, l, n)
    dot = np.asarray(stats.dot, np.float64)
    finite = np.asarray(stats.finite, bool)
    gam = np.asarray(gammas, np.float64)  # (k, l)
    per = np.asarray(perms, np.int64)  # (k, l, n)
    k, l_max, n = per.shape
    recv_idx = np.arange(n)[None, None, :]
    active = (gam[:, :, None] > 0.0) & (per != recv_idx)  # non-self, live slot
    dev_sq = sq_own[:, None, :] + sq_recv - 2.0 * dot  # ||p_j - p_i||^2
    norm_gap = np.abs(np.sqrt(sq_recv) - np.sqrt(sq_own)[:, None, :])
    a = allow.reshape(k, 1, 1)
    bad = ~finite | (norm_gap > a) | (dev_sq > a * a)
    # edge (t, l, i) blames SENDER per[t, l, i]: scatter-or by sender
    flagged = np.zeros((k, n), dtype=bool)
    exposed = np.zeros((k, n), dtype=bool)
    t_idx = np.broadcast_to(np.arange(k)[:, None, None], per.shape)
    np.logical_or.at(exposed, (t_idx[active], per[active]), True)
    hit = active & bad
    np.logical_or.at(flagged, (t_idx[hit], per[hit]), True)
    return flagged, exposed


class QuarantineController:
    """Streak-confirmed quarantine with probation re-admission.

    The host-side half of the corruption defense. A fault runner calls
    :meth:`ingest` once per segment with the scan's stacked
    :class:`~repro.core.mixing.ScreenStats`, the per-step mixing tables
    it actually used, and the per-step probe scalars; the controller
    updates its per-node lifecycle state machine

        trusted --confirm_streak flags--> quarantined
        quarantined --cooldown--> probation
        probation --clean window--> trusted
        probation --any flag--> quarantined (cooldown doubled)

    and exposes the resulting mask via :meth:`mask` / ``quarantined``.
    All transitions land at segment boundaries -- the scan that already
    ran is immutable -- as pure value changes (the caller folds the
    mask into ``FaultInjector.set_quarantine``), so the rollout never
    retraces.

    ``inner`` (optional) is an ``OnlineTopologyController``:
    :meth:`observe` masks quarantined nodes' label rows to -1 (absent)
    before forwarding, so the streaming Pi estimate holds their rows
    exactly while isolated and ``rejoin_beta`` snaps them on
    re-admission; :meth:`on_segment` delegates, so the stack composes
    as one hook.
    """

    def __init__(
        self,
        n_nodes: int,
        policy: ScreenPolicy | None = None,
        *,
        lr: float,
        tau_max: int = 0,
        inner=None,
    ):
        if n_nodes < 1:
            raise ValueError(f"n_nodes must be >= 1, got {n_nodes}")
        if tau_max < 0:
            raise ValueError(f"tau_max must be >= 0, got {tau_max}")
        self.n_nodes = int(n_nodes)
        self.policy = policy or ScreenPolicy()
        self.lr = float(lr)
        self.tau_max = int(tau_max)
        self.inner = inner
        self.quarantined = np.zeros(self.n_nodes, dtype=bool)
        self.events: list[dict] = []
        self.n_quarantines = 0
        self.n_readmissions = 0
        self._streak = np.zeros(self.n_nodes, dtype=np.int64)
        self._cooldown = np.zeros(self.n_nodes, dtype=np.int64)
        self._probation = np.zeros(self.n_nodes, dtype=np.int64)
        # per-node cooldown length, doubled on each probation failure
        self._cooldown_len = np.full(
            self.n_nodes, self.policy.cooldown_steps, dtype=np.int64
        )
        # trailing probe window for staleness-aware thresholds
        self._probe_win: deque = deque(maxlen=self.tau_max + 1)

    def mask(self) -> np.ndarray:
        """Current quarantine mask (copy) -- True = isolated."""
        return self.quarantined.copy()

    @property
    def trusted(self) -> np.ndarray:
        return ~self.quarantined

    # -- probe plumbing -----------------------------------------------------

    def _allowances(self, probes: dict, k: int, tau_bar: float) -> np.ndarray:
        cons = np.asarray(probes["consensus_sq"], np.float64).reshape(-1)
        gdev = np.asarray(probes["gdev_sq"], np.float64).reshape(-1)
        gbar = np.asarray(probes["gbar_sq"], np.float64).reshape(-1)
        if not (cons.shape == gdev.shape == gbar.shape == (k,)):
            raise ValueError(
                f"probes must be ({k},) each, got {cons.shape}/{gdev.shape}/"
                f"{gbar.shape}"
            )
        allow = np.empty(k)
        for j in range(k):
            self._probe_win.append((cons[j], gdev[j], gbar[j]))
            win = np.asarray(self._probe_win)
            allow[j] = self.policy.dev_allow(
                float(win[:, 0].max()),
                float(win[:, 1].max()),
                float(win[:, 2].max()),
                lr=self.lr,
                tau_max=self.tau_max,
                tau_bar=tau_bar,
            )
        return allow

    # -- lifecycle ----------------------------------------------------------

    def ingest(
        self,
        t0: int,
        stats: ScreenStats,
        gammas: np.ndarray,
        perms: np.ndarray,
        probes: dict,
        tau_bar: float = 0.0,
    ) -> np.ndarray:
        """Fold one segment's screen evidence in; returns the new mask.

        Args:
          t0: global step index of the segment's first step.
          stats: scan-stacked screen stats (leading axis k).
          gammas / perms: the (k, l_max) / (k, l_max, n) mixing tables
            the segment actually ran with (quarantined nodes appear as
            self-loops there, so they gather no votes and cast none).
          probes: dict with per-step (k,) arrays ``consensus_sq``
            (max_i ||p_i - p_bar||^2), ``gdev_sq``
            (max_i ||g_i - g_bar||^2), and ``gbar_sq`` (||g_bar||^2).
          tau_bar: optional live heterogeneity proxy for the policy's
            ``tau_term``.
        """
        k = int(np.asarray(gammas).shape[0])
        allow = self._allowances(probes, k, float(tau_bar))
        flagged, exposed = _edge_flags(stats, gammas, perms, allow)
        p = self.policy
        for j in range(k):
            t = t0 + j
            fl, ex = flagged[j], exposed[j]
            # ticking clocks: isolation and probation age per STEP, not
            # per segment, so lifecycle lengths are segment-size-free
            cooling = self.quarantined & (self._cooldown > 0)
            self._cooldown[cooling] -= 1
            release = self.quarantined & (self._cooldown == 0)
            for i in np.flatnonzero(release):
                self.quarantined[i] = False
                self._probation[i] = p.probation_steps
                self._streak[i] = 0
                self.events.append({
                    "t": int(t), "node": int(i), "event": "probation",
                })
            on_probation = self._probation > 0
            # probation failure: ANY flag re-quarantines, backoff doubled
            relapse = on_probation & fl
            for i in np.flatnonzero(relapse):
                self._cooldown_len[i] *= 2
                self._quarantine(int(t), int(i), reason="probation_flag")
            # probation success: a clean exposed step burns one
            # probation step; survival of the whole window restores
            # full trust (and resets the backoff)
            clean = on_probation & ex & ~fl & ~relapse
            self._probation[clean] -= 1
            for i in np.flatnonzero(clean & (self._probation == 0)):
                self._cooldown_len[i] = p.cooldown_steps
                self.n_readmissions += 1
                self.events.append({
                    "t": int(t), "node": int(i), "event": "readmitted",
                })
                # fleet composition is whole again: ask the topology
                # stack to re-solve with the returning node's (snapped)
                # Pi row instead of waiting for the drift detector
                if self.inner is not None and hasattr(
                    self.inner, "request_refresh"
                ):
                    self.inner.request_refresh(reason="readmitted")
            # trusted nodes: streak-confirmed quarantine
            watch = ~self.quarantined & ~(self._probation > 0)
            self._streak[watch & fl] += 1
            self._streak[watch & ex & ~fl] = 0
            for i in np.flatnonzero(
                watch & (self._streak >= p.confirm_streak)
            ):
                self._quarantine(int(t), int(i), reason="confirmed")
        return self.mask()

    def _quarantine(self, t: int, i: int, reason: str) -> None:
        self.quarantined[i] = True
        self._cooldown[i] = self._cooldown_len[i]
        self._probation[i] = 0
        self._streak[i] = 0
        self.n_quarantines += 1
        self.events.append({
            "t": int(t), "node": int(i), "event": "quarantine",
            "reason": reason, "cooldown": int(self._cooldown_len[i]),
        })
        if self.inner is not None and hasattr(self.inner, "request_refresh"):
            self.inner.request_refresh(reason="quarantine")

    # -- inner-controller chaining ------------------------------------------

    def observe(self, labels: np.ndarray) -> None:
        """Forward one step's labels with quarantined rows masked absent.

        A quarantined node's data is untrusted, so its Pi row must not
        keep updating; marking the whole row < 0 makes the
        ``StreamingPiEstimator`` hold it (and count ``absent_streak``),
        and ``rejoin_beta`` snaps it on the first post-release batch.
        """
        if self.inner is None:
            return
        self.inner.observe(mask_absent(labels, self.quarantined))

    def on_segment(self, t: int):
        """Delegate to the inner topology controller (or no-op)."""
        if self.inner is None:
            return None
        return self.inner.on_segment(t)

    def summary(self) -> dict:
        return {
            "n_quarantines": int(self.n_quarantines),
            "n_readmissions": int(self.n_readmissions),
            "quarantined_now": [int(i) for i in np.flatnonzero(self.quarantined)],
            "events": list(self.events),
        }


def false_quarantines(events: list[dict], plan) -> int:
    """Count quarantine events whose node was honest at confirm time.

    Ground-truth audit against a :class:`~repro.faults.plan.FaultPlan`:
    a quarantine at step ``t`` of node ``i`` is FALSE iff the plan's
    corruption trace shows ``i`` honest over the trailing confirm
    window ``[t - steps_back, t]`` (a node can recover between lying
    and being confirmed -- blaming the screen for reacting to real lies
    that just ended would be unfair, so the window looks back).
    """
    bad = (plan.corrupt_mult != np.float32(1.0)) | (plan.corrupt_xor != 0)
    count = 0
    for ev in events:
        if ev.get("event") != "quarantine":
            continue
        t, i = int(ev["t"]), int(ev["node"])
        lo = max(t - 2 * max(plan.tau_max, 1) - 8, 0)
        hi = min(t + 1, plan.steps)
        if not bad[lo:hi, i].any():
            count += 1
    return count
