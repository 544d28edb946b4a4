"""Streaming heterogeneity estimation: Pi_hat from minibatch labels.

The paper learns W once, from the exact label-proportion matrix Pi,
before training starts (Section 5). Online topology adaptation needs the
same quantity *during* training, from the only signal a node actually
observes: the labels of its minibatches. Two pieces live here:

* ``StreamingPiEstimator`` -- an exponentially-weighted estimator of Pi.
  Each update folds one step's per-node batch label proportions into
  ``Pi_hat_i <- (1 - beta) Pi_hat_i + beta p_batch_i``, so every row
  stays on the probability simplex by construction and the estimate is
  unbiased under stationarity (``E[p_batch_i] = Pi_i``). ``beta`` sets
  the memory/variance trade-off: the effective window is ``~2/beta``
  batches, and under an abrupt drift the estimate converges to the new
  Pi geometrically at rate ``(1 - beta)`` per step.
* ``DriftDetector`` -- a relative trigger on a scalar heterogeneity
  proxy (the refresh controller feeds it ``tau_bar_label_skew`` of the
  *current* W evaluated at Pi_hat -- Proposition 2's closed form, i.e.
  exactly the criterion the paper optimizes). The detector keeps an
  exponentially-weighted baseline of the proxy; a drift fires when the
  observed value exceeds ``threshold x baseline + abs_slack``. The
  threshold is configurable; the false-positive rate on stationary
  streams is pinned by tests under a fixed seed
  (tests/test_online.py).

Everything here is host-side numpy: label streams are exogenous to the
compiled training step, so estimation adds zero work to the hot path.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["StreamingPiEstimator", "DriftDetector", "mask_absent"]


def mask_absent(labels: np.ndarray, absent: np.ndarray) -> np.ndarray:
    """Mark whole node rows of a label batch absent (all entries -> -1).

    The one blessed way to hide a node from the streaming estimator for
    a step -- churn drivers and the quarantine controller both use it,
    so "absent" means exactly one thing: the row is held (no decay),
    ``absent_streak`` counts, and ``rejoin_beta`` snaps on return.
    Returns a copy when any row is masked; the original array otherwise.
    """
    labels = np.asarray(labels)
    if labels.ndim == 1:
        labels = labels[:, None]
    absent = np.asarray(absent, bool)
    if absent.shape != (labels.shape[0],):
        raise ValueError(
            f"absent mask must be ({labels.shape[0]},), got {absent.shape}"
        )
    if not absent.any():
        return labels
    out = labels.copy()
    out[absent] = -1
    return out


class StreamingPiEstimator:
    """Exponentially-weighted streaming estimate of the (n, K) Pi matrix.

    Args:
      n_nodes: number of nodes (rows of Pi).
      num_classes: number of classes K (fixed across drift -- pass the
        task's class count, not the max label seen so far, or the
        estimate changes shape mid-run).
      beta: EW step size in (0, 1]; effective window ~2/beta batches.
      init: optional (n, K) initial estimate (e.g. the Pi the initial
        topology was learned from). Defaults to the uniform matrix.
      rejoin_beta: optional boosted step size in (0, 1] applied to a
        node's FIRST update after one or more fully-absent steps. A
        node dark for a whole outage window holds a stale row (held,
        not decayed -- see below); on rejoin the stale row is exactly
        the thing to forget fast, so ``rejoin_beta`` (typically >>
        ``beta``, e.g. 0.5) snaps it toward the fresh batch instead of
        blending at the slow stationary rate. ``None`` (default) keeps
        the single-rate behavior bitwise.

    Labels < 0 are treated as "absent" (node churn: a node that is
    offline this step contributes no observations and its row keeps its
    previous value, decaying toward nothing new rather than toward
    garbage). ``absent_streak[i]`` counts consecutive fully-absent
    updates for node ``i`` (reset on the first present batch).
    """

    def __init__(
        self,
        n_nodes: int,
        num_classes: int,
        beta: float = 0.1,
        init: np.ndarray | None = None,
        rejoin_beta: float | None = None,
    ):
        if not 0.0 < beta <= 1.0:
            raise ValueError(f"beta must be in (0, 1], got {beta}")
        if rejoin_beta is not None and not 0.0 < rejoin_beta <= 1.0:
            raise ValueError(f"rejoin_beta must be in (0, 1], got {rejoin_beta}")
        if n_nodes < 1 or num_classes < 1:
            raise ValueError("need n_nodes >= 1 and num_classes >= 1")
        self.n_nodes = int(n_nodes)
        self.num_classes = int(num_classes)
        self.beta = float(beta)
        if init is None:
            pi = np.full((n_nodes, num_classes), 1.0 / num_classes)
        else:
            pi = np.asarray(init, dtype=np.float64).copy()
            if pi.shape != (n_nodes, num_classes):
                raise ValueError(
                    f"init must be ({n_nodes}, {num_classes}), got {pi.shape}"
                )
            if not np.allclose(pi.sum(axis=1), 1.0, atol=1e-6):
                raise ValueError("rows of init must sum to 1")
        self._pi = pi
        self.rejoin_beta = None if rejoin_beta is None else float(rejoin_beta)
        self._absent_streak = np.zeros(self.n_nodes, dtype=np.int64)
        self.n_updates = 0

    @property
    def Pi_hat(self) -> np.ndarray:
        """Current estimate (copy; rows sum to 1)."""
        return self._pi.copy()

    @property
    def absent_streak(self) -> np.ndarray:
        """Consecutive fully-absent updates per node (copy)."""
        return self._absent_streak.copy()

    def update(self, labels: np.ndarray) -> np.ndarray:
        """Fold one step's labels in; returns the updated Pi_hat (copy).

        Args:
          labels: (n_nodes, batch) integer labels in [0, K); entries < 0
            mark absent observations (that node's row is left untouched
            when its whole batch is absent, and renormalized over the
            present entries otherwise).
        """
        labels = np.asarray(labels)
        if labels.ndim == 1:
            labels = labels[:, None]
        if labels.shape[0] != self.n_nodes:
            raise ValueError(
                f"labels must be ({self.n_nodes}, batch), got {labels.shape}"
            )
        if labels.size and labels.max() >= self.num_classes:
            raise ValueError(
                f"label {int(labels.max())} out of range for K={self.num_classes}"
            )
        counts = np.zeros((self.n_nodes, self.num_classes))
        present = labels >= 0
        node_idx = np.broadcast_to(
            np.arange(self.n_nodes)[:, None], labels.shape
        )[present]
        np.add.at(counts, (node_idx, labels[present]), 1.0)
        totals = counts.sum(axis=1)
        active = totals > 0
        if np.any(active):
            p_batch = counts[active] / totals[active, None]
            if self.rejoin_beta is not None and np.any(
                self._absent_streak[active] > 0
            ):
                # a rejoining node's row is stale by absent_streak
                # steps: snap it toward the fresh batch at rejoin_beta
                beta = np.where(
                    self._absent_streak[active] > 0, self.rejoin_beta, self.beta
                )[:, None]
            else:
                beta = self.beta  # scalar fast path, bitwise-stable
            self._pi[active] = (1.0 - beta) * self._pi[active] + beta * p_batch
        self._absent_streak[active] = 0
        self._absent_streak[~active] += 1
        self.n_updates += 1
        return self.Pi_hat


@dataclasses.dataclass
class DriftDetector:
    """Relative trigger on a scalar heterogeneity proxy.

    The controller evaluates ``proxy_t`` (by default Proposition 2's
    ``tau_bar_label_skew`` of the current W at Pi_hat) once per segment
    and calls :meth:`update`. The detector maintains an EW baseline of
    the proxy; a drift fires when

        proxy_t > threshold * baseline + abs_slack

    after ``warmup`` updates have seeded the baseline. ``rebase()``
    resets the baseline after a refresh (the proxy legitimately drops
    once W is re-learned -- carrying the stale baseline over would make
    the *next* trigger threshold nonsense).

    Attributes:
      threshold: relative trigger factor (> 1; 1.5 means "fire when the
        neighborhood-heterogeneity proxy worsens by 50%").
      abs_slack: additive slack so near-zero baselines (a topology that
        nails Pi exactly) don't turn fp noise into triggers.
      baseline_beta: EW rate of the baseline tracker.
      warmup: updates required before triggering is allowed (both after
        construction and after each ``rebase``).
    """

    threshold: float = 1.5
    abs_slack: float = 1e-8
    baseline_beta: float = 0.2
    warmup: int = 3

    def __post_init__(self) -> None:
        if self.threshold <= 1.0:
            raise ValueError("threshold must be > 1 (relative trigger)")
        self._baseline: float | None = None
        self._seen = 0
        self.n_triggers = 0

    @property
    def baseline(self) -> float | None:
        return self._baseline

    def update(self, value: float) -> bool:
        """Fold one proxy observation in; True iff a drift fired."""
        value = float(value)
        self._seen += 1
        if self._baseline is None:
            self._baseline = value
            return False
        if self._seen > self.warmup and value > (
            self.threshold * self._baseline + self.abs_slack
        ):
            self.n_triggers += 1
            return True
        b = self.baseline_beta
        self._baseline = (1.0 - b) * self._baseline + b * value
        return False

    def rebase(self, value: float | None = None) -> None:
        """Reset the baseline after a topology refresh."""
        self._baseline = None if value is None else float(value)
        self._seen = 0
