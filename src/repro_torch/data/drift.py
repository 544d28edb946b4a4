"""Synthetic drift scenarios: reproducible workloads for online adaptation.

Each scenario is a time-indexed label-distribution process: ``Pi(t)``
returns the true (n, K) per-node class proportions at step ``t`` and
``sample_labels(t, batch, rng)`` draws the (n, batch) minibatch labels a
node would observe -- the exact signal ``repro.online.streaming``
consumes. Three drift shapes cover the deployment stories the online
subsystem exists for:

* ``AbruptLabelSwap``       -- at ``t_drift`` the nodes' distributions are
  permuted (the classic "two shards trade places" shift). The optimal
  topology changes discontinuously; this is the headline benchmark
  scenario (BENCH_online.json).
* ``GradualDirichlet``      -- row-wise linear interpolation from ``Pi0``
  to ``Pi1`` over ``[t_start, t_end]`` (rows stay on the simplex, so
  every intermediate matrix is a valid Pi). Models slow data-collection
  shift; exercises the detector's baseline tracking.
* ``NodeChurn``             -- point events where a node's distribution is
  replaced by a fresh Dirichlet draw (a "new participant" taking over
  the slot) and optional offline windows during which the node emits no
  observations (labels = -1, which the streaming estimator masks).

Two feature-space drift shapes complete the taxonomy (both carry a
Gaussian class-conditional feature model, so they emit (features,
labels) pairs via ``sample``):

* ``FeatureDrift``          -- covariate shift: at ``t_drift`` every node's
  feature distribution gains a seeded node-specific mean offset while
  the label marginals never move (``Pi(t) = Pi0`` for all t). The
  label-space detector is provably blind to it; monitoring must watch a
  feature statistic.
* ``ConceptShift``          -- ``P(y | x)`` changes: at ``t_drift`` the
  labels are re-mapped by a seeded class permutation while the feature
  process is untouched. The label marginals permute with it, so the
  streaming-Pi detector CAN see this one.

``labels_stream`` materializes any scenario into a (steps, n, batch)
array for presampled rollouts (``features_stream`` is the
feature-bearing twin), and ``partition_from_pi`` resamples a dataset
partition matching a target Pi -- the bridge from a drifted
distribution back to ``run_classification``'s per-node index lists.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = [
    "AbruptLabelSwap",
    "GradualDirichlet",
    "NodeChurn",
    "FeatureDrift",
    "ConceptShift",
    "labels_stream",
    "features_stream",
    "partition_from_pi",
]


def _check_pi(Pi: np.ndarray, name: str = "Pi") -> np.ndarray:
    Pi = np.asarray(Pi, dtype=np.float64)
    if Pi.ndim != 2:
        raise ValueError(f"{name} must be (n, K)")
    if not np.allclose(Pi.sum(axis=1), 1.0, atol=1e-6):
        raise ValueError(f"rows of {name} must sum to 1")
    return Pi


def _sample_rows(Pi_t: np.ndarray, batch: int, rng: np.random.Generator) -> np.ndarray:
    """Vectorized per-row categorical sampling: (n, K) -> (n, batch) int32.

    Inverse-CDF against one uniform draw per (node, sample) -- one
    ``searchsorted`` per node row, no python-level class loops.
    """
    n, K = Pi_t.shape
    cdf = np.cumsum(Pi_t, axis=1)
    cdf[:, -1] = 1.0  # guard fp undershoot so u < cdf[-1] always
    u = rng.random((n, batch))
    out = np.empty((n, batch), np.int32)
    for i in range(n):
        out[i] = np.searchsorted(cdf[i], u[i], side="right")
    return np.minimum(out, K - 1).astype(np.int32)


@dataclasses.dataclass
class AbruptLabelSwap:
    """``Pi(t) = Pi0`` for ``t < t_drift``, else ``Pi0[node_perm]``.

    ``node_perm=None`` defaults to the half-rotation (node ``i`` takes
    node ``(i + n//2) % n``'s distribution), which changes every node's
    distribution. Caveat: on *structured* Pi the rotation can be a
    symmetry of the topology-learning problem -- e.g. cyclic one-hot
    rows (``class(i) = i mod K``) rotate onto an equally-well-mixed
    assignment, so a W learned pre-drift is exactly as good post-drift
    and the heterogeneity criterion (correctly) never fires. Pass an
    explicit random permutation to guarantee a criterion-visible drift.
    """

    Pi0: np.ndarray
    t_drift: int
    node_perm: np.ndarray | None = None

    def __post_init__(self) -> None:
        self.Pi0 = _check_pi(self.Pi0, "Pi0")
        n = self.Pi0.shape[0]
        if self.node_perm is None:
            self.node_perm = (np.arange(n) + n // 2) % n
        self.node_perm = np.asarray(self.node_perm)
        if not np.array_equal(np.sort(self.node_perm), np.arange(n)):
            raise ValueError("node_perm must be a permutation of the nodes")

    @property
    def n_nodes(self) -> int:
        return self.Pi0.shape[0]

    @property
    def num_classes(self) -> int:
        return self.Pi0.shape[1]

    def Pi(self, t: int) -> np.ndarray:
        return self.Pi0 if t < self.t_drift else self.Pi0[self.node_perm]

    def sample_labels(self, t: int, batch: int, rng: np.random.Generator) -> np.ndarray:
        return _sample_rows(self.Pi(t), batch, rng)


@dataclasses.dataclass
class GradualDirichlet:
    """Row-wise linear interpolation ``Pi0 -> Pi1`` over ``[t_start, t_end]``.

    ``Pi1=None`` draws it as Dirichlet(alpha) label skew (a fresh
    independent skew pattern), seeded for reproducibility.
    """

    Pi0: np.ndarray
    t_start: int
    t_end: int
    Pi1: np.ndarray | None = None
    alpha: float = 0.5
    seed: int = 0

    def __post_init__(self) -> None:
        self.Pi0 = _check_pi(self.Pi0, "Pi0")
        if self.t_end <= self.t_start:
            raise ValueError("need t_end > t_start")
        if self.Pi1 is None:
            rng = np.random.default_rng(self.seed)
            self.Pi1 = rng.dirichlet(
                self.alpha * np.ones(self.Pi0.shape[1]), size=self.Pi0.shape[0]
            )
        self.Pi1 = _check_pi(self.Pi1, "Pi1")
        if self.Pi1.shape != self.Pi0.shape:
            raise ValueError("Pi1 must match Pi0's shape")

    @property
    def n_nodes(self) -> int:
        return self.Pi0.shape[0]

    @property
    def num_classes(self) -> int:
        return self.Pi0.shape[1]

    def Pi(self, t: int) -> np.ndarray:
        if t <= self.t_start:
            return self.Pi0
        if t >= self.t_end:
            return self.Pi1
        w = (t - self.t_start) / (self.t_end - self.t_start)
        return (1.0 - w) * self.Pi0 + w * self.Pi1

    def sample_labels(self, t: int, batch: int, rng: np.random.Generator) -> np.ndarray:
        return _sample_rows(self.Pi(t), batch, rng)


@dataclasses.dataclass(frozen=True)
class _ChurnEvent:
    t: int
    node: int
    offline_until: int  # labels masked (-1) for t in [t, offline_until)


@dataclasses.dataclass
class NodeChurn:
    """Node-replacement drift: at each event a node leaves and a new one
    (fresh Dirichlet(alpha) label distribution) joins its slot.

    Args:
      Pi0: initial proportions.
      events: ``(t, node)`` or ``(t, node, offline_steps)`` tuples. The
        node's distribution changes to a fresh draw at step ``t``; with
        ``offline_steps > 0`` the slot first goes dark (labels -1) for
        that many steps before the new node starts emitting.
      alpha: Dirichlet concentration of the replacement distributions.
      seed: draw seed (one independent draw per event).
    """

    Pi0: np.ndarray
    events: tuple
    alpha: float = 0.5
    seed: int = 0

    def __post_init__(self) -> None:
        self.Pi0 = _check_pi(self.Pi0, "Pi0")
        n, K = self.Pi0.shape
        rng = np.random.default_rng(self.seed)
        parsed = []
        for ev in self.events:
            if len(ev) == 2:
                t, node, offline = int(ev[0]), int(ev[1]), 0
            else:
                t, node, offline = int(ev[0]), int(ev[1]), int(ev[2])
            if not 0 <= node < n:
                raise ValueError(f"event node {node} out of range")
            parsed.append(
                (_ChurnEvent(t=t, node=node, offline_until=t + offline),
                 rng.dirichlet(self.alpha * np.ones(K)))
            )
        self._events = sorted(parsed, key=lambda pair: pair[0].t)

    @property
    def n_nodes(self) -> int:
        return self.Pi0.shape[0]

    @property
    def num_classes(self) -> int:
        return self.Pi0.shape[1]

    def Pi(self, t: int) -> np.ndarray:
        Pi_t = self.Pi0.copy()
        for ev, row in self._events:
            if ev.t <= t:
                Pi_t[ev.node] = row
        return Pi_t

    def offline_nodes(self, t: int) -> np.ndarray:
        """Indices of nodes emitting no observations at step t."""
        off = [ev.node for ev, _ in self._events if ev.t <= t < ev.offline_until]
        return np.asarray(sorted(set(off)), dtype=np.int64)

    def offline_windows(self) -> tuple:
        """All dark windows as ``(node, t_start, t_end)`` tuples,
        labels masked for ``t_start <= t < t_end`` (empty windows from
        ``offline_steps == 0`` events are omitted). This is the bridge
        into ``repro.faults.FaultPlan.from_node_churn``: a churn
        scenario's outages double as crash windows for the mixing
        layer."""
        return tuple(
            (ev.node, ev.t, ev.offline_until)
            for ev, _ in self._events
            if ev.offline_until > ev.t
        )

    def sample_labels(self, t: int, batch: int, rng: np.random.Generator) -> np.ndarray:
        labels = _sample_rows(self.Pi(t), batch, rng)
        off = self.offline_nodes(t)
        if off.size:
            labels[off] = -1
        return labels


@dataclasses.dataclass
class FeatureDrift:
    """Covariate shift: node-specific Gaussian feature-mean offsets
    switch on at ``t_drift``; the label process never moves.

    Features are drawn from a shared class-conditional Gaussian model
    (seeded class means at pairwise distance ~``class_sep``, isotropic
    ``noise``); from ``t_drift`` on, node ``i``'s features are all
    shifted by a seeded unit direction scaled to ``shift``. Because
    ``Pi(t) = Pi0`` for every t, a detector watching label proportions
    (``StreamingPiEstimator`` + heterogeneity proxy) sees NOTHING --
    the scenario exists to exercise feature-statistic monitoring
    (e.g. feed ``DriftDetector`` the per-step deviation of the batch
    feature mean from a pre-drift baseline) and mean-re-estimation
    recovery.
    """

    Pi0: np.ndarray
    t_drift: int
    dim: int = 8
    class_sep: float = 4.0
    shift: float = 3.0
    noise: float = 1.0
    seed: int = 0

    def __post_init__(self) -> None:
        self.Pi0 = _check_pi(self.Pi0, "Pi0")
        if self.dim < 1:
            raise ValueError(f"dim must be >= 1, got {self.dim}")
        if self.shift < 0 or self.noise < 0:
            raise ValueError("shift and noise must be non-negative")
        n, K = self.Pi0.shape
        rng = np.random.default_rng(self.seed)
        self._class_means = self.class_sep * rng.normal(size=(K, self.dim))
        direc = rng.normal(size=(n, self.dim))
        direc /= np.linalg.norm(direc, axis=1, keepdims=True)
        self._node_shift = self.shift * direc

    @property
    def n_nodes(self) -> int:
        return self.Pi0.shape[0]

    @property
    def num_classes(self) -> int:
        return self.Pi0.shape[1]

    def Pi(self, t: int) -> np.ndarray:
        return self.Pi0  # label marginals are drift-invariant by design

    def feature_shift(self, t: int) -> np.ndarray:
        """The (n, dim) mean offset in effect at step t (the oracle the
        detector smoke test checks its statistic against)."""
        if t < self.t_drift:
            return np.zeros_like(self._node_shift)
        return self._node_shift

    def sample_labels(self, t: int, batch: int, rng: np.random.Generator) -> np.ndarray:
        return _sample_rows(self.Pi0, batch, rng)

    def sample(
        self, t: int, batch: int, rng: np.random.Generator
    ) -> tuple[np.ndarray, np.ndarray]:
        """One step's observations: ``(X (n, batch, dim) f32, y (n, batch))``."""
        y = self.sample_labels(t, batch, rng)
        X = self._class_means[y] + self.noise * rng.normal(
            size=(self.n_nodes, batch, self.dim)
        )
        X = X + self.feature_shift(t)[:, None, :]
        return X.astype(np.float32), y


@dataclasses.dataclass
class ConceptShift:
    """``P(y | x)`` drift: from ``t_drift`` on, labels are re-mapped by a
    seeded class permutation while the feature process is untouched.

    The latent class (which drives the features through the same
    Gaussian model as :class:`FeatureDrift`) is always drawn from
    ``Pi0``; the EMITTED label is ``class_perm[latent]`` once the drift
    hits. The label marginals permute accordingly --
    ``Pi(t)[:, class_perm[k]] = Pi0[:, k]`` -- so the streaming-Pi
    detector CAN see this drift (unlike pure covariate shift), and a
    model trained pre-drift misclassifies exactly the moved classes
    until it adapts.

    ``class_perm=None`` draws a seeded derangement-ish permutation
    (re-drawn until it is not the identity; requires ``K >= 2``).
    """

    Pi0: np.ndarray
    t_drift: int
    class_perm: np.ndarray | None = None
    dim: int = 8
    class_sep: float = 4.0
    noise: float = 1.0
    seed: int = 0

    def __post_init__(self) -> None:
        self.Pi0 = _check_pi(self.Pi0, "Pi0")
        n, K = self.Pi0.shape
        rng = np.random.default_rng(self.seed)
        if self.class_perm is None:
            if K < 2:
                raise ValueError("a default class_perm needs K >= 2")
            perm = np.arange(K)
            while np.array_equal(perm, np.arange(K)):
                perm = rng.permutation(K)
            self.class_perm = perm
        self.class_perm = np.asarray(self.class_perm)
        if not np.array_equal(np.sort(self.class_perm), np.arange(K)):
            raise ValueError("class_perm must be a permutation of the classes")
        self._class_means = self.class_sep * rng.normal(size=(K, self.dim))

    @property
    def n_nodes(self) -> int:
        return self.Pi0.shape[0]

    @property
    def num_classes(self) -> int:
        return self.Pi0.shape[1]

    def Pi(self, t: int) -> np.ndarray:
        if t < self.t_drift:
            return self.Pi0
        # emitted label c had latent class argsort(perm)[c]
        return self.Pi0[:, np.argsort(self.class_perm)]

    def sample_labels(self, t: int, batch: int, rng: np.random.Generator) -> np.ndarray:
        latent = _sample_rows(self.Pi0, batch, rng)
        if t < self.t_drift:
            return latent
        return self.class_perm[latent].astype(np.int32)

    def sample(
        self, t: int, batch: int, rng: np.random.Generator
    ) -> tuple[np.ndarray, np.ndarray]:
        """One step's observations: features keyed by the LATENT class,
        labels by the (possibly permuted) emitted class."""
        latent = _sample_rows(self.Pi0, batch, rng)
        X = self._class_means[latent] + self.noise * rng.normal(
            size=(self.n_nodes, batch, self.dim)
        )
        y = (
            latent
            if t < self.t_drift
            else self.class_perm[latent].astype(np.int32)
        )
        return X.astype(np.float32), y


def labels_stream(
    scenario, steps: int, batch: int, seed: int = 0
) -> np.ndarray:
    """Materialize a scenario's label stream: (steps, n, batch) int32.

    One rng drives the whole stream, so the same (scenario, steps,
    batch, seed) is bit-reproducible -- the property every drift
    benchmark and test here relies on.
    """
    rng = np.random.default_rng(seed)
    return np.stack(
        [scenario.sample_labels(t, batch, rng) for t in range(steps)]
    ) if steps else np.zeros((0, scenario.n_nodes, batch), np.int32)


def features_stream(
    scenario, steps: int, batch: int, seed: int = 0
) -> tuple[np.ndarray, np.ndarray]:
    """Feature-bearing twin of :func:`labels_stream` for scenarios with a
    ``sample(t, batch, rng)`` method (:class:`FeatureDrift`,
    :class:`ConceptShift`): returns ``(X (steps, n, batch, dim) f32,
    y (steps, n, batch) int32)``, one rng for the whole stream so the
    same arguments are bit-reproducible.
    """
    rng = np.random.default_rng(seed)
    if not steps:
        return (
            np.zeros((0, scenario.n_nodes, batch, scenario.dim), np.float32),
            np.zeros((0, scenario.n_nodes, batch), np.int32),
        )
    pairs = [scenario.sample(t, batch, rng) for t in range(steps)]
    return (
        np.stack([X for X, _ in pairs]),
        np.stack([y for _, y in pairs]),
    )


def partition_from_pi(
    labels: np.ndarray,
    Pi: np.ndarray,
    samples_per_node: int,
    seed: int = 0,
) -> list[np.ndarray]:
    """Resample a per-node index partition matching a target Pi.

    Draws ``samples_per_node`` indices per node (with replacement, from
    the per-class index pools of ``labels``) so node ``i``'s empirical
    class counts follow ``Pi[i]``. Classes with zero pool mass are
    renormalized away from that node's row; a node whose entire row
    lands on empty pools gets an empty index list (the trainers' padded
    stacking and ``proportions_from_labels`` both handle that). This is
    the bridge from a drifted Pi(t) back to ``run_classification``'s
    data format.
    """
    labels = np.asarray(labels)
    Pi = _check_pi(Pi)
    n, K = Pi.shape
    rng = np.random.default_rng(seed)
    pools = [np.nonzero(labels == k)[0] for k in range(K)]
    have = np.asarray([len(p) > 0 for p in pools])
    indices_per_node: list[np.ndarray] = []
    for i in range(n):
        row = np.where(have, Pi[i], 0.0)
        total = row.sum()
        if total <= 0.0:
            indices_per_node.append(np.array([], dtype=np.int64))
            continue
        counts = rng.multinomial(samples_per_node, row / total)
        idx = [rng.choice(pools[k], size=c) for k, c in enumerate(counts) if c > 0]
        indices_per_node.append(np.sort(np.concatenate(idx)) if idx else np.array([], dtype=np.int64))
    return indices_per_node
