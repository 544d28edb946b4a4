"""Mid-training topology refresh: warm STL-FW re-solves + hot-swap plumbing.

The pieces the streaming estimator feeds:

* ``TopologyRefresher`` -- re-runs :func:`repro_torch.core.stl_fw.learn_topology`
  *warm*: Frank-Wolfe restarts from the previous W's Birkhoff atoms
  (``init=``), a single persistent ``LMOSolver`` carries the auction
  backends' dual prices across refreshes, and the solve early-stops at
  the duality-gap level the initial cold solve certified (``stop_gap``).
  A refresh therefore costs a few FW steps, not a cold ``budget``-length
  solve (measured in benchmarks/bench_online.py, BENCH_online.json).
  After each solve the atom set is truncated back to a fixed capacity
  ``l_max`` (largest coefficients kept, renormalized -- still doubly
  stochastic), so the data-plane schedule the trainers consume never
  changes shape.
* ``OnlineTopologyController`` -- the object a training loop talks to.
  It owns the estimator, the drift detector, and the refresher;
  ``observe(labels)`` streams minibatch labels in, and ``on_segment(t)``
  (the hook the drivers in ``repro_torch.train.trainer`` call at segment
  boundaries) evaluates the heterogeneity proxy, consults the detector,
  and -- on a trigger -- refreshes W and returns the new fixed-shape
  :class:`~repro_torch.core.mixing.ScheduleArrays` for a capture-free
  swap.

The port of ``repro.online.refresh``: the same behaviour, with one
addition. The ``ScheduleArrays`` a refresher hands out are tensors on
its ``device`` (None = CUDA). They are made only on the calling thread,
in ``schedule_arrays`` / ``_emit``; a solve -- which overlap mode runs
on a worker thread -- does numpy and scipy only and makes no CUDA call,
so it can run while the trainer captures a CUDA graph.

Layering: this module imports core + data only. The trainers never
import it -- they accept any object with the ``on_segment`` protocol --
so ``repro_torch.train`` stays independent of ``repro_torch.online``.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import time

import numpy as np

import torch

from repro_torch.core.heterogeneity import tau_bar_label_skew
from repro_torch.core.mixing import (
    BirkhoffSchedule,
    PermPool,
    PoolSwap,
    ScheduleArrays,
    schedule_from_result,
    schedule_to_arrays,
    truncate_schedule,
)
from repro_torch.core.stl_fw import LMOSolver, STLFWResult, learn_topology
from repro_torch.device import resolve_device
from repro_torch.obs.trace import Tracer

from .streaming import DriftDetector, StreamingPiEstimator

# instrumented paths take an always-on tracer; callers opt in with a
# real one (the Tracer is thread-safe, so overlap-mode worker solves
# record spans on their own tid against the shared clock origin)
_NULL_TRACER = Tracer(enabled=False)

__all__ = [
    "RefreshConfig",
    "RefreshError",
    "RefreshTimeoutError",
    "TopologyRefresher",
    "OnlineTopologyController",
]


class RefreshError(RuntimeError):
    """A refresh solve failed (after any configured retries).

    ``meta`` carries the refresh metadata at failure time: ``t_submit``,
    ``pending_segments``, ``overlap_wall_s``, ``attempts``, and the
    original exception's ``repr`` under ``error`` -- so a trainer that
    catches this knows exactly which refresh died and how long it ran.
    """

    def __init__(self, message: str, meta: dict | None = None):
        super().__init__(message)
        self.meta = dict(meta or {})


class RefreshTimeoutError(RefreshError):
    """``flush(timeout=)`` expired with the solve still running.

    The solve is NOT cancelled -- it stays pending, and a later
    ``on_segment``/``flush`` can still collect it. ``meta`` records how
    long the solve has been in flight."""


@dataclasses.dataclass
class RefreshConfig:
    """Policy knobs for warm mid-training refreshes.

    Attributes:
      budget: max FW iterations per refresh (the cap that guarantees a
        refresh is cheap even when the drift is total; the gap stop
        usually fires earlier).
      lam: Eq. (8) bias/variance trade-off. ``None`` (default) inherits
        the initial solve's recorded ``lam`` -- the only choice under
        which the gap target compares like with like. Setting it
        explicitly to a different value is allowed but then the
        refresher discards ``gap_ref`` (gaps of different objectives
        are incomparable) and falls back to the relative ``stop_tol``.
      gap_slack: the refresh stops once its FW gap reaches
        ``gap_slack x`` the initial cold solve's final gap (1.0 =
        "certifiably as converged as the cold solve").
      stop_tol: fallback relative gap stop when the warm start has no
        recorded reference gap.
      l_max: fixed atom capacity of the emitted data-plane schedule
        (which is also the per-step gather/communication degree of the
        data-plane transport). ``None`` defaults to the initial
        result's atom count plus one refresh ``budget`` of headroom:
        a single refresh then fits without truncating its new atoms,
        and across repeated refreshes the contraction-decayed old atoms
        are the ones dropped. A tight ``l_max`` (= initial atom count)
        keeps communication minimal at a measurable topology-quality
        cost -- the trade-off is the operator's.
      method: ``learn_topology`` method ("incremental" | "reference").
    """

    budget: int = 16
    lam: float | None = None
    gap_slack: float = 1.0
    stop_tol: float | None = 0.05
    l_max: int | None = None
    method: str = "incremental"


class TopologyRefresher:
    """Warm re-learner with persistent LMO state and fixed atom capacity.

    Args:
      initial: the cold-solved topology training started with (its atoms
        seed the first warm refresh; its final FW gap is the quality
        target every refresh stops at).
      config: refresh policy.
      lmo: LMO backend name, or a pre-built persistent ``LMOSolver``.
        The same solver instance is reused across every refresh, so the
        auction backend's dual prices warm-start each solve; ``"auto"``
        resolves with ``budget=None`` -- the open-ended online rule.
      device: where :meth:`schedule_arrays` puts its tensors (None =
        CUDA; ``"cpu"`` for the plain path).
    """

    def __init__(
        self,
        initial: STLFWResult,
        config: RefreshConfig | None = None,
        lmo: "str | LMOSolver" = "auto",
        tracer: "Tracer | None" = None,
        device: "torch.device | str | None" = None,
    ):
        self.config = config or RefreshConfig()
        self.tracer = tracer
        self.device = resolve_device(device)
        self.solver = lmo if isinstance(lmo, LMOSolver) else LMOSolver(lmo)
        self.solver.resolve(n=initial.W.shape[0], budget=None)
        sched = schedule_from_result(initial)
        # `is None`, not truthiness: an explicit l_max=0 must hit
        # truncate_schedule's validation, not silently become the default
        if self.config.l_max is not None:
            self.l_max = int(self.config.l_max)
        else:
            self.l_max = sched.n_atoms + self.config.budget
        sched = truncate_schedule(sched, self.l_max)
        self._atoms = (list(sched.coeffs), [np.asarray(p) for p in sched.perms])
        self.result = initial
        if self.config.lam is not None:
            self.lam = float(self.config.lam)
        elif initial.lam is not None:
            self.lam = float(initial.lam)
        else:
            self.lam = 0.1  # the paper's default; pre-lam-field results only
        gap_ref = None
        # the gap target is only meaningful against the SAME objective:
        # require a recorded lam that matches (a result without one --
        # hand-built or pre-lam-field -- could have been solved at any
        # lam, so its gap is incomparable and we fall back to stop_tol)
        same_objective = initial.lam is not None and float(initial.lam) == self.lam
        if same_objective and initial.gap_trace is not None and len(initial.gap_trace):
            gap_ref = float(initial.gap_trace[-1])
        self.gap_ref = gap_ref
        self.n_refreshes = 0
        self.last_refresh_s: float | None = None
        self.last_iters: int | None = None

    @property
    def schedule(self) -> BirkhoffSchedule:
        """Current (truncated) static schedule."""
        return BirkhoffSchedule(
            coeffs=tuple(float(c) for c in self._atoms[0]),
            perms=tuple(tuple(int(x) for x in p) for p in self._atoms[1]),
        )

    @property
    def W(self) -> np.ndarray:
        """Current dense W (rebuilt from the truncated atoms)."""
        return self.schedule.to_matrix()

    def schedule_arrays(self) -> ScheduleArrays:
        """Current schedule in the fixed-shape data-plane format, as
        tensors on the refresher's ``device`` (call on the thread that
        drives the device, never from a solve)."""
        return schedule_to_arrays(self.schedule, self.l_max, device=self.device)

    def refresh(self, Pi_hat: np.ndarray) -> STLFWResult:
        """Warm re-solve against the streamed Pi estimate.

        Returns the (un-truncated) STLFWResult; the refresher's own
        schedule/arrays views reflect the ``l_max``-truncated atoms.
        """
        cfg = self.config
        stop_gap = None if self.gap_ref is None else self.gap_ref * cfg.gap_slack
        stop_tol = cfg.stop_tol if stop_gap is None else None
        tr = self.tracer if self.tracer is not None else _NULL_TRACER
        t0 = time.perf_counter()
        with tr.span("refresh.solve", n_refresh=self.n_refreshes):
            res = learn_topology(
                Pi_hat,
                cfg.budget,
                lam=self.lam,
                method=cfg.method,
                lmo=self.solver,
                init=self._atoms,
                stop_tol=stop_tol,
                stop_gap=stop_gap,
            )
        self.last_refresh_s = time.perf_counter() - t0
        self.last_iters = len(res.gamma_trace)
        sched = truncate_schedule(schedule_from_result(res), self.l_max)
        self._atoms = (list(sched.coeffs), [np.asarray(p) for p in sched.perms])
        self.result = res
        self.n_refreshes += 1
        return res


class OnlineTopologyController:
    """Streaming estimation -> drift detection -> warm refresh, as one hook.

    The training drivers call ``on_segment(t)`` at segment boundaries
    (duck-typed -- ``repro_torch.train`` never imports this module). Between
    those calls the label stream is fed in with ``observe`` (labels are
    exogenous to the compiled training step, so this happens host-side
    at zero hot-path cost).

    Args:
      refresher: warm re-learner holding the current topology.
      estimator: streaming Pi estimator (defaults: seeded from the
        refresher's n plus ``num_classes``, uniform init).
      detector: drift detector on the heterogeneity proxy.
      num_classes: K, required when ``estimator`` is not given.
      Pi0: the Pi the initial topology was learned from; seeds the
        default estimator so the proxy does not ramp from the uniform
        init to its stationary value (a ramp the detector would read as
        drift). Ignored when ``estimator`` is given.
      proxy_B / proxy_sigma2: the ``B`` and ``sigma_max^2`` constants of
        Proposition 2's ``tau_bar_label_skew`` proxy. The *relative*
        detector only cares about B up to scale; sigma adds the
        variance term, which does not depend on Pi_hat -- keep it 0 to
        track the drift-sensitive bias part alone.
      pool: a staged :class:`~repro_torch.core.mixing.PermPool` puts the
        controller in POOL COORDINATES: ``on_segment`` returns
        :class:`~repro_torch.core.mixing.PoolSwap` updates instead of
        ``ScheduleArrays``. A refresh whose atoms project onto the pool
        with at most ``pool_miss_tol`` dropped coefficient mass is
        emitted as an in-pool gamma swap (zero retraces for the pool-
        transport trainer); beyond the tolerance the controller
        restages a new pool from the refreshed schedule (counted in
        ``pool_misses``; the trainer pays one recompile). The
        pool-aware truncation this implements trades a bounded amount
        of mixing mass (``dropped_mass``) for staying inside the
        compiled communication plan.
      pool_miss_tol: max coefficient mass the in-pool projection may
        drop before a restage is declared.
      overlap: run each refresh solve in a background worker thread
        instead of inline. The numpy/scipy LMO releases the GIL in
        BLAS, so the solve overlaps the captured rollout (the worker
        makes no CUDA call, so it cannot invalidate a capture): the
        triggering ``on_segment`` SUBMITS and returns ``None`` (the
        rollout launches its next segment immediately); the first
        boundary after the solve finishes collects the result and
        hands the swap back -- a double-buffered handoff in which the
        hook never blocks on the solver (only an explicit
        :meth:`flush` waits). Detector updates are suspended while a
        solve is in flight (the post-collect ``rebase`` re-anchors the
        baseline), and per-refresh timing lands in ``refresh_log``.
      solve_retries: re-run a raising solve up to this many extra times
        (exponential backoff starting at ``retry_backoff_s``) before
        declaring the refresh failed. Retries happen inside the worker
        in overlap mode, so the rollout never sees them.
      retry_backoff_s: initial backoff; doubles per retry.
      solve_timeout_s: in overlap mode, a solve still running this many
        seconds after submit is ABANDONED at the next ``on_segment``:
        the controller falls back to the last-good schedule, counts a
        ``failed_refreshes``, and re-arms the detector. The wedged
        worker thread is detached (``shutdown(wait=False)``) and a
        fresh executor is created lazily -- the thread itself cannot be
        killed, so a truly hung native solve still holds its memory
        until process exit (and, being non-daemon, interpreter exit
        joins it; scripted hang drills must release their hang event).

    A failed or abandoned refresh NEVER raises out of ``on_segment``:
    the rollout keeps mixing with the last-good schedule, the failure
    is recorded (``failed_refreshes``, a ``refresh_log`` entry with an
    ``error`` field, an ``events`` entry), and the detector is
    re-armed so a later segment can trigger again. Only :meth:`flush`
    -- the explicit wait -- re-raises, as :class:`RefreshError` /
    :class:`RefreshTimeoutError` with the metadata attached.
    """

    def __init__(
        self,
        refresher: TopologyRefresher,
        estimator: StreamingPiEstimator | None = None,
        detector: DriftDetector | None = None,
        *,
        num_classes: int | None = None,
        Pi0: np.ndarray | None = None,
        proxy_B: float = 1.0,
        proxy_sigma2: float = 0.0,
        pool: PermPool | None = None,
        pool_miss_tol: float = 0.05,
        overlap: bool = False,
        solve_retries: int = 0,
        retry_backoff_s: float = 0.05,
        solve_timeout_s: float | None = None,
        tracer: "Tracer | None" = None,
    ):
        self.refresher = refresher
        self.tracer = tracer if tracer is not None else _NULL_TRACER
        if tracer is not None:
            # propagate to the (possibly wrapped -- e.g. FlakyRefresher)
            # refresher so its solves record "refresh.solve" spans; walk
            # the _inner proxy chain to the object that actually solves
            target = refresher
            while hasattr(target, "_inner"):
                target = target._inner
            if getattr(target, "tracer", None) is None:
                target.tracer = tracer
        n = refresher.W.shape[0]
        if estimator is None:
            if num_classes is None and Pi0 is None:
                raise ValueError("pass num_classes, Pi0, or a pre-built estimator")
            if num_classes is None:
                num_classes = int(np.asarray(Pi0).shape[1])
            estimator = StreamingPiEstimator(n, num_classes, init=Pi0)
        if estimator.n_nodes != n:
            raise ValueError(
                f"estimator is for {estimator.n_nodes} nodes, topology has {n}"
            )
        if pool is not None and pool.n_nodes != n:
            raise ValueError(f"pool is for {pool.n_nodes} nodes, topology has {n}")
        self.estimator = estimator
        self.detector = detector or DriftDetector()
        self.proxy_B = float(proxy_B)
        self.proxy_sigma2 = float(proxy_sigma2)
        self.pool = pool
        self.pool_miss_tol = float(pool_miss_tol)
        self.pool_misses = 0
        self.overlap = bool(overlap)
        if solve_retries < 0:
            raise ValueError(f"solve_retries must be >= 0, got {solve_retries}")
        self.solve_retries = int(solve_retries)
        self.retry_backoff_s = float(retry_backoff_s)
        self.solve_timeout_s = (
            None if solve_timeout_s is None else float(solve_timeout_s)
        )
        self.failed_refreshes = 0
        self.events: list[dict] = []
        self.refresh_log: list[dict] = []
        self._W = refresher.W
        self._executor: concurrent.futures.ThreadPoolExecutor | None = None
        self._pending: tuple[concurrent.futures.Future, dict] | None = None
        self._manual_request = False
        self._manual_reason: str | None = None
        self._last_attempts = 0

    def observe(self, labels: np.ndarray) -> None:
        """Stream one step's (n, batch) minibatch labels in."""
        self.estimator.update(labels)

    def proxy(self) -> float:
        """Current neighborhood-heterogeneity proxy (Prop. 2 at Pi_hat)."""
        return tau_bar_label_skew(
            self._W, self.estimator.Pi_hat, self.proxy_B, self.proxy_sigma2
        )

    def request_refresh(self, reason: str | None = None) -> None:
        """Force a refresh at the next ``on_segment`` (scripted drills /
        external schedulers, quarantine membership changes), bypassing
        the detector. ``reason`` is recorded on the trigger event, so
        the event log says WHY a refresh happened off-detector."""
        self._manual_request = True
        if reason is not None:
            self._manual_reason = str(reason)

    @property
    def refresh_pending(self) -> bool:
        return self._pending is not None

    def on_segment(self, t: int):
        """Segment-boundary hook.

        Returns ``None`` (no update -- including "solve still running"
        in overlap mode), a :class:`ScheduleArrays` (no pool), or a
        :class:`PoolSwap` (pool coordinates).
        """
        if self._pending is not None:
            fut, meta = self._pending
            if not fut.done():
                wall = time.perf_counter() - meta["wall0"]
                if (
                    self.solve_timeout_s is not None
                    and wall > self.solve_timeout_s
                ):
                    self._abandon(t, wall)
                    return None
                meta["pending_segments"] += 1
                self.events.append({"t": int(t), "pending": True})
                return None
            return self._collect(t, blocked_s=0.0)
        value = self.proxy()
        manual = self._manual_request
        triggered = self.detector.update(value) or manual
        self._manual_request = False
        reason, self._manual_reason = self._manual_reason, None
        event = {"t": int(t), "proxy": float(value), "triggered": bool(triggered)}
        if manual and reason is not None:
            event["reason"] = reason
        if not triggered:
            self.events.append(event)
            return None
        # the worker must see a frozen Pi: observe() keeps mutating the
        # estimator while the solve runs (double-buffered handoff)
        snapshot = np.array(self.estimator.Pi_hat)
        if self.overlap:
            self.tracer.instant("refresh.submit", t=int(t), proxy=float(value))
            fut = self._ensure_executor().submit(self._solve, snapshot)
            self._pending = (
                fut,
                {"t_submit": int(t), "pending_segments": 0,
                 "wall0": time.perf_counter()},
            )
            event["submitted"] = True
            self.events.append(event)
            return None
        wall0 = time.perf_counter()
        try:
            self._solve(snapshot)
        except Exception as exc:  # fall back to the last-good schedule
            self.events.append(event)
            self._record_failure(
                t,
                {"t_submit": int(t), "pending_segments": 0, "wall0": wall0},
                exc,
            )
            return None
        self.events.append(event)
        swap = self._finish_refresh(t)
        self.refresh_log.append({
            "t_submit": int(t), "t_collect": int(t),
            "solve_s": self.refresher.last_refresh_s,
            "pending_segments": 0, "overlap_wall_s": 0.0, "blocked_s": 0.0,
            "attempts": self._last_attempts,
            "restaged": isinstance(swap, PoolSwap) and swap.restaged,
        })
        self.tracer.instant(
            "refresh.collect", t=int(t), t_submit=int(t),
            solve_s=self.refresher.last_refresh_s,
        )
        return swap

    def flush(self, t: int | None = None, timeout: float | None = None):
        """Block on an in-flight solve and return its swap (or None).

        The one place the controller is allowed to wait: call it after
        the rollout's final segment so a late solve still lands (the
        blocked time is recorded honestly in ``refresh_log``).

        Unlike ``on_segment`` -- which never raises -- ``flush`` is the
        honest surface: a worker exception (after in-worker retries)
        re-raises here as :class:`RefreshError` with the refresh
        metadata on ``.meta`` (the failure is also logged and the
        pending slot cleared, so training COULD continue on the
        last-good schedule after catching it). With ``timeout=``, a
        solve still running when it expires raises
        :class:`RefreshTimeoutError`; the solve is left pending, so a
        later boundary or a second ``flush`` can still collect it.
        """
        if self._pending is None:
            return None
        fut, meta = self._pending
        t0 = time.perf_counter()
        try:
            fut.result(timeout=timeout)
        except concurrent.futures.TimeoutError:
            wall = time.perf_counter() - meta["wall0"]
            raise RefreshTimeoutError(
                f"refresh submitted at t={meta['t_submit']} still running "
                f"after {wall:.3f}s (flush timeout={timeout})",
                meta={
                    "t_submit": meta["t_submit"],
                    "pending_segments": meta["pending_segments"],
                    "overlap_wall_s": wall,
                    "timeout_s": timeout,
                },
            ) from None
        except Exception as exc:
            self._pending = None
            failure = self._record_failure(
                -1 if t is None else t, meta, exc, blocked_s=time.perf_counter() - t0
            )
            raise RefreshError(
                f"refresh submitted at t={meta['t_submit']} failed: {exc!r}",
                meta=failure,
            ) from exc
        blocked = time.perf_counter() - t0
        return self._collect(-1 if t is None else t, blocked_s=blocked)

    def close(self) -> None:
        if self._executor is not None:
            self._executor.shutdown(wait=True)
            self._executor = None

    # -- internals ---------------------------------------------------------

    def _ensure_executor(self) -> concurrent.futures.ThreadPoolExecutor:
        if self._executor is None:
            self._executor = concurrent.futures.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="topo-refresh"
            )
        return self._executor

    def _solve(self, Pi_snapshot: np.ndarray) -> None:
        # runs on the worker thread in overlap mode: refresher state is
        # only read back on the main thread after fut.done(). numpy and
        # scipy only: the schedule's tensors are made later, in _emit,
        # on the calling thread
        attempt = 0
        while True:
            try:
                self.refresher.refresh(Pi_snapshot)
                self._last_attempts = attempt + 1
                return
            except Exception:
                attempt += 1
                if attempt > self.solve_retries:
                    self._last_attempts = attempt
                    raise
                # exponential backoff; in overlap mode this sleeps the
                # worker thread, never the rollout
                time.sleep(self.retry_backoff_s * (2.0 ** (attempt - 1)))

    def _record_failure(
        self, t: int, meta: dict, exc: BaseException, blocked_s: float = 0.0
    ) -> dict:
        """Log a dead refresh and re-arm the detector; returns the entry."""
        self.failed_refreshes += 1
        entry = {
            "t_submit": meta["t_submit"], "t_collect": int(t),
            "solve_s": None,
            "pending_segments": meta["pending_segments"],
            "overlap_wall_s": time.perf_counter() - meta["wall0"],
            "blocked_s": float(blocked_s),
            "attempts": self._last_attempts,
            "restaged": False,
            "error": repr(exc),
        }
        self.refresh_log.append(entry)
        self.events.append({
            "t": int(t), "refresh_failed": True, "error": repr(exc),
        })
        # keep mixing with the last-good schedule; re-anchor the
        # detector at the current proxy so drift can trigger again
        self.detector.rebase(self.proxy())
        return entry

    def _abandon(self, t: int, wall_s: float) -> None:
        """Give up on a timed-out solve: fall back to last-good W.

        The worker thread cannot be killed; it is detached via
        ``shutdown(wait=False)`` and a fresh executor is created on the
        next submit. If the old solve eventually finishes it mutates
        the refresher -- harmless for correctness (the refresher only
        ever holds SOME valid doubly stochastic topology, and the next
        emitted swap re-reads it) but the reason ``solve_timeout_s``
        should comfortably exceed a healthy solve time.
        """
        fut, meta = self._pending
        self._pending = None
        self.tracer.instant(
            "refresh.abandon", t=int(t), t_submit=meta["t_submit"],
            wall_s=float(wall_s),
        )
        if self._executor is not None:
            self._executor.shutdown(wait=False)
            self._executor = None
        self._record_failure(
            t, meta,
            TimeoutError(
                f"refresh solve exceeded solve_timeout_s="
                f"{self.solve_timeout_s} ({wall_s:.3f}s elapsed)"
            ),
        )

    def _collect(self, t: int, blocked_s: float):
        fut, meta = self._pending
        self._pending = None
        try:
            fut.result()
        except Exception as exc:  # fall back to the last-good schedule
            self._record_failure(t, meta, exc, blocked_s=blocked_s)
            return None
        swap = self._finish_refresh(t)
        self.refresh_log.append({
            "t_submit": meta["t_submit"], "t_collect": int(t),
            "solve_s": self.refresher.last_refresh_s,
            "pending_segments": meta["pending_segments"],
            "overlap_wall_s": time.perf_counter() - meta["wall0"],
            "blocked_s": float(blocked_s),
            "attempts": self._last_attempts,
            "restaged": None,  # patched below once the swap is built
        })
        self.refresh_log[-1]["restaged"] = (
            isinstance(swap, PoolSwap) and swap.restaged
        )
        self.tracer.instant(
            "refresh.collect", t=int(t), t_submit=meta["t_submit"],
            solve_s=self.refresher.last_refresh_s,
        )
        self.events.append({
            "t": int(t), "collected": True,
            "refresh_s": self.refresher.last_refresh_s,
            "refresh_iters": self.refresher.last_iters,
        })
        return swap

    def _finish_refresh(self, t: int):
        self._W = self.refresher.W
        self.detector.rebase(self.proxy())
        if self.events and self.events[-1].get("triggered"):
            self.events[-1]["refresh_s"] = self.refresher.last_refresh_s
            self.events[-1]["refresh_iters"] = self.refresher.last_iters
        return self._emit()

    def _emit(self):
        """Current topology as the trainer-facing update object (device
        tensors are made here, on the calling thread)."""
        if self.pool is None:
            return self.refresher.schedule_arrays()
        sched = self.refresher.schedule
        gammas, dropped = self.pool.project(sched)
        if dropped <= self.pool_miss_tol and gammas.sum() > 0.0:
            return PoolSwap(gammas=gammas, pool=None, dropped_mass=dropped)
        # pool miss: restage the refreshed atoms (capacity-truncated),
        # keeping the old capacity so the trainer's gamma operand shape
        # -- and hence everything EXCEPT the one recompile -- is stable.
        # Projecting the UN-truncated schedule reports any capacity-
        # truncation residue honestly in dropped_mass (0 iff every
        # refreshed atom fit).
        self.pool_misses += 1
        new_pool = PermPool.from_schedule(sched, capacity=self.pool.capacity)
        self.pool = new_pool
        new_gammas, dropped = new_pool.project(sched)
        return PoolSwap(gammas=new_gammas, pool=new_pool, dropped_mass=dropped)

    def schedule_arrays(self) -> ScheduleArrays:
        """Current schedule in the trainers' data-plane format."""
        return self.refresher.schedule_arrays()
