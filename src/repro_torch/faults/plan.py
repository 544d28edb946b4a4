"""Seeded fault plans: reproducible crash / drop / straggler / solver traces.

Reproducibility contract: every draw comes from
``np.random.default_rng([seed, stream, ...])`` seed sequences, so

* two processes constructing ``FaultPlan(seed=s, ...)`` with the same
  config produce byte-identical traces (asserted by a subprocess test),
  and
* a checkpoint resume reconstructs the exact trace WITHOUT replaying
  the run: the Markov alive/delay processes are precomputed arrays, and
  per-step edge drops are random-access (stream keyed by ``t``), so
  step 500's drops can be drawn without drawing steps 0..499.
"""

from __future__ import annotations

import dataclasses
import hashlib
import threading

import numpy as np

from repro_torch.core.mixing import ScheduleArrays, degrade_schedule

__all__ = ["FaultPlan", "FaultInjector", "FlakyRefresher"]

# rng stream tags (part of the on-disk/reproducibility contract: changing
# one silently changes every seeded trace)
_STREAM_ALIVE = 1
_STREAM_DELAYS = 2
_STREAM_EDGES = 3
_STREAM_SOLVES = 4
_STREAM_CORRUPT = 5

# bitflip corruption draws one exponent bit in [24, 28): flipping it
# rescales the payload by a large-but-FINITE power of two (a low
# mantissa flip would be indistinguishable from honest noise, bit 30
# overflows straight to inf -- which the nan mode already covers)
_BITFLIP_LO, _BITFLIP_HI = 24, 28


def _parse_corrupt_mode(mode: str) -> tuple[float | None, bool]:
    """``mode`` -> ``(mult, is_bitflip)``.

    ``mult`` is the multiplicative plane value (``nan`` / ``-1`` /
    ``k``); ``None`` with ``is_bitflip=True`` means the XOR plane draws
    an exponent bit instead.
    """
    if mode == "nan":
        return float("nan"), False
    if mode == "sign_flip":
        return -1.0, False
    if mode == "bitflip":
        return None, True
    if mode.startswith("scale:"):
        try:
            k = float(mode[len("scale:"):])
        except ValueError:
            raise ValueError(
                f"unknown corruption mode {mode!r}: the scale factor in "
                "'scale:<k>' must be a number"
            ) from None
        if not np.isfinite(k):
            raise ValueError(f"scale factor must be finite, got {mode!r}")
        return k, False
    raise ValueError(
        f"unknown corruption mode {mode!r}: expected 'nan', 'sign_flip', "
        "'bitflip', or 'scale:<k>'"
    )


@dataclasses.dataclass
class FaultPlan:
    """A reproducible fault trace for an ``steps``-step, ``n_nodes`` run.

    Args:
      n_nodes / steps: trace dimensions.
      seed: the single seed every stream derives from.
      crash_rate: per-node per-step probability that an alive node
        crashes (start of an offline window).
      mean_outage: expected outage length in steps; a crashed node
        rejoins each step with probability ``1 / mean_outage``
        (geometric outages -- the memoryless twin of
        ``data.drift.NodeChurn``'s fixed windows).
      straggler_rate: per-node per-step probability that a node's
        parameters arrive stale this step.
      tau_max: bounded-delay cap; a straggling node's delay is uniform
        in ``[1, tau_max]`` (0 = no staleness model).
      edge_drop_rate: per-directed-edge per-step message-drop
        probability.
      solve_failure_rate / solve_hang_rate: per-refresh probabilities
        that the k-th topology solve raises / hangs (consumed by
        :class:`FlakyRefresher`).
      corrupt_rate: per-node per-step probability that an honest node
        turns CORRUPT (starts lying on the wire -- start of a
        corruption window).
      mean_corruption: expected corruption-window length in steps; a
        corrupt node recovers each step with probability
        ``1 / mean_corruption`` (geometric windows, like outages --
        finite windows are what make self-healing re-admission a
        testable event rather than a hypothetical).
      corrupt_modes: the palette a corruption window draws its mode
        from (uniformly, once per window): ``"nan"``, ``"sign_flip"``,
        ``"scale:<k>"``, ``"bitflip"``.

    Derived (precomputed, deterministic):
      alive: (steps, n) bool -- the crash/rejoin Markov trace.
      delays: (steps, n) int32 in [0, tau_max] -- the straggler trace
        (crashed nodes carry delay 0; their transfers are cut by the
        alive mask, not by staleness).
      corrupt_mult / corrupt_xor: (steps, n) f32 / int32 -- the wire
        corruption trace in the two planes
        :class:`repro.core.mixing.WireCorruption` consumes (1.0 / 0 =
        honest; dead nodes are forced honest -- they send nothing).
    """

    n_nodes: int
    steps: int
    seed: int = 0
    crash_rate: float = 0.0
    mean_outage: float = 10.0
    straggler_rate: float = 0.0
    tau_max: int = 0
    edge_drop_rate: float = 0.0
    solve_failure_rate: float = 0.0
    solve_hang_rate: float = 0.0
    corrupt_rate: float = 0.0
    mean_corruption: float = 8.0
    corrupt_modes: tuple = ("nan", "sign_flip", "scale:8", "bitflip")
    alive: np.ndarray = dataclasses.field(init=False, repr=False)
    delays: np.ndarray = dataclasses.field(init=False, repr=False)
    corrupt_mult: np.ndarray = dataclasses.field(init=False, repr=False)
    corrupt_xor: np.ndarray = dataclasses.field(init=False, repr=False)

    def __post_init__(self) -> None:
        if self.n_nodes < 1 or self.steps < 0:
            raise ValueError(f"bad n_nodes={self.n_nodes} / steps={self.steps}")
        for name in ("crash_rate", "straggler_rate", "edge_drop_rate",
                     "corrupt_rate"):
            v = getattr(self, name)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"{name} must be in [0, 1], got {v}")
        if self.mean_outage < 1.0:
            raise ValueError(f"mean_outage must be >= 1, got {self.mean_outage}")
        if self.mean_corruption < 1.0:
            raise ValueError(
                f"mean_corruption must be >= 1, got {self.mean_corruption}"
            )
        if self.tau_max < 0:
            raise ValueError(f"tau_max must be >= 0, got {self.tau_max}")
        if self.solve_failure_rate + self.solve_hang_rate > 1.0:
            raise ValueError("solve_failure_rate + solve_hang_rate must be <= 1")
        self.corrupt_modes = tuple(self.corrupt_modes)
        if not self.corrupt_modes:
            raise ValueError("corrupt_modes must not be empty")
        for mode in self.corrupt_modes:
            _parse_corrupt_mode(mode)  # validates
        self.alive = self._gen_alive()
        self.delays = self._gen_delays()
        self.corrupt_mult, self.corrupt_xor = self._gen_corruption()

    # -- trace generation ---------------------------------------------------

    def _gen_alive(self) -> np.ndarray:
        n, T = self.n_nodes, self.steps
        alive = np.ones((T, n), dtype=bool)
        if self.crash_rate == 0.0 or T == 0:
            return alive
        rng = np.random.default_rng([self.seed, _STREAM_ALIVE])
        rejoin_p = 1.0 / self.mean_outage
        state = np.ones(n, dtype=bool)
        for t in range(T):
            u = rng.random(n)
            crash = state & (u < self.crash_rate)
            rejoin = ~state & (u < rejoin_p)
            state = (state & ~crash) | rejoin
            if not state.any():
                # never let the whole fleet die: W would degrade to I and
                # the run silently stops mixing forever; resurrect one
                # node deterministically (lowest index)
                state[0] = True
            alive[t] = state
        return alive

    def _gen_delays(self) -> np.ndarray:
        n, T = self.n_nodes, self.steps
        delays = np.zeros((T, n), dtype=np.int32)
        if self.straggler_rate == 0.0 or self.tau_max == 0 or T == 0:
            return delays
        rng = np.random.default_rng([self.seed, _STREAM_DELAYS])
        lagging = rng.random((T, n)) < self.straggler_rate
        draw = rng.integers(1, self.tau_max + 1, size=(T, n), dtype=np.int32)
        # defensive clamp to the ring's reach: a delay past tau_max would
        # alias modulo the (tau_max + 1)-deep ring and silently read a
        # NEWER state than asked for (the draw above already respects the
        # bound; the clamp pins the invariant against future draw changes)
        delays[lagging] = np.minimum(draw[lagging], self.tau_max)
        # offline nodes carry delay 0: the alive mask governs them (their
        # transfers are cut by schedule repair), not staleness
        delays[~self.alive] = 0
        return delays

    def _gen_corruption(self) -> tuple[np.ndarray, np.ndarray]:
        n, T = self.n_nodes, self.steps
        mult = np.ones((T, n), dtype=np.float32)
        xor = np.zeros((T, n), dtype=np.int32)
        if self.corrupt_rate == 0.0 or T == 0:
            return mult, xor
        rng = np.random.default_rng([self.seed, _STREAM_CORRUPT])
        recover_p = 1.0 / self.mean_corruption
        # per-node window state: honest (mult 1 / xor 0) or one drawn
        # mode held for the whole window -- a corrupted node lies the
        # same WAY until it recovers, so streak-based confirmation sees
        # a consistent signature
        cur_mult = np.ones(n, dtype=np.float32)
        cur_xor = np.zeros(n, dtype=np.int32)
        corrupt = np.zeros(n, dtype=bool)
        for t in range(T):
            u = rng.random(n)
            start = ~corrupt & (u < self.corrupt_rate)
            stop = corrupt & (u < recover_p)
            for i in np.flatnonzero(start):
                mode = self.corrupt_modes[
                    int(rng.integers(len(self.corrupt_modes)))
                ]
                m, is_bitflip = _parse_corrupt_mode(mode)
                if is_bitflip:
                    cur_mult[i] = 1.0
                    cur_xor[i] = np.int32(1) << np.int32(
                        rng.integers(_BITFLIP_LO, _BITFLIP_HI)
                    )
                else:
                    cur_mult[i] = np.float32(m)
                    cur_xor[i] = 0
            corrupt = (corrupt | start) & ~stop
            cur_mult[~corrupt] = 1.0
            cur_xor[~corrupt] = 0
            # dead nodes send nothing: force their wire planes honest so
            # the corruption trace never claims bytes that never moved
            row_ok = corrupt & self.alive[t]
            mult[t] = np.where(row_ok, cur_mult, np.float32(1.0))
            xor[t] = np.where(row_ok, cur_xor, 0)
        return mult, xor

    @property
    def has_corruption(self) -> bool:
        """True iff any (node, step) actually lies on the wire.

        Checked on the DERIVED arrays, not the config: a scripted plan
        (arrays edited in place, like :meth:`from_node_churn` does for
        ``alive``) still reports -- and fingerprints -- its corruption.
        """
        return bool(
            (self.corrupt_mult != np.float32(1.0)).any()
            or (self.corrupt_xor != 0).any()
        )

    @property
    def ring_depth(self) -> int:
        """Ring-buffer depth that makes every drawn delay reachable:
        ``tau_max + 1`` slots hold delays 0..tau_max without aliasing."""
        return self.tau_max + 1

    def dropped_edges(self, t: int) -> np.ndarray:
        """(m, 2) int64 array of (src, dst) drops at step ``t``.

        Random-access: stream keyed by ``[seed, tag, t]``, so a resumed
        run re-draws exactly this step's drops without replaying the
        prefix.
        """
        if not 0 <= t < self.steps:
            raise ValueError(f"t={t} outside [0, {self.steps})")
        if self.edge_drop_rate == 0.0:
            return np.zeros((0, 2), dtype=np.int64)
        rng = np.random.default_rng([self.seed, _STREAM_EDGES, t])
        mask = rng.random((self.n_nodes, self.n_nodes)) < self.edge_drop_rate
        np.fill_diagonal(mask, False)
        return np.argwhere(mask).astype(np.int64)

    def solve_fault(self, k: int) -> str:
        """Fate of the k-th topology refresh solve: 'ok'|'raise'|'hang'."""
        if k < 0:
            raise ValueError(f"k must be >= 0, got {k}")
        if self.solve_failure_rate == 0.0 and self.solve_hang_rate == 0.0:
            return "ok"
        u = np.random.default_rng([self.seed, _STREAM_SOLVES, k]).random()
        if u < self.solve_failure_rate:
            return "raise"
        if u < self.solve_failure_rate + self.solve_hang_rate:
            return "hang"
        return "ok"

    # -- derived views ------------------------------------------------------

    def alive_frac(self, t0: int = 0, k: int | None = None) -> float:
        """Mean alive fraction over steps [t0, t0 + k)."""
        k = self.steps - t0 if k is None else k
        window = self.alive[t0 : t0 + k]
        return float(window.mean()) if window.size else 1.0

    def delivered_frac(self, t: int) -> float:
        """Fraction of the fault-free per-step transfer volume delivered.

        The all-gather model moves n(n-1) directed transfers per step; a
        transfer survives iff both endpoints are alive and the edge was
        not dropped. This is the honest ``delivered_frac`` for
        :meth:`repro.train.metrics.CommMeter.tick` under faults.
        """
        n = self.n_nodes
        if n < 2:
            return 1.0
        a = self.alive[t]
        ok = np.outer(a, a)
        np.fill_diagonal(ok, False)
        edges = self.dropped_edges(t)
        if edges.size:
            ok[edges[:, 0], edges[:, 1]] = False
        return float(ok.sum()) / (n * (n - 1))

    def transfer_fracs(
        self, t: int, deadline: int | None = None, mode: str = "wait"
    ) -> tuple[float, float, float]:
        """Three-way fate split of step ``t``'s n(n-1) directed transfers:
        ``(on_time, deferred, dropped)``, summing to 1.

        * *dropped*: an endpoint is dead or the edge was dropped -- the
          bytes never arrive. Under ``mode="degrade"`` with a
          ``deadline``, a source later than the deadline joins this
          bucket (the repaired schedule self-loops it for the step).
        * *deferred*: the source is a straggler (``delays[t, src] > 0``)
          but the transfer is otherwise alive -- the bytes DO arrive,
          past their freshness deadline (the wait policy consumes them
          stale).
        * *on_time*: everything else.

        ``on_time + deferred == delivered_frac(t)`` under ``wait`` (the
        back-compatible two-way split); ``degrade`` moves the
        past-deadline deferred mass into dropped. This is the honest
        pair for :meth:`repro.train.metrics.CommMeter.tick`'s
        ``(delivered_frac, deferred_frac)``.
        """
        if mode not in ("wait", "degrade"):
            raise ValueError(f"mode must be 'wait' or 'degrade', got {mode!r}")
        n = self.n_nodes
        if n < 2:
            return 1.0, 0.0, 0.0
        a = np.asarray(self.alive[t], bool).copy()
        d = np.asarray(self.delays[t])
        if mode == "degrade" and deadline is not None:
            a &= ~(d > deadline)
        ok = np.outer(a, a)
        np.fill_diagonal(ok, False)
        edges = self.dropped_edges(t)
        if edges.size:
            ok[edges[:, 0], edges[:, 1]] = False
        total = n * (n - 1)
        delivered = int(ok.sum())
        late_src = (d > 0) & a
        deferred = int(ok[late_src, :].sum())
        on_time = delivered - deferred
        return on_time / total, deferred / total, (total - delivered) / total

    def quarantined_frac(
        self,
        t: int,
        quarantined: np.ndarray,
        deadline: int | None = None,
        mode: str = "wait",
    ) -> float:
        """Fraction of step ``t``'s n(n-1) directed transfers that were
        DELIVERED but touch a quarantined endpoint.

        Quarantine isolation is bidirectional (the repaired W pins the
        node to ``e_i`` symmetrically), so a transfer is quarantined iff
        it would otherwise deliver AND either endpoint is quarantined.
        Always a subset of ``delivered`` = ``on_time + deferred`` from
        :meth:`transfer_fracs` -- the meter's ``quarantined_bytes``
        honesty invariant.
        """
        if mode not in ("wait", "degrade"):
            raise ValueError(f"mode must be 'wait' or 'degrade', got {mode!r}")
        n = self.n_nodes
        q = np.asarray(quarantined, bool)
        if q.shape != (n,):
            raise ValueError(f"quarantined must be ({n},), got {q.shape}")
        if n < 2 or not q.any():
            return 0.0
        a = np.asarray(self.alive[t], bool).copy()
        d = np.asarray(self.delays[t])
        if mode == "degrade" and deadline is not None:
            a &= ~(d > deadline)
        ok = np.outer(a, a)
        np.fill_diagonal(ok, False)
        edges = self.dropped_edges(t)
        if edges.size:
            ok[edges[:, 0], edges[:, 1]] = False
        touched = q[:, None] | q[None, :]
        return float((ok & touched).sum()) / (n * (n - 1))

    def fingerprint(self) -> str:
        """sha256 over the full derived trace (the cross-process
        determinism witness: two processes with the same config must
        agree on every byte)."""
        h = hashlib.sha256()
        h.update(repr((self.n_nodes, self.steps, self.seed, self.crash_rate,
                       self.mean_outage, self.straggler_rate, self.tau_max,
                       self.edge_drop_rate, self.solve_failure_rate,
                       self.solve_hang_rate)).encode())
        h.update(self.alive.tobytes())
        h.update(self.delays.tobytes())
        for t in range(self.steps):
            h.update(self.dropped_edges(t).tobytes())
        for k in range(self.steps):
            h.update(self.solve_fault(k).encode())
        # corruption joins the hash ONLY when the derived trace actually
        # lies somewhere: plans that don't use it keep their pre-existing
        # fingerprints byte-for-byte (pinned by a regression test)
        if self.has_corruption:
            h.update(repr((self.corrupt_rate, self.mean_corruption,
                           self.corrupt_modes)).encode())
            h.update(self.corrupt_mult.tobytes())
            h.update(self.corrupt_xor.tobytes())
        return h.hexdigest()

    @classmethod
    def from_node_churn(cls, churn, steps: int, **kwargs) -> "FaultPlan":
        """Generalize a :class:`repro.data.drift.NodeChurn` scenario: the
        plan's alive trace mirrors the churn's offline windows exactly
        (on top of any additional stochastic faults in ``kwargs``)."""
        plan = cls(n_nodes=churn.n_nodes, steps=steps, **kwargs)
        for node, t_start, t_end in churn.offline_windows():
            plan.alive[max(t_start, 0) : min(t_end, steps), node] = False
        for t in range(steps):
            if not plan.alive[t].any():
                plan.alive[t, 0] = True
        plan.delays[~plan.alive] = 0
        return plan


class FaultInjector:
    """Binds a :class:`FaultPlan` to a live data-plane schedule.

    Produces the per-step degraded ``ScheduleArrays`` and delay vectors
    a compiled rollout consumes as scan data. ``rebind`` swaps the
    fault-free base schedule after an online topology refresh -- the
    degradation then applies to the NEW topology from the next step on.

    ``policy`` (a :class:`repro.core.mixing.StragglerPolicy`) resolves
    the plan's raw delay trace against a deadline: each step's alive
    mask, edge drops AND past-deadline stragglers fold into one
    schedule repair, and the streamed delay vectors become the policy's
    effective (clamped / zeroed) delays. ``policy=None`` keeps the
    PR 6 behavior: repair on crashes/drops only, raw delays passed
    through.

    ``set_quarantine`` folds a host-decided quarantine mask into the
    SAME single repair call (``alive_eff = alive & ~quarantined``): a
    quarantined node is isolated to ``e_i`` symmetrically, so W stays
    exactly doubly stochastic on the trusted support with zero extra
    repair passes -- and zero retraces, since the swap is pure values.
    """

    def __init__(self, plan: FaultPlan, base: ScheduleArrays, policy=None,
                 tracer=None):
        if base.n_nodes != plan.n_nodes:
            raise ValueError(
                f"schedule is for {base.n_nodes} nodes, plan for {plan.n_nodes}"
            )
        self.plan = plan
        self.base = base
        self.policy = policy
        # a repro.obs.Tracer (duck-typed; this module stays importable
        # without obs loaded) -- stream() records "faults.stream" spans
        self.tracer = tracer
        self.quarantined = np.zeros(plan.n_nodes, dtype=bool)

    def set_quarantine(self, mask: np.ndarray) -> None:
        """Replace the quarantine mask (applies from the next streamed
        step on -- the controller calls this at segment boundaries)."""
        m = np.asarray(mask, bool)
        if m.shape != (self.plan.n_nodes,):
            raise ValueError(
                f"mask must be ({self.plan.n_nodes},), got {m.shape}"
            )
        self.quarantined = m.copy()

    def _alive_eff(self, t: int) -> np.ndarray:
        if not self.quarantined.any():
            return self.plan.alive[t]
        return self.plan.alive[t] & ~self.quarantined

    def rebind(self, base: ScheduleArrays) -> None:
        if base.n_nodes != self.plan.n_nodes or base.l_max != self.base.l_max:
            raise ValueError(
                "rebind must preserve the schedule shape "
                f"({self.base.l_max}, {self.base.n_nodes}); got "
                f"({base.l_max}, {base.n_nodes})"
            )
        self.base = base

    def arrays_at(self, t: int) -> ScheduleArrays:
        """Degraded schedule for step ``t`` (host-side value change)."""
        return degrade_schedule(
            self.base, self._alive_eff(t), self.plan.dropped_edges(t)
        )

    def delays_at(self, t: int) -> np.ndarray:
        return self.plan.delays[t]

    def stream(self, t0: int, k: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Host-side per-step fault data for steps [t0, t0 + k), stacked
        for a ``lax.scan``: ``(gammas (k, l_max), perms (k, l_max, n),
        delays (k, n))``. Fixed shapes whatever the faults -- the whole
        zero-retrace argument."""
        if self.tracer is not None:
            with self.tracer.span("faults.stream", t0=int(t0), k=int(k)):
                return self._stream(t0, k)
        return self._stream(t0, k)

    def _stream(self, t0: int, k: int):
        gammas = np.empty((k, self.base.l_max), np.float32)
        perms = np.empty((k, self.base.l_max, self.base.n_nodes), np.int32)
        delays = np.empty((k, self.base.n_nodes), np.int32)
        for j in range(k):
            t = t0 + j
            if self.policy is None:
                arrays_t = self.arrays_at(t)
                delays[j] = self.plan.delays[t]
            else:
                arrays_t, delays[j] = self.policy.apply(
                    self.base,
                    self.plan.delays[t],
                    alive_mask=self._alive_eff(t),
                    dropped_edges=self.plan.dropped_edges(t),
                )
            gammas[j] = np.asarray(arrays_t.gammas)
            perms[j] = np.asarray(arrays_t.perms)
        return gammas, perms, delays

    def corrupt_stream(self, t0: int, k: int) -> tuple[np.ndarray, np.ndarray]:
        """Wire-corruption planes for steps [t0, t0 + k), stacked for a
        ``lax.scan``: ``(mult (k, n) f32, xor (k, n) int32)``. Slices of
        the precomputed trace -- same fixed-shape/zero-retrace contract
        as :meth:`stream`."""
        if not 0 <= t0 <= t0 + k <= self.plan.steps:
            raise ValueError(
                f"window [{t0}, {t0 + k}) outside [0, {self.plan.steps})"
            )
        return (
            np.ascontiguousarray(self.plan.corrupt_mult[t0 : t0 + k]),
            np.ascontiguousarray(self.plan.corrupt_xor[t0 : t0 + k]),
        )


class FlakyRefresher:
    """Wrap a ``TopologyRefresher`` so its solves fail per the plan.

    The k-th ``refresh`` call consults ``plan.solve_fault(k)``:
    ``"raise"`` raises RuntimeError, ``"hang"`` blocks on ``hang_event``
    (or sleeps ``hang_s``) before proceeding, ``"ok"`` delegates.
    Everything else (``schedule``, ``W``, ``schedule_arrays``,
    ``last_refresh_s``, ...) proxies to the wrapped refresher, so the
    controller cannot tell the difference -- which is the point: the
    hardening must work against the real interface.

    Pass a ``threading.Event`` as ``hang_event`` in tests and SET it in
    the test's finally block: executor worker threads are non-daemon,
    so an un-released hang would block interpreter exit.
    """

    def __init__(
        self,
        inner,
        plan: FaultPlan,
        hang_event: "threading.Event | None" = None,
        hang_s: float = 60.0,
    ):
        self._inner = inner
        self._plan = plan
        self._hang_event = hang_event
        self._hang_s = float(hang_s)
        self.n_solves = 0
        self.n_injected_failures = 0
        self.n_injected_hangs = 0

    def refresh(self, Pi_hat):
        k = self.n_solves
        self.n_solves += 1
        fate = self._plan.solve_fault(k)
        if fate == "raise":
            self.n_injected_failures += 1
            raise RuntimeError(f"injected solve failure (refresh #{k})")
        if fate == "hang":
            self.n_injected_hangs += 1
            if self._hang_event is not None:
                self._hang_event.wait()
            else:
                import time

                time.sleep(self._hang_s)
        return self._inner.refresh(Pi_hat)

    def __getattr__(self, name):
        return getattr(self._inner, name)
