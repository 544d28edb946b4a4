"""Mean-estimation D-SGD under injected faults, with crash recovery.

The faulty twin of ``train.trainer.run_mean_estimation``'s online
driver, with the same step math op for op:

    grads = 2 (theta - z_bar)                      # quadratic task
    half  = theta - lr * grads                     # local half-step
    push half into the staleness ring
    theta = sum_l gammas_t[l] * stale[perms_t[l]]  # degraded + delayed mix

run as a captured rollout (``train/rollout.py``): theta, the ring and its
head are static tensors of the segment bodies, and the plan's per-step
data -- the degraded ``(gammas, perms)`` tables, the delay vector and, on
the screened path, the wire-corruption planes -- are the bodies' static
inputs, resolved on the host by the :class:`FaultInjector` for each
segment. Every fault event (a crash's repaired schedule, a straggler's
delay, a quarantine, the rejoin back to the full schedule) is a value:
one capture for the whole run. A zero-fault plan is the fault-free
driver's trajectory, bitwise (zero delays read back the state just
pushed, and ``degrade_schedule`` with everyone alive changes nothing).

Crash recovery: at segment boundaries the runner's static state (theta,
the ring and its head) and the current base schedule -- so a topology
refresh before the crash survives -- are checkpointed with
``train.checkpoints``; ``resume=True`` copies the newest checkpoint back
into the static tensors and continues from there. Every fault draw is
random-access from the plan's seed, so the resumed run replays the same
bodies on the same inputs and ends bitwise where the uninterrupted run
ends.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from repro_torch.core.mixing import (
    KERNEL_ROW_ALIGN,
    ScheduleArrays,
    ScreenStats,
    StaleBuffer,
    StragglerPolicy,
    WireCorruption,
    mix_schedule_arrays_screened,
    mix_schedule_arrays_stale,
    ravel_stack,
    stale_push,
)
from repro_torch.device import resolve_device
from repro_torch.obs.trace import Tracer
from repro_torch.train.checkpoints import latest_step, restore_checkpoint, save_checkpoint
from repro_torch.train.metrics import CommMeter, mix_bytes_per_step
from repro_torch.train.rollout import SegmentRunner

from .plan import FaultInjector, FaultPlan

__all__ = ["run_faulty_mean_estimation"]

_NULL_TRACER = Tracer(enabled=False)


def _host_arrays(arrays: ScheduleArrays) -> ScheduleArrays:
    """A schedule's host copy (the injector repairs it with numpy)."""
    return ScheduleArrays(
        gammas=torch.as_tensor(arrays.gammas, dtype=torch.float32).cpu(),
        perms=torch.as_tensor(arrays.perms, dtype=torch.int32).cpu(),
    )


def run_faulty_mean_estimation(
    task,
    plan: FaultPlan,
    schedule: ScheduleArrays,
    *,
    lr: float = 0.1,
    batch: int = 1,
    seed: int = 0,
    segment_len: int | None = None,
    on_segment: Callable | None = None,
    zs: np.ndarray | None = None,
    checkpoint_dir: str | None = None,
    checkpoint_every: int = 1,
    resume: bool = False,
    stop_after_segments: int | None = None,
    staleness: StragglerPolicy | None = None,
    quarantine=None,
    tracer: "Tracer | None" = None,
    retrace_guard=None,
    rollout: str = "scan",
    device: torch.device | str | None = None,
) -> dict:
    """D-SGD mean estimation under a seeded fault plan.

    Args:
      task: a ``MeanEstimationTask`` (``theta_star`` and the observation
        sampler; ``zs`` overrides the presampled stream).
      plan: the fault trace; ``plan.steps`` is the run length.
      schedule: fault-free base topology as ``ScheduleArrays`` (refreshes
        swap it via ``on_segment``).
      segment_len: boundary spacing for the hook and the checkpoints
        (default one segment).
      on_segment: ``hook(t) -> ScheduleArrays | None`` after every segment
        but the last; a returned schedule rebases the injector (same
        shape). An ``OnlineTopologyController`` plugs in unchanged.
      checkpoint_dir / checkpoint_every: save the runner's static state
        and the base schedule every ``checkpoint_every``-th boundary (and
        at an early stop). ``resume=True`` restores the newest checkpoint
        and continues bitwise; the returned traces then cover only the
        resumed tail (``resumed_from`` records the restart step).
      stop_after_segments: run at most this many segments, then return
        (the scripted crash of recovery drills); ``stopped_at`` records
        where.
      staleness: a ``StragglerPolicy`` resolving the plan's raw delays
        against a deadline (one schedule repair with the crash and drop
        faults); the ring depth is then the policy's and the meter splits
        delivered bytes into on-time and deferred. None passes the raw
        delays through, the ring sized by the plan.
      quarantine: a ``faults.quarantine.QuarantineController``: enables
        the screened transport (non-finite guard in the body, screens on
        the host), folds the controller's mask into the injector's
        repair at every boundary and meters ``quarantined_bytes``. The
        body is chosen when it is built: with no controller and a
        corruption-free plan the unscreened body runs; a corrupting plan
        without a controller runs the screened body with the guard off.
      tracer: records ``sim.segment`` spans, and ``faults.stream`` spans
        for the host-side fault resolution.
      retrace_guard: counts captures under ``"faults.roll"``.
      rollout: ``"scan"`` (CUDA graphs) or ``"loop"`` (the same bodies
        eagerly).
      device: None runs on CUDA.

    Returns a dict with the fault-free driver's keys
    (``mean/max/min_sq_error``, ``theta``, ``n_traces``, ``swaps``,
    ``comm``) plus ``resumed_from``, ``stopped_at``, ``alive_frac``,
    ``quarantine`` and ``sq_error_nodes`` (the (steps, n) per-node error
    trace of the screened body, else None).
    """
    if rollout not in ("scan", "loop"):
        raise ValueError(f"unknown rollout {rollout!r}")
    device = resolve_device(device)
    steps = plan.steps
    n = task.n_nodes
    if plan.n_nodes != n:
        raise ValueError(f"plan is for {plan.n_nodes} nodes, task for {n}")
    if checkpoint_every < 1:
        raise ValueError(f"checkpoint_every must be >= 1, got {checkpoint_every}")
    seg = int(segment_len) if segment_len is not None else max(steps, 1)
    if seg < 1:
        raise ValueError(f"segment_len must be >= 1, got {segment_len}")

    if zs is None:
        # the call sequence of run_mean_estimation: a zero-fault plan at
        # the same seed traverses the same observations
        rng = np.random.default_rng(seed)
        zs_host = [task.sample(batch, rng) for _ in range(steps)]
        zs = np.stack(zs_host) if zs_host else np.zeros((0, n, batch))
    zs_t = torch.as_tensor(np.asarray(zs), dtype=torch.float32, device=device)
    if zs_t.ndim != 3 or zs_t.shape[0] != steps or zs_t.shape[1] != n:
        raise ValueError(f"zs must be ({steps}, {n}, batch), got {tuple(zs_t.shape)}")

    tracer = _NULL_TRACER if tracer is None else tracer
    injector = FaultInjector(
        plan, _host_arrays(schedule), policy=staleness,
        tracer=tracer if tracer.enabled else None,
    )
    depth = staleness.ring_depth if staleness is not None else plan.ring_depth
    runner = SegmentRunner("faults.roll", device, captured=rollout == "scan",
                           retrace_guard=retrace_guard)
    theta = runner.carry("theta", torch.zeros((n, 1)))
    flat0, _ = ravel_stack(theta, pad_to=KERNEL_ROW_ALIGN)
    buffer = StaleBuffer(
        buf=runner.carry("ring", flat0.unsqueeze(0).repeat(depth, 1, 1)),
        head=runner.carry("head", torch.zeros((), dtype=torch.long)),
    )
    theta_star = torch.as_tensor(task.theta_star, dtype=torch.float32, device=device)
    lr = float(lr)
    # the body is chosen when it is built: the screened one only exists
    # when the plan corrupts or a controller screens, so a
    # corruption-off run is the unscreened trajectory, bitwise
    screened = plan.has_corruption or quarantine is not None
    guard = quarantine is not None
    l_max = injector.base.l_max

    def make_body(k: int, _shape):
        inputs = (
            torch.empty((k, n, zs_t.shape[2]), device=device),
            torch.empty((k, l_max), dtype=torch.float32, device=device),
            torch.empty((k, l_max, n), dtype=torch.int32, device=device),
            torch.empty((k, n), dtype=torch.int32, device=device),
        )
        if screened:
            inputs += (torch.empty((k, n), dtype=torch.float32, device=device),
                       torch.empty((k, n), dtype=torch.int32, device=device))
        errs = torch.empty((k, 3), device=device)
        outputs = (errs,)
        if screened:
            outputs += (
                torch.empty((k, n), device=device),  # per-node error
                torch.empty((k, n), device=device),  # ScreenStats.sq_own
                torch.empty((k, l_max, n), device=device),  # .sq_recv
                torch.empty((k, l_max, n), device=device),  # .dot
                torch.empty((k, l_max, n), dtype=torch.bool, device=device),  # .finite
                torch.empty((k, 3), device=device),  # consensus, gdev, gbar_sq
            )

        def body() -> None:
            z_in, g_in, p_in, d_in = inputs[:4]
            th = theta
            for j in range(k):
                grads = 2.0 * (th - z_in[j].mean(dim=1, keepdim=True))
                half = th - lr * grads
                flat, _ = ravel_stack(half, pad_to=KERNEL_ROW_ALIGN)
                stale_push(buffer, flat)
                sa = ScheduleArrays(gammas=g_in[j], perms=p_in[j])
                if screened:
                    corrupt = WireCorruption(mult=inputs[4][j], xor=inputs[5][j])
                    mixed, stats = mix_schedule_arrays_screened(
                        buffer, sa, d_in[j], flat, corrupt=corrupt, guard=guard)
                else:
                    mixed = mix_schedule_arrays_stale(buffer, sa, d_in[j])
                th = mixed[:, :1]
                err = torch.square(th[:, 0] - theta_star)
                errs[j] = torch.stack([err.mean(), err.max(), err.min()])
                if screened:
                    # the live probes the host-side screen derives its
                    # honest-deviation allowance from (max over nodes:
                    # the bound is a triangle inequality against the
                    # worst honest node)
                    hbar = half.mean(dim=0, keepdim=True)
                    gbar = grads.mean(dim=0, keepdim=True)
                    outputs[1][j] = err
                    for out, value in zip(outputs[2:6], stats):
                        out[j] = value
                    outputs[6][j] = torch.stack([
                        torch.sum(torch.square(half - hbar), dim=1).max(),
                        torch.sum(torch.square(grads - gbar), dim=1).max(),
                        torch.sum(torch.square(gbar)),
                    ])
            theta.copy_(th)

        return body, inputs, outputs

    segment: dict = {}

    def fill(inputs, t, k):
        inputs[0].copy_(zs_t[t : t + k])
        lo = t - segment["t0"]
        for dst, src in zip(inputs[1:], segment["streams"]):
            dst.copy_(torch.as_tensor(src[lo : lo + k]))

    def save(t: int) -> None:
        save_checkpoint(
            checkpoint_dir, t,
            {**runner.state_dict(), "gammas": injector.base.gammas,
             "perms": injector.base.perms},
            metadata={"t": int(t), "seed": int(seed)},
        )

    t0 = 0
    resumed_from = None
    if checkpoint_dir is not None and resume:
        last = latest_step(checkpoint_dir)
        if last is not None:
            like = {**runner.state_dict(), "gammas": injector.base.gammas,
                    "perms": injector.base.perms}
            tree, _meta = restore_checkpoint(checkpoint_dir, last, like)
            runner.load_state_dict({k: tree[k] for k in runner.state_dict()})
            injector.rebind(ScheduleArrays(gammas=torch.as_tensor(tree["gammas"]),
                                           perms=torch.as_tensor(tree["perms"])))
            t0 = int(last)
            resumed_from = t0

    meter = CommMeter(per_step_bytes=mix_bytes_per_step("allgather", n_nodes=n, p_total=1))
    mse_l, mx_l, mn_l = [], [], []
    nodes_l: list[np.ndarray] = []
    swaps: list[int] = []
    stopped_at = None
    seg_idx = 0
    while t0 < steps:
        k = min(seg, steps - t0)
        gammas_k, perms_k, delays_k = injector.stream(t0, k)
        streams = (gammas_k, perms_k, delays_k)
        if screened:
            streams += injector.corrupt_stream(t0, k)
        segment.update(t0=t0, streams=streams)
        # the mask active during this segment (transitions from ingest
        # below land on the next one) -- also the basis of this
        # segment's quarantined-byte fate
        qmask = injector.quarantined.copy()
        with tracer.span("sim.segment", t0=t0, k=k):
            outs = [o.cpu().numpy() for o in
                    runner.run_segment(t0, k, injector.base, make_body, fill)]
        errs = outs[0]
        mse_l.append(errs[:, 0])
        mx_l.append(errs[:, 1])
        mn_l.append(errs[:, 2])
        if screened:
            nodes_l.append(outs[1])
        if staleness is not None:
            fates = [
                plan.transfer_fracs(t, deadline=staleness.tau_max, mode=staleness.mode)
                for t in range(t0, t0 + k)
            ]
            on_time = float(np.mean([f[0] for f in fates]))
            deferred = float(np.mean([f[1] for f in fates]))
            q_frac = float(np.mean([
                plan.quarantined_frac(t, qmask, deadline=staleness.tau_max, mode=staleness.mode)
                for t in range(t0, t0 + k)
            ])) if qmask.any() else 0.0
            meter.tick(k, delivered_frac=on_time + deferred, deferred_frac=deferred,
                       quarantined_frac=q_frac)
        else:
            frac = float(np.mean([plan.delivered_frac(t) for t in range(t0, t0 + k)]))
            q_frac = float(np.mean([
                plan.quarantined_frac(t, qmask) for t in range(t0, t0 + k)
            ])) if qmask.any() else 0.0
            meter.tick(k, delivered_frac=frac, quarantined_frac=q_frac)
        if quarantine is not None:
            probes = outs[6]
            new_mask = quarantine.ingest(
                t0, ScreenStats(*outs[2:6]), gammas_k, perms_k,
                {"consensus_sq": probes[:, 0], "gdev_sq": probes[:, 1],
                 "gbar_sq": probes[:, 2]},
            )
            injector.set_quarantine(new_mask)
        t0 += k
        seg_idx += 1
        if on_segment is not None and t0 < steps:
            update = on_segment(t0 - 1)
            if update is not None:
                injector.rebind(_host_arrays(update))
                swaps.append(t0 - 1)
        if checkpoint_dir is not None and (seg_idx % checkpoint_every == 0 or t0 >= steps):
            save(t0)
        if stop_after_segments is not None and seg_idx >= stop_after_segments and t0 < steps:
            if checkpoint_dir is not None and seg_idx % checkpoint_every != 0:
                save(t0)  # the crash drill must leave a resumable state
            stopped_at = t0
            break

    empty = np.zeros((0,))
    return {
        "mean_sq_error": np.concatenate(mse_l) if mse_l else empty,
        "max_sq_error": np.concatenate(mx_l) if mx_l else empty,
        "min_sq_error": np.concatenate(mn_l) if mn_l else empty,
        "theta": theta.cpu().numpy(),
        "n_traces": runner.n_traces,
        "swaps": swaps,
        "comm": meter.summary(),
        "resumed_from": resumed_from,
        "stopped_at": stopped_at,
        "alive_frac": plan.alive_frac(),
        "quarantine": None if quarantine is None else quarantine.summary(),
        # per-node (steps, n) error trace, screened path only: honest-node
        # tail loss apart from the quarantined nodes' solo error
        "sq_error_nodes": np.concatenate(nodes_l) if nodes_l else None,
    }
