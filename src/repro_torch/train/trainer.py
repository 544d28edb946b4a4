"""n-node D-SGD simulator (the paper's experimental rig), in PyTorch.

Simulates Algorithm 1 on one device: per-node parameters are stacked on a
leading node axis, local gradients come from one autograd call over all
nodes (the nodes are independent, so the gradient of the summed losses
is each node's own), and the mixing step runs through
``dsgd_step_stacked`` -- on the card, in the hand-written gossip kernels.

Two drivers, with the reference's arguments and return values:
* ``run_mean_estimation`` -- Section 6.1 / Example 1 quadratic task, with
  closed-form error tracking against theta*.
* ``run_classification``  -- Section 6.2-style label-skew classification
  (linear model or MLP, :class:`StackedClassifier`) on a partitioned
  dataset.

Both split the run into the reference's segments (``segment_len`` steps,
or the steps between two evaluation points) and run each segment as
bodies of at most ``rollout.MAX_GRAPH_STEPS`` steps that read and write
static tensors (``train/rollout.py``). ``rollout="loop"`` runs every body
step by step, eagerly; ``rollout="scan"`` -- the counterpart of the
reference's compiled ``lax.scan`` -- captures each body that runs more
than once as a CUDA graph and replays it. Both run the same operations
on the same tensors; traces stay on the device and are copied to the
host once per segment, where evaluation, logging and the ``on_segment``
hook run. The default is ``"scan"``, as in the reference: on the card
the graph replays give the loop's results bit for bit.

Online topology adaptation: with ``schedule`` as a ``ScheduleArrays``,
``on_segment(t)`` may hand back a new ``ScheduleArrays`` at a segment
boundary; it is copied into the static schedule tensors the bodies read,
so a swap recaptures nothing (``n_traces`` counts the captures).

The robustness layer rides the same bodies, each as static state of the
captured rollout (``train/rollout.py``):

* ``compression`` -- EF-compressed gossip (``core/compression.py``): the
  EF memory is a static tensor; the identity wire builds the
  uncompressed body, bitwise the uncompressed run.
* ``staleness`` / ``delays`` -- bounded-delay gossip: the half-steps are
  raveled into one (n, P) buffer (rows padded to the kernel's
  alignment) and pushed into a static ring of ``tau_max + 1`` states;
  the policy-resolved per-step schedules and delays of each segment are
  body inputs. All-zero delays give the fresh run, bitwise.
* ``probes`` / ``pi_hat`` -- health probes (``obs/probes.py``) as extra
  per-step outputs; ``pi_hat`` is a static tensor refreshed by ``copy_``
  at each boundary from the hook's live estimator. A probes-on run is
  bitwise the probes-off run.

Arguments are checked as the reference checks them, with one
difference: the port's ``rollout="loop"`` runs the same bodies eagerly,
so it takes ``staleness`` and ``probes`` too (the reference needs its
scan for them). A ``PoolSwap`` from the hook raises
``NotImplementedError``, as it cannot run in the reference's drivers
either: they put the hook's return into their scan carry, which takes a
``ScheduleArrays`` only (``repro/train/trainer.py:495-500``). The staged
pool runs with one node per rank (``train/lm_trainer.py``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from repro_torch.convert import params_from_numpy
from repro_torch.core.compression import ef_init, ef_stale_mix_flat, make_compressor
from repro_torch.core.dsgd import dsgd_init, dsgd_step_stacked
from repro_torch.core.mixing import (
    KERNEL_ROW_ALIGN,
    BirkhoffSchedule,
    PoolSwap,
    ScheduleArrays,
    StaleBuffer,
    StragglerPolicy,
    mix_schedule_arrays_stale,
    ravel_stack,
    select_transport,
    stale_push,
    straggler_stream,
    unravel_stack,
)
from repro_torch.data.synthetic import MeanEstimationTask
from repro_torch.device import resolve_device
from repro_torch.obs.probes import HealthProbes, compute_probes
from repro_torch.obs.trace import Tracer

from .metrics import (
    CommMeter,
    MetricLogger,
    consensus_distance,
    mix_bytes_per_step,
    staleness_transfer_fracs,
)
from .rollout import SegmentRunner

__all__ = [
    "StackedClassifier",
    "classifier_losses",
    "run_mean_estimation",
    "run_classification",
]

# instrumented code paths take an always-on tracer (span() bodies still
# run); callers opt in by passing a real one
_NULL_TRACER = Tracer(enabled=False)


def _check_rollout(rollout: str) -> None:
    if rollout not in ("scan", "loop"):
        raise ValueError(f"unknown rollout {rollout!r}")


def _check_staleness_args(staleness, delays, steps, n, online):
    """Validate and normalize the (staleness, delays) pair of both
    drivers. Returns the (steps, n) int32 raw-delay trace, or None when
    no policy is given."""
    if staleness is None:
        if delays is not None:
            raise ValueError(
                "delays without staleness: pass a StragglerPolicy to say "
                "how the delay trace should be consumed (wait vs degrade)"
            )
        return None
    if not isinstance(staleness, StragglerPolicy):
        raise TypeError(
            f"staleness must be a StragglerPolicy, got {type(staleness).__name__}"
        )
    if not online:
        raise ValueError(
            "staleness rides the retrace-free data plane: pass the "
            "schedule as ScheduleArrays (a static schedule cannot carry "
            "the ring buffer / per-step delay data)"
        )
    if delays is None:
        delays = np.zeros((steps, n), np.int32)
    delays = np.asarray(delays)
    if delays.shape != (steps, n):
        raise ValueError(
            f"delays must be (steps={steps}, n={n}), got {delays.shape}"
        )
    if delays.size and delays.min() < 0:
        raise ValueError("delays must be non-negative")
    return delays.astype(np.int32)


def _check_probe_args(probes, pi_hat, n, online, staleness, device):
    """Validate the (probes, pi_hat) pair of both drivers; returns pi_hat
    as a float32 tensor on ``device`` (or None)."""
    if probes is None:
        if pi_hat is not None:
            raise ValueError(
                "pi_hat without probes: pass HealthProbes(tau_bar=True) to "
                "say what the estimate is for"
            )
        return None
    if not isinstance(probes, HealthProbes):
        raise TypeError(
            f"probes must be a HealthProbes, got {type(probes).__name__}"
        )
    if not online:
        raise ValueError(
            "health probes ride the retrace-free data plane: pass the "
            "schedule as ScheduleArrays (probe values are per-step outputs "
            "of the captured rollout)"
        )
    if staleness is not None:
        raise ValueError(
            "health probes under bounded-delay gossip are not supported "
            "yet: run probes on the fresh online path, or sample at eval "
            "boundaries under staleness"
        )
    if probes.tau_bar:
        if pi_hat is None:
            raise ValueError(
                "HealthProbes(tau_bar=True) needs pi_hat: the live (n, K) "
                "label-histogram estimate the Prop. 2 proxy is evaluated at"
            )
        pi_hat = torch.as_tensor(np.asarray(pi_hat), dtype=torch.float32, device=device)
        if pi_hat.ndim != 2 or pi_hat.shape[0] != n:
            raise ValueError(
                f"pi_hat must be (n={n}, K), got {tuple(pi_hat.shape)}"
            )
        return pi_hat
    if pi_hat is not None:
        raise ValueError("pi_hat given but probes.tau_bar is off")
    return None


def _check_compression(compression, online):
    """The wire format (None for no compression); compression needs the
    ``ScheduleArrays`` data plane."""
    compressor = make_compressor(compression)
    if compressor is not None and not online:
        raise ValueError(
            "compression rides the retrace-free data plane: pass the "
            "schedule as ScheduleArrays (static schedules have no EF carry)"
        )
    return compressor


def _live_pi_hat(on_segment):
    """The hook's live Pi estimate (an ``OnlineTopologyController``
    exposes ``.estimator.Pi_hat``), or None for hooks without one."""
    est = getattr(on_segment, "estimator", None)
    return getattr(est, "Pi_hat", None) if est is not None else None


def _staleness_meter_fracs(delays, staleness) -> tuple[float, float]:
    """Mean (delivered_frac, deferred_frac) over a (k, n) delay window --
    the :meth:`CommMeter.tick` pair, from the closed-form model."""
    fates = [
        staleness_transfer_fracs(row, staleness.tau_max, staleness.mode)
        for row in np.asarray(delays)
    ]
    on_time = float(np.mean([f[0] for f in fates])) if fates else 1.0
    deferred = float(np.mean([f[1] for f in fates])) if fates else 0.0
    return on_time + deferred, deferred


def _online_comm_meter(n_nodes: int, params_per_node: int, compression=None) -> CommMeter:
    """Modeled comm meter for a data-plane (hot-swappable) schedule: the
    bytes the same run would move on a device mesh, where the
    ``ScheduleArrays`` transport is the all-gather, ``(n-1) P`` received
    per node per step (the reference's ``_online_comm_meter``);
    ``compression`` swaps in the compressed wire layout."""
    return CommMeter(per_step_bytes=mix_bytes_per_step(
        "allgather", n_nodes=n_nodes, p_total=params_per_node,
        compression=compression,
    ))


def _check_update(update) -> ScheduleArrays:
    """The hook's non-None return, which must be a ``ScheduleArrays``."""
    if isinstance(update, PoolSwap):
        raise NotImplementedError(
            "on_segment returned a PoolSwap: the simulator drivers take ScheduleArrays "
            "only, as the reference's do (its scan carry holds a ScheduleArrays); the "
            "staged-pool transport runs with one node per rank (train.lm_trainer with "
            "group=); use an OnlineTopologyController without pool="
        )
    if not isinstance(update, ScheduleArrays):
        raise TypeError(
            f"on_segment must return ScheduleArrays or None, got {type(update).__name__}"
        )
    return update


def _device_mixing(W, schedule, transport: str, device: torch.device, params_stack):
    """W on the device, a static dense transport's W made once, and the
    transport resolved: a body that runs inside a CUDA graph copies
    nothing from the host and measures nothing. ``"auto"`` /
    ``"autotune"`` on a static schedule become ``"schedule"`` or
    ``"dense"`` here, on the host, once per run (the table looked up, or
    measured on a miss, before any capture)."""
    if schedule is None or isinstance(schedule, BirkhoffSchedule):
        transport = select_transport(transport, params_stack, W, schedule)
    Wt = torch.as_tensor(W, dtype=torch.float32, device=device) if W is not None else None
    if Wt is None and isinstance(schedule, BirkhoffSchedule) and transport == "dense":
        Wt = torch.as_tensor(schedule.to_matrix(), dtype=torch.float32, device=device)
    if isinstance(schedule, BirkhoffSchedule):
        schedule.operands(device)  # made and checked once, before any capture
    return Wt, transport


class _StaleStreams:
    """Bounded-delay inputs of a run: the ring (static, in the runner) and
    each segment's policy-resolved ``(gammas, perms, delays)``, resolved
    on the host from the current base schedule and sliced into a body's
    static inputs by :meth:`fill`."""

    def __init__(self, runner: SegmentRunner, flat0: torch.Tensor, staleness: StragglerPolicy,
                 delays: np.ndarray, base: ScheduleArrays):
        depth = staleness.ring_depth
        self.buffer = StaleBuffer(
            buf=runner.carry("ring", flat0.unsqueeze(0).repeat(depth, 1, 1)),
            head=runner.carry("head", torch.zeros((), dtype=torch.long)),
        )
        self.staleness = staleness
        self.delays = delays
        self.rebase(base)
        self.t0 = 0
        self.segment = None

    def rebase(self, base: ScheduleArrays) -> None:
        """Resolve later segments from ``base`` (kept on the host, where the
        policy repairs it)."""
        self.base = ScheduleArrays(gammas=base.gammas.detach().cpu().float(),
                                   perms=base.perms.detach().cpu().int())

    def resolve(self, t0: int, k: int) -> None:
        """Resolve steps ``t0 .. t0 + k - 1`` against the current base."""
        self.t0 = t0
        self.segment = straggler_stream(self.staleness, self.base, self.delays[t0 : t0 + k])

    def inputs(self, k: int, device) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        l_max, n = self.base.perms.shape
        return (torch.empty((k, l_max), dtype=torch.float32, device=device),
                torch.empty((k, l_max, n), dtype=torch.int32, device=device),
                torch.empty((k, n), dtype=torch.int32, device=device))

    def fill(self, inputs, t: int, k: int) -> None:
        for dst, src in zip(inputs, self.segment):
            dst.copy_(src[t - self.t0 : t - self.t0 + k])

    def tick(self, meter: CommMeter, t0: int, k: int) -> None:
        delivered, deferred = _staleness_meter_fracs(self.delays[t0 : t0 + k], self.staleness)
        meter.tick(k, delivered_frac=delivered, deferred_frac=deferred)


def _stale_mix(flat, ef, streams: _StaleStreams, inputs, j: int, compressor, payload: int,
               use_kernel: bool):
    """One bounded-delay mix of the raveled half-step ``flat`` at body step
    ``j``; returns ``(mixed, new_ef)``."""
    g_in, p_in, d_in = inputs
    sa = ScheduleArrays(gammas=g_in[j], perms=p_in[j])
    if ef is not None:
        mixed, ef, _ = ef_stale_mix_flat(flat, ef, streams.buffer, sa, d_in[j], compressor,
                                         payload=payload, use_kernel=use_kernel)
        return mixed, ef
    stale_push(streams.buffer, flat)
    return mix_schedule_arrays_stale(streams.buffer, sa, d_in[j], use_kernel=use_kernel), None


def _segment_hook(on_segment, t: int, runner: SegmentRunner, swaps: list, stale, ph_live: bool):
    """The hook after a segment ending at step ``t``: a returned schedule is
    copied into the runner's static schedule tensors (or, under staleness,
    becomes the base the next segments are resolved from); a live
    ``pi_hat`` is refreshed by ``copy_``. Returns the schedule the next
    bodies mix with, or None when unchanged."""
    update = on_segment(t)
    new = None
    if update is not None:
        update = _check_update(update)
        swaps.append(t)
        if stale is not None:
            stale.rebase(update)
        else:
            new = runner.swap(update)
    if ph_live:
        live = _live_pi_hat(on_segment)
        if live is not None:
            runner.refresh("pi_hat", np.asarray(live, np.float32))
    return new


# ---------------------------------------------------------------------------
# Section 6.1: decentralized mean estimation
# ---------------------------------------------------------------------------

def run_mean_estimation(
    task: MeanEstimationTask,
    W: np.ndarray | None,
    steps: int = 50,
    lr: float = 0.1,
    batch: int = 1,
    seed: int = 0,
    use_kernel: bool = False,
    schedule: BirkhoffSchedule | ScheduleArrays | None = None,
    transport: str = "auto",
    rollout: str = "scan",
    zs: np.ndarray | None = None,
    on_segment=None,
    segment_len: int | None = None,
    compression=None,
    staleness: StragglerPolicy | None = None,
    delays: np.ndarray | None = None,
    probes: HealthProbes | None = None,
    pi_hat: np.ndarray | None = None,
    tracer: Tracer | None = None,
    retrace_guard=None,
    device: torch.device | str | None = None,
) -> dict:
    """D-SGD on ``F_i(theta, z) = (theta - z)^2``; returns error traces.

    Returns dict with 'mean_sq_error' (n^-1 ||theta - theta*||^2 per step),
    'max_sq_error', 'min_sq_error' (the paper's dashed lines), and the final
    per-node parameters 'theta'.

    The noise is presampled with numpy's ``default_rng(seed)`` in the
    reference's call sequence, so the same ``seed`` (or the same explicit
    (steps, n, batch) ``zs`` stream, e.g. a drift scenario's) drives both
    packages through the same data. ``device=None`` runs on CUDA.

    ``rollout="scan"`` runs the captured rollout (CUDA graphs; see the
    module docstring), ``"loop"`` the same bodies eagerly. With
    ``schedule`` as a ``ScheduleArrays`` the run is segmented every
    ``segment_len`` steps; ``on_segment(t)`` is called after each segment
    but the last, and a ``ScheduleArrays`` it returns is swapped in by
    value. The result then also carries ``"n_traces"`` (captures of the
    rollout -- one per distinct body that ran more than once -- or, for
    the loop, one per distinct schedule shape), ``"swaps"`` (the steps
    where a swap landed), ``"comm"`` (the modeled all-gather bytes,
    compressed and staleness-split as the run is) and ``"compression"``
    (the wire's label, or None).

    ``compression`` (a ``Compressor`` or a spec string like ``"bf16"`` /
    ``"topk:0.25"``) mixes through the EF-compressed transport, with the
    EF memory a static tensor of the bodies. ``staleness`` (a
    ``StragglerPolicy``) turns on bounded-delay gossip on the raw
    (steps, n) ``delays`` trace (default all zero): each segment's steps
    are resolved by the policy against the current base schedule (a hook
    swap rebases it), and the half-steps mix through the ring; the
    result gains ``"staleness"``. ``probes`` (a ``HealthProbes``) adds
    ``"health"``, one (steps,) series per probe; with ``tau_bar`` it reads
    ``pi_hat``, re-snapshotted from an ``OnlineTopologyController`` hook's
    estimator at every boundary. ``tracer`` records a ``sim.segment``
    span per segment; ``retrace_guard`` counts captures under
    ``"mean_estimation.roll"``.
    """
    _check_rollout(rollout)
    device = resolve_device(device)
    n = task.n_nodes
    if zs is None:
        rng = np.random.default_rng(seed)
        zs_host = [task.sample(batch, rng) for _ in range(steps)]
        zs = np.stack(zs_host) if zs_host else np.zeros((0, n, batch))
    zs_t = torch.as_tensor(np.asarray(zs), dtype=torch.float32, device=device)
    if zs_t.ndim != 3 or zs_t.shape[0] != steps or zs_t.shape[1] != n:
        raise ValueError(
            f"zs must be (steps={steps}, n={n}, batch), got {tuple(zs_t.shape)}"
        )
    online = isinstance(schedule, ScheduleArrays)
    if on_segment is not None and not online:
        raise ValueError(
            "on_segment hot-swapping needs the schedule as ScheduleArrays "
            "(a static BirkhoffSchedule is baked into the rollout)"
        )
    compressor = _check_compression(compression, online)
    delays_arr = _check_staleness_args(staleness, delays, steps, n, online)
    pi_hat_t = _check_probe_args(probes, pi_hat, n, online, staleness, device)
    # as in the reference, only the online run is segmented
    seg = int(segment_len) if online and segment_len is not None else max(steps, 1)
    if seg < 1:
        raise ValueError(f"segment_len must be >= 1, got {segment_len}")
    tracer = _NULL_TRACER if tracer is None else tracer

    runner = SegmentRunner("mean_estimation.roll", device, captured=rollout == "scan",
                           retrace_guard=retrace_guard)
    # static: every body continues these
    theta = runner.carry("theta", torch.zeros((n, 1)))
    state = dsgd_init(theta)
    use_ef = compressor is not None and not compressor.routes_to_plain
    Wt, transport = _device_mixing(W, schedule, transport, device, theta)
    theta_star = torch.tensor(task.theta_star, dtype=torch.float32, device=device)
    stale = None
    if staleness is not None:
        flat0, _ = ravel_stack(theta, pad_to=KERNEL_ROW_ALIGN)
        stale = _StaleStreams(runner, flat0, staleness, delays_arr, schedule)
        ef = runner.carry("ef", torch.zeros_like(flat0)) if use_ef else None
        sched = schedule
    else:
        ef = runner.carry("ef", ef_init(theta)) if use_ef else None
        sched = runner.swap(schedule) if online else schedule
    ph = runner.carry("pi_hat", pi_hat_t) if pi_hat_t is not None else None
    names = probes.names() if probes is not None else ()

    def make_body(k: int, sched):
        z_in = torch.empty((k,) + tuple(zs_t.shape[1:]), device=device)
        inputs = (z_in,) + (stale.inputs(k, device) if stale is not None else ())
        errs = torch.empty((k, 3), device=device)
        health = torch.empty((k, len(names)), device=device)

        def body() -> None:
            th, e = theta, ef
            for j in range(k):
                grads = 2.0 * (th - z_in[j].mean(dim=1, keepdim=True))
                if stale is not None:
                    half = th - lr * grads
                    flat, _ = ravel_stack(half, pad_to=KERNEL_ROW_ALIGN)
                    mixed, e = _stale_mix(flat, e, stale, inputs[1:], j, compressor, 1,
                                          use_kernel)
                    th = mixed[:, :1]
                elif e is not None:
                    th, _, e = dsgd_step_stacked(
                        th, grads, state, Wt, lr, use_kernel=use_kernel, schedule=sched,
                        transport=transport, ef=e, compression=compressor,
                    )
                else:
                    th, _ = dsgd_step_stacked(
                        th, grads, state, Wt, lr,
                        use_kernel=use_kernel, schedule=sched, transport=transport,
                    )
                err = torch.square(th[:, 0] - theta_star)
                errs[j] = torch.stack([err.mean(), err.max(), err.min()])
                if names:
                    # extra outputs only: the run itself is unchanged
                    pv = compute_probes(probes, params_stack=th, grads_stack=grads,
                                        arrays=sched, pi_hat=ph)
                    health[j] = torch.stack(list(pv.values()))
            theta.copy_(th)
            if e is not None:
                ef.copy_(e)

        return body, inputs, (errs, health) if names else errs

    def fill(inputs, t, k):
        inputs[0].copy_(zs_t[t : t + k])
        if stale is not None:
            stale.fill(inputs[1:], t, k)

    traces: list[np.ndarray] = []
    series: list[np.ndarray] = []
    swaps: list[int] = []
    meter = _online_comm_meter(n, 1, compressor) if online else None
    t0 = 0
    while t0 < steps:
        length = min(seg, steps - t0)
        if stale is not None:
            stale.resolve(t0, length)
        with tracer.span("sim.segment", t0=t0, k=length):
            out = runner.run_segment(t0, length, stale.base if stale is not None else sched,
                                     make_body, fill)
            errs, health = out if names else (out, None)
            traces.append(errs.cpu().numpy())
            if health is not None:
                series.append(health.cpu().numpy())
        if stale is not None:
            stale.tick(meter, t0, length)
        elif meter is not None:
            meter.tick(length)
        t0 += length
        if on_segment is not None and t0 < steps:
            # no hook after the final segment: a refresh triggered there
            # would burn a warm solve whose schedule nothing executes
            new = _segment_hook(on_segment, t0 - 1, runner, swaps, stale, ph is not None)
            sched = new if new is not None else sched
    trace = np.concatenate(traces) if traces else np.zeros((0, 3), np.float32)
    out = {
        "mean_sq_error": trace[:, 0],
        "max_sq_error": trace[:, 1],
        "min_sq_error": trace[:, 2],
        "theta": theta.cpu().numpy(),
    }
    if online:
        out.update(n_traces=runner.n_traces, swaps=swaps, comm=meter.summary(),
                   compression=compressor.label if compressor is not None else None)
    if names:
        health = np.concatenate(series) if series else np.zeros((0, len(names)), np.float32)
        out["health"] = {name: health[:, i] for i, name in enumerate(names)}
    if staleness is not None:
        out["staleness"] = {"mode": staleness.mode, "tau_max": staleness.tau_max}
    return out


# ---------------------------------------------------------------------------
# Section 6.2: label-skew classification
# ---------------------------------------------------------------------------

class StackedClassifier(nn.Module):
    """Linear model or one-hidden-layer MLP for n nodes at once.

    Every parameter carries the node axis first, under the reference's
    names (``repro/train/trainer.py:627-651``): ``w`` (n, dim, C) and
    ``b`` (n, C) for the linear model; ``w1`` (n, dim, hidden), ``b1``,
    ``w2`` (n, hidden, C), ``b2`` for the MLP. ``forward`` is a batched
    product over nodes: x (n, B, dim) gives (n, B, C), and one shared
    x (M, dim) gives each node's logits (n, M, C).

    The initial parameters are the same on every node (theta_i^0 =
    theta^0, Algorithm 1), drawn as the reference draws them -- normal
    weights scaled by 0.01 (linear) or He-scaled (MLP), zero biases --
    from ``generator`` (a CPU ``torch.Generator``), or given as
    ``params0``: a dict of single-node numpy arrays.
    """

    def __init__(
        self,
        n_nodes: int,
        dim: int,
        num_classes: int,
        model: str = "linear",
        hidden: int = 64,
        generator: torch.Generator | None = None,
        params0: dict[str, np.ndarray] | None = None,
        device: torch.device | str | None = None,
    ):
        super().__init__()
        if model not in ("linear", "mlp"):
            raise ValueError(f"unknown model {model!r}; expected 'linear' or 'mlp'")
        device = resolve_device(device)
        if params0 is None:
            randn = lambda *shape: torch.randn(*shape, generator=generator)  # noqa: E731
            if model == "linear":
                params0 = {
                    "w": randn(dim, num_classes) * 0.01,
                    "b": torch.zeros(num_classes),
                }
            else:
                params0 = {
                    "w1": randn(dim, hidden) * (2.0 / dim) ** 0.5,
                    "b1": torch.zeros(hidden),
                    "w2": randn(hidden, num_classes) * (2.0 / hidden) ** 0.5,
                    "b2": torch.zeros(num_classes),
                }
        else:
            params0 = params_from_numpy(params0, "cpu")
        expected = {"w", "b"} if model == "linear" else {"w1", "b1", "w2", "b2"}
        if set(params0) != expected:
            raise ValueError(f"params0 for model {model!r} needs keys {sorted(expected)}")
        for name, p in params0.items():
            stacked = p.to(torch.float32).unsqueeze(0).repeat(n_nodes, *([1] * p.ndim))
            self.register_parameter(name, nn.Parameter(stacked.to(device)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if hasattr(self, "w1"):
            h = torch.relu(torch.matmul(x, self.w1) + self.b1.unsqueeze(-2))
            return torch.matmul(h, self.w2) + self.b2.unsqueeze(-2)
        return torch.matmul(x, self.w) + self.b.unsqueeze(-2)


def classifier_losses(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Per-node mean cross-entropy: logits (n, B, C), y (n, B) -> (n,)."""
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(-1, y.unsqueeze(-1)).squeeze(-1).mean(dim=-1)


@dataclasses.dataclass
class _NodeData:
    """Per-node dataset views, padded to a common length for stacking."""

    x: torch.Tensor  # (n, max_len, dim)
    y: torch.Tensor  # (n, max_len) int64
    lengths: torch.Tensor  # (n,)


def _stack_node_data(X, y, indices_per_node, device) -> _NodeData:
    n = len(indices_per_node)
    max_len = max(len(idx) for idx in indices_per_node)
    dim = X.shape[1]
    xs = np.zeros((n, max_len, dim), np.float32)
    ys = np.zeros((n, max_len), np.int64)
    lens = np.zeros((n,), np.int64)
    for i, idx in enumerate(indices_per_node):
        L = len(idx)
        xs[i, :L] = X[idx]
        ys[i, :L] = y[idx]
        lens[i] = L
        if L > 0 and L < max_len:  # cyclic pad so sampling stays uniform
            reps = idx[np.arange(max_len - L) % L]
            xs[i, L:] = X[reps]
            ys[i, L:] = y[reps]
            lens[i] = max_len
    return _NodeData(
        torch.as_tensor(xs, device=device),
        torch.as_tensor(ys, device=device),
        torch.as_tensor(lens, device=device),
    )


def _eval_segments(steps: int, eval_every: int, segmented: bool) -> list[tuple[int, bool]]:
    """Split [0, steps) into segments ending at eval points (the
    reference's ``_eval_segments``).

    Returns (segment_length, evaluate_after) pairs covering all steps in
    order, where ``evaluate_after`` marks the eval condition
    ``t % eval_every == 0 or t == steps - 1`` on the segment's last step.
    """
    if steps <= 0:
        return []
    if not segmented:
        return [(steps, False)]
    segments: list[tuple[int, bool]] = []
    start = 0
    while start < steps:
        end = start
        while end < steps - 1 and not (end % eval_every == 0 or end == steps - 1):
            end += 1
        segments.append((end - start + 1, True))
        start = end + 1
    return segments


def run_classification(
    X: np.ndarray,
    y: np.ndarray,
    indices_per_node: list[np.ndarray],
    W: np.ndarray | None,
    *,
    model: str = "linear",
    hidden: int = 64,
    steps: int = 300,
    batch_size: int = 32,
    lr: float = 0.1,
    eval_every: int = 20,
    X_test: np.ndarray | None = None,
    y_test: np.ndarray | None = None,
    seed: int = 0,
    use_kernel: bool = False,
    schedule: BirkhoffSchedule | ScheduleArrays | None = None,
    transport: str = "auto",
    rollout: str = "scan",
    on_segment=None,
    compression=None,
    staleness: StragglerPolicy | None = None,
    delays: np.ndarray | None = None,
    probes: HealthProbes | None = None,
    pi_hat: np.ndarray | None = None,
    tracer: Tracer | None = None,
    retrace_guard=None,
    device: torch.device | str | None = None,
    params0: dict[str, np.ndarray] | None = None,
    batch_indices: np.ndarray | None = None,
) -> MetricLogger:
    """D-SGD classification with per-node local data (Algorithm 1).

    Logs train loss (node mean) every step and, at ``t % eval_every == 0``
    and at the last step, test accuracy min/mean/max across nodes and the
    consensus distance. The run is segmented at those points -- also
    without test data when ``on_segment`` is given, so the hook still
    fires at ``eval_every`` boundaries -- and each segment runs as
    ``rollout="loop"`` (eager) or ``"scan"`` (CUDA graphs) bodies.

    ``on_segment(t)`` is called after each segment but the last; a
    ``ScheduleArrays`` it returns is swapped in by value (``schedule``
    must be a ``ScheduleArrays``). ``logger.aux`` records ``n_traces``
    (captures, or for the loop one per distinct schedule shape) and
    ``swaps``, and for a ``ScheduleArrays`` run ``comm`` (the modeled
    all-gather bytes) and ``compression`` (the wire's label, or None).
    ``compression``, ``staleness`` / ``delays`` and ``probes`` /
    ``pi_hat`` work as in :func:`run_mean_estimation`: under staleness
    the half-step pytree is raveled into one (n, P) buffer and mixed
    through the ring (``aux["staleness"]``); probes land in
    ``aux["health"]``. ``tracer`` records the call's spans:
    ``sim.prepare`` (its staging), a ``sim.segment`` per segment with a
    ``graph.warmup`` / ``graph.capture`` per body's first and second run
    inside, a ``sim.eval`` per evaluation and ``sim.release`` (dropping
    the bodies and their graphs at the end); while a profiler records,
    each is also a named range in its trace, with or without a tracer.
    ``retrace_guard`` counts captures under ``"classification.roll"``.

    Random draws come from ``torch.Generator``s seeded from ``seed``: the
    initial parameters from a CPU generator (``seed``, so every device
    starts alike) and the minibatch indices from one on the device
    (``seed + 1``, registered with every captured graph, so both rollouts
    draw the same indices). Two seams replace them, for comparing with
    the reference on its own ``jax.random`` draws: ``params0``, a dict of
    single-node numpy arrays, and ``batch_indices``, a
    (steps, n, batch_size) integer array. ``device=None`` runs on CUDA.
    """
    _check_rollout(rollout)
    device = resolve_device(device)
    online = isinstance(schedule, ScheduleArrays)
    if on_segment is not None and not online:
        raise ValueError(
            "on_segment hot-swapping needs the schedule as ScheduleArrays "
            "(a static BirkhoffSchedule is baked into the rollout)"
        )
    compressor = _check_compression(compression, online)
    n = len(indices_per_node)
    delays_arr = _check_staleness_args(staleness, delays, steps, n, online)
    pi_hat_t = _check_probe_args(probes, pi_hat, n, online, staleness, device)
    tracer = _NULL_TRACER if tracer is None else tracer
    # the call's staging: everything before its first segment
    with tracer.span("sim.prepare", n=n, steps=steps):
        num_classes = int(np.max(y)) + 1
        dim = X.shape[1]
        data = _stack_node_data(X, y, indices_per_node, device)
        net = StackedClassifier(
            n, dim, num_classes, model=model, hidden=hidden,
            generator=torch.Generator().manual_seed(seed), params0=params0,
            device=device,
        )
        gen = torch.Generator(device=device).manual_seed(seed + 1)
        runner = SegmentRunner("classification.roll", device, captured=rollout == "scan",
                               retrace_guard=retrace_guard, generators=(gen,), tracer=tracer)
        # static: every body reads and continues these
        params = {k: runner.carry(k, p.detach()) for k, p in net.named_parameters()}
        state = dsgd_init(params)
        use_ef = compressor is not None and not compressor.routes_to_plain
        Wt, transport = _device_mixing(W, schedule, transport, device, params)
        if batch_indices is not None:
            batch_idx = torch.as_tensor(np.asarray(batch_indices), dtype=torch.long, device=device)
            if batch_idx.shape != (steps, n, batch_size):
                raise ValueError(
                    f"batch_indices must be (steps={steps}, n={n}, batch_size={batch_size}), "
                    f"got {tuple(batch_idx.shape)}"
                )
        # a node with no samples draws index 0 of its (empty, zero) rows, as
        # the reference's maximum(length, 1) does
        draw_len = data.lengths.clamp(min=1).to(torch.float32).unsqueeze(1)
        rows = torch.arange(n, device=device).unsqueeze(1)
        stale = spec = None
        if staleness is not None:
            flat0, spec = ravel_stack(params, pad_to=KERNEL_ROW_ALIGN)
            stale = _StaleStreams(runner, flat0, staleness, delays_arr, schedule)
            ef = runner.carry("ef", torch.zeros_like(flat0)) if use_ef else None
            sched = schedule
        else:
            ef = ({k: runner.carry(f"ef.{k}", v) for k, v in ef_init(params).items()}
                  if use_ef else None)
            sched = runner.swap(schedule) if online else schedule
        ph = runner.carry("pi_hat", pi_hat_t) if pi_hat_t is not None else None
        names = probes.names() if probes is not None else ()
        do_eval = X_test is not None
        X_t = torch.as_tensor(X_test, dtype=torch.float32, device=device) if do_eval else None
        y_t = torch.as_tensor(y_test, dtype=torch.long, device=device) if do_eval else None

    def make_body(k: int, sched):
        idx_in = (torch.empty((k, n, batch_size), dtype=torch.long, device=device)
                  if batch_indices is not None else None)
        inputs = (idx_in,) + (stale.inputs(k, device) if stale is not None else ())
        losses_out = torch.empty((k,), device=device)
        health = torch.empty((k, len(names)), device=device)

        def body() -> None:
            p, e = params, ef
            for j in range(k):
                if idx_in is not None:
                    idx = idx_in[j]
                else:
                    u = torch.rand((n, batch_size), generator=gen, device=device)
                    idx = torch.minimum((u * draw_len).long(), (draw_len - 1).long())
                xb, yb = data.x[rows, idx], data.y[rows, idx]
                leaves = {name: v.detach().requires_grad_() for name, v in p.items()}
                losses = classifier_losses(torch.func.functional_call(net, leaves, (xb,)), yb)
                grads = dict(zip(leaves, torch.autograd.grad(losses.sum(), list(leaves.values()))))
                if stale is not None:
                    half = {name: p[name] - lr * grads[name] for name in p}
                    flat, _ = ravel_stack(half, pad_to=KERNEL_ROW_ALIGN)
                    mixed, e = _stale_mix(flat, e, stale, inputs[1:], j, compressor,
                                          spec.total, use_kernel)
                    p = unravel_stack(mixed, spec)
                elif e is not None:
                    p, _, e = dsgd_step_stacked(
                        p, grads, state, Wt, lr, use_kernel=use_kernel, schedule=sched,
                        transport=transport, ef=e, compression=compressor,
                    )
                else:
                    p, _ = dsgd_step_stacked(
                        p, grads, state, Wt, lr,
                        use_kernel=use_kernel, schedule=sched, transport=transport,
                    )
                losses_out[j] = losses.detach().mean()
                if names:
                    # extra outputs only: the loss trajectory is unchanged
                    pv = compute_probes(probes, params_stack=p, grads_stack=grads,
                                        arrays=sched, pi_hat=ph)
                    health[j] = torch.stack(list(pv.values()))
            for name, v in params.items():
                v.copy_(p[name])
            if isinstance(e, dict):
                for name, v in ef.items():
                    v.copy_(e[name])
            elif e is not None:
                ef.copy_(e)

        return body, inputs, (losses_out, health) if names else losses_out

    logger = MetricLogger()

    def log_segment(t0: int, losses: np.ndarray, evaluate: bool) -> None:
        for j, loss in enumerate(losses):
            t = t0 + j
            if j == len(losses) - 1 and evaluate and (t % eval_every == 0 or t == steps - 1):
                with tracer.span("sim.eval", t=t):
                    with torch.no_grad():
                        logits = torch.func.functional_call(net, params, (X_t,))
                        accs = (logits.argmax(-1) == y_t).float().mean(dim=1).cpu().numpy()
                    consensus = float(consensus_distance(params))
                logger.log(
                    t,
                    loss=float(loss),
                    acc_mean=float(accs.mean()),
                    acc_min=float(accs.min()),
                    acc_max=float(accs.max()),
                    consensus=consensus,
                )
            else:
                logger.log(t, loss=float(loss))

    def fill(inputs, t, k):
        if inputs[0] is not None:
            inputs[0].copy_(batch_idx[t : t + k])
        if stale is not None:
            stale.fill(inputs[1:], t, k)

    swaps: list[int] = []
    series: list[np.ndarray] = []
    # on_segment needs segment boundaries even without eval data (the
    # eval calls themselves stay gated on do_eval)
    segmented = do_eval or on_segment is not None
    t0 = 0
    for seg_len, evaluate in _eval_segments(steps, eval_every, segmented):
        if stale is not None:
            stale.resolve(t0, seg_len)
        with tracer.span("sim.segment", t0=t0, k=seg_len):
            out = runner.run_segment(t0, seg_len, stale.base if stale is not None else sched,
                                     make_body, fill)
            losses, health = out if names else (out, None)
            losses = losses.cpu().numpy()
            if health is not None:
                series.append(health.cpu().numpy())
        log_segment(t0, losses, evaluate and do_eval)
        t0 += seg_len
        if on_segment is not None and t0 < steps:  # no hook after the final segment
            new = _segment_hook(on_segment, t0 - 1, runner, swaps, stale, ph is not None)
            sched = new if new is not None else sched
    with tracer.span("sim.release"):
        runner.release()
    logger.aux["n_traces"] = runner.n_traces
    logger.aux["swaps"] = swaps
    if names:
        health = np.concatenate(series) if series else np.zeros((0, len(names)), np.float32)
        logger.aux["health"] = {name: health[:, i] for i, name in enumerate(names)}
    if online:
        meter = _online_comm_meter(n, sum(int(np.prod(p.shape[1:])) for p in params.values()),
                                   compressor)
        if stale is not None:
            stale.tick(meter, 0, steps)
            logger.aux["staleness"] = {"mode": staleness.mode, "tau_max": staleness.tau_max}
        else:
            meter.tick(steps)
        logger.aux["comm"] = meter.summary()
        logger.aux["compression"] = compressor.label if compressor is not None else None
    return logger
