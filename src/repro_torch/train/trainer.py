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
so a swap recaptures nothing (``n_traces`` counts the captures). The
arguments of later slices -- ``compression``, ``staleness`` / ``delays``,
``probes`` / ``pi_hat``, and a ``PoolSwap`` from the hook -- raise
``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from repro_torch.convert import params_from_numpy
from repro_torch.core.dsgd import dsgd_init, dsgd_step_stacked
from repro_torch.core.mixing import BirkhoffSchedule, PoolSwap, ScheduleArrays
from repro_torch.data.synthetic import MeanEstimationTask
from repro_torch.device import resolve_device
from repro_torch.obs.trace import Tracer

from .metrics import CommMeter, MetricLogger, consensus_distance, mix_bytes_per_step
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

# the later slices' arguments, and the ROADMAP queue-1 item that ports each
_LATER = {
    "compression": "EF-compressed gossip, item 9",
    "staleness": "bounded-delay gossip, item 10",
    "delays": "bounded-delay gossip, item 10",
    "probes": "health probes, item 8",
    "pi_hat": "health probes, item 8",
}


def _check_rollout_and_later_args(rollout: str, **later) -> None:
    if rollout not in ("scan", "loop"):
        raise ValueError(f"unknown rollout {rollout!r}")
    given = [name for name, value in later.items() if value is not None]
    if given:
        raise NotImplementedError(
            "not ported yet: " + ", ".join(f"{name} ({_LATER[name]})" for name in given)
        )


def _online_comm_meter(n_nodes: int, params_per_node: int) -> CommMeter:
    """Modeled comm meter for a data-plane (hot-swappable) schedule: the
    bytes the same run would move on a device mesh, where the
    ``ScheduleArrays`` transport is the all-gather, ``(n-1) P`` received
    per node per step (the reference's ``_online_comm_meter``)."""
    return CommMeter(per_step_bytes=mix_bytes_per_step(
        "allgather", n_nodes=n_nodes, p_total=params_per_node,
    ))


def _check_update(update) -> ScheduleArrays:
    """The hook's non-None return, which must be a ``ScheduleArrays``."""
    if isinstance(update, PoolSwap):
        raise NotImplementedError(
            "on_segment returned a PoolSwap: the staged-pool transport "
            "(mix_ppermute_pool) comes with the mesh trainer (ROADMAP queue 1 "
            "item 13); use an OnlineTopologyController without pool="
        )
    if not isinstance(update, ScheduleArrays):
        raise TypeError(
            f"on_segment must return ScheduleArrays or None, got {type(update).__name__}"
        )
    return update


def _device_mixing(W, schedule, transport: str, device: torch.device):
    """W on the device, and a static dense transport's W made once: a body
    that runs inside a CUDA graph copies nothing from the host."""
    Wt = torch.as_tensor(W, dtype=torch.float32, device=device) if W is not None else None
    if Wt is None and isinstance(schedule, BirkhoffSchedule) and transport == "dense":
        Wt = torch.as_tensor(schedule.to_matrix(), dtype=torch.float32, device=device)
    if isinstance(schedule, BirkhoffSchedule):
        schedule.operands(device)  # made and checked once, before any capture
    return Wt


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
    staleness=None,
    delays: np.ndarray | None = None,
    probes=None,
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
    where a swap landed), ``"comm"`` (the modeled all-gather bytes) and
    ``"compression"`` (None). ``tracer`` records a ``sim.segment`` span
    per segment; ``retrace_guard`` counts captures under
    ``"mean_estimation.roll"``.
    """
    _check_rollout_and_later_args(
        rollout, compression=compression, staleness=staleness, delays=delays,
        probes=probes, pi_hat=pi_hat,
    )
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
    # as in the reference, only the online run is segmented
    seg = int(segment_len) if online and segment_len is not None else max(steps, 1)
    if seg < 1:
        raise ValueError(f"segment_len must be >= 1, got {segment_len}")
    tracer = _NULL_TRACER if tracer is None else tracer

    theta = torch.zeros((n, 1), device=device)  # static: every body continues it
    state = dsgd_init(theta)
    Wt = _device_mixing(W, schedule, transport, device)
    theta_star = torch.tensor(task.theta_star, dtype=torch.float32, device=device)
    runner = SegmentRunner("mean_estimation.roll", device, captured=rollout == "scan",
                           retrace_guard=retrace_guard)
    sched = runner.swap(schedule) if online else schedule

    def make_body(k: int, sched):
        z_in = torch.empty((k,) + tuple(zs_t.shape[1:]), device=device)
        errs = torch.empty((k, 3), device=device)

        def body() -> None:
            th = theta
            for j in range(k):
                grads = 2.0 * (th - z_in[j].mean(dim=1, keepdim=True))
                th, _ = dsgd_step_stacked(
                    th, grads, state, Wt, lr,
                    use_kernel=use_kernel, schedule=sched, transport=transport,
                )
                err = torch.square(th[:, 0] - theta_star)
                errs[j] = torch.stack([err.mean(), err.max(), err.min()])
            theta.copy_(th)

        return body, z_in, errs

    def fill(z_in, t, k):
        z_in.copy_(zs_t[t : t + k])

    traces: list[np.ndarray] = []
    swaps: list[int] = []
    meter = _online_comm_meter(n, 1) if online else None
    t0 = 0
    while t0 < steps:
        length = min(seg, steps - t0)
        with tracer.span("sim.segment", t0=t0, k=length):
            errs = runner.run_segment(t0, length, sched, make_body, fill)
            traces.append(errs.cpu().numpy())
        if meter is not None:
            meter.tick(length)
        t0 += length
        if on_segment is not None and t0 < steps:
            # no hook after the final segment: a refresh triggered there
            # would burn a warm solve whose schedule nothing executes
            update = on_segment(t0 - 1)
            if update is not None:
                sched = runner.swap(_check_update(update))
                swaps.append(t0 - 1)
    trace = np.concatenate(traces) if traces else np.zeros((0, 3), np.float32)
    out = {
        "mean_sq_error": trace[:, 0],
        "max_sq_error": trace[:, 1],
        "min_sq_error": trace[:, 2],
        "theta": theta.cpu().numpy(),
    }
    if online:
        out.update(n_traces=runner.n_traces, swaps=swaps, comm=meter.summary(),
                   compression=None)
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
    staleness=None,
    delays: np.ndarray | None = None,
    probes=None,
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
    all-gather bytes) and ``compression`` (None). ``tracer`` records a
    ``sim.segment`` span per segment; ``retrace_guard`` counts captures
    under ``"classification.roll"``.

    Random draws come from ``torch.Generator``s seeded from ``seed``: the
    initial parameters from a CPU generator (``seed``, so every device
    starts alike) and the minibatch indices from one on the device
    (``seed + 1``, registered with every captured graph, so both rollouts
    draw the same indices). Two seams replace them, for comparing with
    the reference on its own ``jax.random`` draws: ``params0``, a dict of
    single-node numpy arrays, and ``batch_indices``, a
    (steps, n, batch_size) integer array. ``device=None`` runs on CUDA.
    """
    _check_rollout_and_later_args(
        rollout, compression=compression, staleness=staleness, delays=delays,
        probes=probes, pi_hat=pi_hat,
    )
    device = resolve_device(device)
    online = isinstance(schedule, ScheduleArrays)
    if on_segment is not None and not online:
        raise ValueError(
            "on_segment hot-swapping needs the schedule as ScheduleArrays "
            "(a static BirkhoffSchedule is baked into the rollout)"
        )
    tracer = _NULL_TRACER if tracer is None else tracer
    n = len(indices_per_node)
    num_classes = int(np.max(y)) + 1
    dim = X.shape[1]
    data = _stack_node_data(X, y, indices_per_node, device)
    net = StackedClassifier(
        n, dim, num_classes, model=model, hidden=hidden,
        generator=torch.Generator().manual_seed(seed), params0=params0,
        device=device,
    )
    # static: every body reads and continues these
    params = {k: p.detach() for k, p in net.named_parameters()}
    state = dsgd_init(params)
    Wt = _device_mixing(W, schedule, transport, device)
    if batch_indices is not None:
        batch_idx = torch.as_tensor(np.asarray(batch_indices), dtype=torch.long, device=device)
        if batch_idx.shape != (steps, n, batch_size):
            raise ValueError(
                f"batch_indices must be (steps={steps}, n={n}, batch_size={batch_size}), "
                f"got {tuple(batch_idx.shape)}"
            )
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    # a node with no samples draws index 0 of its (empty, zero) rows, as
    # the reference's maximum(length, 1) does
    draw_len = data.lengths.clamp(min=1).to(torch.float32).unsqueeze(1)
    rows = torch.arange(n, device=device).unsqueeze(1)
    runner = SegmentRunner("classification.roll", device, captured=rollout == "scan",
                           retrace_guard=retrace_guard, generators=(gen,))
    sched = runner.swap(schedule) if online else schedule

    def make_body(k: int, sched):
        idx_in = (torch.empty((k, n, batch_size), dtype=torch.long, device=device)
                  if batch_indices is not None else None)
        losses_out = torch.empty((k,), device=device)

        def body() -> None:
            p = params
            for j in range(k):
                if idx_in is not None:
                    idx = idx_in[j]
                else:
                    u = torch.rand((n, batch_size), generator=gen, device=device)
                    idx = torch.minimum((u * draw_len).long(), (draw_len - 1).long())
                xb, yb = data.x[rows, idx], data.y[rows, idx]
                leaves = {name: v.detach().requires_grad_() for name, v in p.items()}
                losses = classifier_losses(torch.func.functional_call(net, leaves, (xb,)), yb)
                grads = torch.autograd.grad(losses.sum(), list(leaves.values()))
                p, _ = dsgd_step_stacked(
                    p, dict(zip(leaves, grads)), state, Wt, lr,
                    use_kernel=use_kernel, schedule=sched, transport=transport,
                )
                losses_out[j] = losses.detach().mean()
            for name, v in params.items():
                v.copy_(p[name])

        return body, idx_in, losses_out

    do_eval = X_test is not None
    X_t = torch.as_tensor(X_test, dtype=torch.float32, device=device) if do_eval else None
    y_t = torch.as_tensor(y_test, dtype=torch.long, device=device) if do_eval else None
    logger = MetricLogger()

    def log_segment(t0: int, losses: np.ndarray, evaluate: bool) -> None:
        for j, loss in enumerate(losses):
            t = t0 + j
            if j == len(losses) - 1 and evaluate and (t % eval_every == 0 or t == steps - 1):
                with torch.no_grad():
                    logits = torch.func.functional_call(net, params, (X_t,))
                    accs = (logits.argmax(-1) == y_t).float().mean(dim=1).cpu().numpy()
                logger.log(
                    t,
                    loss=float(loss),
                    acc_mean=float(accs.mean()),
                    acc_min=float(accs.min()),
                    acc_max=float(accs.max()),
                    consensus=float(consensus_distance(params)),
                )
            else:
                logger.log(t, loss=float(loss))

    def fill(idx_in, t, k):
        if idx_in is not None:
            idx_in.copy_(batch_idx[t : t + k])

    swaps: list[int] = []
    # on_segment needs segment boundaries even without eval data (the
    # eval calls themselves stay gated on do_eval)
    segmented = do_eval or on_segment is not None
    t0 = 0
    for seg_len, evaluate in _eval_segments(steps, eval_every, segmented):
        with tracer.span("sim.segment", t0=t0, k=seg_len):
            losses = runner.run_segment(t0, seg_len, sched, make_body, fill).cpu().numpy()
        log_segment(t0, losses, evaluate and do_eval)
        t0 += seg_len
        if on_segment is not None and t0 < steps:  # no hook after the final segment
            update = on_segment(t0 - 1)
            if update is not None:
                sched = runner.swap(_check_update(update))
                swaps.append(t0 - 1)
    logger.aux["n_traces"] = runner.n_traces
    logger.aux["swaps"] = swaps
    if online:
        meter = _online_comm_meter(n, sum(int(np.prod(p.shape[1:])) for p in params.values()))
        meter.tick(steps)
        logger.aux["comm"] = meter.summary()
        logger.aux["compression"] = None
    return logger
