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

Both run the step-by-step loop (``rollout="loop"``), keep their traces on
the device and copy them to the host once per evaluation segment. The
reference's compiled ``rollout="scan"`` has a later counterpart here, a
CUDA-graph rollout, and raises for now, as do the arguments of later
slices (online swaps, compression, staleness, probes, tracing).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from repro_torch.convert import params_from_numpy
from repro_torch.core.dsgd import dsgd_init, dsgd_step_stacked
from repro_torch.core.mixing import BirkhoffSchedule, ScheduleArrays
from repro_torch.data.synthetic import MeanEstimationTask
from repro_torch.device import resolve_device

from .metrics import MetricLogger, consensus_distance

__all__ = [
    "StackedClassifier",
    "classifier_losses",
    "run_mean_estimation",
    "run_classification",
]


def _check_rollout_and_later_args(rollout: str, **later) -> None:
    if rollout == "scan":
        raise NotImplementedError(
            "rollout='scan' (the reference's compiled lax.scan rollout) is not "
            "ported yet; its counterpart here will be a CUDA-graph rollout. "
            "Use rollout='loop'."
        )
    if rollout != "loop":
        raise ValueError(f"unknown rollout {rollout!r}")
    given = [name for name, value in later.items() if value is not None]
    if given:
        raise NotImplementedError(
            f"{', '.join(given)}: not ported yet (online swaps, compression, "
            "staleness, probes and tracing come in later slices)"
        )


def _device_schedule(schedule, device: torch.device):
    if isinstance(schedule, ScheduleArrays):
        return ScheduleArrays(schedule.gammas.to(device), schedule.perms.to(device))
    return schedule


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
    rollout: str = "loop",
    zs: np.ndarray | None = None,
    on_segment=None,
    segment_len: int | None = None,
    compression=None,
    staleness=None,
    delays: np.ndarray | None = None,
    probes=None,
    pi_hat: np.ndarray | None = None,
    tracer=None,
    retrace_guard=None,
    device: torch.device | str | None = None,
) -> dict:
    """D-SGD on ``F_i(theta, z) = (theta - z)^2``; returns error traces.

    Returns dict with 'mean_sq_error' (n^-1 ||theta - theta*||^2 per step),
    'max_sq_error', 'min_sq_error' (the paper's dashed lines), and the final
    per-node parameters 'theta'.

    The noise is presampled with numpy's ``default_rng(seed)`` in the
    reference's call sequence, so the same ``seed`` (or the same explicit
    (steps, n, batch) ``zs`` stream) drives both packages through the
    same data. ``device=None`` runs on CUDA.
    """
    _check_rollout_and_later_args(
        rollout, on_segment=on_segment, segment_len=segment_len,
        compression=compression, staleness=staleness, delays=delays,
        probes=probes, pi_hat=pi_hat, tracer=tracer, retrace_guard=retrace_guard,
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
    theta = torch.zeros((n, 1), device=device)
    state = dsgd_init(theta)
    Wt = torch.as_tensor(W, dtype=torch.float32, device=device) if W is not None else None
    schedule = _device_schedule(schedule, device)
    theta_star = torch.tensor(task.theta_star, dtype=torch.float32, device=device)
    errs = []
    for t in range(steps):
        grads = 2.0 * (theta - zs_t[t].mean(dim=1, keepdim=True))
        theta, state = dsgd_step_stacked(
            theta, grads, state, Wt, lr,
            use_kernel=use_kernel, schedule=schedule, transport=transport,
        )
        err = torch.square(theta[:, 0] - theta_star)
        errs.append(torch.stack([err.mean(), err.max(), err.min()]))
    trace = torch.stack(errs).cpu().numpy() if errs else np.zeros((0, 3), np.float32)
    return {
        "mean_sq_error": trace[:, 0],
        "max_sq_error": trace[:, 1],
        "min_sq_error": trace[:, 2],
        "theta": theta.cpu().numpy(),
    }


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
    rollout: str = "loop",
    on_segment=None,
    compression=None,
    staleness=None,
    delays: np.ndarray | None = None,
    probes=None,
    pi_hat: np.ndarray | None = None,
    tracer=None,
    retrace_guard=None,
    device: torch.device | str | None = None,
    params0: dict[str, np.ndarray] | None = None,
    batch_indices: np.ndarray | None = None,
) -> MetricLogger:
    """D-SGD classification with per-node local data (Algorithm 1).

    Logs train loss (node mean) every step and, at ``t % eval_every == 0``
    and at the last step, test accuracy min/mean/max across nodes and the
    consensus distance.

    Random draws come from ``torch.Generator``s seeded from ``seed``: the
    initial parameters from a CPU generator (``seed``, so every device
    starts alike) and the minibatch indices from one on the device
    (``seed + 1``). Two seams replace them, for comparing with the
    reference on its own ``jax.random`` draws: ``params0``, a dict of
    single-node numpy arrays, and ``batch_indices``, a
    (steps, n, batch_size) integer array. ``device=None`` runs on CUDA.
    """
    _check_rollout_and_later_args(
        rollout, on_segment=on_segment, compression=compression,
        staleness=staleness, delays=delays, probes=probes, pi_hat=pi_hat,
        tracer=tracer, retrace_guard=retrace_guard,
    )
    device = resolve_device(device)
    n = len(indices_per_node)
    num_classes = int(np.max(y)) + 1
    dim = X.shape[1]
    data = _stack_node_data(X, y, indices_per_node, device)
    net = StackedClassifier(
        n, dim, num_classes, model=model, hidden=hidden,
        generator=torch.Generator().manual_seed(seed), params0=params0,
        device=device,
    )
    params = {k: p.detach() for k, p in net.named_parameters()}
    state = dsgd_init(params)
    Wt = torch.as_tensor(W, dtype=torch.float32, device=device) if W is not None else None
    schedule = _device_schedule(schedule, device)
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

    do_eval = X_test is not None
    X_t = torch.as_tensor(X_test, dtype=torch.float32, device=device) if do_eval else None
    y_t = torch.as_tensor(y_test, dtype=torch.long, device=device) if do_eval else None

    logger = MetricLogger()
    pending: list[torch.Tensor] = []  # per-step losses still on the device

    def flush(t_end: int) -> None:
        """Log the pending losses as steps ``t_end - len(pending) .. t_end - 1``."""
        if pending:
            for j, loss in enumerate(torch.stack(pending).cpu().numpy()):
                logger.log(t_end - len(pending) + j, loss=float(loss))
            pending.clear()

    for t in range(steps):
        if batch_indices is not None:
            idx = batch_idx[t]
        else:
            u = torch.rand((n, batch_size), generator=gen, device=device)
            idx = torch.minimum((u * draw_len).long(), (draw_len - 1).long())
        xb, yb = data.x[rows, idx], data.y[rows, idx]
        leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
        losses = classifier_losses(torch.func.functional_call(net, leaves, (xb,)), yb)
        grads = torch.autograd.grad(losses.sum(), list(leaves.values()))
        grads = dict(zip(leaves, grads))
        params, state = dsgd_step_stacked(
            params, grads, state, Wt, lr,
            use_kernel=use_kernel, schedule=schedule, transport=transport,
        )
        pending.append(losses.detach().mean())
        if do_eval and (t % eval_every == 0 or t == steps - 1):
            loss_t = pending.pop()
            flush(t)
            with torch.no_grad():
                logits = torch.func.functional_call(net, params, (X_t,))
                accs = (logits.argmax(-1) == y_t).float().mean(dim=1).cpu().numpy()
            logger.log(
                t,
                loss=float(loss_t),
                acc_mean=float(accs.mean()),
                acc_min=float(accs.min()),
                acc_max=float(accs.max()),
                consensus=float(consensus_distance(params)),
            )
    flush(steps)
    return logger
