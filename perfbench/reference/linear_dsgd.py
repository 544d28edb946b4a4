"""Decentralised SGD of n linear classifiers (the paper's Algorithm 1),
in plain PyTorch.

Each node i holds a linear model (w (dim, C), b (C,)); at every step it
takes its minibatch (the given indices into its own samples), computes the
mean cross entropy and its gradient (written out), takes a gradient step,
and the nodes mix: theta_i <- sum_j W_ij theta_j. After the step ending at
t, for t a multiple of ``eval_every`` or the last step, each node's
accuracy on the test set and the consensus distance
sum_i ||theta_i - mean_j theta_j||^2 are recorded. A step's loss is the
mean over nodes of their minibatch losses before the step.

``precision="float32"`` is the configuration's; ``"tf32"`` is its control
(``precision.py``). ``fault=`` plants one of the faults a step can have,
for reading where each shows: ``"unchanged"`` (the step returns its
state), ``"half_batch"`` (the loss over half of each minibatch),
``"no_mix"`` (no exchange between nodes) and ``"alter"`` (each loss
reported 0.01 high).
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench.reference.precision import mm


def run(X: torch.Tensor, y: torch.Tensor, nodes: list[np.ndarray], W: np.ndarray,
        params0: dict[str, np.ndarray], batch_idx: torch.Tensor, lr: float, eval_every: int,
        X_test: torch.Tensor, y_test: torch.Tensor, precision: str = "float32",
        fault: str | None = None) -> dict:
    """The losses (steps,) and, at each evaluation, (t, acc_mean, acc_min,
    acc_max, consensus). X, y, X_test, y_test and batch_idx (steps, n, B)
    are on the device the run takes."""
    device = X.device
    n = len(nodes)
    steps = batch_idx.shape[0]
    width = max(len(s) for s in nodes)
    rows = torch.zeros((n, width), dtype=torch.long, device=device)
    for i, s in enumerate(nodes):
        rows[i, :len(s)] = torch.as_tensor(s, dtype=torch.long, device=device)
    Wt = torch.as_tensor(W, dtype=torch.float32, device=device)
    dim, C = params0["w"].shape
    # the nodes' parameters as one (n, P) matrix: w's dim * C, then b's C
    flat = torch.cat([torch.as_tensor(params0[k], dtype=torch.float32, device=device).reshape(-1)
                      for k in ("w", "b")])[None].repeat(n, 1)

    def leaves(m: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        return m[:, :dim * C].reshape(n, dim, C), m[:, dim * C:]

    node = torch.arange(n, device=device)[:, None]
    losses = torch.empty(steps, device=device)
    evals = []
    for t in range(steps):
        w, b = leaves(flat)
        sample = rows[node, batch_idx[t].to(device)]
        if fault == "half_batch":
            sample = sample[:, : sample.shape[1] // 2]
        xb, yb = X[sample], y[sample]
        logits = mm(xb, w, precision) + b[:, None, :]
        logp = torch.log_softmax(logits, dim=-1)
        losses[t] = -logp.gather(-1, yb[..., None]).mean() + (1e-2 if fault == "alter" else 0.0)
        d_logits = torch.softmax(logits, dim=-1)
        d_logits.scatter_add_(-1, yb[..., None], torch.full_like(logp[..., :1], -1.0))
        d_logits /= sample.shape[1]
        grad = torch.cat([mm(xb.transpose(1, 2), d_logits, precision).reshape(n, -1),
                          d_logits.sum(1)], dim=1)
        if fault != "unchanged":
            half = flat - lr * grad
            flat = half if fault == "no_mix" else mm(Wt, half, precision)
        if t % eval_every == 0 or t == steps - 1:
            w, b = leaves(flat)
            acc = ((mm(X_test, w, precision) + b[:, None, :]).argmax(-1) == y_test).float()
            acc = acc.mean(dim=1)
            cons = float(((flat - flat.mean(dim=0, keepdim=True)) ** 2).sum())
            evals.append((t, float(acc.mean()), float(acc.min()), float(acc.max()), cons))
    return {"losses": losses.cpu().numpy(), "evals": evals}
