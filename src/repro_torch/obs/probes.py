"""In-rollout health probes: the paper's quantities as per-step outputs.

The quantities the theory says predict convergence, computed inside a
captured rollout body as pure value computations on its tensors -- a
health sample at every step, no host round trip, no extra capture:

* ``consensus`` -- consensus distance ``||Theta - Theta_bar||_F^2``
  (Lemma 3), on the post-mix stacked parameters.
* ``grad_dev``  -- per-node gradient deviation
  ``(1/n) sum_i ||g_i - g_bar||^2``, the streaming proxy for Assumption
  4's H(theta).
* ``tau_bar``   -- Proposition 2's ``tau_bar^2`` at the live
  label-histogram estimate Pi_hat and the schedule the body mixes with:
  ``K B / n ||W Pi_hat - 1 pibar^T||_F^2 + sigma^2/n ||W - J||_F^2``,
  straight off the :class:`ScheduleArrays` without densifying W. On the
  card ``W Pi_hat`` is one ``gossip_schedule`` launch on the (n, K)
  operand, its rows padded to the kernel's alignment.

:class:`HealthProbes` selects which probes a rollout emits; ``names()``
fixes the output order the drivers and reports agree on. Sums are in
float32.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.core.mixing import (
    KERNEL_ROW_ALIGN,
    ScheduleArrays,
    _mix_arrays_flat,
    ravel_stack,
    tree_leaves,
)
from repro_torch.kernels.gossip_mix import ops as gossip_ops

PyTree = Any

__all__ = [
    "HealthProbes",
    "consensus_sq",
    "grad_deviation_sq",
    "mix_pi_arrays",
    "w_frobenius_sq",
    "w_minus_j_frobenius_sq",
    "tau_bar_arrays",
    "compute_probes",
]


@dataclasses.dataclass(frozen=True)
class HealthProbes:
    """Which health quantities a captured rollout emits per step.

    ``tau_bar`` needs the run to carry a ``ScheduleArrays`` plus a Pi_hat
    operand and the Prop. 2 constants ``B`` / ``sigma2``.
    """

    consensus: bool = True
    grad_dev: bool = True
    tau_bar: bool = False
    B: float = 1.0
    sigma2: float = 0.0

    def __post_init__(self):
        if self.tau_bar and self.B < 0.0:
            raise ValueError(f"B must be >= 0, got {self.B}")
        if self.tau_bar and self.sigma2 < 0.0:
            raise ValueError(f"sigma2 must be >= 0, got {self.sigma2}")
        if not (self.consensus or self.grad_dev or self.tau_bar):
            raise ValueError(
                "HealthProbes with every probe disabled -- pass probes=None "
                "instead of an empty config"
            )

    def names(self) -> tuple[str, ...]:
        """Probe output ordering (the contract between rollout and report)."""
        out = []
        if self.consensus:
            out.append("consensus")
        if self.grad_dev:
            out.append("grad_dev")
        if self.tau_bar:
            out.append("tau_bar")
        return tuple(out)


def _deviation_sq(tree: PyTree) -> torch.Tensor:
    """``sum_leaves ||X - X_bar||_F^2`` over the node axis: the mean, then
    the squared deviations, as the reference sums them. (One
    ``torch.var`` pass a leaf, tried, ran slower on an H100.)"""
    leaves = tree_leaves(tree)
    total = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    for leaf in leaves:
        mean = leaf.mean(dim=0, keepdim=True)
        total = total + torch.sum(torch.square((leaf - mean).to(torch.float32)))
    return total


def consensus_sq(params_stack: PyTree) -> torch.Tensor:
    """``||Theta - Theta_bar||_F^2`` over node-stacked parameters (the
    math of ``train.metrics.consensus_distance``)."""
    return _deviation_sq(params_stack)


def grad_deviation_sq(grads_stack: PyTree) -> torch.Tensor:
    """``(1/n) sum_i ||g_i - g_bar||^2`` over node-stacked gradients."""
    return _deviation_sq(grads_stack) / tree_leaves(grads_stack)[0].shape[0]


def mix_pi_arrays(arrays: ScheduleArrays, pi: torch.Tensor) -> torch.Tensor:
    """``W @ Pi`` straight from the Birkhoff atoms: ``(n, K)``.

    ``(W Pi)[i, k] = sum_l gamma_l Pi[perms[l, i], k]``, summed in
    float32 in atom order. On a CUDA tensor this is one
    ``gossip_schedule`` launch on Pi with its rows padded with zeros to a
    multiple of ``KERNEL_ROW_ALIGN`` (the kernel's arithmetic is the
    plain sum's, bit for bit).
    """
    pi = pi.to(torch.float32)
    if pi.is_cuda:
        padded, _ = ravel_stack(pi, pad_to=KERNEL_ROW_ALIGN)
        out = gossip_ops.gossip_schedule(padded, arrays.gammas, arrays.perms)
        return out[:, : pi.shape[1]]
    return _mix_arrays_flat(pi, ScheduleArrays(arrays.gammas.to(torch.float32), arrays.perms))


def w_frobenius_sq(arrays: ScheduleArrays) -> torch.Tensor:
    """``||W||_F^2`` from the atoms: ``g^T E g`` with
    ``E[l, m] = #{i : perms[l, i] == perms[m, i]}`` -- O(L^2 n), no (n, n)
    densification."""
    eq = torch.sum(arrays.perms[:, None, :] == arrays.perms[None, :, :], dim=-1).to(torch.float32)
    g = arrays.gammas.to(torch.float32)
    return g @ eq @ g


def w_minus_j_frobenius_sq(arrays: ScheduleArrays) -> torch.Tensor:
    """``||W - 11^T/n||_F^2 = ||W||_F^2 - 1`` for doubly stochastic W,
    clamped at 0 against round-off when W is exactly J."""
    return torch.clamp(w_frobenius_sq(arrays) - 1.0, min=0.0)


def tau_bar_arrays(
    arrays: ScheduleArrays,
    pi_hat: torch.Tensor,
    B: float,
    sigma2: float,
) -> torch.Tensor:
    """Proposition 2's ``tau_bar^2`` at (schedule, Pi_hat):

    ``K B / n * sum_{k,i} ((W Pi)_ik - pibar_k)^2
    + sigma^2 / n * ||W - 11^T/n||_F^2``.
    """
    pi_hat = pi_hat.to(torch.float32)
    n, K = pi_hat.shape
    resid = mix_pi_arrays(arrays, pi_hat) - pi_hat.mean(dim=0, keepdim=True)
    bias = torch.sum(torch.square(resid)) / n
    return K * B * bias + sigma2 / n * w_minus_j_frobenius_sq(arrays)


def compute_probes(
    probes: HealthProbes,
    *,
    params_stack: PyTree = None,
    grads_stack: PyTree = None,
    arrays: ScheduleArrays | None = None,
    pi_hat: torch.Tensor | None = None,
) -> dict[str, torch.Tensor]:
    """Evaluate the enabled probes; returns ``{name: scalar tensor}`` in
    ``probes.names()`` order. A missing operand for an enabled probe
    raises (a configuration error)."""
    out: dict[str, torch.Tensor] = {}
    for name in probes.names():
        if name == "consensus":
            if params_stack is None:
                raise ValueError("consensus probe needs params_stack")
            out[name] = consensus_sq(params_stack)
        elif name == "grad_dev":
            if grads_stack is None:
                raise ValueError("grad_dev probe needs grads_stack")
            out[name] = grad_deviation_sq(grads_stack)
        elif name == "tau_bar":
            if arrays is None or pi_hat is None:
                raise ValueError(
                    "tau_bar probe needs the run's ScheduleArrays and a "
                    "pi_hat operand"
                )
            out[name] = tau_bar_arrays(arrays, pi_hat, probes.B, probes.sigma2)
    return out
