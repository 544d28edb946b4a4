"""Functional optimizers (SGD / momentum / AdamW) on pytrees of tensors.

A pytree here is a tensor, or a dict / list / tuple of pytrees (dict keys
in sorted order, as ``jax.tree_util`` orders them), or None. The API is
the reference's (``repro/optim/optimizers.py``): an optimizer is an
``(init, update)`` pair, ``update(grads, state, params) -> (updates,
state)``, and ``apply_updates`` adds the updates to the parameters in
their dtype. Nothing is updated in place. ``step`` is a 0-d int32 tensor
on the parameters' device; a learning rate may be a float or a schedule
(``optim/schedule.py``) of that step.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch

PyTree = Any

__all__ = [
    "Optimizer",
    "OptState",
    "sgd",
    "adamw",
    "apply_updates",
    "global_norm",
    "clip_by_global_norm",
]


def _map(fn: Callable, tree: PyTree, *rest: PyTree) -> PyTree:
    if isinstance(tree, dict):
        return {k: _map(fn, tree[k], *(r[k] for r in rest)) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, *xs) for xs in zip(tree, *rest))
    if tree is None:
        return None
    return fn(tree, *rest)


def _leaves(tree: PyTree) -> list[torch.Tensor]:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _leaves(t)]
    return [] if tree is None else [tree]


class OptState(NamedTuple):
    step: torch.Tensor
    mu: PyTree | None  # first moment / momentum
    nu: PyTree | None  # second moment (adam only)


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[PyTree], OptState]
    update: Callable[[PyTree, OptState, PyTree], tuple[PyTree, OptState]]


def _zeros_like_tree(params: PyTree) -> PyTree:
    return _map(torch.zeros_like, params)


def _step0(params: PyTree) -> torch.Tensor:
    leaves = _leaves(params)
    device = leaves[0].device if leaves else None
    return torch.zeros((), dtype=torch.int32, device=device)


def _lr_at(learning_rate, step: torch.Tensor):
    return learning_rate(step) if callable(learning_rate) else learning_rate


def sgd(
    learning_rate: float | Callable[[torch.Tensor], torch.Tensor],
    momentum: float = 0.0,
    nesterov: bool = False,
    weight_decay: float = 0.0,
) -> Optimizer:
    """Plain / heavy-ball / Nesterov SGD with optional decoupled weight decay."""

    def init(params: PyTree) -> OptState:
        mu = _zeros_like_tree(params) if momentum > 0.0 else None
        return OptState(step=_step0(params), mu=mu, nu=None)

    def update(grads: PyTree, state: OptState, params: PyTree):
        lr = _lr_at(learning_rate, state.step)
        if weight_decay > 0.0:
            grads = _map(lambda g, p: g + weight_decay * p, grads, params)
        if momentum > 0.0:
            mu = _map(lambda m, g: momentum * m + g, state.mu, grads)
            if nesterov:
                upd = _map(lambda m, g: -lr * (momentum * m + g), mu, grads)
            else:
                upd = _map(lambda m: -lr * m, mu)
            return upd, OptState(step=state.step + 1, mu=mu, nu=None)
        upd = _map(lambda g: -lr * g, grads)
        return upd, OptState(step=state.step + 1, mu=None, nu=None)

    return Optimizer(init=init, update=update)


def adamw(
    learning_rate: float | Callable[[torch.Tensor], torch.Tensor],
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    weight_decay: float = 0.0,
) -> Optimizer:
    """AdamW with bias correction and decoupled weight decay."""

    def init(params: PyTree) -> OptState:
        return OptState(step=_step0(params), mu=_zeros_like_tree(params),
                        nu=_zeros_like_tree(params))

    def update(grads: PyTree, state: OptState, params: PyTree):
        step = state.step + 1
        lr = _lr_at(learning_rate, state.step)
        mu = _map(lambda m, g: b1 * m + (1 - b1) * g, state.mu, grads)
        nu = _map(lambda v, g: b2 * v + (1 - b2) * torch.square(g), state.nu, grads)
        bc1 = 1.0 - b1 ** step.to(torch.float32)
        bc2 = 1.0 - b2 ** step.to(torch.float32)

        def u(m, v, p):
            upd = (m / bc1) / (torch.sqrt(v / bc2) + eps)
            if weight_decay > 0.0:
                upd = upd + weight_decay * p
            return -lr * upd

        return _map(u, mu, nu, params), OptState(step=step, mu=mu, nu=nu)

    return Optimizer(init=init, update=update)


def apply_updates(params: PyTree, updates: PyTree) -> PyTree:
    return _map(lambda p, u: p + u.to(p.dtype), params, updates)


def global_norm(tree: PyTree) -> torch.Tensor:
    """The l2 norm of every leaf together, summed in float32."""
    leaves = _leaves(tree)
    total = sum(torch.sum(torch.square(x.to(torch.float32))) for x in leaves)
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


def clip_by_global_norm(grads: PyTree, max_norm: float) -> tuple[PyTree, torch.Tensor]:
    """``grads`` scaled to a global norm of at most ``max_norm``; (grads, norm)."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-12), max=1.0)
    return _map(lambda g: g * scale, grads), norm
