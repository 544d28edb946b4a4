"""D-SGD (paper, Algorithm 1) on stacked per-node parameters, in PyTorch.

The algorithm, per node i at step t:

    theta_i^{t+1/2} = theta_i^t - eta_t * grad F_i(theta_i^t, Z_i^t)
    theta_i^{t+1}   = sum_j W_ij^t theta_j^{t+1/2}

This is the *stacked* form of the n-node simulator: leaves carry a
leading node axis and the mixing runs through ``mixing.mix_stacked``
(dense W, a static ``BirkhoffSchedule`` or ``ScheduleArrays``), with
optional heavy-ball momentum applied locally, or through the EF-compressed
transport (``compression.ef_mix_schedule_arrays``) when an EF memory is
given. ``dsgd_step_sharded`` is the reference's per-shard form: one node
per rank of a ``torch.distributed`` group, mixing by ``mix_ppermute``
(a static schedule) or ``mix_allreduce`` (the complete graph).
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from .mixing import (
    BirkhoffSchedule,
    ScheduleArrays,
    mix_allreduce,
    mix_ppermute,
    mix_stacked,
    tree_map,
)

__all__ = ["DSGDState", "dsgd_init", "dsgd_step_stacked", "dsgd_step_sharded"]

PyTree = Any


class DSGDState(NamedTuple):
    """Optimizer state: step count and (optional) per-node momentum."""

    step: int
    momentum: PyTree | None


def dsgd_init(params: PyTree, momentum: float = 0.0) -> DSGDState:
    mom = None
    if momentum > 0.0:
        mom = tree_map(torch.zeros_like, params)
    return DSGDState(step=0, momentum=mom)


def _local_update(params, grads, state, lr, momentum):
    """The local gradient half-step theta^{t+1/2}."""
    if state.momentum is not None:
        new_mom = tree_map(lambda m, g: momentum * m + g, state.momentum, grads)
        half = tree_map(lambda p, m: p - lr * m, params, new_mom)
    else:
        new_mom = None
        half = tree_map(lambda p, g: p - lr * g, params, grads)
    return half, new_mom


def dsgd_step_stacked(
    params_stack: PyTree,
    grads_stack: PyTree,
    state: DSGDState,
    W,
    lr: float | torch.Tensor,
    momentum: float = 0.0,
    use_kernel: bool = False,
    schedule: BirkhoffSchedule | ScheduleArrays | None = None,
    transport: str = "auto",
    single_buffer: bool = False,
    ef: PyTree | None = None,
    compression=None,
) -> tuple[PyTree, DSGDState] | tuple[PyTree, DSGDState, PyTree]:
    """One D-SGD iteration on stacked per-node parameters (simulator form).

    Args:
      params_stack / grads_stack: tensors or dicts of tensors with leading
        node axis n.
      W: (n, n) doubly-stochastic mixing matrix (may differ per call). May
        be None when ``schedule`` is given.
      lr: stepsize eta_t.
      momentum: heavy-ball coefficient (0 = the paper's plain D-SGD).
      use_kernel: on the CPU, reproduce the kernels' numerics; on a CUDA
        tensor the mix runs in the kernels either way (see ``mixing``).
      schedule: Birkhoff decomposition of W (``BirkhoffSchedule`` or
        ``ScheduleArrays``); ``transport`` ("auto" | "dense" | "schedule")
        picks between it and the dense path.
      single_buffer: on the CPU schedule transport, mix one raveled buffer.
      ef / compression: EF-compressed gossip. With ``ef`` (a pytree of
        per-node error-feedback memories, see ``compression.ef_init``) the
        half-step mixes through ``compression.ef_mix_schedule_arrays``
        under the ``compression`` wire format and the call returns a
        triple ``(params, state, new_ef)``. Requires the schedule as
        ``ScheduleArrays``.
    """
    half, new_mom = _local_update(params_stack, grads_stack, state, lr, momentum)
    if ef is not None:
        from .compression import ef_mix_schedule_arrays

        if not isinstance(schedule, ScheduleArrays):
            raise ValueError(
                "EF-compressed stacked mixing needs the schedule as "
                "ScheduleArrays (the hot-swappable data plane); a static "
                "BirkhoffSchedule or dense-W path carries no EF memory"
            )
        mixed, new_ef = ef_mix_schedule_arrays(half, ef, schedule, compression,
                                               use_kernel=use_kernel)
        return mixed, DSGDState(step=state.step + 1, momentum=new_mom), new_ef
    if compression is not None:
        raise ValueError("compression without ef: pass ef=ef_init(params)")
    mixed = mix_stacked(
        half,
        W=W,
        schedule=schedule,
        transport=transport,
        use_kernel=use_kernel,
        single_buffer=single_buffer,
    )
    return mixed, DSGDState(step=state.step + 1, momentum=new_mom)


def dsgd_step_sharded(
    params: PyTree,
    grads: PyTree,
    state: DSGDState,
    schedule: BirkhoffSchedule | None,
    group=None,
    lr: float | torch.Tensor = 1e-3,
    momentum: float = 0.0,
) -> tuple[PyTree, DSGDState]:
    """One D-SGD iteration with one node per rank of ``group`` (None: the
    world): this rank's parameters and gradients, no node axis.
    ``schedule=None`` is complete-graph mixing (the C-PSGD all-reduce)."""
    half, new_mom = _local_update(params, grads, state, lr, momentum)
    if schedule is None:
        mixed = mix_allreduce(half, group)
    else:
        mixed = mix_ppermute(half, schedule, group)
    return mixed, DSGDState(step=state.step + 1, momentum=new_mom)
