"""Carry weights and schedules between numpy and the port's tensors.

The reference's classifier parameters leave JAX as a dict of numpy arrays
(stacked on a node axis or not); ``params_from_numpy`` puts them on a
device so both packages compute on the same weights, and
``params_to_numpy`` brings them back. ``schedule_arrays_from_numpy``
builds a ``ScheduleArrays`` from a (gammas, perms) pair.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device

__all__ = ["params_from_numpy", "params_to_numpy", "schedule_arrays_from_numpy"]


def params_from_numpy(
    tree: dict[str, np.ndarray], device: torch.device | str | None = None
) -> dict[str, torch.Tensor]:
    """A dict of numpy arrays as a dict of tensors on ``device`` (dtypes kept)."""
    device = resolve_device(device)
    return {k: torch.from_numpy(np.array(v)).to(device) for k, v in tree.items()}  # copies


def params_to_numpy(tree: dict[str, torch.Tensor]) -> dict[str, np.ndarray]:
    """A dict of tensors as a dict of numpy arrays on the host."""
    return {k: v.detach().cpu().numpy() for k, v in tree.items()}


def schedule_arrays_from_numpy(gammas, perms, device: torch.device | str | None = None):
    """``ScheduleArrays`` on ``device`` from (L,) weights and an (L, n)
    permutation table; checks that every row is a permutation of ``0..n-1``."""
    from repro_torch.core.mixing import ScheduleArrays

    device = resolve_device(device)
    gammas = np.asarray(gammas, dtype=np.float32)
    perms = np.asarray(perms, dtype=np.int32)
    if perms.ndim != 2 or gammas.shape != (perms.shape[0],):
        raise ValueError(
            f"need gammas (L,) and perms (L, n), got {gammas.shape} and {perms.shape}"
        )
    ref = np.arange(perms.shape[1])
    for row in perms:
        if not np.array_equal(np.sort(row), ref):
            raise ValueError(f"perms row is not a permutation of {perms.shape[1]} nodes")
    return ScheduleArrays(
        gammas=torch.as_tensor(gammas, device=device),
        perms=torch.as_tensor(perms, device=device),
    )
