"""Plain PyTorch versions of the gossip mixing kernels.

``gossip_mix_ref``: dense ``out = W @ theta``.
``gossip_schedule_ref``: Birkhoff form ``out = sum_l coeffs[l] theta[perms[l]]``.

``theta``: (n, P) stacked per-node flat parameters; ``W``: (n, n) mixing
matrix. ``out[i] = sum_j W[i, j] theta[j]`` -- the D-SGD averaging step
(Algorithm 1, line 4) over all nodes at once. Both accumulate in float32
and cast to ``theta``'s dtype, as ``repro/kernels/gossip_mix/ref.py`` does.
"""

from __future__ import annotations

import torch

__all__ = ["gossip_mix_ref", "gossip_schedule_ref"]


def gossip_mix_ref(theta: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    if theta.ndim != 2 or W.ndim != 2 or W.shape[0] != W.shape[1]:
        raise ValueError(f"bad shapes theta={tuple(theta.shape)} W={tuple(W.shape)}")
    if W.shape[1] != theta.shape[0]:
        raise ValueError("W columns must match theta rows")
    return (W.float() @ theta.float()).to(theta.dtype)


def gossip_schedule_ref(
    theta: torch.Tensor, coeffs: torch.Tensor, perms: torch.Tensor
) -> torch.Tensor:
    if theta.ndim != 2 or perms.ndim != 2 or perms.shape[1] != theta.shape[0]:
        raise ValueError(
            f"bad shapes theta={tuple(theta.shape)} perms={tuple(perms.shape)}"
        )
    x = theta.float()
    acc = torch.zeros_like(x)
    perms = perms.long()
    for l in range(perms.shape[0]):
        acc = acc + coeffs[l].float() * x[perms[l]]
    return acc.to(theta.dtype)
