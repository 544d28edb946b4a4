"""Plain PyTorch version of the RG-LRU linear scan: h_t = a_t * h_{t-1} + b_t."""

from __future__ import annotations

import torch

__all__ = ["rglru_scan_ref"]


def rglru_scan_ref(
    a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor | None = None
) -> torch.Tensor:
    """Elementwise linear recurrence over axis 1.

    a, b: (B, S, D) coefficients; h0: optional (B, D) initial state.
    Returns h: (B, S, D) in a's dtype, with h_t = a_t * h_{t-1} + b_t and
    h_{-1} = h0 or 0. Computed in float32 as a Hillis-Steele scan of the
    reference's combine ``(a1, b1), (a2, b2) -> (a1 a2, a2 b1 + b2)``:
    log2(S) whole-tensor steps, the plain-PyTorch form of its
    ``associative_scan`` (the order of the products differs, so results
    agree to rounding, not bitwise).
    """
    if a.shape != b.shape or a.ndim != 3:
        raise ValueError(f"bad shapes a={tuple(a.shape)} b={tuple(b.shape)}")
    A = a.float()
    H = b.float()
    if h0 is not None:
        H = torch.cat([H[:, :1] + A[:, :1] * h0.float()[:, None], H[:, 1:]], dim=1)
    S = a.shape[1]
    shift = 1
    while shift < S:
        H = torch.cat([H[:, :shift], A[:, shift:] * H[:, :-shift] + H[:, shift:]], dim=1)
        A = torch.cat([A[:, :shift], A[:, shift:] * A[:, :-shift]], dim=1)
        shift *= 2
    return H.to(a.dtype)
