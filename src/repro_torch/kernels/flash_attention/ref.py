"""Plain PyTorch version of flash attention (causal / sliding-window, GQA).

The same function as the reference's ``flash_attention/ref.py``: logits
in float32, scaled by the true ``D**-0.5`` (or the given ``scale``),
optionally tanh-softcapped, masked with -2e9, then a softmax and the
product with v.
"""

from __future__ import annotations

import torch

__all__ = ["flash_attention_ref"]

_NEG_INF = -2.0e9


def flash_attention_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
    softcap: float = 0.0,
    scale: float | None = None,
) -> torch.Tensor:
    """Reference attention. q: (B, S, H, D); k/v: (B, S, Hkv, D).

    Hkv must divide H (GQA: query head h reads kv head h // (H / Hkv)).
    Returns (B, S, H, D) in q's dtype.
    """
    B, S, H, D = q.shape
    Hkv = k.shape[2]
    groups = H // Hkv
    qg = q.reshape(B, S, Hkv, groups, D).float()
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * (D**-0.5 if scale is None
                                                                  else scale)
    if softcap > 0.0:
        logits = softcap * torch.tanh(logits / softcap)
    qpos = torch.arange(S, device=q.device)[:, None]
    kpos = torch.arange(S, device=q.device)[None, :]
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (kpos <= qpos)
    if window is not None:
        mask = mask & (kpos > qpos - window)
    logits = torch.where(mask, logits, _NEG_INF)
    probs = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    probs = probs / probs.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v.float())
    return out.reshape(B, S, H, D).to(q.dtype)
