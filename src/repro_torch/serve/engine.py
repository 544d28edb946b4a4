"""Serving engine: batched prefill + single-token greedy decode with caches.

``prefill`` runs the prompt through the model and builds the per-layer
caches (window rings for local attention, RG-LRU states); ``decode_step``
takes one new token against them; ``generate`` is the greedy host loop,
under ``torch.inference_mode()``. Prefill attention and decode are plain
PyTorch, as they are plain XLA in the reference; the RG-LRU recurrence of
the prefill goes through ``kernels.rglru_scan`` (``impl="kernel"``).

The reference's ``long_context`` mode (a window cache on every
attention layer) and ``make_serve_setup`` (its sharded dry-run serve
step) wait for the mesh slice (ROADMAP queue 1 item 13).
"""

from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.models import transformer
from repro_torch.models.common import ModelConfig
from repro_torch.models.layers import unembed

__all__ = ["prefill", "decode_step", "generate"]


def prefill(
    model: transformer.LM,
    cfg: ModelConfig,
    tokens: torch.Tensor,
    *,
    max_len: int,
) -> tuple[torch.Tensor, list]:
    """Run the prompt (B, S) through the model, building the decode cache.

    Returns (last-position logits (B, V), cache). Only the last position
    is unembedded (the reference unembeds all S and keeps the last).
    """
    B, S = tokens.shape
    cache = transformer.init_cache(cfg, B, max_len, device=tokens.device)
    pos = torch.arange(S, device=tokens.device)[None].expand(B, S)
    # impl="kernel" (the default): the RG-LRU recurrence in its kernel
    hidden, cache, _ = model(tokens, cache=cache, positions=pos, return_hidden=True)
    return unembed(model.embed, hidden[:, -1:], cfg)[:, 0], cache


def decode_step(
    model: transformer.LM,
    cfg: ModelConfig,
    token: torch.Tensor,  # (B, 1)
    position: torch.Tensor,  # (B, 1) absolute position of the new token
    cache: list,
) -> tuple[torch.Tensor, list]:
    """One new token against the cache. Returns (logits (B, V), new cache)."""
    logits, cache, _ = model(token, cache=cache, positions=position)
    return logits[:, 0], cache


def generate(
    model: transformer.LM,
    cfg: ModelConfig,
    prompt,
    *,
    max_new_tokens: int = 16,
    device: torch.device | str | None = None,
) -> torch.Tensor:
    """Greedy generation: (B, max_new_tokens) int64 tokens on ``device``.

    ``prompt`` is a (B, S) integer array or tensor; ``device`` (None =
    CUDA) must be the model's device.
    """
    device = resolve_device(device)
    model_device = next(model.parameters()).device
    if model_device.type != device.type:
        raise ValueError(f"the model is on {model_device}, generate was asked for {device}")
    if model.cfg != cfg:
        raise ValueError(f"model was built for {model.cfg.name!r}, not for this config")
    prompt = torch.as_tensor(prompt, dtype=torch.int64, device=model_device)
    B, S = prompt.shape
    with torch.inference_mode():
        logits, cache = prefill(model, cfg, prompt, max_len=S + max_new_tokens + 1)
        toks = [logits.argmax(dim=-1)[:, None]]
        for pos in range(S, S + max_new_tokens - 1):
            position = torch.full((B, 1), pos, dtype=torch.int64, device=model_device)
            logits, cache = decode_step(model, cfg, toks[-1], position, cache)
            toks.append(logits.argmax(dim=-1)[:, None])
    return torch.cat(toks, dim=1)
