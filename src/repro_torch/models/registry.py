"""Model registry: uniform init / loss / forward entry points per family.

Dispatches on ``cfg.arch_type``:

* decoder-only families (dense / moe / ssm / hybrid / vlm) -> ``transformer.py``
  (the VLM with its stub patch embeddings, ``batch["image_embeds"]``);
* audio (whisper) -> ``whisper.py`` (stub frame embeddings, ``batch["frames"]``).

    from repro_torch.configs import get_config
    from repro_torch.models import registry

    cfg = get_config("recurrentgemma-2b")
    model = registry.init_model(cfg, seed=0)          # on the card
    batch = registry.make_inputs(cfg, 2, 4096, device="cuda")
    with torch.inference_mode():
        loss, _ = registry.loss_fn(model, cfg, batch)  # impl="kernel"
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device

from . import transformer, whisper
from .common import ModelConfig, dtype_of

__all__ = ["init_model", "loss_fn", "model_forward", "make_inputs"]

WHISPER_MAX_TARGET = 448  # whisper's decoder length (its max target positions)


def _same_config(model, cfg: ModelConfig) -> None:
    if model.cfg != cfg:
        raise ValueError(f"model was built for {model.cfg.name!r}, not for this config")


def init_model(
    cfg: ModelConfig, *, seed: int = 0, device: torch.device | str | None = None
) -> transformer.LM | whisper.Whisper:
    """The model of ``cfg`` with weights drawn from ``seed`` on ``device``
    (None = CUDA); forward only, gradients off."""
    if cfg.arch_type == "audio":
        return whisper.init_whisper(cfg, seed=seed, device=device)
    return transformer.init_lm(cfg, seed=seed, device=device)


def model_forward(
    model,
    cfg: ModelConfig,
    batch: dict,
    *,
    cache=None,
    positions: torch.Tensor | None = None,
    window_override: int | None = None,
    impl: str = "kernel",
):
    """Uniform forward: (logits, new_cache, aux); the batch's keys depend on
    the family (see ``make_inputs``). Whisper's attention is plain on every
    path (``impl`` and ``window_override`` do not apply to it)."""
    _same_config(model, cfg)
    if cfg.arch_type == "audio":
        return whisper.whisper_forward(model, cfg, batch.get("frames"), batch["tokens"],
                                       cache=cache, positions=positions)
    return model(
        batch["tokens"], image_embeds=batch.get("image_embeds"), cache=cache,
        positions=positions, window_override=window_override, impl=impl,
    )


def loss_fn(model, cfg: ModelConfig, batch: dict, impl: str = "kernel", remat: bool = False):
    """Cross-entropy loss for any family. Returns (loss, metrics).
    ``remat`` recomputes a decoder's activations in the backward pass
    (``transformer.lm_loss``; whisper keeps them)."""
    _same_config(model, cfg)
    if cfg.arch_type == "audio":
        logits, _, aux = whisper.whisper_forward(model, cfg, batch["frames"], batch["tokens"])
        loss = transformer.softmax_xent(logits, batch["labels"])
        return loss, {"nll": loss, "aux": aux}
    return transformer.lm_loss(model, cfg, batch["tokens"], batch["labels"],
                               image_embeds=batch.get("image_embeds"), impl=impl,
                               remat=remat)


def make_inputs(
    cfg: ModelConfig,
    batch_size: int,
    seq_len: int,
    *,
    seed: int = 0,
    device: torch.device | str | None = None,
) -> dict:
    """Example inputs for (cfg, shape) on ``device`` (None = CUDA):
    ``tokens`` and ``labels``, int64 tensors drawn uniformly from the
    vocabulary with ``numpy.random.default_rng(seed)`` (the reference
    draws them with ``jax.random`` and reuses one key for both).

    For VLM configs the text length is ``max(seq_len - num_patches, 16)``,
    so the whole sequence fits the shape, and ``image_embeds`` (B,
    num_patches, d) are zeros; for audio ``seq_len`` is the decoder length,
    capped at 448, and ``frames`` (B, num_frames, d) are zeros -- both in
    the model's dtype, as the reference makes them.
    """
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    dt = dtype_of(cfg)
    out = {}
    if cfg.arch_type == "audio":
        seq_len = min(seq_len, WHISPER_MAX_TARGET)
        out["frames"] = torch.zeros((batch_size, cfg.encoder.num_frames, cfg.d_model),
                                    dtype=dt, device=device)
    elif cfg.arch_type == "vlm":
        p = cfg.vision.num_patches
        seq_len = max(seq_len - p, 16)
        out["image_embeds"] = torch.zeros((batch_size, p, cfg.d_model), dtype=dt, device=device)
    shape = (batch_size, seq_len)
    out["tokens"] = torch.as_tensor(rng.integers(0, cfg.vocab_size, shape), device=device)
    out["labels"] = torch.as_tensor(rng.integers(0, cfg.vocab_size, shape), device=device)
    return out
