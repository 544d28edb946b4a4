"""Model registry: uniform init / loss / forward entry points per family.

Decoder-only families run through ``transformer.py``. The audio family
(whisper) and the VLM stub wait for their slices (ROADMAP queue 1
item 12) and raise ``NotImplementedError``.

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

from . import transformer
from .common import NOT_PORTED, ModelConfig

__all__ = ["init_model", "loss_fn", "model_forward", "make_inputs"]


def _same_config(model: transformer.LM, cfg: ModelConfig) -> None:
    if model.cfg != cfg:
        raise ValueError(f"model was built for {model.cfg.name!r}, not for this config")


def init_model(
    cfg: ModelConfig, *, seed: int = 0, device: torch.device | str | None = None
) -> transformer.LM:
    """The model of ``cfg`` with weights drawn from ``seed`` on ``device``
    (None = CUDA); forward only, gradients off. The audio and VLM families
    raise ``NotImplementedError``."""
    return transformer.init_lm(cfg, seed=seed, device=device)


def model_forward(
    model: transformer.LM,
    cfg: ModelConfig,
    batch: dict,
    *,
    cache: list | None = None,
    positions: torch.Tensor | None = None,
    window_override: int | None = None,
    impl: str = "kernel",
):
    """Uniform forward: (logits, new_cache, aux) for ``batch["tokens"]``."""
    _same_config(model, cfg)
    return model(
        batch["tokens"], cache=cache, positions=positions,
        window_override=window_override, impl=impl,
    )


def loss_fn(model: transformer.LM, cfg: ModelConfig, batch: dict, impl: str = "kernel"):
    """Cross-entropy loss. Returns (loss, metrics)."""
    _same_config(model, cfg)
    return transformer.lm_loss(model, cfg, batch["tokens"], batch["labels"], impl=impl)


def make_inputs(
    cfg: ModelConfig,
    batch_size: int,
    seq_len: int,
    *,
    seed: int = 0,
    device: torch.device | str | None = None,
) -> dict:
    """Example inputs for (cfg, shape): ``tokens`` and ``labels``, (B, S)
    int64 tensors on ``device`` (None = CUDA), drawn uniformly from the
    vocabulary with ``numpy.random.default_rng(seed)`` (the reference
    draws them with ``jax.random`` and reuses one key for both)."""
    if cfg.arch_type in ("audio", "vlm"):
        raise NotImplementedError(f"{cfg.arch_type} inputs: {NOT_PORTED}")
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    shape = (batch_size, seq_len)
    return {
        "tokens": torch.as_tensor(rng.integers(0, cfg.vocab_size, shape), device=device),
        "labels": torch.as_tensor(rng.integers(0, cfg.vocab_size, shape), device=device),
    }
