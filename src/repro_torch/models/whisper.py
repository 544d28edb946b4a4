"""Whisper-style encoder-decoder backbone (arXiv:2212.04356).

As in the reference, the mel-spectrogram + conv feature extractor is a
stub: the model consumes precomputed frame embeddings of shape
``(batch, num_frames, d_model)`` (1500 frames for whisper-small). Both
stacks use sinusoidal absolute positions and pre-LayerNorm blocks with
GeLU MLPs. Every attention here is plain PyTorch (the reference passes no
``impl``, so its attention is plain XLA): the encoder's bidirectional
(``causal=False``, RoPE at angle 0, the identity), the decoder's causal
self-attention with its full cache, and ``cross_attention`` to the
encoder's states, whose keys and values are projected again at every
call, decode steps included, as the reference does.

``Whisper`` holds the reference's pytree names: ``token_embed``,
``enc_layers``, ``enc_final_ln``, ``dec_layers``, ``dec_final_ln``.

API:
  init_whisper(cfg, seed=, device=)          -> Whisper (weights drawn, no grad)
  whisper_forward(model, cfg, frames, tokens, cache=None, positions=None)
      -> (logits | hidden, new_cache, aux=0)
  encode(model, cfg, frames)                 -> encoder hidden states
  init_whisper_cache(cfg, batch, max_len, encoder_out=None, device=) -> decode cache
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.device import resolve_device

from . import parallel as P
from .attention import Attention, attention, cross_attention, init_attention_cache
from .common import ModelConfig, dtype_of, truncated_normal_
from .layers import MLP, LayerNorm, layer_norm, mlp_forward, sinusoidal_positions

__all__ = ["Whisper", "init_whisper", "whisper_forward", "encode", "init_whisper_cache",
           "encoder_layer", "decoder_layer", "MAX_POSITIONS"]

MAX_POSITIONS = 4096  # rows of the decoder's position table


class EncoderLayer(nn.Module):
    """``ln1``, ``attn``, ``ln2``, ``mlp``."""

    def __init__(self, cfg: ModelConfig, device: torch.device | str):
        super().__init__()
        dt = dtype_of(cfg)
        self.ln1 = LayerNorm(cfg.d_model, dt, device)
        self.attn = Attention(cfg, device)
        self.ln2 = LayerNorm(cfg.d_model, dt, device)
        self.mlp = MLP(cfg, device)


class DecoderLayer(nn.Module):
    """``ln1``, ``self_attn``, ``ln_cross``, ``cross_attn``, ``ln2``, ``mlp``."""

    def __init__(self, cfg: ModelConfig, device: torch.device | str):
        super().__init__()
        dt = dtype_of(cfg)
        self.ln1 = LayerNorm(cfg.d_model, dt, device)
        self.self_attn = Attention(cfg, device)
        self.ln_cross = LayerNorm(cfg.d_model, dt, device)
        self.cross_attn = Attention(cfg, device)
        self.ln2 = LayerNorm(cfg.d_model, dt, device)
        self.mlp = MLP(cfg, device)


class Whisper(nn.Module):
    """The encoder-decoder. Built with uninitialised weights on ``device``:
    ``init_whisper`` draws them, ``repro_torch.convert.lm_params_from_numpy``
    loads the reference's. The decoder's position table (``MAX_POSITIONS``
    rows, the model's dtype) is a buffer, made once."""

    def __init__(self, cfg: ModelConfig, device: torch.device | str):
        super().__init__()
        if cfg.encoder is None:
            raise ValueError(f"{cfg.name} has no encoder config")
        dt = dtype_of(cfg)
        self.cfg = cfg
        self.token_embed = nn.Parameter(
            torch.empty((cfg.vocab_size, cfg.d_model), dtype=dt, device=device))
        self.enc_layers = nn.ModuleList(
            EncoderLayer(cfg, device) for _ in range(cfg.encoder.num_layers))
        self.enc_final_ln = LayerNorm(cfg.d_model, dt, device)
        self.dec_layers = nn.ModuleList(DecoderLayer(cfg, device) for _ in range(cfg.num_layers))
        self.dec_final_ln = LayerNorm(cfg.d_model, dt, device)
        self.register_buffer("positions", sinusoidal_positions(MAX_POSITIONS, cfg.d_model, dt,
                                                               device), persistent=False)

    def init_weights(self, generator: torch.Generator) -> None:
        truncated_normal_(self.token_embed, 0.02, generator)
        for layer in self.enc_layers:
            layer.attn.init_weights(generator)
            layer.mlp.init_weights(generator)
        for layer in self.dec_layers:
            layer.self_attn.init_weights(generator)
            layer.cross_attn.init_weights(generator)
            layer.mlp.init_weights(generator)


def init_whisper(
    cfg: ModelConfig, *, seed: int = 0, device: torch.device | str | None = None
) -> Whisper:
    """A ``Whisper`` with weights drawn from ``torch.Generator(seed)`` on
    ``device`` (None = CUDA), in eval mode with gradients off."""
    device = resolve_device(device)
    model = Whisper(cfg, device)
    model.init_weights(torch.Generator(device=device).manual_seed(seed))
    return model.requires_grad_(False).eval()


def _mlp(params, cfg: ModelConfig, x: torch.Tensor, tp) -> torch.Tensor:
    return mlp_forward(params, x, "gelu", P.split(tp, params.w_down.shape[0], cfg.d_ff))


def encoder_layer(lp: EncoderLayer, cfg: ModelConfig, x: torch.Tensor, zeros: torch.Tensor,
                  tp: P.TPGroup | None = None) -> torch.Tensor:
    """One encoder layer: bidirectional self-attention (RoPE at angle 0:
    ``zeros`` positions) and the GELU MLP, layer norms with bias. ``tp``:
    a split replica's blocks where the rules split them, norms whole."""
    h = layer_norm(lp.ln1, x, cfg.norm_eps)
    out, _ = attention(lp.attn, cfg, h, positions=zeros, causal=False, impl="plain", tp=tp)
    x = x + out
    return x + _mlp(lp.mlp, cfg, layer_norm(lp.ln2, x, cfg.norm_eps), tp)


def decoder_layer(lp: DecoderLayer, cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor,
                  encoder_out: torch.Tensor, cache: dict | None = None,
                  tp: P.TPGroup | None = None) -> tuple[torch.Tensor, dict | None]:
    """One decoder layer: causal self-attention (``cache`` written in
    place), cross-attention to ``encoder_out``, the GELU MLP. Returns (x,
    the new self-attention cache). ``tp``: as in ``encoder_layer``."""
    h = layer_norm(lp.ln1, x, cfg.norm_eps)
    attn_out, new_cache = attention(lp.self_attn, cfg, h, positions=positions, cache=cache,
                                    impl="plain", tp=tp)
    x = x + attn_out
    h = layer_norm(lp.ln_cross, x, cfg.norm_eps)
    x = x + cross_attention(lp.cross_attn, cfg, h, encoder_out, tp)
    return x + _mlp(lp.mlp, cfg, layer_norm(lp.ln2, x, cfg.norm_eps), tp), new_cache


def encode(model: Whisper, cfg: ModelConfig, frames: torch.Tensor) -> torch.Tensor:
    """frames: (B, num_frames, d_model) stub embeddings -> encoder states."""
    B, S, D = frames.shape
    x = frames + sinusoidal_positions(S, D, frames.dtype, frames.device)[None]
    zeros = torch.zeros((B, S), dtype=torch.int64, device=frames.device)  # RoPE at angle 0
    for lp in model.enc_layers:
        x = encoder_layer(lp, cfg, x, zeros)
    return layer_norm(model.enc_final_ln, x, cfg.norm_eps)


def whisper_forward(
    model: Whisper,
    cfg: ModelConfig,
    frames: torch.Tensor | None,
    tokens: torch.Tensor,
    *,
    cache: dict | None = None,
    positions: torch.Tensor | None = None,
    return_hidden: bool = False,
) -> tuple[torch.Tensor, dict | None, torch.Tensor]:
    """Enc-dec forward. For decode, pass ``cache`` (which holds encoder_out;
    its self-attention caches are written in place).

    Returns (logits | hidden, new_cache, aux=0.0); ``return_hidden`` skips
    the unembedding.
    """
    if cache is None:
        if frames is None:
            raise ValueError("frames are required without a cache")
        encoder_out = encode(model, cfg, frames)
        self_caches = [None] * cfg.num_layers
    else:
        encoder_out = cache["encoder_out"]
        self_caches = cache["self"]

    B, S = tokens.shape
    x = nn.functional.embedding(tokens, model.token_embed)
    if positions is None:
        if cache is not None:
            raise ValueError("positions are required with a cache")
        positions = torch.arange(S, device=tokens.device)[None, :].expand(B, S)
    x = x + model.positions[positions]

    new_self = []
    for i, lp in enumerate(model.dec_layers):
        x, nc = decoder_layer(lp, cfg, x, positions, encoder_out, self_caches[i])
        new_self.append(nc)

    x = layer_norm(model.dec_final_ln, x, cfg.norm_eps)
    new_cache = {"encoder_out": encoder_out, "self": new_self} if cache is not None else None
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if return_hidden:
        return x, new_cache, aux
    return unembed(model, x), new_cache, aux


def unembed(model: Whisper, x: torch.Tensor) -> torch.Tensor:
    """Logits of decoder states: ``x @ token_embed.T``."""
    return x @ model.token_embed.T


def init_whisper_cache(
    cfg: ModelConfig, batch: int, max_len: int, encoder_out: torch.Tensor | None = None,
    *, device: torch.device | str | None = None,
) -> dict:
    """The decode cache: ``encoder_out`` (the given states, or a zero
    (B, num_frames, d) buffer on ``device`` (None = CUDA) to fill in place)
    and one full self-attention cache of ``max_len`` per decoder layer."""
    device = resolve_device(device if encoder_out is None else encoder_out.device)
    if encoder_out is None:
        encoder_out = torch.zeros((batch, cfg.encoder.num_frames, cfg.d_model),
                                  dtype=dtype_of(cfg), device=device)
    return {
        "encoder_out": encoder_out,
        "self": [init_attention_cache(cfg, batch, max_len, local=False, device=device)
                 for _ in range(cfg.num_layers)],
    }
