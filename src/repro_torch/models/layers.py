"""Shared layers: RMS and layer norms, rotary and sinusoidal positions,
MLPs, embedding tables.

Each parameterised piece is an ``nn.Module`` whose parameters carry the
reference's pytree names (``scale``, ``bias``; ``w_gate`` / ``w_up`` / ``w_down``;
``table`` / ``unembed``), stored as the reference stores them: weights as
(in, out) matrices used as ``x @ W``. The functions keep the reference's
names and signatures, with the module in place of the params dict.

A module is built with uninitialised weights on an explicit device;
``init_weights(generator)`` draws them (``init_*`` does both), and
``repro_torch.convert.lm_params_from_numpy`` loads them instead.
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch import nn

from .common import ModelConfig, YarnConfig, dtype_of, truncated_normal_, yarn_mscale

__all__ = [
    "RMSNorm",
    "LayerNorm",
    "MLP",
    "Embedding",
    "rms_norm",
    "init_rms_norm",
    "layer_norm",
    "init_layer_norm",
    "rotary_embedding",
    "yarn_inv_freq",
    "yarn_correction_range",
    "apply_rope",
    "sinusoidal_positions",
    "causal_conv1d",
    "init_mlp",
    "mlp_forward",
    "init_embedding",
    "embed",
    "unembed",
]


def _empty(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device))


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

class RMSNorm(nn.Module):
    """RMS norm with a learned ``scale`` (initialised to ones)."""

    def __init__(self, dim: int, dtype: torch.dtype, device: torch.device | str):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim, dtype=dtype, device=device))

    def forward(self, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
        return rms_norm(self, x, eps)


def init_rms_norm(dim: int, dtype: torch.dtype, device: torch.device | str) -> RMSNorm:
    return RMSNorm(dim, dtype, device)


def rms_norm(params: RMSNorm, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """``x / rms(x) * scale``, computed in float32 and cast back to x's dtype."""
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    normed = x32 * torch.rsqrt(var + eps)
    return (normed * params.scale.float()).to(x.dtype)


class LayerNorm(nn.Module):
    """Layer norm with a learned ``scale`` (ones) and ``bias`` (zeros)."""

    def __init__(self, dim: int, dtype: torch.dtype, device: torch.device | str):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim, dtype=dtype, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, dtype=dtype, device=device))


def init_layer_norm(dim: int, dtype: torch.dtype, device: torch.device | str) -> LayerNorm:
    return LayerNorm(dim, dtype, device)


def layer_norm(params: LayerNorm, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """``(x - mean) / sqrt(var + eps) * scale + bias``, statistics in float32,
    cast back to x's dtype."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, unbiased=False, keepdim=True)
    normed = (x32 - mean) * torch.rsqrt(var + eps)
    return (normed * params.scale.float() + params.bias.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------

def rotary_embedding(
    positions: torch.Tensor, head_dim: int, theta: float, scaling: YarnConfig | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) of shape ``positions.shape + (head_dim // 2,)``, float32;
    with ``scaling`` the YaRN frequencies (``yarn_inv_freq``), cos and sin
    times ``mscale(factor, mscale) / mscale(factor, mscale_all_dim)``."""
    if scaling is None:
        exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=positions.device) / head_dim
        freqs = 1.0 / (theta**exps)
    else:
        freqs = yarn_inv_freq(head_dim, theta, scaling, positions.device)
    angles = positions.to(torch.float32)[..., None] * freqs
    if scaling is None:
        return torch.cos(angles), torch.sin(angles)
    m = yarn_mscale(scaling.factor, scaling.mscale) / yarn_mscale(scaling.factor,
                                                                   scaling.mscale_all_dim)
    return torch.cos(angles) * m, torch.sin(angles) * m


def yarn_correction_range(head_dim: int, theta: float, s: YarnConfig) -> tuple[int, int]:
    """YaRN's (low, high) dims: ``dim(r) = D ln(L0 / (2 pi r)) / (2 ln theta)``
    at r = beta_fast (floored) and r = beta_slow (ceiled), clamped to [0, D - 1]."""
    def dim(rotations: float) -> float:
        return head_dim * math.log(s.original_max_position_embeddings
                                   / (rotations * 2 * math.pi)) / (2 * math.log(theta))

    return (max(math.floor(dim(s.beta_fast)), 0),
            min(math.ceil(dim(s.beta_slow)), head_dim - 1))


def yarn_inv_freq(head_dim: int, theta: float, s: YarnConfig,
                  device: torch.device | str = "cpu") -> torch.Tensor:
    """(head_dim / 2,) float32 YaRN inverse frequencies on ``device`` (made
    there: no host copy, so a captured step can make them): for pair i,
    ``theta^(-2i/D) (m_i + (1 - m_i) / factor)``, ``m_i = 1 - clamp((i - low)
    / (high - low), 0, 1)`` (DeepSeek-V2's ``DeepseekV2YarnRotaryEmbedding``)."""
    low, high = yarn_correction_range(head_dim, theta, s)
    extra = 1.0 / theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
                            / head_dim)
    span = (high - low) if high != low else 0.001
    ramp = ((torch.arange(head_dim // 2, dtype=torch.float32, device=device) - low)
            / span).clamp(0, 1)
    keep = 1.0 - ramp
    return extra / s.factor * (1.0 - keep) + extra * keep


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate split halves (not interleaved pairs). x: (..., S, H, D);
    cos/sin: (..., S, D/2) broadcast over H. Computed in float32 (the
    reference's type promotion), returned in x's dtype."""
    x1, x2 = x.chunk(2, dim=-1)
    c = cos[..., None, :]
    s = sin[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


def sinusoidal_positions(length: int, dim: int, dtype: torch.dtype,
                         device: torch.device | str = "cpu") -> torch.Tensor:
    """Whisper-style fixed sinusoidal position table (length, dim): sin in
    the even columns, cos in the odd ones; computed in float32, cast to
    ``dtype``."""
    pos = torch.arange(length, dtype=torch.float32, device=device)[:, None]
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=device)
    div = torch.exp(-math.log(10000.0) * exps / dim)
    tab = torch.zeros((length, dim), dtype=torch.float32, device=device)
    tab[:, 0::2] = torch.sin(pos * div)
    tab[:, 1::2] = torch.cos(pos * div)
    return tab.to(dtype)


# ---------------------------------------------------------------------------
# Causal conv (the recurrent blocks: RG-LRU, mLSTM)
# ---------------------------------------------------------------------------

def causal_conv1d(x: torch.Tensor, w: torch.Tensor, state: torch.Tensor | None = None):
    """Depthwise causal conv. x: (B,S,C); w: (width, C); the taps summed in
    x's dtype, in tap order.

    Returns (y, new_state) where state caches the last ``width-1`` inputs
    for decode. With ``state=None`` the sequence is left-padded with zeros.
    """
    width = w.shape[0]
    if state is None:
        pad = torch.zeros((x.shape[0], width - 1, x.shape[2]), dtype=x.dtype, device=x.device)
    else:
        pad = state
    xp = torch.cat([pad, x], dim=1)  # (B, S+width-1, C)
    y = sum(xp[:, i : i + x.shape[1], :] * w[i] for i in range(width))
    new_state = xp[:, -(width - 1) :, :] if width > 1 else pad
    return y, new_state


# ---------------------------------------------------------------------------
# Dense MLPs (SwiGLU / GeGLU / GeLU)
# ---------------------------------------------------------------------------

class MLP(nn.Module):
    """Gated (swiglu, geglu: ``w_gate``, ``w_up``, ``w_down``) or plain
    (gelu: ``w_up``, ``w_down``) MLP."""

    def __init__(self, cfg: ModelConfig, device: torch.device | str, d_ff: int | None = None):
        super().__init__()
        dt = dtype_of(cfg)
        self.d_model = cfg.d_model
        self.d_ff = d_ff if d_ff is not None else cfg.d_ff
        self.gated = cfg.mlp_type in ("swiglu", "geglu")
        if self.gated:
            self.w_gate = _empty((self.d_model, self.d_ff), dt, device)
        self.w_up = _empty((self.d_model, self.d_ff), dt, device)
        self.w_down = _empty((self.d_ff, self.d_model), dt, device)

    def init_weights(self, generator: torch.Generator) -> None:
        std_in, std_out = self.d_model**-0.5, self.d_ff**-0.5
        if self.gated:
            truncated_normal_(self.w_gate, std_in, generator)
        truncated_normal_(self.w_up, std_in, generator)
        truncated_normal_(self.w_down, std_out, generator)


def init_mlp(
    cfg: ModelConfig, *, generator: torch.Generator, device: torch.device | str,
    d_ff: int | None = None,
) -> MLP:
    mlp = MLP(cfg, device, d_ff)
    mlp.init_weights(generator)
    return mlp


def mlp_forward(params: MLP, x: torch.Tensor, mlp_type: str, tp=None) -> torch.Tensor:
    """The MLP; ``tp`` (a ``parallel.TPGroup`` where the rules split it):
    ``w_gate`` / ``w_up`` by columns, ``w_down`` by rows, the partial sums
    reduced."""
    from . import parallel as P

    x = P.copy_to(x, tp)
    if mlp_type == "swiglu":
        gate = F.silu(x @ params.w_gate)
        out = (gate * (x @ params.w_up)) @ params.w_down
    elif mlp_type == "geglu":
        gate = F.gelu(x @ params.w_gate, approximate="tanh")
        out = (gate * (x @ params.w_up)) @ params.w_down
    elif mlp_type == "gelu":
        out = F.gelu(x @ params.w_up, approximate="tanh") @ params.w_down
    else:
        raise ValueError(f"unknown mlp_type {mlp_type}")
    return P.reduce_from(out, tp)


# ---------------------------------------------------------------------------
# Embeddings
# ---------------------------------------------------------------------------

class Embedding(nn.Module):
    """Token ``table`` (V, d); an ``unembed`` (d, V) matrix when untied."""

    def __init__(self, cfg: ModelConfig, device: torch.device | str):
        super().__init__()
        dt = dtype_of(cfg)
        self.d_model = cfg.d_model
        self.table = _empty((cfg.vocab_size, cfg.d_model), dt, device)
        if not cfg.tie_embeddings:
            self.unembed = _empty((cfg.d_model, cfg.vocab_size), dt, device)

    def init_weights(self, generator: torch.Generator) -> None:
        truncated_normal_(self.table, 0.02, generator)
        if hasattr(self, "unembed"):
            truncated_normal_(self.unembed, self.d_model**-0.5, generator)


def init_embedding(
    cfg: ModelConfig, *, generator: torch.Generator, device: torch.device | str
) -> Embedding:
    emb = Embedding(cfg, device)
    emb.init_weights(generator)
    return emb


def embed(params: Embedding, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Table lookup; gemma's ``sqrt(d)`` scale is rounded to the table's
    dtype first, as the reference does (50.5, not 50.596, in bfloat16)."""
    x = F.embedding(tokens, params.table)
    if cfg.embedding_scale:
        x = x * _rounded(cfg.d_model**0.5, x.dtype)
    return x


@functools.cache
def _rounded(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype``, as a host float: a scalar operand,
    so the product needs no host-to-device copy (a captured decode step
    may hold none)."""
    return torch.tensor(value, dtype=dtype).item()


def unembed(params: Embedding, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if cfg.tie_embeddings:
        logits = x @ params.table.T
    else:
        logits = x @ params.unembed
    if cfg.final_logit_softcap > 0.0:
        cap = cfg.final_logit_softcap
        logits = cap * torch.tanh(logits / cap)
    return logits
