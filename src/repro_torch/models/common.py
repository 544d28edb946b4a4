"""Model configuration and shared helpers for the LM stack.

One ``ModelConfig`` covers every architecture of the reference through a
per-layer block pattern (attention / local attention / mLSTM / sLSTM /
RG-LRU) plus optional MoE / MLA / encoder / vision / audio sub-configs.
The dataclasses are copies of the reference's ``models/common.py`` (same
fields, same defaults), so a config built for one package builds for the
other; the port's own fields (``PORT_FIELDS``: DeepSeek-V2-Lite's leading
dense layers, router form, sequence-wise auxiliary loss, held expert
share, flash MLA and YaRN rotary scaling) come after them, and their
defaults keep every reference config's behaviour (``reference_dict``
gives a config as the reference's dataclasses hold it). ``moe`` and
``mla`` build the MoE block and MLA attention (``models/moe.py``,
``models/attention.py``); ``encoder`` sizes whisper's encoder
(``models/whisper.py``), ``vision`` the VLM's stub patch
embeddings (``registry.make_inputs``); ``audio`` is carried as data only
(its frontend is a stub, as in the reference).

Parameters live in ``nn.Module``s (``models/layers.py`` and up), each
parameter named as the reference's pytree leaf, so the reference's
weights load by name (``repro_torch.convert.lm_params_from_numpy``).
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

__all__ = [
    "MoEConfig",
    "MLAConfig",
    "EncoderConfig",
    "VisionStubConfig",
    "AudioStubConfig",
    "ModelConfig",
    "IMPLS",
    "param_count",
    "truncated_normal_",
    "dtype_of",
    "layer_kind",
    "active_param_count",
    "YarnConfig",
    "PORT_FIELDS",
    "reference_dict",
    "yarn_mscale",
]

# full-sequence implementations: the reference's "xla" and "pallas"
IMPLS = ("plain", "kernel")


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts MLP block configuration."""

    num_experts: int
    top_k: int
    d_ff_expert: int
    num_shared_experts: int = 0
    d_ff_shared: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    # --- the port's own (DeepSeek-V2-Lite's router and expert share) ---
    norm_topk_prob: bool = True  # renormalise the top-k gate values
    routed_scaling_factor: float = 1.0  # the gate values' scale
    router_f32: bool = False  # the router product in float32 (else the model dtype)
    aux_loss: str = "switch"  # "switch" (top-1 share) | "seq" (sequence-wise, DeepSeek)
    # held_experts > 0: this device holds experts [first_expert, first_expert
    # + held_experts) of the num_experts the router scores, and runs them
    # grouped over the choices they received, dropping none; 0: every
    # expert, dispatched to capacity slots
    held_experts: int = 0
    first_expert: int = 0


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """Multi-head latent attention (DeepSeek-V2)."""

    kv_lora_rank: int = 512
    q_lora_rank: int = 0  # 0 = full-rank q projection
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    # the port's own: full-sequence attention without a cache in the flash
    # kernels under impl="kernel" (q / k / v zero-padded to a kernel head dim)
    flash: bool = False


@dataclasses.dataclass(frozen=True)
class YarnConfig:
    """YaRN rotary scaling (DeepSeek-V2's ``rope_scaling``, type ``yarn``)."""

    factor: float = 40.0
    original_max_position_embeddings: int = 4096
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    mscale: float = 0.707
    mscale_all_dim: float = 0.707


def yarn_mscale(factor: float, mscale: float) -> float:
    """``0.1 mscale ln(factor) + 1`` (1 for ``factor <= 1``)."""
    return 1.0 if factor <= 1.0 else 0.1 * mscale * math.log(factor) + 1.0


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    """Whisper-style encoder consumed via cross-attention."""

    num_layers: int
    num_frames: int  # 1500 for whisper-small (30 s audio, 50 Hz)


@dataclasses.dataclass(frozen=True)
class VisionStubConfig:
    """LLaVA-style vision stub: precomputed patch embeddings are prepended
    to the text sequence. ``num_patches`` is the anyres-tiled total."""

    num_patches: int


@dataclasses.dataclass(frozen=True)
class AudioStubConfig:
    """Marker for audio models whose frontend is stubbed (whisper)."""

    num_mel_bins: int = 80


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str  # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 => d_model // num_heads
    # --- attention flavor ---
    attn_bias: bool = False  # qwen2.5-style QKV bias
    qk_norm: bool = False  # qwen3-style per-head RMSNorm on q/k
    attn_logit_softcap: float = 0.0  # gemma2 attention softcap
    final_logit_softcap: float = 0.0  # gemma2 output softcap
    rope_theta: float = 10000.0
    sliding_window: int = 4096  # window used by 'local_attn' layers
    # --- block pattern, cycled over layers ---
    # entries: 'attn' | 'local_attn' | 'mlstm' | 'slstm' | 'rglru'
    layer_pattern: tuple[str, ...] = ("attn",)
    mlp_type: str = "swiglu"  # swiglu | geglu | gelu (none if d_ff == 0)
    # --- sub-configs ---
    moe: MoEConfig | None = None
    mla: MLAConfig | None = None
    encoder: EncoderConfig | None = None
    vision: VisionStubConfig | None = None
    audio: AudioStubConfig | None = None
    # --- misc ---
    tie_embeddings: bool = True
    norm_eps: float = 1e-6
    embedding_scale: bool = False  # gemma multiplies embeddings by sqrt(d)
    post_block_norms: bool = False  # gemma2 pre+post norms around each block
    dtype: str = "float32"
    # conv width for recurrent blocks (rglru / xlstm causal conv)
    conv_width: int = 4
    # RG-LRU / recurrent block width (d_rnn); 0 => d_model
    rnn_width: int = 0
    # long-context override: when serving long_500k, attention layers use a
    # ring-buffer window of this size (sub-quadratic requirement).
    long_context_window: int = 4096
    # --- the port's own (DeepSeek-V2-Lite) ---
    first_dense_layers: int = 0  # with moe: layers [0, k) take a dense MLP
    dense_d_ff: int = 0  # their width (0 => d_ff)
    rope_scaling: YarnConfig | None = None

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim > 0 else self.d_model // self.num_heads

    @property
    def resolved_rnn_width(self) -> int:
        return self.rnn_width if self.rnn_width > 0 else self.d_model

    def kind(self, layer: int) -> str:
        return self.layer_pattern[layer % len(self.layer_pattern)]


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


# the fields the reference's dataclasses lack, by class
PORT_FIELDS = {
    "ModelConfig": ("first_dense_layers", "dense_d_ff", "rope_scaling"),
    "MoEConfig": ("norm_topk_prob", "routed_scaling_factor", "router_f32", "aux_loss",
                  "held_experts", "first_expert"),
    "MLAConfig": ("flash",),
}


def reference_dict(cfg) -> dict:
    """``dataclasses.asdict(cfg)`` without the port's own fields where they
    hold their defaults (a field set otherwise stays, so the config no
    longer reads as the reference's)."""
    out = {}
    for f in dataclasses.fields(cfg):
        value = getattr(cfg, f.name)
        if f.name in PORT_FIELDS.get(type(cfg).__name__, ()) and value == f.default:
            continue
        out[f.name] = reference_dict(value) if dataclasses.is_dataclass(value) else value
    return out


def layer_kind(cfg: ModelConfig, layer: int) -> str:
    return cfg.kind(layer)


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    """The torch dtype named by ``cfg.dtype``."""
    try:
        return _DTYPES[cfg.dtype]
    except KeyError:
        raise ValueError(f"unsupported model dtype {cfg.dtype!r}") from None


def truncated_normal_(param: torch.Tensor, stddev: float, generator: torch.Generator) -> None:
    """Fill ``param`` with N(0, 1) truncated to [-2, 2], times ``stddev``.

    Drawn in float32 and cast once, as the reference's ``truncated_normal``
    does (its draws come from ``jax.random``, so the numbers differ).
    """
    tmp = torch.empty(param.shape, dtype=torch.float32, device=param.device)
    nn.init.trunc_normal_(tmp, 0.0, 1.0, -2.0, 2.0, generator=generator)
    with torch.no_grad():
        param.copy_(tmp.mul_(stddev))


def param_count(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


def _named_sizes(model_or_named_shapes) -> dict[str, int]:
    """``{name: numel}`` of a module's parameters, or of a mapping name ->
    tensor or shape."""
    if isinstance(model_or_named_shapes, nn.Module):
        return {n: p.numel() for n, p in model_or_named_shapes.named_parameters()}
    out = {}
    for name, leaf in model_or_named_shapes.items():
        shape = leaf.shape if isinstance(leaf, torch.Tensor) else leaf
        n = 1
        for s in shape:
            n *= int(s)
        out[name] = n
    return out


def active_param_count(model_or_named_shapes, cfg: ModelConfig) -> int:
    """Active parameters per token: with MoE only ``top_k`` of the routed
    experts' parameters count (the reference's ``active_param_count``,
    which finds them by ``routed`` in the path). Takes a module or a
    mapping name -> tensor or shape (a meta model's)."""
    sizes = _named_sizes(model_or_named_shapes)
    total = sum(sizes.values())
    if cfg.moe is None:
        return total
    routed = sum(n for name, n in sizes.items() if "routed" in name.split("."))
    return total - routed + routed * cfg.moe.top_k // cfg.moe.num_experts
