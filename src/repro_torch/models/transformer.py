"""Decoder-only language model assembly from a ModelConfig.

``LM`` holds ``embed``, a ``ModuleList`` of blocks (``layers``) and
``final_norm``. Each block is built for its kind in the config's layer
pattern: ``attn`` / ``local_attn`` (GQA attention, or MLA with
``cfg.mla``, + an MLP, or the MoE block with ``cfg.moe``), ``mlstm`` /
``slstm`` (the self-contained xLSTM blocks, no MLP) or ``rglru`` (Griffin
recurrent block + MLP); with ``cfg.first_dense_layers`` (DeepSeek-V2-Lite)
the first layers of an MoE config take a dense MLP of ``dense_d_ff``. The
reference stacks the layers of each pattern position on a group axis and
runs ``lax.scan`` over the groups (plus an unrolled tail); here a plain
Python loop runs the layers in order (``repro_torch.convert`` maps the
reference's stacked layout onto ``layers``) and sums the MoE layers'
auxiliary losses as the scan's carry does. VLM (llava) inputs prepend
stub patch embeddings to the token embeddings. The encoder-decoder
(whisper) is ``models/whisper.py``.

API:
  init_lm(cfg, seed=, device=)          -> LM (weights drawn, no grad)
  LM.forward(tokens, image_embeds=, ...) -> (logits|hidden, new_cache, aux)
  init_cache(cfg, batch, max_len, long_context=, device=) -> per-layer caches
  reset_cache_(cfg, cache)               -> the caches back to their initial values
  lm_loss(model, cfg, tokens, labels)    -> (loss, metrics)
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.device import resolve_device

from .attention import (
    Attention,
    MLAAttention,
    attention,
    init_attention_cache,
    init_mla_attention_cache,
    mla_attention,
)
from . import xlstm
from .common import IMPLS, ModelConfig, dtype_of
from .layers import MLP, Embedding, RMSNorm, embed, mlp_forward, rms_norm, unembed
from .moe import MoE, moe_forward
from .rglru import RGLRUBlock, init_rglru_state, rglru_block

__all__ = [
    "Layer",
    "LM",
    "init_lm",
    "init_cache",
    "reset_cache_",
    "lm_loss",
    "softmax_xent",
    "fused_unembed_xent",
]

_ATTN_KINDS = ("attn", "local_attn")
_XLSTM_KINDS = ("mlstm", "slstm")


class Layer(nn.Module):
    """One block of kind ``attn`` / ``local_attn`` (``ln1``, ``attn``: GQA,
    or MLA with ``cfg.mla``), ``mlstm`` / ``slstm`` or ``rglru``
    (``block``), then, but for the xLSTM kinds, ``ln2`` and ``mlp`` (an
    MLP, or the MoE block with ``cfg.moe`` from layer
    ``cfg.first_dense_layers`` on) when ``d_ff > 0``; ``post_ln1`` /
    ``post_ln2`` with gemma2's post-block norms."""

    def __init__(self, cfg: ModelConfig, kind: str, device: torch.device | str,
                 index: int = 0):
        super().__init__()
        dt = dtype_of(cfg)
        self.kind = kind
        if kind in _ATTN_KINDS:
            self.ln1 = RMSNorm(cfg.d_model, dt, device)
            self.attn = MLAAttention(cfg, device) if cfg.mla is not None else Attention(cfg, device)
            if cfg.post_block_norms:
                self.post_ln1 = RMSNorm(cfg.d_model, dt, device)
        elif kind == "mlstm":
            self.block = xlstm.MLSTMBlock(cfg, device)
        elif kind == "slstm":
            self.block = xlstm.SLSTMBlock(cfg, device)
        elif kind == "rglru":
            self.block = RGLRUBlock(cfg, device)
        else:
            raise ValueError(f"unknown layer kind {kind}")
        if cfg.d_ff > 0 and kind not in _XLSTM_KINDS:
            self.ln2 = RMSNorm(cfg.d_model, dt, device)
            if cfg.moe is not None and index >= cfg.first_dense_layers:
                self.mlp = MoE(cfg, device)
            else:
                self.mlp = MLP(cfg, device, d_ff=cfg.dense_d_ff or None)
            if cfg.post_block_norms:
                self.post_ln2 = RMSNorm(cfg.d_model, dt, device)

    def init_weights(self, generator: torch.Generator) -> None:
        for child in (getattr(self, "attn", None), getattr(self, "block", None),
                      getattr(self, "mlp", None)):
            if child is not None:
                child.init_weights(generator)


def _layer_forward(
    lp: Layer,
    cfg: ModelConfig,
    x: torch.Tensor,
    positions: torch.Tensor,
    cache_layer: dict | None,
    window_override: int | None,
    impl: str,
) -> tuple[torch.Tensor, dict | None, torch.Tensor | None]:
    """One layer: (x, new cache, the MoE block's aux loss or None)."""
    new_cache = aux = None
    if lp.kind in _ATTN_KINDS:
        h = rms_norm(lp.ln1, x, cfg.norm_eps)
        local = lp.kind == "local_attn" or window_override is not None
        if cfg.mla is not None:
            win = window_override if window_override is not None else (
                cfg.sliding_window if lp.kind == "local_attn" else None)
            attn_out, new_cache = mla_attention(
                lp.attn, cfg, h, positions=positions, cache=cache_layer, window=win, impl=impl)
        else:
            attn_out, new_cache = attention(
                lp.attn, cfg, h,
                positions=positions,
                local=local,
                window=window_override,
                cache=cache_layer,
                impl=impl,
            )
        if cfg.post_block_norms:
            attn_out = rms_norm(lp.post_ln1, attn_out, cfg.norm_eps)
        x = x + attn_out
    elif lp.kind == "mlstm":
        x, new_cache = xlstm.mlstm_block(lp.block, cfg, x, cache_layer)
    elif lp.kind == "slstm":
        x, new_cache = xlstm.slstm_block(lp.block, cfg, x, cache_layer)
    else:  # rglru
        x, new_cache = rglru_block(lp.block, cfg, x, cache_layer, impl=impl)

    if cfg.d_ff > 0 and lp.kind not in _XLSTM_KINDS:
        h = rms_norm(lp.ln2, x, cfg.norm_eps)
        if isinstance(lp.mlp, MoE):
            mlp_out, aux = moe_forward(lp.mlp, cfg, h)
        else:
            mlp_out = mlp_forward(lp.mlp, h, cfg.mlp_type)
        if cfg.post_block_norms:
            mlp_out = rms_norm(lp.post_ln2, mlp_out, cfg.norm_eps)
        x = x + mlp_out
    return x, new_cache, aux


class LM(nn.Module):
    """Decoder-only LM. Built with uninitialised weights on ``device``:
    ``init_lm`` draws them, ``repro_torch.convert.lm_params_from_numpy``
    loads the reference's."""

    def __init__(self, cfg: ModelConfig, device: torch.device | str):
        super().__init__()
        if cfg.arch_type == "audio":
            raise ValueError(f"{cfg.name} is an encoder-decoder: build it with "
                             "models.whisper.init_whisper (or registry.init_model)")
        self.cfg = cfg
        self.embed = Embedding(cfg, device)
        self.layers = nn.ModuleList(
            Layer(cfg, cfg.kind(i), device, i) for i in range(cfg.num_layers)
        )
        self.final_norm = RMSNorm(cfg.d_model, dtype_of(cfg), device)

    def init_weights(self, generator: torch.Generator) -> None:
        for layer in self.layers:
            layer.init_weights(generator)
        self.embed.init_weights(generator)

    def forward(
        self,
        tokens: torch.Tensor,
        *,
        image_embeds: torch.Tensor | None = None,
        cache: list | None = None,
        positions: torch.Tensor | None = None,
        window_override: int | None = None,
        impl: str = "kernel",
        return_hidden: bool = False,
        remat: bool = False,
    ) -> tuple[torch.Tensor, list | None, torch.Tensor]:
        """Decoder forward.

        Args:
          tokens: (B, S_text) int tokens.
          image_embeds: optional (B, P, D) stub patch embeddings (VLM),
            prepended to the token embeddings (prefill and scoring).
          cache: per-layer caches from ``init_cache`` (prefill / decode);
            None = full sequence. Attention buffers are written in place.
          positions: (B, P + S_text) absolute positions (required with a
            cache).
          window_override: force every attention layer to a sliding window
            (the long_500k sub-quadratic serving mode).
          impl: "kernel" (the reference's "pallas": the flash-attention and
            RG-LRU scan kernels) or "plain" (the reference's "xla").
          return_hidden: skip the unembedding (used by the fused loss).
          remat: for a full sequence under autograd, recompute each layer's
            activations in the backward pass (the reference's ``remat``):
            the same values, one layer's activations held at a time.

        Returns (logits | hidden, new_cache, aux); aux is the sum of the
        MoE layers' router losses (float32; 0 without MoE).
        """
        if impl not in IMPLS:
            raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
        cfg = self.cfg
        if cache is not None and len(cache) != len(self.layers):
            raise ValueError(f"cache has {len(cache)} layers, the model {len(self.layers)}")
        x = embed(self.embed, tokens, cfg)
        if image_embeds is not None:
            x = torch.cat([image_embeds.to(x.dtype), x], dim=1)
        B, S, _ = x.shape
        if positions is None:
            if cache is not None:
                raise ValueError("positions are required with a cache")
            positions = torch.arange(S, device=x.device)[None, :].expand(B, S)
        new_cache = [] if cache is not None else None
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        remat = remat and cache is None and torch.is_grad_enabled()
        for i, layer in enumerate(self.layers):
            cl = cache[i] if cache is not None else None
            if remat:
                x, nc, a = _remat(_layer_forward, layer, cfg, x, positions, cl, window_override,
                                  impl)
            else:
                x, nc, a = _layer_forward(layer, cfg, x, positions, cl, window_override, impl)
            if a is not None:
                aux = aux + a
            if new_cache is not None:
                new_cache.append(nc)
        x = rms_norm(self.final_norm, x, cfg.norm_eps)
        if return_hidden:
            return x, new_cache, aux
        return unembed(self.embed, x, cfg), new_cache, aux


def init_lm(cfg: ModelConfig, *, seed: int = 0, device: torch.device | str | None = None) -> LM:
    """An ``LM`` with weights drawn from ``torch.Generator(seed)`` on
    ``device`` (None = CUDA), in eval mode with gradients off: for
    scoring and serving (the trainers make their own parameter leaves)."""
    device = resolve_device(device)
    model = LM(cfg, device)
    model.init_weights(torch.Generator(device=device).manual_seed(seed))
    return model.requires_grad_(False).eval()


# ---------------------------------------------------------------------------
# Caches
# ---------------------------------------------------------------------------

def _init_layer_cache(cfg: ModelConfig, kind: str, batch: int, max_len: int,
                      long_context: bool, device) -> dict:
    if kind in _ATTN_KINDS:
        if cfg.mla is not None:
            ring = cfg.long_context_window if long_context else None
            return init_mla_attention_cache(cfg, batch, max_len, device, ring=ring)
        window = cfg.long_context_window if long_context else None
        return init_attention_cache(cfg, batch, max_len,
                                    local=kind == "local_attn" or long_context,
                                    window=window, device=device)
    if kind == "mlstm":
        return xlstm.init_mlstm_state(cfg, batch, device)
    if kind == "slstm":
        return xlstm.init_slstm_state(cfg, batch, device)
    if kind == "rglru":
        return init_rglru_state(cfg, batch, device)
    raise ValueError(f"unknown layer kind {kind}")


def init_cache(
    cfg: ModelConfig,
    batch: int,
    max_len: int,
    *,
    long_context: bool = False,
    device: torch.device | str | None = None,
) -> list:
    """One cache per layer, in layer order (the reference groups them as
    its stacked parameters are grouped), on ``device`` (None = CUDA).

    ``long_context=True`` is the reference's sub-quadratic mode: every
    attention layer but MLA gets a window ring of ``min(long_context_window,
    max_len)`` slots, an MLA layer a latent ring of exactly
    ``long_context_window`` slots; recurrent layers keep their O(1)
    state. Its forwards pass ``window_override=cfg.long_context_window``.
    """
    device = resolve_device(device)
    return [
        _init_layer_cache(cfg, cfg.kind(i), batch, max_len, long_context, device)
        for i in range(cfg.num_layers)
    ]


def reset_cache_(cfg: ModelConfig, cache: list) -> list:
    """Put every layer's cache back to the values ``init_cache`` gives, in
    place (the tensors stay the same): zeros, but -1e30 for the xLSTM
    stabiliser states ``m`` -- a prefill's sLSTM loop starts from the
    incoming state, so an ``m`` of 0 would change every output. (An MLA
    ring's ``"ring"`` flag is no tensor and stays.)"""
    for i, layer in enumerate(cache):
        if cfg.kind(i) in _XLSTM_KINDS:
            xlstm.reset_state_(layer)
        else:
            for t in layer.values():
                if isinstance(t, torch.Tensor):
                    t.zero_()
    return cache


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------

def _remat(fn, *args):
    """``fn(*args)`` with the activations it saves for the backward pass
    recomputed there instead (the reference's ``jax.checkpoint``): the same
    values, one block's activations held at a time. Nothing it runs draws
    random numbers, so no generator state is kept."""
    from torch.utils.checkpoint import checkpoint

    return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)


def _chunk_nll(params: Embedding, cfg: ModelConfig, hidden: torch.Tensor,
               labels: torch.Tensor) -> torch.Tensor:
    return _token_nll(unembed(params, hidden, cfg), labels).sum()


def _token_nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-token ``logsumexp - label logit``, reduced over V in float32."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    label_logit = lf.gather(-1, labels[..., None].long())[..., 0]
    return lse - label_logit


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross entropy; logits stay in their dtype until the
    float32 reduction."""
    return _token_nll(logits, labels).mean()


_XENT_CHUNK = 512


def fused_unembed_xent(
    params: Embedding, cfg: ModelConfig, hidden: torch.Tensor, labels: torch.Tensor,
    remat: bool = False,
) -> torch.Tensor:
    """Unembed + cross-entropy over sequence chunks of 512: the full
    (B, S, V) logits never materialise, one (B, 512, V) block at a time
    (with ``remat``, under autograd, recomputed in the backward pass, as
    the reference's remat does)."""
    B, S, D = hidden.shape
    if S % _XENT_CHUNK != 0:
        return softmax_xent(unembed(params, hidden, cfg), labels)
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c0 in range(0, S, _XENT_CHUNK):
        args = (params, cfg, hidden[:, c0 : c0 + _XENT_CHUNK], labels[:, c0 : c0 + _XENT_CHUNK])
        total = total + (_remat(_chunk_nll, *args) if remat and torch.is_grad_enabled()
                         else _chunk_nll(*args))
    return total / (B * S)


def lm_loss(
    model: LM,
    cfg: ModelConfig,
    tokens: torch.Tensor,
    labels: torch.Tensor,
    *,
    image_embeds: torch.Tensor | None = None,
    impl: str = "kernel",
    remat: bool = False,
) -> tuple[torch.Tensor, dict]:
    """Next-token cross-entropy, plus ``router_aux_coef * aux`` with MoE.
    Labels align with the text tokens: the image positions are dropped
    before the loss. ``remat``: recompute the layers' and the loss chunks'
    activations in the backward pass. Returns (loss, {"nll", "aux"})."""
    hidden, _, aux = model(tokens, image_embeds=image_embeds, impl=impl, return_hidden=True,
                           remat=remat)
    if image_embeds is not None:
        hidden = hidden[:, image_embeds.shape[1] :, :]
    nll = fused_unembed_xent(model.embed, cfg, hidden, labels, remat)
    total = nll
    if cfg.moe is not None:
        total = total + cfg.moe.router_aux_coef * aux
    return total, {"nll": nll, "aux": aux}
