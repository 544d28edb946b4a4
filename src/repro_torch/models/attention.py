"""Attention blocks: GQA/MQA (qk-norm, bias, softcap, sliding window) with
full-sequence and cached (prefill / decode) paths.

Layout conventions, as in the reference: activations (B, S, D); q/k/v
(B, S, H, Dh). Keys are rotated (RoPE) before caching.

``impl`` picks the full-sequence attention:

* ``"kernel"`` -- the reference's ``impl="pallas"``: a full-sequence
  causal call goes to ``kernels.flash_attention.ops.flash_attention``
  (the hand-written CUDA kernel on the card, its plain version on the
  CPU);
* ``"plain"`` -- the reference's ``impl="xla"``: plain PyTorch, the
  chunked online-softmax form above 2048 positions, one quadratic
  softmax below.

With a cache, decode is plain PyTorch whatever ``impl`` says, as it is
plain XLA in the reference. A causal prefill (from a fresh cache) takes
the full-sequence path above: under ``"kernel"`` the flash kernel, with
the layer's window or the long-context mode's ``window`` (the reference
runs every prefill in plain XLA).

DeepSeek-V2's multi-head latent attention (``MLAAttention``,
``mla_attention``) is plain PyTorch on every path, as it is plain XLA in
the reference (which has no Pallas MLA kernel), but for a config with
``mla.flash`` (the port's own: DeepSeek-V2-Lite) whose full sequence runs
without a cache under ``impl="kernel"``: there the per-head q = [q_nope;
q_rope] and k = [k_nope; k_rope] (192 wide) and v (128) are zero-padded
to the flash kernels' head dim 256 -- zeros add nothing to a dot product,
and the padded output columns are dropped -- and the kernel is given
MLA's own softmax scale (``mla_scale``: (dn + dr)^-0.5, times YaRN's
mscale squared). Its cache holds the compressed latents, decompressed per
head at every call; in the long-context mode that cache is a ring that
wraps (the cache says so: ``kvcache.init_mla_cache(ring=True)``).

Whisper's decoder attends to the encoder's states through
``cross_attention``: queries from the decoder, keys and values projected
from ``encoder_out`` at every call (decode steps too, as the reference
does), no RoPE, plain ``_sdpa`` with no mask.
"""

from __future__ import annotations

import types

import torch
from torch import nn

from repro_torch.kernels.flash_attention import ops as fa_ops

from .common import IMPLS, ModelConfig, dtype_of, truncated_normal_, yarn_mscale
from .kvcache import (
    init_full_cache,
    init_mla_cache,
    init_window_cache,
    update_full_cache,
    update_mla,
    update_window_cache,
)
from . import parallel as P
from .layers import RMSNorm, apply_rope, rms_norm, rotary_embedding

_NEG_INF = -2.0e9

__all__ = [
    "Attention",
    "init_attention",
    "attention",
    "init_attention_cache",
    "MLAAttention",
    "init_mla_attention",
    "mla_attention",
    "mla_scale",
    "init_mla_attention_cache",
    "init_cross_attention",
    "cross_attention",
]


# ---------------------------------------------------------------------------
# Standard multi-head attention with GQA / MQA
# ---------------------------------------------------------------------------

class Attention(nn.Module):
    """Projections ``wq`` (d, H Dh), ``wk`` / ``wv`` (d, Hkv Dh), ``wo``
    (H Dh, d); ``bq`` / ``bk`` / ``bv`` with ``attn_bias``; ``q_norm`` /
    ``k_norm`` with ``qk_norm``."""

    def __init__(self, cfg: ModelConfig, device: torch.device | str):
        super().__init__()
        dt = dtype_of(cfg)
        d, h, hkv, dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim

        def empty(*shape):
            return nn.Parameter(torch.empty(shape, dtype=dt, device=device))

        self.wq = empty(d, h * dh)
        self.wk = empty(d, hkv * dh)
        self.wv = empty(d, hkv * dh)
        self.wo = empty(h * dh, d)
        if cfg.attn_bias:
            self.bq = nn.Parameter(torch.zeros(h * dh, dtype=dt, device=device))
            self.bk = nn.Parameter(torch.zeros(hkv * dh, dtype=dt, device=device))
            self.bv = nn.Parameter(torch.zeros(hkv * dh, dtype=dt, device=device))
        if cfg.qk_norm:
            self.q_norm = RMSNorm(dh, dt, device)
            self.k_norm = RMSNorm(dh, dt, device)

    def init_weights(self, generator: torch.Generator) -> None:
        std = self.wq.shape[0] ** -0.5
        truncated_normal_(self.wq, std, generator)
        truncated_normal_(self.wk, std, generator)
        truncated_normal_(self.wv, std, generator)
        truncated_normal_(self.wo, self.wo.shape[0] ** -0.5, generator)


def init_attention(
    cfg: ModelConfig, *, generator: torch.Generator, device: torch.device | str
) -> Attention:
    attn = Attention(cfg, device)
    attn.init_weights(generator)
    return attn


def _project_qkv(params: Attention, cfg: ModelConfig, x: torch.Tensor,
                 tp: P.TPGroup | None = None, kv_x: torch.Tensor | None = None,
                 all_heads: bool = False):
    """q (B, S, heads, Dh) and k / v (B, Sk, kv heads, Dh); ``kv_x``: keys
    and values from it (cross-attention:
    no bias, no qk-norm). With ``tp`` (the query columns split over its
    ranks, ``wo``'s rows with them): keys and values split by whole heads
    stay local, else they are gathered (or computed whole where the rules
    leave them whole); query heads split inside a head are gathered and
    every head the rank's columns touch (``parallel.touched``) is kept;
    with ``all_heads`` (a decode step over a cache split by head_dim) the
    queries of every head are gathered."""
    B, S, _ = x.shape
    h, hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    cross = kv_x is not None
    x = P.copy_to(x, tp)
    xk = x if not cross else P.copy_to(kv_x, tp)
    kv_split = P.split(tp, params.wk.shape[1], hkv * dh)

    def kv_weight(w):  # whole keys / values read by split queries: gradient summed
        return w if kv_split else P.copy_to(w, tp)

    q = x @ params.wq
    k = xk @ kv_weight(params.wk)
    v = xk @ kv_weight(params.wv)
    if cfg.attn_bias and not cross:
        q = q + P.slice_last(params.bq, tp)
        k = k + (P.slice_last(params.bk, tp) if kv_split else kv_weight(params.bk))
        v = v + (P.slice_last(params.bv, tp) if kv_split else kv_weight(params.bv))
    aligned = tp is None or h % tp.size == 0
    if kv_split and not (aligned and hkv % tp.size == 0 and not all_heads):
        k, v = P.gather_last_partial(k, tp), P.gather_last_partial(v, tp)
    lo, hi, _ = (0, h, 0) if all_heads else P.touched(h, dh, tp)
    if all_heads:
        q = P.gather_last(q, tp)
    elif not aligned:
        q = P.gather_last_partial(q, tp)[..., lo * dh:hi * dh]
    q = q.reshape(B, S, hi - lo, dh)
    k = k.reshape(B, xk.shape[1], -1, dh)
    v = v.reshape(B, xk.shape[1], -1, dh)
    if cfg.qk_norm and not cross:
        q = rms_norm(types.SimpleNamespace(scale=P.copy_to(params.q_norm.scale, tp)), q,
                     cfg.norm_eps)
        k = rms_norm(types.SimpleNamespace(scale=P.copy_to(params.k_norm.scale, tp)), k,
                     cfg.norm_eps)
    return q, k, v


def _cache_layout(cache: dict, cfg: ModelConfig) -> str:
    """How a rank's block of an attention cache splits it over ``model``
    (``serve.engine``'s cache specs): ``"heads"`` (the kv heads),
    ``"head_dim"`` (where the kv heads do not divide), or ``"whole"``."""
    k = cache["k"]
    if k.shape[2] < cfg.num_kv_heads:
        return "heads"
    if k.shape[3] < cfg.resolved_head_dim:
        return "head_dim"
    return "whole"


def _cache_block(t: torch.Tensor, cache_t: torch.Tensor, layout: str,
                 tp: P.TPGroup | None) -> torch.Tensor:
    """This rank's block of new keys or values ``t`` (B, S, heads, Dh) --
    the rank's kv heads, or every kv head -- for a cache block
    ``cache_t``."""
    if layout == "whole" or t.shape[2] == cache_t.shape[2] and t.shape[3] == cache_t.shape[3]:
        return t
    dim = 2 if layout == "heads" else 3
    return P.own_block(t, tp, dim)


def _sdpa_split_dim(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor,
                    cfg: ModelConfig, tp: P.TPGroup) -> torch.Tensor:
    """Attention over a cache split by head_dim: q (B, Sq, H, Dh) every
    head's queries, k / v (B, Sk, Hkv, Dh / m) the rank's block. The
    scores' partial products over the rank's Dh block are summed over
    ``model`` (float32), the softmax runs whole, and the output's Dh
    blocks are gathered: (B, Sq, H, Dh)."""
    B, Sq, H, Dh = q.shape
    Hkv, width = k.shape[2], k.shape[3]
    groups = H // Hkv
    qg = P.own_block(q, tp, 3).reshape(B, Sq, Hkv, groups, width)
    logits = P.reduce_from(torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()), tp)
    logits = logits * Dh**-0.5
    if cfg.attn_logit_softcap > 0.0:
        cap = cfg.attn_logit_softcap
        logits = cap * torch.tanh(logits / cap)
    logits = torch.where(mask[:, :, None] if mask.ndim == 4 else mask, logits, _NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v.float())
    return P.gather_last(out.reshape(B, Sq, H, width).to(q.dtype), tp)


def _own_heads(k: torch.Tensor, v: torch.Tensor, cfg: ModelConfig, tp: P.TPGroup | None):
    """The kv heads of this rank's query heads where every key / value
    head is here (gathered or whole) but only some query heads."""
    lo, hi, _ = P.touched(cfg.num_heads, cfg.resolved_head_dim, tp)
    if hi - lo == cfg.num_heads or k.shape[2] < cfg.num_kv_heads:
        return k, v
    idx = torch.arange(lo, hi, device=k.device) // (cfg.num_heads // cfg.num_kv_heads)
    return k.index_select(2, idx), v.index_select(2, idx)


def _out_proj(params: Attention, cfg: ModelConfig, out: torch.Tensor,
              tp: P.TPGroup | None, all_heads: bool = False) -> torch.Tensor:
    """The output projection of the rank's heads (or, ``all_heads``, of
    every head): its columns kept where the heads split inside a head or
    every head is here, partial sums reduced."""
    B, S = out.shape[:2]
    out = out.reshape(B, S, -1)
    if tp is not None and (all_heads or cfg.num_heads % tp.size):
        width = cfg.num_heads * cfg.resolved_head_dim // tp.size
        off = tp.rank * width if all_heads else P.touched(cfg.num_heads,
                                                          cfg.resolved_head_dim, tp)[2]
        out = out[..., off:off + width]
    return P.reduce_from(out @ params.wo, tp)


def _sdpa(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: torch.Tensor | None,
    cfg: ModelConfig,
) -> torch.Tensor:
    """Grouped scaled-dot-product attention. q: (B,Sq,H,Dh); k/v: (B,Sk,Hkv,Dh).

    mask: broadcastable to (B, 1, Sq, Sk) boolean (True = attend) or None.
    """
    B, Sq, H, Dh = q.shape
    Hkv = k.shape[2]
    groups = H // Hkv
    scale = Dh**-0.5
    qg = q.reshape(B, Sq, Hkv, groups, Dh)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float())
    logits = logits * scale
    if cfg.attn_logit_softcap > 0.0:
        cap = cfg.attn_logit_softcap
        logits = cap * torch.tanh(logits / cap)
    if mask is not None:
        logits = torch.where(mask[:, :, None] if mask.ndim == 4 else mask, logits, _NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v.float())
    return out.reshape(B, Sq, H, Dh).to(q.dtype)


_CHUNK_THRESHOLD = 2048  # full-seq lengths above this use the chunked path
_CHUNK_Q = 512


def _sdpa_chunked(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    cfg: ModelConfig,
    window: int | None,
    chunk_q: int = _CHUNK_Q,
) -> torch.Tensor:
    """Causal attention as a loop over q chunks, each with a full-k
    softmax: the peak temporary is O(B H chunk_q S) instead of O(B H S^2).

    Products take the operands' values exactly and sum in float32 (the
    reference's ``preferred_element_type``); p is cast to v's dtype
    before the product with v, as the reference does.
    """
    B, S, H, Dh = q.shape
    Hkv = k.shape[2]
    groups = H // Hkv
    scale = Dh**-0.5
    if S % chunk_q:
        raise ValueError(f"S={S} must be a multiple of chunk_q={chunk_q}")
    qg = q.reshape(B, S, Hkv, groups, Dh)
    kf = k.float()
    vf = v.float()
    kpos = torch.arange(S, device=q.device)
    chunks = []
    for ci in range(S // chunk_q):
        q_chunk = qg[:, ci * chunk_q : (ci + 1) * chunk_q].float()
        logits = torch.einsum("bqhgd,bkhd->bhgqk", q_chunk, kf) * scale
        if cfg.attn_logit_softcap > 0.0:
            cap = cfg.attn_logit_softcap
            logits = cap * torch.tanh(logits / cap)
        qpos = ci * chunk_q + torch.arange(chunk_q, device=q.device)
        mask = kpos[None, :] <= qpos[:, None]
        if window is not None:
            mask = mask & (kpos[None, :] > qpos[:, None] - window)
        logits = torch.where(mask, logits, _NEG_INF)
        p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
        out = torch.einsum("bhgqk,bkhd->bqhgd", p.to(v.dtype).float(), vf)
        out = out / p.sum(dim=-1).permute(0, 3, 1, 2)[..., None]
        chunks.append(out.reshape(B, chunk_q, H, Dh).to(q.dtype))
    return torch.cat(chunks, dim=1)


def _causal_mask(Sq: int, Sk: int, window: int | None, device=None) -> torch.Tensor:
    """(1, 1, Sq, Sk) boolean mask; Sk == Sq for full-sequence paths."""
    qpos = torch.arange(Sq, device=device)[:, None]
    kpos = torch.arange(Sk, device=device)[None, :]
    mask = kpos <= qpos
    if window is not None:
        mask = mask & (kpos > qpos - window)
    return mask[None, None]


def attention(
    params: Attention,
    cfg: ModelConfig,
    x: torch.Tensor,
    *,
    positions: torch.Tensor,
    local: bool = False,
    window: int | None = None,
    cache: dict | None = None,
    causal: bool = True,
    impl: str = "kernel",
    tp: P.TPGroup | None = None,
) -> tuple[torch.Tensor, dict | None]:
    """Self-attention. Returns (output, updated_cache).

    Full-sequence when ``cache is None``; cached prefill / decode
    otherwise (the cache's buffers are written in place, see
    ``models/kvcache.py``). ``local=True`` applies the layer's sliding
    window (``window`` overrides ``cfg.sliding_window`` -- the long_500k
    sub-quadratic mode). ``tp``: this rank's block of a split replica
    (``_project_qkv``), whole where the rules leave ``wq`` whole; with a
    cache, the rank's block of it (``serve.engine``'s cache specs): by kv
    heads (the rank's own), or by head_dim, where a decode step sums the
    scores' partial products over the ranks (``_sdpa_split_dim``).
    """
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    B, S, _ = x.shape
    dh = cfg.resolved_head_dim
    ctp = tp  # the cache's block follows the cache specs, whatever the weights' split
    tp = P.split(tp, params.wq.shape[1], cfg.num_heads * dh)
    eff_window = window if window is not None else (cfg.sliding_window if local else None)
    layout = "whole" if cache is None else _cache_layout(cache, cfg)
    if layout == "heads" and (tp is None or cfg.num_heads % tp.size):
        raise ValueError("a cache split by kv heads needs whole query heads a rank")
    split_dim = layout == "head_dim" and S == 1
    q, k, v = _project_qkv(params, cfg, x, tp, all_heads=split_dim)
    cos, sin = rotary_embedding(positions, dh, cfg.rope_theta, cfg.rope_scaling)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    if cache is not None:
        k_new, v_new = (_cache_block(t, cache[n], layout, ctp) for t, n in ((k, "k"), (v, "v")))
    if not split_dim:
        k, v = _own_heads(k, v, cfg, tp)

    if cache is None or S > 1:
        # The full sequence, or a prefill (a multi-token append, from a
        # fresh cache): attention on the full-sequence path, then the
        # prefill's cache write. (A window ring cannot be the source while
        # it is filled: early keys may be evicted before later queries
        # need them.)
        if impl == "kernel" and causal:
            out = fa_ops.flash_attention(
                q, k, v, causal=True, window=eff_window, softcap=cfg.attn_logit_softcap
            )
        elif causal and S > _CHUNK_THRESHOLD and S % _CHUNK_Q == 0:
            out = _sdpa_chunked(q, k, v, cfg, eff_window)
        else:
            mask = _causal_mask(S, S, eff_window, x.device) if causal else None
            out = _sdpa(q, k, v, mask, cfg)
        if cache is None:
            new_cache = None
        elif local or window is not None:
            new_cache = update_window_cache(cache, k_new, v_new)
        else:
            new_cache = update_full_cache(cache, k_new, v_new)
    else:
        # positions: (B, S) absolute positions of the new tokens.
        qpos = positions[:, :, None]  # (B, Sq, 1)
        if not (local or window is not None):
            new_cache = update_full_cache(cache, k_new, v_new)
            Sk = new_cache["k"].shape[1]
            kpos = torch.arange(Sk, device=x.device)[None, None, :]  # (1, 1, Sk)
            mask = kpos <= qpos  # (B, Sq, Sk)
        else:  # window ring buffer
            new_cache = update_window_cache(cache, k_new, v_new)
            W = new_cache["k"].shape[1]
            slot = torch.arange(W, device=x.device)
            idx = new_cache["index"]  # absolute positions written so far
            # absolute position held by each ring slot after the write:
            # the largest value < idx congruent to the slot modulo W.
            abs_pos = (idx - 1) - torch.remainder(idx - 1 - slot, W)  # (W,)
            abs_pos = abs_pos[None, None, :]  # (1, 1, W)
            mask = (abs_pos >= 0) & (abs_pos <= qpos)
            if eff_window is not None:
                mask = mask & (abs_pos > qpos - eff_window)
        if split_dim:
            out = _sdpa_split_dim(q, new_cache["k"], new_cache["v"], mask[:, None], cfg, ctp)
            return _out_proj(params, cfg, out, tp, all_heads=True), new_cache
        kc, vc = _own_heads(new_cache["k"], new_cache["v"], cfg, tp)
        out = _sdpa(q, kc, vc, mask[:, None], cfg)

    return _out_proj(params, cfg, out, tp), new_cache


def init_attention_cache(
    cfg: ModelConfig, batch: int, max_len: int, *, local: bool, window: int | None = None,
    device: torch.device | str | None = None,
) -> dict:
    """A window (ring) cache for a local layer or a given ``window``, else
    a full cache of ``max_len`` positions; on ``device`` (None = CUDA)."""
    dt = dtype_of(cfg)
    dh = cfg.resolved_head_dim
    if local or window is not None:
        w = window if window is not None else cfg.sliding_window
        w = min(w, max_len)
        return init_window_cache(batch, w, cfg.num_kv_heads, dh, dt, device)
    return init_full_cache(batch, max_len, cfg.num_kv_heads, dh, dt, device)


# ---------------------------------------------------------------------------
# Multi-head latent attention (DeepSeek-V2)
# ---------------------------------------------------------------------------

class MLAAttention(nn.Module):
    """``wq`` (d, H (dn + dr)), ``w_dkv`` (d, r), ``w_krope`` (d, dr),
    ``kv_norm`` (an RMS norm of the r latents), ``w_uk`` (r, H dn),
    ``w_uv`` (r, H dv), ``wo`` (H dv, d). ``q_lora_rank`` is not used:
    the q projection is full rank, as in the reference."""

    def __init__(self, cfg: ModelConfig, device: torch.device | str):
        super().__init__()
        m = cfg.mla
        dt = dtype_of(cfg)
        d, h = cfg.d_model, cfg.num_heads

        def empty(*shape):
            return nn.Parameter(torch.empty(shape, dtype=dt, device=device))

        self.wq = empty(d, h * (m.qk_nope_head_dim + m.qk_rope_head_dim))
        self.w_dkv = empty(d, m.kv_lora_rank)
        self.w_krope = empty(d, m.qk_rope_head_dim)
        self.kv_norm = RMSNorm(m.kv_lora_rank, dt, device)
        self.w_uk = empty(m.kv_lora_rank, h * m.qk_nope_head_dim)
        self.w_uv = empty(m.kv_lora_rank, h * m.v_head_dim)
        self.wo = empty(h * m.v_head_dim, d)

    def init_weights(self, generator: torch.Generator) -> None:
        std = self.wq.shape[0] ** -0.5
        for w in (self.wq, self.w_dkv, self.w_krope):
            truncated_normal_(w, std, generator)
        r_std = self.w_uk.shape[0] ** -0.5
        truncated_normal_(self.w_uk, r_std, generator)
        truncated_normal_(self.w_uv, r_std, generator)
        truncated_normal_(self.wo, self.wo.shape[0] ** -0.5, generator)


def init_mla_attention(
    cfg: ModelConfig, *, generator: torch.Generator, device: torch.device | str
) -> MLAAttention:
    attn = MLAAttention(cfg, device)
    attn.init_weights(generator)
    return attn


def _decompress(params: MLAAttention, cfg: ModelConfig, c_kv: torch.Tensor):
    """Per-head keys (B, Sk, H, dn) and values (B, Sk, H, dv) of the latents."""
    m = cfg.mla
    B, Sk, _ = c_kv.shape
    k_nope = (c_kv @ params.w_uk).reshape(B, Sk, -1, m.qk_nope_head_dim)
    v = (c_kv @ params.w_uv).reshape(B, Sk, -1, m.v_head_dim)
    return k_nope, v


def mla_scale(cfg: ModelConfig) -> float:
    """MLA's softmax scale: ``(dn + dr)^-0.5``, times ``mscale(factor,
    mscale_all_dim)^2`` under YaRN (DeepSeek-V2's ``softmax_scale``)."""
    m = cfg.mla
    scale = (m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5
    y = cfg.rope_scaling
    if y is not None and y.mscale_all_dim:
        scale *= yarn_mscale(y.factor, y.mscale_all_dim) ** 2
    return scale


def _mla_flash(params: MLAAttention, cfg: ModelConfig, q_nope: torch.Tensor,
               q_rope: torch.Tensor, c_kv: torch.Tensor, k_rope: torch.Tensor,
               window: int | None) -> torch.Tensor:
    """Causal MLA over the full sequence in the flash kernels: per-head q, k
    (dn + dr) and v (dv) zero-padded to the smallest kernel head dim that
    holds both, the kernel given ``mla_scale``; the output's padded columns
    dropped. (B, S, H dv)."""
    m = cfg.mla
    B, S, H, _ = q_nope.shape
    k_nope, v = _decompress(params, cfg, c_kv)
    dq, dv = m.qk_nope_head_dim + m.qk_rope_head_dim, m.v_head_dim
    D = min(d for d in fa_ops.HEAD_DIMS if d >= max(dq, dv))
    pad = torch.nn.functional.pad
    q = pad(torch.cat([q_nope, q_rope], dim=-1), (0, D - dq))
    k = pad(torch.cat([k_nope, k_rope[:, :, None, :].expand(B, S, H, -1)], dim=-1), (0, D - dq))
    out = fa_ops.flash_attention(q, k, pad(v, (0, D - dv)), causal=True, window=window,
                                 scale=mla_scale(cfg))
    return out[..., :dv].reshape(B, S, H * dv)


def _mla_attend(
    params: MLAAttention,
    cfg: ModelConfig,
    q_nope: torch.Tensor,
    q_rope: torch.Tensor,
    c_kv: torch.Tensor,
    k_rope: torch.Tensor,
    mask: torch.Tensor | None,
) -> torch.Tensor:
    """Attention over compressed latents, float32 throughout. q_*:
    (B, Sq, H, *); c_kv: (B, Sk, r); k_rope: (B, Sk, dr); mask
    broadcastable to (B, H, Sq, Sk)."""
    m = cfg.mla
    B, Sq, H, _ = q_nope.shape
    k_nope, v = _decompress(params, cfg, c_kv)
    scale = mla_scale(cfg)
    logits = (
        torch.einsum("bqhd,bkhd->bhqk", q_nope.float(), k_nope.float())
        + torch.einsum("bqhd,bkd->bhqk", q_rope.float(), k_rope.float())
    ) * scale
    if mask is not None:
        logits = torch.where(mask, logits, _NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v.float())
    return out.reshape(B, Sq, H * m.v_head_dim).to(q_nope.dtype)


def _mla_attend_chunked(
    params: MLAAttention,
    cfg: ModelConfig,
    q_nope: torch.Tensor,
    q_rope: torch.Tensor,
    c_kv: torch.Tensor,
    k_rope: torch.Tensor,
    window: int | None,
    chunk_q: int = _CHUNK_Q,
) -> torch.Tensor:
    """Chunked causal MLA: k / v decompressed once, then a loop over q
    chunks with a full-k softmax each, so the (H, S, S) logits never
    materialise. Products sum in float32 (the reference's
    ``preferred_element_type``); p is cast to v's dtype before the product
    with v and the output normalised after it, as the reference does."""
    m = cfg.mla
    B, S, H, _ = q_nope.shape
    k_nope, v = _decompress(params, cfg, c_kv)
    scale = mla_scale(cfg)
    kf, krf, vf = k_nope.float(), k_rope.float(), v.float()
    kpos = torch.arange(S, device=q_nope.device)
    chunks = []
    for ci in range(S // chunk_q):
        rows = slice(ci * chunk_q, (ci + 1) * chunk_q)
        logits = (
            torch.einsum("bqhd,bkhd->bhqk", q_nope[:, rows].float(), kf)
            + torch.einsum("bqhd,bkd->bhqk", q_rope[:, rows].float(), krf)
        ) * scale
        qpos = ci * chunk_q + torch.arange(chunk_q, device=q_nope.device)
        mask = kpos[None, :] <= qpos[:, None]
        if window is not None:
            mask = mask & (kpos[None, :] > qpos[:, None] - window)
        logits = torch.where(mask, logits, _NEG_INF)
        p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
        del logits
        out = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), vf)
        out = out / p.sum(dim=-1).permute(0, 2, 1)[..., None]
        chunks.append(out.reshape(B, chunk_q, H * m.v_head_dim).to(q_nope.dtype))
    return torch.cat(chunks, dim=1)


def mla_attention(
    params: MLAAttention,
    cfg: ModelConfig,
    x: torch.Tensor,
    *,
    positions: torch.Tensor,
    cache: dict | None = None,
    window: int | None = None,
    tp: P.TPGroup | None = None,
    impl: str = "plain",
) -> tuple[torch.Tensor, dict | None]:
    """MLA self-attention; the cache stores the normalised latents
    ``c_kv`` and the rotated ``k_rope`` only (written in place by
    ``kvcache.update_mla``): appended, or around the ring if the cache
    is one (the long-context mode's). Returns (output, updated cache).
    ``tp`` (a split replica): this rank's heads of
    ``wq`` / ``w_uk`` / ``w_uv`` and rows of ``wo``, the latent and the
    shared rope key whole on every rank (gathered where the rules split
    them, the latent before ``kv_norm``), the output's partial sums
    reduced; with a cache, the rank's block of its last dimension
    (``serve.engine``'s cache specs): a step writes the block of the new
    latents and gathers the whole cache to decompress it."""
    m = cfg.mla
    B, S, _ = x.shape
    dq = m.qk_nope_head_dim + m.qk_rope_head_dim
    ctp = tp  # the cache's block follows the cache specs
    tp = P.split(tp, params.wq.shape[1], cfg.num_heads * dq)
    x = P.copy_to(x, tp)
    dkv = P.split(tp, params.w_dkv.shape[1], m.kv_lora_rank) is not None
    krope = P.split(tp, params.w_krope.shape[1], m.qk_rope_head_dim) is not None
    q = (x @ params.wq).reshape(B, S, -1, dq)
    q_nope, q_rope = q.split([m.qk_nope_head_dim, m.qk_rope_head_dim], dim=-1)
    cos, sin = rotary_embedding(positions, m.qk_rope_head_dim, cfg.rope_theta,
                                cfg.rope_scaling)
    q_rope = apply_rope(q_rope, cos, sin)
    c_kv = P.latent_norm(x @ (params.w_dkv if dkv else P.copy_to(params.w_dkv, tp)),
                         params.kv_norm, cfg.norm_eps, tp, dkv)
    kr = x @ (params.w_krope if krope else P.copy_to(params.w_krope, tp))
    if krope:
        kr = P.gather_last_partial(kr, tp)
    # the rope key is shared by the heads: rotated with a singleton head axis
    k_rope = apply_rope(kr[:, :, None, :], cos, sin)[:, :, 0, :]

    def block(t, name):  # the rank's block of a new latent / rope key
        return t if cache[name].shape[-1] == t.shape[-1] else P.own_block(t, ctp, t.ndim - 1)

    def whole(t, full):  # a cache block gathered whole
        return t if t.shape[-1] == full else P.gather_dim(t, ctp, t.ndim - 1)

    long_seq = S > _CHUNK_THRESHOLD and S % _CHUNK_Q == 0
    if cache is None or S > 1:
        # full sequence, or a prefill from a fresh cache: attention over
        # the new positions, then (prefill) the cache write
        if cache is None and impl == "kernel" and m.flash:
            out = _mla_flash(params, cfg, q_nope, q_rope, c_kv, k_rope, window)
        elif long_seq:
            out = _mla_attend_chunked(params, cfg, q_nope, q_rope, c_kv, k_rope, window)
        else:
            mask = _causal_mask(S, S, window, x.device)
            out = _mla_attend(params, cfg, q_nope, q_rope, c_kv, k_rope, mask)
        new_cache = None if cache is None else update_mla(
            cache, block(c_kv, "c_kv"), block(k_rope, "k_rope"))
    else:
        new_cache = update_mla(cache, block(c_kv, "c_kv"), block(k_rope, "k_rope"))
        L = new_cache["c_kv"].shape[1]
        slot = torch.arange(L, device=x.device)
        idx = new_cache["index"]  # on the device: a replayed step reads its own
        # the reference's ring formula: the position a slot holds (the
        # largest below idx congruent to it modulo L), negative while
        # unwritten; an appended cache never wraps (check_fits)
        abs_pos = ((idx - 1) - torch.remainder(idx - 1 - slot, L))[None, None, :]
        qpos = positions[:, :, None]  # (B, Sq, 1)
        mask = (abs_pos >= 0) & (abs_pos <= qpos)
        if window is not None:
            mask = mask & (abs_pos > qpos - window)
        out = _mla_attend(params, cfg, q_nope, q_rope,
                          whole(new_cache["c_kv"], m.kv_lora_rank),
                          whole(new_cache["k_rope"], m.qk_rope_head_dim), mask[:, None])
    return P.reduce_from(out @ params.wo, tp), new_cache


def init_mla_attention_cache(cfg: ModelConfig, batch: int, max_len: int,
                             device: torch.device | str | None = None, *,
                             ring: int | None = None) -> dict:
    """An MLA layer's cache on ``device`` (None = CUDA): ``max_len``
    positions, or a ring of ``ring`` slots (the long-context mode: the
    reference's ring of exactly ``long_context_window``, with no ``min``
    against ``max_len``)."""
    m = cfg.mla
    length = max_len if ring is None else ring
    return init_mla_cache(batch, length, m.kv_lora_rank, m.qk_rope_head_dim, dtype_of(cfg),
                          device, ring=ring is not None)


# ---------------------------------------------------------------------------
# Cross-attention (whisper decoder)
# ---------------------------------------------------------------------------

def init_cross_attention(
    cfg: ModelConfig, *, generator: torch.Generator, device: torch.device | str
) -> Attention:
    return init_attention(cfg, generator=generator, device=device)


def cross_attention(
    params: Attention,
    cfg: ModelConfig,
    x: torch.Tensor,
    encoder_out: torch.Tensor,
    tp: P.TPGroup | None = None,
) -> torch.Tensor:
    """Query from decoder x, keys/values from encoder output (no RoPE --
    whisper uses sinusoidal absolute positions; no bias). ``tp``: as in
    ``attention``."""
    tp = P.split(tp, params.wq.shape[1], cfg.num_heads * cfg.resolved_head_dim)
    q, k, v = _project_qkv(params, cfg, x, tp, kv_x=encoder_out)
    k, v = _own_heads(k, v, cfg, tp)
    return _out_proj(params, cfg, _sdpa(q, k, v, None, cfg), tp)
