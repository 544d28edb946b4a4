"""Tensor parallelism within one node's replica: the LM's loss on local
shards over the ``model`` mesh dimension, with explicit collectives.

The reference leaves its ``model`` mesh axis automatic: GSPMD places each
weight by ``train/sharding.py``'s rules and inserts the collectives. Here
a rank holds its block of each weight (``sharding.shard`` of the spec
``make_param_specs`` gives) and runs the Megatron form of the same
placements, whose collectives (``models/parallel.py``) are autograd
functions on plain tensors. The blocks are the model's own
(``models/attention.py``, ``rglru.py``, ``xlstm.py``, ``whisper.py``,
``layers.mlp_forward``): each takes the rank's ``tp`` group, sees from its
weights' shapes what the rules split, and runs these collectives where
they do (the identity on a whole model). This module plans the split,
checks it against the specs, and keeps what only a split replica has:
the vocabulary-parallel lookup and cross entropy, and the MoE's expert
split.

* ``copy_to`` -- identity forward, all-reduce of the gradient: where a
  replicated activation (or a replicated weight such as a qk-norm scale)
  enters a computation split over ``model``;
* ``reduce_from`` -- all-reduce forward, identity backward: the partial
  sums of a row-parallel product, of the vocabulary-parallel lookup and
  of the softmax denominators;
* ``gather_last`` -- all-gather of the last dimension forward, this
  rank's block of the gradient backward: an activation split over its
  features that replicated computation reads (the MoE router's logits,
  a lookup of a table split by features, the sLSTM's gate inputs);
* ``gather_last_partial`` -- the same gather with the gradient's blocks
  summed over ranks (a reduce-scatter) backward: an activation split
  over its features that this rank's split computation reads whole (keys
  and values whose heads do not divide among the ranks, query heads
  split inside a head, MLA's latent, a recurrent block's branch read by
  its gates);
* ``slice_last`` -- this rank's block of a replicated vector forward,
  the gradient's blocks gathered backward (the q/k/v biases, the whole
  ``conv_w`` of a split recurrent branch, an output norm's scale).

Placements, as the rules give them: ``embed.table`` (V, d) by vocabulary
rows (a masked lookup, partial sums reduced) -- or, where the vocabulary
does not divide and the rules' >32 MiB fallback splits it by features
(whisper's 51865), by features (the lookup gathered, the tied
unembedding's partial logits reduced) --, the unembedding (tied: the
table's rows; untied: ``unembed``'s columns) by vocabulary columns with
a vocabulary-parallel cross entropy (max, sum of exponentials and the
label's logit reduced over ranks, float32); attention's ``wq`` / ``wk`` /
``wv`` by output features (whole heads a rank; where the heads do not
divide -- recurrentgemma's 10 on 4 --, the queries gathered and every
head a rank's columns touch computed, its columns kept), ``wo`` by input
features; MLA's ``wq`` / ``w_uk`` / ``w_uv`` by heads, its latent
gathered before ``kv_norm`` (an RMS norm over all r latents) and the
shared rope key whole; the MLP's ``w_gate`` / ``w_up`` by columns,
``w_down`` by rows; the MoE router by experts (its logits gathered,
routing replicated) and the routed experts by experts (each rank
computes its experts' slots; the combine's partial sums reduced with the
block's); the RG-LRU block's branches by columns (the gates read the
gathered branch; the scan elementwise on the rank's features); the
mLSTM's up / gate / q / k / v by columns (its output norm over the split
features: the sum of squares reduced); the sLSTM's gate inputs gathered
whole (the rule's contiguous columns of ``w_in`` hand a rank whole gates,
not heads) and its time loop, step by step under autograd, on the
rank's heads of ``r``; whisper's encoder and decoder self- and
cross-attention and its MLPs the same way, layer norms with bias whole;
norms replicated. A weight the rules leave whole computes whole. No
weight is ever gathered. Every rank of a node runs the same batch; the
loss is the same on every rank.

``collective_bytes`` (``core.mixing``) counts what a rank receives under
``"tp_all_reduce"`` and ``"tp_all_gather"``, ``collective_calls`` the
calls.
"""

from __future__ import annotations

import dataclasses
import types

import torch
import torch.nn.functional as F

from repro_torch.models import transformer
from repro_torch.models.attention import attention, mla_attention
from repro_torch.models.common import ModelConfig
from repro_torch.models.layers import (_rounded, layer_norm, mlp_forward, rms_norm,
                                       sinusoidal_positions)
from repro_torch.models.moe import capacity, router_aux_loss, slots
from repro_torch.models.parallel import (TPGroup, _all_reduce, _SumOver, copy_to,
                                         gather_last, gather_last_partial, reduce_from,
                                         slice_last)
from repro_torch.models.rglru import rglru_block
from repro_torch.models.whisper import decoder_layer, encoder_layer
from repro_torch.models.xlstm import mlstm_block, slstm_block

__all__ = ["TPGroup", "TPPlan", "make_plan", "lm_loss", "copy_to", "reduce_from",
           "gather_last", "gather_last_partial", "slice_last"]

_ATTN_KINDS = ("attn", "local_attn")


def _batch_mean(x: torch.Tensor, batch: tuple[TPGroup, ...], grad: bool = True) -> torch.Tensor:
    """The mean of ``x`` over the ranks a node's batch is split over (one
    group per mesh dimension), each rank's gradient the adjoint's (the
    trainer then averages the ranks' gradients)."""
    for g in batch:
        y = _SumOver.apply(x, g) if grad else _all_reduce(x, g, kind="grad_all_reduce")
        x = y / g.size
    return x


def _max_over(x: torch.Tensor, tp: TPGroup) -> torch.Tensor:
    import torch.distributed as dist

    return x if tp.group is None else _all_reduce(x, tp, dist.ReduceOp.MAX)


# ---------------------------------------------------------------------------
# The plan: which blocks are split, checked against the specs
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TPPlan:
    """Which blocks are split over ``model`` (from the specs): the
    vocabulary (``"rows"``, ``"features"`` or None), each layer's blocks
    (``"attn"``: query heads split, ``"aligned"`` whole heads a rank or
    split inside a head, keys / values ``"local"``, ``"gather"`` or
    ``"whole"``; MLA's latent and rope key; a recurrent ``"block"``'s
    split; the MLP's, the MoE router's and experts', the shared
    experts'), and whisper's encoder layers."""

    size: int
    vocab: str | None
    layers: tuple
    enc_layers: tuple = ()


def _split(spec, dim: int) -> bool:
    return spec is not None and len(spec) > dim and spec[dim] == "model"


def _unsupported(what: str) -> ValueError:
    return ValueError(f"tensor parallelism of {what}: the partition rules give no such "
                      "placement")


def _is_norm(name: str) -> bool:
    return any("norm" in part or part.startswith("ln") or part.endswith("_ln")
               for part in name.split("."))


def _attn_plan(spec: dict, pre: str, cfg: ModelConfig, size: int, where: str) -> dict:
    wq, wk, wv, wo = (spec[pre + n] for n in ("wq", "wk", "wv", "wo"))
    q = _split(wq, 1)
    if q != _split(wo, 0) or any(_split(s, 0) for s in (wq, wk, wv)) or _split(wo, 1):
        raise _unsupported(f"{where}'s attention projections split as "
                           f"{ {n: spec[pre + n] for n in ('wq', 'wk', 'wv', 'wo')} }")
    kv_split = _split(wk, 1)
    if kv_split != _split(wv, 1):
        raise _unsupported(f"{where}'s keys and values split differently")
    if not q:
        if kv_split:
            raise _unsupported(f"{where}: keys split with whole query heads")
        return {"q": False, "kv": "whole", "aligned": True}
    aligned = cfg.num_heads % size == 0
    if not kv_split:
        kv = "whole"
    else:
        kv = "local" if aligned and cfg.num_kv_heads % size == 0 else "gather"
    return {"q": True, "kv": kv, "aligned": aligned}


def _mla_plan(spec: dict, cfg: ModelConfig, size: int, where: str) -> dict:
    q = _split(spec["attn.wq"], 1)
    heads = [_split(spec[f"attn.{n}"], 1) for n in ("w_uk", "w_uv")] + [
        _split(spec["attn.wo"], 0)]
    if any(h != q for h in heads) or any(_split(spec[f"attn.{n}"], 0) for n in
                                         ("wq", "w_dkv", "w_krope", "w_uk", "w_uv")):
        raise _unsupported(f"{where}'s MLA projections split as "
                           f"{ {n: s for n, s in spec.items() if n.startswith('attn.w')} }")
    dkv, krope = _split(spec["attn.w_dkv"], 1), _split(spec["attn.w_krope"], 1)
    if not q and (dkv or krope):
        raise _unsupported(f"{where}: an MLA latent split beside whole heads")
    if q and cfg.num_heads % size:
        raise _unsupported(f"{where}: {cfg.num_heads} MLA heads over {size} ranks")
    return {"q": q, "dkv": dkv, "krope": krope}


def _mlp_plan(spec: dict, cfg: ModelConfig, where: str) -> dict:
    mlp = moe = shared = False
    if cfg.moe is None:
        cols = [_split(spec[f"mlp.{n}"], 1) for n in ("w_gate", "w_up") if f"mlp.{n}" in spec]
        mlp = _split(spec["mlp.w_down"], 0)
        if any(c != mlp for c in cols) or _split(spec["mlp.w_down"], 1):
            raise _unsupported(f"{where}'s MLP split as "
                               f"{ {n: spec[n] for n in spec if n.startswith('mlp')} }")
    else:
        moe = _split(spec["mlp.router"], 1)
        routed = [_split(spec[f"mlp.routed.{n}"], 0) for n in ("w_gate", "w_up", "w_down")]
        if any(r != moe for r in routed):
            raise _unsupported(f"{where}'s router and experts split differently")
        if "mlp.shared.w_down" in spec:
            shared = _split(spec["mlp.shared.w_down"], 0)
            if any(_split(spec[f"mlp.shared.{n}"], 1) != shared for n in
                   ("w_gate", "w_up") if f"mlp.shared.{n}" in spec):
                raise _unsupported(f"{where}'s shared experts split unevenly")
        if shared and not moe:
            raise _unsupported(f"{where}: shared experts split beside whole experts")
    return {"mlp": mlp, "moe": moe, "shared": shared}


def _block_plan(spec: dict, cols: tuple, rows: tuple, vecs: tuple, where: str) -> dict:
    """A recurrent block: ``cols`` split by output features, ``rows`` by
    input features, ``vecs`` along their one dimension, all together or
    none; ``conv_w`` split by features where the rules split it."""
    split = _split(spec[f"block.{cols[0]}"], 1)
    ok = all(_split(spec[f"block.{n}"], 1) == split and not _split(spec[f"block.{n}"], 0)
             for n in cols) and all(_split(spec[f"block.{n}"], 0) == split and not
                                    _split(spec[f"block.{n}"], 1) for n in rows) and all(
        _split(spec[f"block.{n}"], 0) == split for n in vecs)
    conv = _split(spec["block.conv_w"], 1)
    if not ok or _split(spec["block.conv_w"], 0) or (conv and not split):
        raise _unsupported(f"{where}'s block split as "
                           f"{ {n: s for n, s in spec.items() if n.startswith('block.')} }")
    return {"split": split, "conv": conv}


def _slstm_plan(spec: dict, cfg: ModelConfig, size: int, where: str) -> dict:
    w_in, heads = _split(spec["block.w_in"], 1), _split(spec["block.r"], 1)
    ff = _split(spec["block.w_ff_up"], 1)
    if (_split(spec["block.w_in"], 0) or any(_split(spec["block.r"], d) for d in (0, 2, 3))
            or _split(spec["block.w_ff_down"], 0) != ff or _split(spec["block.w_ff_down"], 1)
            or _split(spec["block.w_ff_up"], 0) or _split(spec["block.b_in"], 0)):
        raise _unsupported(f"{where}'s sLSTM split as "
                           f"{ {n: s for n, s in spec.items() if n.startswith('block.')} }")
    return {"w_in": w_in, "heads": heads, "ff": ff}


def _layer_plan(spec: dict, cfg: ModelConfig, size: int, kind: str, where: str):
    out: dict = {}
    if kind in _ATTN_KINDS:
        out["attn"] = _mla_plan(spec, cfg, size, where) if cfg.mla is not None else \
            _attn_plan(spec, "attn.", cfg, size, where)
    elif kind == "enc":
        out["attn"] = _attn_plan(spec, "attn.", cfg, size, where)
    elif kind == "dec":
        out["attn"] = _attn_plan(spec, "self_attn.", cfg, size, where)
        out["cross"] = _attn_plan(spec, "cross_attn.", cfg, size, where)
    elif kind == "rglru":
        out["block"] = _block_plan(spec, ("w_gate", "w_rnn_in", "w_a", "w_x"), ("w_out",),
                                   ("lam",), where)
    elif kind == "mlstm":
        out["block"] = _block_plan(spec, ("w_up", "w_gate", "wq", "wk", "wv"), ("w_down",),
                                   (), where)
        if any(_split(spec[f"block.{n}"], d) for n, d in (("w_if", 0), ("w_if", 1),
                                                          ("b_if", 0))):
            raise _unsupported(f"{where}: the mLSTM gate projection split")
    elif kind == "slstm":
        out["block"] = _slstm_plan(spec, cfg, size, where)
    else:
        raise _unsupported(f"{kind!r} layers")
    if "mlp.w_down" in spec or "mlp.router" in spec:
        out.update(_mlp_plan(spec, cfg, where))
    return types.MappingProxyType(out)


def make_plan(cfg: ModelConfig, specs: dict, size: int) -> TPPlan:
    """The plan of ``cfg`` under ``specs`` (``sharding.make_param_specs``
    without node axis, fsdp axis gathered away) over ``size`` ranks;
    raises ``ValueError`` for a placement the rules never give (a split
    norm, projections split unevenly)."""
    for name, spec in specs.items():
        extra = [e for e in spec if e is not None and e != "model"]
        if extra:
            raise ValueError(f"{name}: spec {spec} splits over {extra} in the compute layout")
        if _is_norm(name) and any(e is not None for e in spec):
            raise _unsupported(f"a split norm ({name})")
    audio = cfg.arch_type == "audio"
    table = specs["token_embed" if audio else "embed.table"]
    vocab = "rows" if _split(table, 0) else "features" if _split(table, 1) else None
    if not audio and not cfg.tie_embeddings:
        un = specs["embed.unembed"]
        want = {"rows": (False, True), "features": (True, False), None: (False, False)}[vocab]
        if (_split(un, 0), _split(un, 1)) != want:
            raise _unsupported(f"an unembedding split as {un} beside a table split as {table}")

    def layer(pre: str, kind: str):
        spec = {name[len(pre):]: s for name, s in specs.items() if name.startswith(pre)}
        return _layer_plan(spec, cfg, size, kind, pre.rstrip("."))

    if audio:
        return TPPlan(size=size, vocab=vocab,
                      layers=tuple(layer(f"dec_layers.{i}.", "dec")
                                   for i in range(cfg.num_layers)),
                      enc_layers=tuple(layer(f"enc_layers.{i}.", "enc")
                                       for i in range(cfg.encoder.num_layers)))
    return TPPlan(size=size, vocab=vocab,
                  layers=tuple(layer(f"layers.{i}.", cfg.kind(i)) for i in range(cfg.num_layers)))


# ---------------------------------------------------------------------------
# The forward on local shards
# ---------------------------------------------------------------------------

def _ns(params: dict, prefix: str):
    """The leaves under ``prefix`` as attributes (a duck-typed module)."""
    out = types.SimpleNamespace()
    for name, v in params.items():
        if name.startswith(prefix):
            node = out
            *path, last = name[len(prefix):].split(".")
            for key in path:
                if not hasattr(node, key):
                    setattr(node, key, types.SimpleNamespace())
                node = getattr(node, key)
            setattr(node, last, v)
    return out


def _moe(p, cfg: ModelConfig, h: torch.Tensor, plan, tp: TPGroup, batch: tuple = ()):
    """The MoE block (``models/moe.py``'s algorithm) with the experts split:
    the router's logits gathered, routing and the aux loss computed whole,
    each rank's experts fill and compute their slots, the combine's
    partial sums reduced (with the split shared experts'). With ``batch``
    (the node's batch split over ranks) the aux loss takes its token
    shares and mean probabilities over the whole batch, as the
    reference's does."""
    m = cfg.moe
    B, S, D = h.shape
    E, K = m.num_experts, m.top_k
    split = plan["moe"]
    x = copy_to(h, tp) if split else h
    logits = x @ p.router
    if split:
        logits = gather_last(logits, tp)
    probs = torch.softmax(logits.float(), dim=-1)
    gate_vals, expert_ids = torch.topk(probs, K, dim=-1, sorted=True)
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)
    if batch:
        experts = torch.arange(E, device=h.device)
        share = _batch_mean((expert_ids.reshape(B * S, K)[:, :1] == experts).float().mean(0),
                            batch, grad=False)
        mean_p = _batch_mean(probs.reshape(B * S, E).float().mean(0), batch)
        aux = E * (share * mean_p).sum()
    else:
        aux = router_aux_loss(probs.reshape(B * S, E), expert_ids.reshape(B * S, K), E)
    C = capacity(S, cfg)
    El = E // tp.size if split else E
    e0 = tp.rank * El if split else 0
    flat_expert = expert_ids.reshape(B, S * K)
    slot = slots(expert_ids, E)
    batch_row = torch.arange(B, device=h.device)[:, None] * C
    mine = (slot < C) & (flat_expert >= e0) & (flat_expert < e0 + El)
    dest = torch.where(mine, (flat_expert - e0) * (B * C) + batch_row + slot,
                       El * B * C).reshape(-1)
    token_rep = x[:, :, None, :].expand(B, S, K, D).reshape(B * S * K, D)
    buf = x.new_zeros((El * B * C + 1, D)).index_copy(0, dest, token_rep)
    expert_in = buf[: El * B * C].view(El, B * C, D)
    r = p.routed
    gate = F.silu(torch.bmm(expert_in, r.w_gate))
    up = torch.bmm(expert_in, r.w_up)
    expert_out = torch.bmm(gate * up, r.w_down).reshape(El * B * C, D)
    flat_out = torch.cat([expert_out, expert_out.new_zeros((1, D))])
    gathered = flat_out.index_select(0, dest)
    gv = copy_to(gate_vals, tp) if split else gate_vals  # each rank weighs its own choices
    out = (gathered * gv.reshape(B * S * K, 1).to(gathered.dtype)).reshape(B, S, K, D).sum(dim=2)
    if hasattr(p, "shared") and plan["shared"]:
        out = out + mlp_forward(p.shared, x, cfg.mlp_type)
    if split:
        out = reduce_from(out, tp)
    if hasattr(p, "shared") and not plan["shared"]:
        out = out + mlp_forward(p.shared, h, cfg.mlp_type)
    return out, aux


def _layer(params: dict, i: int, cfg: ModelConfig, plan: TPPlan, tp: TPGroup, x, positions,
           batch: tuple = (), cache: dict | None = None, window: int | None = None,
           impl: str = "plain"):
    """Layer ``i`` on local shards: (x, the MoE aux loss or None); with a
    ``cache`` (this rank's block of the layer's cache, serving; written in
    place) or ``window`` (the long-context mode's override) as
    ``transformer.LM``'s layer takes them."""
    lp = plan.layers[i]
    kind = cfg.kind(i)
    p = _ns(params, f"layers.{i}.")
    aux = None
    if kind in _ATTN_KINDS:
        h = rms_norm(p.ln1, x, cfg.norm_eps)
        if cfg.mla is not None:
            win = window if window is not None else (
                cfg.sliding_window if kind == "local_attn" else None)
            out = mla_attention(p.attn, cfg, h, positions=positions, cache=cache, window=win,
                                tp=tp)[0]
        else:
            out = attention(p.attn, cfg, h, positions=positions,
                            local=kind == "local_attn" or window is not None, window=window,
                            cache=cache, impl=impl, tp=tp)[0]
        if cfg.post_block_norms:
            out = rms_norm(p.post_ln1, out, cfg.norm_eps)
        x = x + out
    elif kind == "rglru":
        x = rglru_block(p.block, cfg, x, cache, impl=impl, tp=tp)[0]
    elif kind == "mlstm":
        return mlstm_block(p.block, cfg, x, cache, tp=tp)[0], None
    else:  # slstm
        return slstm_block(p.block, cfg, x, cache, tp=tp)[0], None
    if cfg.d_ff > 0:
        h = rms_norm(p.ln2, x, cfg.norm_eps)
        if cfg.moe is not None:
            out, aux = _moe(p.mlp, cfg, h, lp, tp, batch)
        else:
            out = mlp_forward(p.mlp, h, cfg.mlp_type, tp if lp["mlp"] else None)
        if cfg.post_block_norms:
            out = rms_norm(p.post_ln2, out, cfg.norm_eps)
        x = x + out
    return x, aux


def _embed(table: torch.Tensor, cfg: ModelConfig, plan: TPPlan, tp: TPGroup,
           tokens: torch.Tensor):
    """The lookup: by vocabulary rows (a masked lookup, partial sums
    reduced), by features (this rank's features of every token,
    gathered), or whole."""
    if plan.vocab == "rows":
        rows = table.shape[0]
        local = tokens - tp.rank * rows
        mine = (local >= 0) & (local < rows)
        x = F.embedding(torch.where(mine, local, 0), table) * mine[..., None].to(table.dtype)
        x = reduce_from(x, tp)
    elif plan.vocab == "features":
        x = gather_last(F.embedding(tokens, table), tp)
    else:
        x = F.embedding(tokens, table)
    if cfg.embedding_scale:
        x = x * _rounded(cfg.d_model**0.5, x.dtype)
    return x


def _chunk_nll(params: dict, cfg: ModelConfig, plan: TPPlan, tp: TPGroup,
               hidden: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """The summed next-token NLL of a chunk (``transformer._token_nll``
    whole): on this rank's vocabulary columns with the cross entropy
    reduced over ranks; or, the table split by features, this rank's
    features' partial logits reduced to the whole logits."""
    audio = cfg.arch_type == "audio"
    table = params["token_embed" if audio else "embed.table"]
    tied = audio or cfg.tie_embeddings

    def unembed(x):
        logits = x @ table.T if tied else x @ params["embed.unembed"]
        if cfg.final_logit_softcap > 0.0 and plan.vocab != "features":
            cap = cfg.final_logit_softcap
            logits = cap * torch.tanh(logits / cap)
        return logits

    if plan.vocab == "features":
        logits = reduce_from(unembed(slice_last(hidden, tp)), tp)
        if cfg.final_logit_softcap > 0.0:
            cap = cfg.final_logit_softcap
            logits = cap * torch.tanh(logits / cap)
        return transformer._token_nll(logits, labels).sum()
    logits = unembed(copy_to(hidden, tp) if plan.vocab else hidden)
    if not plan.vocab:
        return transformer._token_nll(logits, labels).sum()
    lf = logits.float()
    top = _max_over(lf.detach().amax(dim=-1), tp)
    lse = torch.log(reduce_from(torch.exp(lf - top[..., None]).sum(dim=-1), tp)) + top
    cols = lf.shape[-1]
    local = labels.long() - tp.rank * cols
    mine = (local >= 0) & (local < cols)
    picked = lf.gather(-1, local.clamp(0, cols - 1)[..., None])[..., 0] * mine
    return (lse - reduce_from(picked, tp)).sum()


def _nll(params: dict, cfg: ModelConfig, plan: TPPlan, tp: TPGroup, x: torch.Tensor,
         labels: torch.Tensor, remat: bool) -> torch.Tensor:
    """The mean next-token NLL over chunks of ``transformer._XENT_CHUNK``."""
    B, S, _ = x.shape
    chunk = transformer._XENT_CHUNK if S % transformer._XENT_CHUNK == 0 else S
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for c0 in range(0, S, chunk):
        args = (params, cfg, plan, tp, x[:, c0:c0 + chunk], labels[:, c0:c0 + chunk])
        total = total + (transformer._remat(_chunk_nll, *args) if remat else _chunk_nll(*args))
    return total / (B * S)


def _enc_layer(params: dict, i: int, cfg: ModelConfig, tp: TPGroup, x, zeros):
    return encoder_layer(_ns(params, f"enc_layers.{i}."), cfg, x, zeros, tp)


def _dec_layer(params: dict, i: int, cfg: ModelConfig, tp: TPGroup, x, positions, enc):
    return decoder_layer(_ns(params, f"dec_layers.{i}."), cfg, x, positions, enc, tp=tp)[0]


def _whisper_loss(params: dict, cfg: ModelConfig, batch: dict, plan: TPPlan, tp: TPGroup,
                  remat: bool) -> torch.Tensor:
    """``registry.loss_fn`` of whisper on local shards: the encoder over
    the stub frames (bidirectional, RoPE at angle 0), the decoder's causal
    self-attention and cross-attention, layer norms with bias whole, the
    tied table by vocabulary rows or by features."""
    frames, tokens, labels = batch["frames"], batch["tokens"], batch["labels"]
    B, Sf, D = frames.shape
    x = frames + sinusoidal_positions(Sf, D, frames.dtype, frames.device)[None]
    zeros = torch.zeros((B, Sf), dtype=torch.int64, device=frames.device)
    for i in range(cfg.encoder.num_layers):
        args = (params, i, cfg, tp, x, zeros)
        x = transformer._remat(_enc_layer, *args) if remat else _enc_layer(*args)
    enc = layer_norm(_ns(params, "enc_final_ln."), x, cfg.norm_eps)
    y = _embed(params["token_embed"], cfg, plan, tp, tokens)
    S = tokens.shape[1]
    positions = torch.arange(S, device=tokens.device)[None, :].expand(B, S)
    y = y + sinusoidal_positions(S, D, y.dtype, y.device)[positions]
    for i in range(cfg.num_layers):
        args = (params, i, cfg, tp, y, positions, enc)
        y = transformer._remat(_dec_layer, *args) if remat else _dec_layer(*args)
    y = layer_norm(_ns(params, "dec_final_ln."), y, cfg.norm_eps)
    return _nll(params, cfg, plan, tp, y, labels, remat)


def lm_loss(params: dict, cfg: ModelConfig, batch: dict, plan: TPPlan, tp: TPGroup, *,
            remat: bool = False, batch_groups: tuple = (), impl: str = "plain") -> torch.Tensor:
    """``registry.loss_fn``'s loss (float32: the mean next-token cross
    entropy plus ``router_aux_coef`` times the MoE aux loss) of the model
    whose leaves are ``params`` (this rank's blocks, named as the model's
    ``named_parameters()``) on ``batch`` (``tokens``, ``labels``, optional
    ``image_embeds``; whisper's ``frames``); ``remat`` recomputes each
    layer's and each loss chunk's activations in the backward pass.
    ``batch_groups``: the groups (``TPGroup``s) a node's batch is split
    over, for the MoE aux loss's whole-batch statistics. ``impl``: the
    attention's, as ``models/attention.py`` takes it."""
    remat = remat and torch.is_grad_enabled()
    if cfg.arch_type == "audio":
        return _whisper_loss(params, cfg, batch, plan, tp, remat)
    tokens, labels = batch["tokens"], batch["labels"]
    image_embeds = batch.get("image_embeds")
    x = _embed(params["embed.table"], cfg, plan, tp, tokens)
    if image_embeds is not None:
        x = torch.cat([image_embeds.to(x.dtype), x], dim=1)
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)[None, :].expand(B, S)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(cfg.num_layers):
        args = (params, i, cfg, plan, tp, x, positions, batch_groups, None, None, impl)
        x, a = transformer._remat(_layer, *args) if remat else _layer(*args)
        if a is not None:
            aux = aux + a
    x = rms_norm(types.SimpleNamespace(scale=params["final_norm.scale"]), x, cfg.norm_eps)
    if image_embeds is not None:
        x = x[:, image_embeds.shape[1]:, :]
    loss = _nll(params, cfg, plan, tp, x, labels, remat)
    if cfg.moe is not None:
        loss = loss + cfg.moe.router_aux_coef * aux
    return loss


# ---------------------------------------------------------------------------
# Serving on local shards (``serve.engine.make_serve_setup``)
# ---------------------------------------------------------------------------

def logits(params: dict, cfg: ModelConfig, plan: TPPlan, tp: TPGroup,
           hidden: torch.Tensor) -> torch.Tensor:
    """The logits of ``hidden`` whole over the vocabulary on every rank:
    this rank's vocabulary columns gathered (a table split by rows, an
    untied unembedding by columns), or a table split by features, its
    partial logits reduced; the final softcap after."""
    audio = cfg.arch_type == "audio"
    table = params["token_embed" if audio else "embed.table"]
    tied = audio or cfg.tie_embeddings
    if plan.vocab == "features":
        out = reduce_from(slice_last(hidden, tp) @ table.T, tp)
    else:
        out = hidden @ table.T if tied else hidden @ params["embed.unembed"]
        if plan.vocab:
            out = gather_last(out, tp)
    if cfg.final_logit_softcap > 0.0:
        cap = cfg.final_logit_softcap
        out = cap * torch.tanh(out / cap)
    return out


def serve_hidden(params: dict, cfg: ModelConfig, plan: TPPlan, tp: TPGroup,
                 tokens: torch.Tensor, positions: torch.Tensor, cache: list, *,
                 window: int | None = None,
                 image_embeds: torch.Tensor | None = None) -> torch.Tensor:
    """``LM.forward(return_hidden=True)`` with a cache on local shards: the
    final-normed hidden states of ``tokens`` (after ``image_embeds``) at
    ``positions``, this rank's cache blocks written in place; a prefill's
    attention in flash, its RG-LRU in the scan kernel (``impl="kernel"``)."""
    x = _embed(params["embed.table"], cfg, plan, tp, tokens)
    if image_embeds is not None:
        x = torch.cat([image_embeds.to(x.dtype), x], dim=1)
    for i in range(cfg.num_layers):
        x = _layer(params, i, cfg, plan, tp, x, positions, cache=cache[i], window=window,
                   impl="kernel")[0]
    return rms_norm(types.SimpleNamespace(scale=params["final_norm.scale"]), x, cfg.norm_eps)


def whisper_encode(params: dict, cfg: ModelConfig, tp: TPGroup,
                   frames: torch.Tensor) -> torch.Tensor:
    """``whisper.encode`` on local shards: the encoder's states, whole on
    every rank."""
    B, Sf, D = frames.shape
    x = frames + sinusoidal_positions(Sf, D, frames.dtype, frames.device)[None]
    zeros = torch.zeros((B, Sf), dtype=torch.int64, device=frames.device)
    for i in range(cfg.encoder.num_layers):
        x = _enc_layer(params, i, cfg, tp, x, zeros)
    return layer_norm(_ns(params, "enc_final_ln."), x, cfg.norm_eps)


def whisper_serve_hidden(params: dict, cfg: ModelConfig, plan: TPPlan, tp: TPGroup,
                         tokens: torch.Tensor, positions: torch.Tensor, cache: dict,
                         encoder_out: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """``whisper_forward(return_hidden=True)`` with a cache on local shards:
    the decoder over ``encoder_out`` (whole), ``table`` the decoder's
    position table, this rank's self-attention cache blocks written in
    place."""
    y = _embed(params["token_embed"], cfg, plan, tp, tokens) + table[positions]
    for i in range(cfg.num_layers):
        y = decoder_layer(_ns(params, f"dec_layers.{i}."), cfg, y, positions, encoder_out,
                          cache["self"][i], tp=tp)[0]
    return layer_norm(_ns(params, "dec_final_ln."), y, cfg.norm_eps)
