"""Tensor parallelism within one node's replica: the LM's loss on local
shards over the ``model`` mesh dimension, with explicit collectives.

The reference leaves its ``model`` mesh axis automatic: GSPMD places each
weight by ``train/sharding.py``'s rules and inserts the collectives. Here
a rank holds its block of each weight (``sharding.shard`` of the spec
``make_param_specs`` gives) and runs the Megatron form of the same
placements, whose collectives are autograd functions on plain tensors:

* ``copy_to`` -- identity forward, all-reduce of the gradient: where a
  replicated activation (or a replicated weight such as a qk-norm scale)
  enters a computation split over ``model``;
* ``reduce_from`` -- all-reduce forward, identity backward: the partial
  sums of a row-parallel product, of the vocabulary-parallel lookup and
  of the softmax denominators;
* ``gather_last`` -- all-gather of the last dimension forward, this
  rank's block of the gradient backward: an activation split over its
  features that replicated computation reads (the MoE router's logits);
* ``gather_last_partial`` -- the same gather with the gradient's blocks
  summed over ranks (a reduce-scatter) backward: keys and values whose
  heads do not divide among the ranks, read by this rank's query heads;
* ``slice_last`` -- this rank's block of a replicated vector forward,
  the gradient's blocks gathered backward (the q/k/v biases).

Placements, as the rules give them: ``embed.table`` (V, d) by vocabulary
rows (a masked lookup, partial sums reduced), the unembedding (tied:
the table's rows; untied: ``unembed``'s columns) by vocabulary columns
with a vocabulary-parallel cross entropy (max, sum of exponentials and
the label's logit reduced over ranks, float32); attention's ``wq`` /
``wk`` / ``wv`` by output features (whole heads a rank), ``wo`` by input
features; the MLP's ``w_gate`` / ``w_up`` by columns, ``w_down`` by
rows; the MoE router by experts (its logits gathered, routing replicated)
and the routed experts by experts (each rank computes its experts'
slots; the combine's partial sums reduced with the block's); norms
replicated. A weight the rules leave whole computes whole. No weight is
ever gathered. Every rank of a node runs the same batch; the loss is the
same on every rank.

Layer kinds other than GQA attention with an MLP or MoE block (MLA, the
xLSTM and RG-LRU blocks, whisper) and placements the rules give only
where a dimension does not divide (query heads split inside a head, an
odd vocabulary split by features) raise ``NotImplementedError``: ROADMAP
item 13f.

``collective_bytes`` (``core.mixing``) counts what a rank receives under
``"tp_all_reduce"`` and ``"tp_all_gather"``, ``collective_calls`` the
calls.
"""

from __future__ import annotations

import dataclasses
import types

import torch
import torch.nn.functional as F

from repro_torch.core import mixing as _M
from repro_torch.models import transformer
from repro_torch.models.attention import _causal_mask, _sdpa, _sdpa_chunked, _CHUNK_Q, \
    _CHUNK_THRESHOLD
from repro_torch.models.common import ModelConfig
from repro_torch.models.layers import _rounded, apply_rope, mlp_forward, rms_norm, \
    rotary_embedding
from repro_torch.models.moe import capacity, router_aux_loss, slots

__all__ = ["TPGroup", "TPPlan", "make_plan", "lm_loss", "copy_to", "reduce_from",
           "gather_last", "gather_last_partial", "slice_last", "NOT_PORTED_TP"]

NOT_PORTED_TP = "not ported yet (ROADMAP queue 1 item 13f)"

_ATTN_KINDS = ("attn", "local_attn")


@dataclasses.dataclass(frozen=True)
class TPGroup:
    """The ranks one node's replica is split over: ``group`` (None: one
    rank, every collective the identity), its ``size`` and this rank's
    index."""

    group: object = None
    size: int = 1
    rank: int = 0

    @classmethod
    def of(cls, group) -> "TPGroup":
        if group is None:
            return cls()
        n = _M.axis_size(group)
        return cls(group if n > 1 else None, n, _M.axis_index(group) if n > 1 else 0)


def _count(kind: str, nbytes: int) -> None:
    _M.collective_bytes[kind] += nbytes
    _M.collective_calls[kind] += 1


def _all_reduce(x: torch.Tensor, tp: TPGroup, op=None, kind: str = "tp_all_reduce"
                ) -> torch.Tensor:
    import torch.distributed as dist

    y = x.contiguous().clone()
    if op is None:
        dist.all_reduce(y, group=tp.group)
    else:
        dist.all_reduce(y, op=op, group=tp.group)
    _count(kind, 2 * (tp.size - 1) * y.numel() * y.element_size() // tp.size)
    return y


def _all_gather_last(x: torch.Tensor, tp: TPGroup) -> torch.Tensor:
    import torch.distributed as dist

    flat = x.contiguous().reshape(-1)
    out = torch.empty((tp.size * flat.numel(),), dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, flat, group=tp.group)
    _count("tp_all_gather", (tp.size - 1) * flat.numel() * flat.element_size())
    return torch.cat(out.view((tp.size,) + tuple(x.shape)).unbind(0), dim=-1)


def _own_last(x: torch.Tensor, tp: TPGroup) -> torch.Tensor:
    w = x.shape[-1] // tp.size
    return x[..., tp.rank * w:(tp.rank + 1) * w].contiguous()


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.tp), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        return _all_reduce(x, tp)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumOver(torch.autograd.Function):
    """The sum over ranks with its exact adjoint (the gradients' sum over
    ranks): for a sum whose inputs are different batch slices."""

    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return _all_reduce(x, tp, kind="grad_all_reduce")

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.tp, kind="grad_all_reduce"), None


class _GatherLast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp, partial):
        ctx.tp, ctx.partial = tp, partial
        return _all_gather_last(x, tp)

    @staticmethod
    def backward(ctx, g):
        if ctx.partial:
            g = _all_reduce(g, ctx.tp)
        return _own_last(g, ctx.tp), None, None


class _SliceLast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return _own_last(x, tp)

    @staticmethod
    def backward(ctx, g):
        return _all_gather_last(g, ctx.tp), None


def copy_to(x: torch.Tensor, tp: TPGroup) -> torch.Tensor:
    return x if tp.group is None else _CopyTo.apply(x, tp)


def reduce_from(x: torch.Tensor, tp: TPGroup) -> torch.Tensor:
    return x if tp.group is None else _ReduceFrom.apply(x, tp)


def gather_last(x: torch.Tensor, tp: TPGroup) -> torch.Tensor:
    return x if tp.group is None else _GatherLast.apply(x, tp, False)


def gather_last_partial(x: torch.Tensor, tp: TPGroup) -> torch.Tensor:
    return x if tp.group is None else _GatherLast.apply(x, tp, True)


def slice_last(x: torch.Tensor, tp: TPGroup) -> torch.Tensor:
    return x if tp.group is None else _SliceLast.apply(x, tp)


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
    vocabulary, each layer's attention (``"q"``: query heads split;
    keys / values ``"local"`` (whole heads a rank), ``"gather"`` (split
    inside heads: gathered) or ``"whole"``), its MLP, its MoE router and
    experts, its shared experts."""

    size: int
    vocab: bool
    layers: tuple


def _split(spec, dim: int) -> bool:
    return spec is not None and spec[dim] == "model"


def _unsupported(what: str) -> NotImplementedError:
    return NotImplementedError(f"tensor parallelism of {what}: {NOT_PORTED_TP}")


def make_plan(cfg: ModelConfig, specs: dict, size: int) -> TPPlan:
    """The plan of ``cfg`` under ``specs`` (``sharding.make_param_specs``
    without node axis, fsdp axis gathered away) over ``size`` ranks;
    raises ``NotImplementedError`` for what this module does not split."""
    if cfg.arch_type == "audio":
        raise _unsupported(f"the encoder-decoder {cfg.name}")
    if cfg.mla is not None:
        raise _unsupported("MLA attention")

    def only_model(name):
        spec = specs[name]
        extra = [e for e in spec if e is not None and e != "model"]
        if extra:
            raise ValueError(f"{name}: spec {spec} splits over {extra} in the compute layout")
        return spec

    table = only_model("embed.table")
    vocab = _split(table, 0)
    if any(e is not None for e in table) and not vocab:
        raise _unsupported(f"an embedding table split by features ({cfg.name})")
    if not cfg.tie_embeddings:
        un = only_model("embed.unembed")
        if _split(un, 1) != vocab or _split(un, 0):
            raise _unsupported(f"an unembedding split as {un} beside a table split as {table}")
    layers = []
    for i in range(cfg.num_layers):
        kind = cfg.kind(i)
        if kind not in _ATTN_KINDS:
            raise _unsupported(f"{kind!r} layers")
        pre = f"layers.{i}."
        spec = {name[len(pre):]: only_model(name) for name in specs if name.startswith(pre)}
        for name, s in spec.items():
            if "norm" in name and any(e is not None for e in s):
                raise _unsupported(f"a split norm scale ({pre}{name})")
        q = _split(spec["attn.wq"], 1)
        if q != _split(spec["attn.wo"], 0) or any(_split(spec[n], 0) for n in
                                                    ("attn.wq", "attn.wk", "attn.wv")):
            raise _unsupported(f"layer {i}'s attention projections split as "
                               f"{ {n: spec[n] for n in spec if n.startswith('attn.w')} }")
        if q and cfg.num_heads % size:
            raise _unsupported(f"{cfg.num_heads} query heads over {size} ranks")
        kv_split = _split(spec["attn.wk"], 1)
        if kv_split != _split(spec["attn.wv"], 1):
            raise _unsupported(f"layer {i}'s keys and values split differently")
        if not q:
            kv = "whole" if not kv_split else None
            if kv is None:
                raise _unsupported(f"layer {i}: keys split with whole query heads")
        elif not kv_split:
            kv = "whole"
        else:
            kv = "local" if cfg.num_kv_heads % size == 0 else "gather"
        mlp = moe = shared = False
        if cfg.d_ff > 0:
            if cfg.moe is None:
                cols = [_split(spec[f"mlp.{n}"], 1) for n in ("w_gate", "w_up") if
                        f"mlp.{n}" in spec]
                mlp = _split(spec["mlp.w_down"], 0)
                if any(c != mlp for c in cols) or _split(spec["mlp.w_down"], 1):
                    raise _unsupported(f"layer {i}'s MLP split as "
                                       f"{ {n: spec[n] for n in spec if n.startswith('mlp')} }")
            else:
                moe = _split(spec["mlp.router"], 1)
                routed = [_split(spec[f"mlp.routed.{n}"], 0) for n in
                          ("w_gate", "w_up", "w_down")]
                if any(r != moe for r in routed):
                    raise _unsupported(f"layer {i}'s router and experts split differently")
                if "mlp.shared.w_down" in spec:
                    shared = _split(spec["mlp.shared.w_down"], 0)
                    if any(_split(spec[f"mlp.shared.{n}"], 1) != shared for n in
                           ("w_gate", "w_up") if f"mlp.shared.{n}" in spec):
                        raise _unsupported(f"layer {i}'s shared experts split unevenly")
                if shared and not moe:
                    raise _unsupported(f"layer {i}: shared experts split beside whole experts")
        layers.append(types.MappingProxyType(
            {"q": q, "kv": kv, "mlp": mlp, "moe": moe, "shared": shared}))
    return TPPlan(size=size, vocab=vocab, layers=tuple(layers))


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


def _attention(p, cfg: ModelConfig, h: torch.Tensor, positions: torch.Tensor, local: bool,
               plan, tp: TPGroup) -> torch.Tensor:
    """GQA self-attention on this rank's query heads; the output's partial
    sums reduced over ranks (whole: computed whole)."""
    B, S, _ = h.shape
    H, Hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    split = plan["q"]
    Hl = H // tp.size if split else H
    x = copy_to(h, tp) if split else h

    def weight(w):  # a whole weight read by split computation: gradient summed
        return copy_to(w, tp) if split else w

    q = x @ p.wq
    if cfg.attn_bias:
        q = q + (slice_last(p.bq, tp) if split else p.bq)
    kv = plan["kv"]
    k, v = x @ (p.wk if kv != "whole" else weight(p.wk)), \
        x @ (p.wv if kv != "whole" else weight(p.wv))
    if cfg.attn_bias:
        k = k + (slice_last(p.bk, tp) if kv != "whole" else weight(p.bk))
        v = v + (slice_last(p.bv, tp) if kv != "whole" else weight(p.bv))
    if kv == "gather":
        k, v = gather_last_partial(k, tp), gather_last_partial(v, tp)
    q = q.reshape(B, S, Hl, dh)
    k = k.reshape(B, S, -1, dh)
    v = v.reshape(B, S, -1, dh)
    if cfg.qk_norm:
        q = rms_norm(types.SimpleNamespace(scale=weight(p.q_norm.scale)), q, cfg.norm_eps)
        k = rms_norm(types.SimpleNamespace(scale=weight(p.k_norm.scale)), k, cfg.norm_eps)
    cos, sin = rotary_embedding(positions, dh, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    if split and kv != "local":
        # every key / value head is here: this rank's query heads read theirs
        heads = (tp.rank * Hl + torch.arange(Hl, device=h.device)) // (H // Hkv)
        k, v = k.index_select(2, heads), v.index_select(2, heads)
    window = cfg.sliding_window if local else None
    if S > _CHUNK_THRESHOLD and S % _CHUNK_Q == 0:
        out = _sdpa_chunked(q, k, v, cfg, window)
    else:
        out = _sdpa(q, k, v, _causal_mask(S, S, window, h.device), cfg)
    out = out.reshape(B, S, Hl * dh) @ p.wo
    return reduce_from(out, tp) if split else out


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
           batch: tuple = ()):
    lp = plan.layers[i]
    p = _ns(params, f"layers.{i}.")
    h = rms_norm(p.ln1, x, cfg.norm_eps)
    out = _attention(p.attn, cfg, h, positions, cfg.kind(i) == "local_attn", lp, tp)
    if cfg.post_block_norms:
        out = rms_norm(p.post_ln1, out, cfg.norm_eps)
    x = x + out
    aux = None
    if cfg.d_ff > 0:
        h = rms_norm(p.ln2, x, cfg.norm_eps)
        if cfg.moe is not None:
            out, aux = _moe(p.mlp, cfg, h, lp, tp, batch)
        elif lp["mlp"]:
            out = reduce_from(mlp_forward(p.mlp, copy_to(h, tp), cfg.mlp_type), tp)
        else:
            out = mlp_forward(p.mlp, h, cfg.mlp_type)
        if cfg.post_block_norms:
            out = rms_norm(p.post_ln2, out, cfg.norm_eps)
        x = x + out
    return x, aux


def _embed(params: dict, cfg: ModelConfig, plan: TPPlan, tp: TPGroup, tokens: torch.Tensor):
    table = params["embed.table"]
    if plan.vocab:
        rows = table.shape[0]
        local = tokens - tp.rank * rows
        mine = (local >= 0) & (local < rows)
        x = F.embedding(torch.where(mine, local, 0), table) * mine[..., None].to(table.dtype)
        x = reduce_from(x, tp)
    else:
        x = F.embedding(tokens, table)
    if cfg.embedding_scale:
        x = x * _rounded(cfg.d_model**0.5, x.dtype)
    return x


def _chunk_nll(params: dict, cfg: ModelConfig, plan: TPPlan, tp: TPGroup,
               hidden: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """The summed next-token NLL of a chunk: the unembedding on this rank's
    vocabulary columns and the cross entropy reduced over ranks
    (``transformer._token_nll`` whole)."""
    x = copy_to(hidden, tp) if plan.vocab else hidden
    logits = x @ params["embed.table"].T if cfg.tie_embeddings else x @ params["embed.unembed"]
    if cfg.final_logit_softcap > 0.0:
        cap = cfg.final_logit_softcap
        logits = cap * torch.tanh(logits / cap)
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


def lm_loss(params: dict, cfg: ModelConfig, batch: dict, plan: TPPlan, tp: TPGroup, *,
            remat: bool = False, batch_groups: tuple = ()) -> torch.Tensor:
    """``transformer.lm_loss`` (float32, the mean next-token cross entropy
    plus ``router_aux_coef`` times the MoE aux loss) of the model whose
    leaves are ``params`` (this rank's blocks, named as
    ``LM.named_parameters()``) on ``batch`` (``tokens``, ``labels``,
    optional ``image_embeds``); ``remat`` recomputes each layer's and each
    loss chunk's activations in the backward pass. ``batch_groups``: the
    groups (``TPGroup``s) a node's batch is split over, for the MoE aux
    loss's whole-batch statistics."""
    tokens, labels = batch["tokens"], batch["labels"]
    image_embeds = batch.get("image_embeds")
    x = _embed(params, cfg, plan, tp, tokens)
    if image_embeds is not None:
        x = torch.cat([image_embeds.to(x.dtype), x], dim=1)
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)[None, :].expand(B, S)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = remat and torch.is_grad_enabled()
    for i in range(cfg.num_layers):
        args = (params, i, cfg, plan, tp, x, positions, batch_groups)
        x, a = transformer._remat(_layer, *args) if remat else _layer(*args)
        if a is not None:
            aux = aux + a
    x = rms_norm(types.SimpleNamespace(scale=params["final_norm.scale"]), x, cfg.norm_eps)
    if image_embeds is not None:
        x = x[:, image_embeds.shape[1]:, :]
    B, S, _ = x.shape
    chunk = transformer._XENT_CHUNK if S % transformer._XENT_CHUNK == 0 else S
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for c0 in range(0, S, chunk):
        args = (params, cfg, plan, tp, x[:, c0:c0 + chunk], labels[:, c0:c0 + chunk])
        total = total + (transformer._remat(_chunk_nll, *args) if remat else _chunk_nll(*args))
    loss = total / (B * S)
    if cfg.moe is not None:
        loss = loss + cfg.moe.router_aux_coef * aux
    return loss
