"""Mixture-of-Experts MLP block with capacity-based scatter dispatch.

The reference's algorithm (``repro/models/moe.py``), kept exactly:

1. Router: ``x @ router`` in the model dtype, softmax over experts in
   float32, top-k per token, the k weights renormalised in float32.
2. Dispatch, per sequence: capacity ``C = max(1, ceil(S k cf / E))``.
   The token-choices are flattened token-major (row ``t k + j``); each
   choice's slot is its rank in its expert's queue (a one-hot cumulative
   sum over the rows), and a choice whose slot is ``>= C`` is dropped: it
   writes to a scratch row and reads zeros back, so it adds nothing.
3. Expert compute: batched products ``(E, rows, D) x (E, D, F)``; every
   expert multiplies its ``C`` slots of every sequence.
4. Combine: the K rows of a token, each times its gate value cast to the
   activation dtype, summed.

The reference's ``vmap`` over the batch is one batched computation here:
sequence b's slots of expert e are rows ``b C .. b C + C - 1`` of that
expert, so one product per weight covers the whole batch. Nothing reads
the device and no shape depends on the routing, so the block runs inside
a captured decode step (``serve/engine.py``); the only duplicate writes
land on the discarded scratch row.

Shared experts (DeepSeek) are a dense MLP added unconditionally. The
router's load-balancing loss (Switch-style) is returned beside the output
for ``lm_loss`` to add ``router_aux_coef * aux``.

The port's own form (DeepSeek-V2-Lite's ``MoEGate`` and one chip's expert
share, ``MoEConfig.held_experts > 0``):

* the router: the product in float32 (``router_f32``), the softmax over
  all ``num_experts``, greedy top-k, the gate values renormalised only
  with ``norm_topk_prob`` and times ``routed_scaling_factor``;
* the sequence-wise auxiliary loss (``aux_loss="seq"``): per sequence b,
  ``sum_i f_i P_i`` with ``P_i`` the mean probability of expert i over the
  sequence and ``f_i = E / (K S)`` times the sequence's choices of i (no
  gradient), averaged over b;
* the held share: the block holds experts ``[first_expert, first_expert +
  held_experts)`` (``routed`` is that many experts wide) of the
  ``num_experts`` the router scores; it computes only the choices routed
  to them -- each their gate value times the expert's SwiGLU -- and no
  choice is dropped. The choices are sorted by held expert (stable, the
  others last) and multiplied as grouped products over the rows each
  expert received (``torch._grouped_mm`` with the device's offsets: no host
  read, so the block captures), in static buffers of every choice's row:
  the rows past the held choices are masked to zero on the way in and on
  the way out, since a grouped product leaves them unwritten. Under
  autograd the grouped part is recomputed in the backward pass, so only
  its inputs are held. Each call adds the choices each held expert
  received to the layer's ``load`` buffer (int32, on the device), which
  a trainer passes in (``TrainSetup.expert_loads``). Absent experts add
  nothing: there is no exchange with the devices that hold them.

``route_log(slots)`` records what the router chose, for a check against
a plain reference: while it is open, MoE call i (counted from the log's
opening) copies its expert ids into row ``i % len(slots)`` of the device
tensor ``slots``. A call captured into a CUDA graph keeps its row, so a
log open across a body's eager warm-up and its capture, with one row a
call of the body, has every replay of the body write its calls' routes in
call order.
"""

from __future__ import annotations

import contextlib
from typing import Iterator

import torch
import torch.nn.functional as F
from torch import nn

from .common import ModelConfig, dtype_of, truncated_normal_
from .layers import MLP, mlp_forward

__all__ = ["MoE", "Experts", "init_moe", "moe_forward", "router_aux_loss", "seq_aux_loss",
           "capacity", "route", "slots", "sort_choices", "route_log"]

# the open route logs: [slots, the next call's number]
_ROUTE_LOGS: list[list] = []


@contextlib.contextmanager
def route_log(slots: torch.Tensor) -> Iterator[torch.Tensor]:
    """While open, MoE call i copies its (B, S, K) expert ids, flattened and
    cast to ``slots``' dtype, into the head of ``slots[i % len(slots)]``
    (``slots``: (calls, at least B S K) on the device)."""
    entry = [slots, 0]
    _ROUTE_LOGS.append(entry)
    try:
        yield slots
    finally:
        _ROUTE_LOGS.remove(entry)


def _log_routes(expert_ids: torch.Tensor) -> None:
    for entry in _ROUTE_LOGS:
        slots, at = entry
        flat = expert_ids.reshape(-1)
        slots[at % slots.shape[0], :flat.numel()].copy_(flat)
        entry[1] = at + 1


class Experts(nn.Module):
    """The routed experts' stacked SwiGLU weights: ``w_gate`` / ``w_up``
    (E, D, F), ``w_down`` (E, F, D); E is ``held_experts`` where set."""

    def __init__(self, cfg: ModelConfig, device: torch.device | str):
        super().__init__()
        dt = dtype_of(cfg)
        e, d, f = cfg.moe.held_experts or cfg.moe.num_experts, cfg.d_model, cfg.moe.d_ff_expert

        def empty(*shape):
            return nn.Parameter(torch.empty(shape, dtype=dt, device=device))

        self.w_gate = empty(e, d, f)
        self.w_up = empty(e, d, f)
        self.w_down = empty(e, f, d)


class MoE(nn.Module):
    """``router`` (D, E), ``routed`` (:class:`Experts`) and, with
    ``num_shared_experts > 0``, ``shared``: an :class:`MLP` of width
    ``d_ff_shared`` (``d_ff_expert * num_shared_experts`` when that is 0).
    With ``held_experts``, the ``load`` buffer: (held,) int32, the choices
    each held expert received, added by every call."""

    def __init__(self, cfg: ModelConfig, device: torch.device | str):
        super().__init__()
        m = cfg.moe
        if m.held_experts:
            self.register_buffer("load", torch.zeros(m.held_experts, dtype=torch.int32,
                                                     device=device), persistent=False)
        self.router = nn.Parameter(
            torch.empty((cfg.d_model, m.num_experts), dtype=dtype_of(cfg), device=device))
        self.routed = Experts(cfg, device)
        if m.num_shared_experts > 0:
            shared_ff = m.d_ff_shared or m.d_ff_expert * m.num_shared_experts
            self.shared = MLP(cfg, device, d_ff=shared_ff)

    def init_weights(self, generator: torch.Generator) -> None:
        d, f = self.router.shape[0], self.routed.w_down.shape[1]
        truncated_normal_(self.router, d**-0.5, generator)
        truncated_normal_(self.routed.w_gate, d**-0.5, generator)
        truncated_normal_(self.routed.w_up, d**-0.5, generator)
        truncated_normal_(self.routed.w_down, f**-0.5, generator)
        if hasattr(self, "shared"):
            self.shared.init_weights(generator)


def init_moe(cfg: ModelConfig, *, generator: torch.Generator,
             device: torch.device | str) -> MoE:
    moe = MoE(cfg, device)
    moe.init_weights(generator)
    return moe


def router_aux_loss(router_probs: torch.Tensor, expert_ids: torch.Tensor,
                    num_experts: int) -> torch.Tensor:
    """Switch-transformer load-balance loss ``E * sum_e f_e P_e``: ``f_e`` the
    share of tokens whose top-1 expert is e, ``P_e`` the mean router
    probability of e. ``router_probs`` (N, E), ``expert_ids`` (N, K)."""
    experts = torch.arange(num_experts, device=expert_ids.device)
    f = (expert_ids[:, :1] == experts).float().mean(dim=0)
    p = router_probs.float().mean(dim=0)
    return num_experts * (f * p).sum()


def seq_aux_loss(router_probs: torch.Tensor, expert_ids: torch.Tensor,
                 num_experts: int) -> torch.Tensor:
    """DeepSeek's sequence-wise balance loss, without its coefficient:
    ``mean_b sum_i f_i P_i``, ``P_i`` the mean over the sequence of expert
    i's probability, ``f_i = E / (K S)`` times the sequence's choices of i
    (no gradient). ``router_probs`` (B, S, E), ``expert_ids`` (B, S, K)."""
    B, S, K = expert_ids.shape
    chosen = torch.zeros((B, num_experts), dtype=torch.float32, device=expert_ids.device)
    chosen.scatter_add_(1, expert_ids.reshape(B, S * K),
                        torch.ones((B, S * K), dtype=torch.float32, device=expert_ids.device))
    f = chosen * (num_experts / (S * K))
    return (f * router_probs.float().mean(dim=1)).sum(dim=1).mean()


def capacity(seq_len: int, cfg: ModelConfig) -> int:
    """Slots per expert and sequence, ``max(1, ceil(S k cf / E))``, from
    Python numbers as the reference computes it."""
    m = cfg.moe
    return max(1, int(-(-seq_len * m.top_k * m.capacity_factor // m.num_experts)))


def route(params: MoE, cfg: ModelConfig, x: torch.Tensor):
    """(probs (B, S, E) float32, gate_vals (B, S, K) float32, expert_ids
    (B, S, K) int64): the softmax, and the top-k renormalised (with
    ``norm_topk_prob``) and scaled by ``routed_scaling_factor``."""
    m = cfg.moe
    logits = x.float() @ params.router.float() if m.router_f32 else x @ params.router
    probs = torch.softmax(logits.float(), dim=-1)
    gate_vals, expert_ids = torch.topk(probs, m.top_k, dim=-1, sorted=True)
    if m.norm_topk_prob:
        gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)
    if m.routed_scaling_factor != 1.0:
        gate_vals = gate_vals * m.routed_scaling_factor
    return probs, gate_vals, expert_ids


def slots(expert_ids: torch.Tensor, num_experts: int) -> torch.Tensor:
    """Each token-choice's rank in its expert's queue, (B, S K): choices in
    token-major order (row ``t K + j``), counted per sequence.

    The reference's one-hot cumulative sum over the rows, laid out (B, E,
    S K) and summed as one flat scan: a scan along the rows of a (B, S K,
    E) one-hot runs one thread per column on the card (13 ms a layer at
    qwen3-moe's scoring shape on an H100), a flat one is a single
    device-wide scan.
    Each (b, e) row's count then starts from the scan's total before it.
    """
    B = expert_ids.shape[0]
    flat = expert_ids.reshape(B, -1)
    experts = torch.arange(num_experts, device=flat.device)
    onehot = (flat[:, None, :] == experts[None, :, None]).to(torch.int32)  # (B, E, S K)
    scan = onehot.reshape(-1).cumsum(0, dtype=torch.int32).reshape(B * num_experts, -1)
    before = torch.cat([scan.new_zeros(1), scan[:-1, -1]]).reshape(B, num_experts)
    rank = scan.reshape(B, num_experts, -1).gather(1, flat[:, None, :])[:, 0]
    return (rank - before.gather(1, flat) - 1).long()


def sort_choices(expert_ids: torch.Tensor, first: int, held: int
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """(order, counts): the choices of (T, K) ``expert_ids`` (token-major)
    sorted by held expert ``[first, first + held)``, stably, the choices
    routed elsewhere last; and the choices each held expert received,
    (held,) int64."""
    local = expert_ids.reshape(-1) - first
    key = torch.where((local >= 0) & (local < held), local, held)
    counts = torch.zeros(held + 1, dtype=torch.int64, device=key.device).scatter_add_(
        0, key, torch.ones_like(key))
    return torch.argsort(key, stable=True), counts[:held]


def _held_experts(x: torch.Tensor, gate_vals: torch.Tensor, order: torch.Tensor,
                  counts: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
                  w_down: torch.Tensor) -> torch.Tensor:
    """The held experts' part of (T, D) tokens ``x``: each choice of a held
    expert, its gate value times the expert's SwiGLU, summed over the
    token's K choices (``gate_vals`` (T, K); ``order`` and ``counts`` from
    ``sort_choices``)."""
    T, D = x.shape
    K = gate_vals.shape[1]
    N = T * K
    offs = counts.cumsum(0).to(torch.int32)
    valid = (torch.arange(N, device=x.device) < offs[-1])[:, None]
    # each choice's token row, then sorted: a permutation, so the backward
    # adds no two rows into one (deterministic), and the K copies sum in a
    # reduction
    rows = x[:, None, :].expand(T, K, D).reshape(N, D).index_select(0, order)
    rows = torch.where(valid, rows, 0)
    gate = torch._grouped_mm(rows, w_gate, offs=offs)
    up = torch._grouped_mm(rows, w_up, offs=offs)
    y = torch._grouped_mm(F.silu(gate) * up, w_down, offs=offs)
    y = torch.where(valid, y, 0)  # rows past the held choices are unwritten
    # back to token-major order (a gather, no atomics), weighted, summed over K
    where = torch.empty_like(order).scatter_(0, order, torch.arange(N, device=x.device))
    per_choice = y.index_select(0, where).view(T, K, D)
    return torch.bmm(gate_vals.view(T, 1, K).to(x.dtype), per_choice).view(T, D)


def _held_forward(params: MoE, cfg: ModelConfig, x: torch.Tensor, gate_vals: torch.Tensor,
                  expert_ids: torch.Tensor) -> torch.Tensor:
    """The held share's output (B, S, D); counts each held expert's choices
    into ``params.load``."""
    m = cfg.moe
    B, S, D = x.shape
    order, counts = sort_choices(expert_ids, m.first_expert, m.held_experts)
    if getattr(params, "load", None) is not None and params.load.device.type != "meta":
        params.load.add_(counts.to(torch.int32))
    r = params.routed
    args = (x.reshape(B * S, D), gate_vals.reshape(B * S, -1), order, counts, r.w_gate, r.w_up,
            r.w_down)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        from torch.utils.checkpoint import checkpoint

        out = checkpoint(_held_experts, *args, use_reentrant=False, preserve_rng_state=False)
    else:
        out = _held_experts(*args)
    return out.view(B, S, D)


def moe_forward(params: MoE, cfg: ModelConfig, x: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (output (B, S, D), aux loss scalar float32)."""
    m = cfg.moe
    B, S, D = x.shape
    E, K = m.num_experts, m.top_k
    probs, gate_vals, expert_ids = route(params, cfg, x)
    if _ROUTE_LOGS:
        _log_routes(expert_ids)
    if m.aux_loss == "seq":
        aux = seq_aux_loss(probs, expert_ids, E)
    else:
        aux = router_aux_loss(probs.reshape(B * S, E), expert_ids.reshape(B * S, K), E)
    if m.held_experts:
        out = _held_forward(params, cfg, x, gate_vals, expert_ids)
        if m.num_shared_experts > 0:
            out = out + mlp_forward(params.shared, x, cfg.mlp_type)
        return out, aux

    C = capacity(S, cfg)
    flat_expert = expert_ids.reshape(B, S * K)
    slot = slots(expert_ids, E)
    # row of each choice in the (E, B C) expert buffer; overflow -> scratch
    batch_row = torch.arange(B, device=x.device)[:, None] * C
    dest = torch.where(slot < C, flat_expert * (B * C) + batch_row + slot, E * B * C).reshape(-1)

    token_rep = x[:, :, None, :].expand(B, S, K, D).reshape(B * S * K, D)
    buf = x.new_zeros((E * B * C + 1, D))
    buf.index_copy_(0, dest, token_rep)
    expert_in = buf[: E * B * C].view(E, B * C, D)

    r = params.routed
    gate = F.silu(torch.bmm(expert_in, r.w_gate))
    up = torch.bmm(expert_in, r.w_up)
    # the expert outputs, (E, B C, D), then one zero row for dropped choices
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, r.w_gate, r.w_up, r.w_down)):
        # under autograd the products stay out of place (an ``out=`` product
        # has no backward, and the dispatch buffer is saved for it)
        expert_out = torch.bmm(gate * up, r.w_down).reshape(E * B * C, D)
        flat_out = torch.cat([expert_out, expert_out.new_zeros((1, D))])
    else:
        flat_out = buf  # the dispatch buffer's rows are read: reused in place
        flat_out[E * B * C].zero_()
        torch.bmm(gate * up, r.w_down, out=flat_out[: E * B * C].view(E, B * C, D))
    gathered = flat_out.index_select(0, dest)  # dropped choices read zeros
    weights = gate_vals.reshape(B * S * K, 1).to(gathered.dtype)
    out = (gathered * weights).reshape(B, S, K, D).sum(dim=2)
    if m.num_shared_experts > 0:
        out = out + mlp_forward(params.shared, x, cfg.mlp_type)
    return out, aux
