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
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .common import ModelConfig, dtype_of, truncated_normal_
from .layers import MLP, mlp_forward

__all__ = ["MoE", "Experts", "init_moe", "moe_forward", "router_aux_loss", "capacity", "route",
           "slots"]


class Experts(nn.Module):
    """The routed experts' stacked SwiGLU weights: ``w_gate`` / ``w_up``
    (E, D, F), ``w_down`` (E, F, D)."""

    def __init__(self, cfg: ModelConfig, device: torch.device | str):
        super().__init__()
        dt = dtype_of(cfg)
        e, d, f = cfg.moe.num_experts, cfg.d_model, cfg.moe.d_ff_expert

        def empty(*shape):
            return nn.Parameter(torch.empty(shape, dtype=dt, device=device))

        self.w_gate = empty(e, d, f)
        self.w_up = empty(e, d, f)
        self.w_down = empty(e, f, d)


class MoE(nn.Module):
    """``router`` (D, E), ``routed`` (:class:`Experts`) and, with
    ``num_shared_experts > 0``, ``shared``: an :class:`MLP` of width
    ``d_ff_shared`` (``d_ff_expert * num_shared_experts`` when that is 0)."""

    def __init__(self, cfg: ModelConfig, device: torch.device | str):
        super().__init__()
        m = cfg.moe
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


def capacity(seq_len: int, cfg: ModelConfig) -> int:
    """Slots per expert and sequence, ``max(1, ceil(S k cf / E))``, from
    Python numbers as the reference computes it."""
    m = cfg.moe
    return max(1, int(-(-seq_len * m.top_k * m.capacity_factor // m.num_experts)))


def route(params: MoE, cfg: ModelConfig, x: torch.Tensor):
    """(probs (B, S, E) float32, gate_vals (B, S, K) float32, expert_ids
    (B, S, K) int64): the softmax, and the top-k renormalised."""
    logits = x @ params.router
    probs = torch.softmax(logits.float(), dim=-1)
    gate_vals, expert_ids = torch.topk(probs, cfg.moe.top_k, dim=-1, sorted=True)
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)
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


def moe_forward(params: MoE, cfg: ModelConfig, x: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (output (B, S, D), aux loss scalar float32)."""
    m = cfg.moe
    B, S, D = x.shape
    E, K = m.num_experts, m.top_k
    probs, gate_vals, expert_ids = route(params, cfg, x)
    aux = router_aux_loss(probs.reshape(B * S, E), expert_ids.reshape(B * S, K), E)

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
