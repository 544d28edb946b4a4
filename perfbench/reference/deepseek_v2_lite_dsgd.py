"""Decentralised SGD of n DeepSeek-V2-Lite models at a chip's expert share
(Algorithm 1), in plain PyTorch.

The model follows DeepSeek-V2's published description (arXiv:2405.04434,
the ``DeepseekV2`` modelling code of the published checkpoint): token
lookup; per layer an RMS norm, multi-head latent attention, the residual,
an RMS norm, the MLP, the residual; a final RMS norm and an untied head.

* MLA without q LoRA: per head q = [q_nope; q_rope] (dn + dr) from one
  projection; the latent c = RMS-norm(x W_dkv) (r); k = [c W_uk; k_rope],
  the rope key x W_krope shared by the heads; v = c W_uv (dv); causal
  softmax attention at (dn + dr, dv), unpadded, scaled by (dn + dr)^-0.5
  times YaRN's mscale(factor, mscale_all_dim)^2; the output through W_o.
  Rotary positions on the rope dims with YaRN's frequencies, rotating
  split halves (the published model rotates interleaved pairs: the same up
  to a fixed permutation of the rope columns of W_q and W_krope).
* The first ``first_k_dense_replace`` layers' MLP is a dense SwiGLU; the
  others are expert layers: the router's logits in float32 over all the
  published experts, the softmax, greedy top-k, the gate values not
  renormalised, times ``routed_scaling_factor``; the held experts
  ``[first_expert, first_expert + n_routed_experts)`` each add their gate
  value times their SwiGLU for the choices routed to them (the experts
  held elsewhere add nothing: a chip's share, as the program computes
  it), then the shared experts' SwiGLU; the sequence-wise balance loss
  ``alpha mean_b sum_i f_i P_i`` (f from the choices, without gradient)
  is summed over the expert layers and added to the loss.

Weights and activations are bfloat16, as the model is published;
products take bfloat16 operands and accumulate in float32; the norms, the
rotary angles, the router, the softmaxes, the expert outputs' weighted sum
and the cross entropy are computed in float32, and TF32 is off. A step:
each node's mean next-token cross entropy plus the balance loss on its
batch and its gradient, the SGD half-step in bfloat16, then the mix
theta_i <- sum_j W_ij theta_j, summed in float32 and rounded once. The
work is done a node, and within it a layer, at a time (each layer's
activations recomputed in the backward pass), so that it fits beside the
program's inputs at the timed sizes.

Routing ties: a router input rounded otherwise can pick another expert
on a near tie. Given ``routes`` (the ids the program chose), every
expert layer routes to them, with its own float32 gate values, and
``route_flips`` is the share of choices its own float32 top-k differs in;
without, it routes to its own top-k (and returns them as ``routes``).

``precision="fp8"`` is the control: every product's operands rounded to
float8_e4m3 (``precision.py``). ``fault=`` plants one of the faults a
training step can have, as in ``qwen3_dsgd.py``: ``"unchanged"``,
``"half_batch"``, ``"no_mix"`` and ``"alter"``.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from perfbench.reference.precision import mm, rounded


def _rms(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    x32 = x.float()
    return (x32 * torch.rsqrt(x32.square().mean(-1, keepdim=True) + eps)
            * scale.float()).to(x.dtype)


def _mscale(factor: float, mscale: float) -> float:
    return 1.0 if factor <= 1.0 else 0.1 * mscale * float(np.log(factor)) + 1.0


def yarn_freqs(cfg: dict, device) -> torch.Tensor:
    """(dr / 2,) YaRN inverse frequencies of the rope dims."""
    y, dim, base = cfg["rope_scaling"], cfg["qk_rope_head_dim"], float(cfg["rope_theta"])

    def corr(rotations: float) -> float:
        return dim * float(np.log(y["original_max_position_embeddings"]
                                  / (rotations * 2 * np.pi)) / (2 * np.log(base)))

    low = max(int(np.floor(corr(y["beta_fast"]))), 0)
    high = min(int(np.ceil(corr(y["beta_slow"]))), dim - 1)
    extra = 1.0 / base ** (torch.arange(0, dim, 2, dtype=torch.float32) / dim)
    ramp = ((torch.arange(dim // 2, dtype=torch.float32) - low)
            / (high - low if high != low else 0.001)).clamp(0, 1)
    mask = 1.0 - ramp  # 1 where the frequency is kept
    return (extra / y["factor"] * (1.0 - mask) + extra * mask).to(device)


def softmax_scale(cfg: dict) -> float:
    y = cfg["rope_scaling"]
    scale = (cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]) ** -0.5
    return scale * _mscale(y["factor"], y["mscale_all_dim"]) ** 2


def _rope(x: torch.Tensor, cfg: dict) -> torch.Tensor:
    """x (B, S, heads, dr), rotated by position (split halves)."""
    y = cfg["rope_scaling"]
    S = x.shape[1]
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * yarn_freqs(cfg,
                                                                                      x.device)
    m = _mscale(y["factor"], y["mscale"]) / _mscale(y["factor"], y["mscale_all_dim"])
    c, s = (torch.cos(ang) * m)[:, None, :], (torch.sin(ang) * m)[:, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


def _swiglu(h, w_gate, w_up, w_down, prec: str) -> torch.Tensor:
    return mm(torch.nn.functional.silu(mm(h, w_gate, prec)) * mm(h, w_up, prec), w_down, prec)


def _mla(h: torch.Tensor, w, cfg: dict, prec: str) -> torch.Tensor:
    B, S, _ = h.shape
    H, eps = cfg["num_attention_heads"], cfg["rms_norm_eps"]
    dn, dr, dv = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"]
    q = mm(h, w("attn.wq"), prec).view(B, S, H, dn + dr)
    q_nope, q_rope = q.split([dn, dr], dim=-1)
    q_rope = _rope(q_rope, cfg)
    c = _rms(mm(h, w("attn.w_dkv"), prec), w("attn.kv_norm.scale"), eps)
    k_rope = _rope(mm(h, w("attn.w_krope"), prec)[:, :, None, :], cfg)[:, :, 0, :]
    k_nope = mm(c, w("attn.w_uk"), prec).view(B, S, H, dn)
    v = mm(c, w("attn.w_uv"), prec).view(B, S, H, dv)
    f = lambda t: rounded(t, prec).float()  # noqa: E731
    scores = (torch.einsum("bqhd,bkhd->bhqk", f(q_nope), f(k_nope))
              + torch.einsum("bqhd,bkd->bhqk", f(q_rope), f(k_rope))) * softmax_scale(cfg)
    causal = torch.ones((S, S), dtype=torch.bool, device=h.device).tril()
    probs = torch.softmax(scores.masked_fill(~causal, float("-inf")), dim=-1)
    del scores
    a = torch.einsum("bhqk,bkhd->bqhd", rounded(probs, prec), f(v)).to(h.dtype)
    return mm(a.reshape(B, S, H * dv), w("attn.wo"), prec)


def _moe(h: torch.Tensor, w, cfg: dict, prec: str, ids: torch.Tensor | None):
    """(the held experts' part (B, S, d), the balance loss without alpha,
    the count of choices whose own top-k differs from ``ids``, the ids
    routed to (B, S, K))."""
    B, S, d = h.shape
    E, K = cfg["n_routed_experts_published"], cfg["num_experts_per_tok"]
    logits = rounded(h, prec).float() @ rounded(w("mlp.router"), prec).float()
    probs = torch.softmax(logits, dim=-1)
    own = torch.topk(probs, K, dim=-1).indices
    if ids is None:
        ids = own
    flips = K * own[..., 0].numel() - (own[..., :, None] == ids[..., None, :]).any(-1).sum()
    gates = probs.gather(-1, ids) * cfg["routed_scaling_factor"]
    chosen = torch.zeros((B, E), dtype=torch.float32, device=h.device)
    chosen.scatter_add_(1, ids.reshape(B, S * K), torch.ones((B, S * K), device=h.device))
    aux = ((chosen * (E / (S * K))) * probs.mean(dim=1)).sum(dim=1).mean()
    flat_h, flat_ids, flat_g = h.reshape(B * S, d), ids.reshape(B * S, K), gates.reshape(B * S, K)
    out = torch.zeros((B * S, d), dtype=torch.float32, device=h.device)
    first = cfg["first_expert"]
    for e in range(cfg["n_routed_experts"]):
        t, j = torch.nonzero(flat_ids == first + e, as_tuple=True)
        if t.numel() == 0:
            continue
        y = _swiglu(flat_h[t], w("mlp.routed.w_gate")[e], w("mlp.routed.w_up")[e],
                    w("mlp.routed.w_down")[e], prec)
        out = out.index_add(0, t, y.float() * flat_g[t, j][:, None])
    return out.to(h.dtype).view(B, S, d), aux, flips, ids


def _layer(p: dict, i: int, x: torch.Tensor, cfg: dict, prec: str, ids):
    """One layer: (x, balance loss, flips) -- and the ids routed to, for an
    expert layer."""
    w = lambda name: p[f"layers.{i}.{name}"]  # noqa: E731
    eps = cfg["rms_norm_eps"]
    x = x + _mla(_rms(x, w("ln1.scale"), eps), w, cfg, prec)
    h = _rms(x, w("ln2.scale"), eps)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    if i < cfg["first_k_dense_replace"]:
        return x + _swiglu(h, w("mlp.w_gate"), w("mlp.w_up"), w("mlp.w_down"), prec), zero, zero
    routed, aux, flips, ids = _moe(h, w, cfg, prec, ids)
    shared = _swiglu(h, w("mlp.shared.w_gate"), w("mlp.shared.w_up"), w("mlp.shared.w_down"),
                     prec)
    return x + (routed + shared), aux, flips, ids


def forward(p: dict, tokens: torch.Tensor, cfg: dict, prec: str,
            routes: torch.Tensor | None):
    """One node's float32 logits on (B, S) tokens, the expert layers' balance
    losses summed (without alpha), the flips and the (L_moe, B, S, K) ids
    routed to. ``routes`` (L_moe, B, S, K) or None."""
    x = torch.nn.functional.embedding(tokens, p["embed.table"])
    aux_sum = flips = torch.zeros((), dtype=torch.float32, device=tokens.device)
    used = []
    for i in range(cfg["num_hidden_layers"]):
        m = i - cfg["first_k_dense_replace"]
        if m < 0:
            x, _, _ = checkpoint(_layer, p, i, x, cfg, prec, None, use_reentrant=False)
            continue
        ids = None if routes is None else routes[m].long()
        x, aux, f, ids = checkpoint(_layer, p, i, x, cfg, prec, ids, use_reentrant=False)
        aux_sum, flips = aux_sum + aux, flips + f
        used.append(ids)
    x = _rms(x, p["final_norm.scale"], cfg["rms_norm_eps"])
    return mm(x, p["embed.unembed"], prec).float(), aux_sum, flips, torch.stack(used)


def node_loss(p: dict, tokens: torch.Tensor, labels: torch.Tensor, cfg: dict, prec: str,
              routes: torch.Tensor | None):
    """One node's loss on (B, S) tokens: the mean next-token cross entropy
    plus alpha times the expert layers' balance losses; the flips, and the
    (L_moe, B, S, K) ids routed to (``forward``)."""
    logits, aux_sum, flips, used = forward(p, tokens, cfg, prec, routes)
    nll = (torch.logsumexp(logits, -1) - logits.gather(-1, labels[..., None])[..., 0]).mean()
    return nll + cfg["aux_loss_alpha"] * aux_sum, flips, used


def step(params: dict, tokens: torch.Tensor, labels: torch.Tensor, W: torch.Tensor, cfg: dict,
         lr: float, prec: str = "bfloat16", fault: str | None = None, routes=None):
    """One D-SGD step of stacked (n, ...) weights on (n, B, S) tokens, with
    ``routes`` (n, L_moe, B, S, K) or None. Returns the new weights, the
    mean loss over nodes, every node's gradient (stacked), the flips and
    the ids routed to (n, L_moe, B, S, K)."""
    n = tokens.shape[0]
    if fault == "alter":
        labels = torch.roll(labels, 1, dims=-1)
    if fault == "half_batch":
        half = tokens.shape[1] // 2
        tokens, labels = tokens[:, :half], labels[:, :half]
        routes = None if routes is None else routes[:, :, :half]
    losses, grads, flips, used = [], {k: torch.empty_like(v) for k, v in params.items()}, 0.0, []
    for i in range(n):
        leaves = {k: v[i].detach().requires_grad_() for k, v in params.items()}
        loss, f, ids = node_loss(leaves, tokens[i], labels[i], cfg, prec,
                                 None if routes is None else routes[i])
        for (k, _), g in zip(leaves.items(), torch.autograd.grad(loss, list(leaves.values()))):
            grads[k][i] = g
        losses.append(loss.detach())
        flips += float(f)
        used.append(ids)
        del leaves, loss
    loss = torch.stack(losses).mean()
    used = torch.stack(used)
    if fault == "unchanged":
        return params, loss, grads, flips, used
    new = {}
    for k, v in params.items():
        half_step = v - lr * grads[k]
        if fault == "no_mix":
            new[k] = half_step
        else:
            new[k] = torch.einsum("ij,j...->i...", W, half_step.float()).to(v.dtype)
        del half_step
    return new, loss, grads, flips, used


def readings(params0: dict, batches: dict, W: torch.Tensor, cfg: dict, lr: float, steps: int,
             prec: str = "bfloat16", fault: str | None = None,
             routes: torch.Tensor | None = None) -> dict:
    """What the comparison reads after ``steps`` steps: each step's loss,
    the norm of each weight's gradient at the last step (over all nodes)
    and of its change over the steps, the share of choices whose own top-k
    differs from ``routes`` ((steps, n, L_moe, B, S, K) or None), and the
    ids routed to (the same layout)."""
    p, losses, grad_norms, flips, choices, used = params0, [], None, 0.0, 0, []
    # float32 products in float32 on the card (no TF32), restored after
    was = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        for t in range(steps):
            r = None if routes is None else routes[t]
            p, loss, grads, f, ids = step(p, batches["tokens"][t], batches["labels"][t], W, cfg,
                                          lr, prec, fault, r)
            losses.append(float(loss))
            grad_norms = {k: float(g.float().norm()) for k, g in grads.items()}
            flips += f
            choices += ids.numel()
            used.append(ids.to(torch.uint8))
            del grads
        change = {k: float((p[k].float() - params0[k].float()).norm()) for k in params0}
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = was
    return {"losses": losses, "grad_norms": grad_norms, "change_norms": change,
            "route_flips": flips / choices, "routes": torch.stack(used)}
