"""Decentralised SGD of n Qwen3 models (Algorithm 1), in plain PyTorch.

The model follows Qwen3's published description: token lookup; per layer
an RMS norm, grouped-query attention (queries and keys RMS-normed per
head, rotary positions on split halves with base ``rope_theta``, causal),
the residual, an RMS norm, a SwiGLU MLP, the residual; a final RMS norm
and the head tied to the token table. Weights and activations are
bfloat16, as the model is published; products accumulate in float32; the
norms, the rotary angles, attention's softmax and the cross entropy are
computed in float32. A step: each node's mean next-token cross entropy on
its batch and its gradient, the SGD half-step in bfloat16, then the mix
theta_i <- sum_j W_ij theta_j, summed in float32 and rounded once.

``precision="fp8"`` is the control: every product's operands rounded to
float8_e4m3 (``precision.py``). ``fault=`` plants one of the faults a
training step can have, for reading where each shows: ``"unchanged"`` (the
step returns its state), ``"half_batch"`` (the loss over half of each
node's batch), ``"no_mix"`` (no exchange between nodes) and ``"alter"``
(each label moved one token on, where the feed makes it).
"""

from __future__ import annotations

import torch

from perfbench.reference.precision import mm, rounded


def _rms(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    x32 = x.float()
    return (x32 * torch.rsqrt(x32.square().mean(-1, keepdim=True) + eps)
            * scale.float()).to(x.dtype)


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, S, heads, Dh), rotated by position."""
    S, Dh = x.shape[1], x.shape[-1]
    freqs = 1.0 / theta ** (torch.arange(0, Dh, 2, dtype=torch.float32, device=x.device) / Dh)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * freqs
    c, s = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


def _attention(q, k, v, prec: str) -> torch.Tensor:
    """Causal GQA: q (B, S, H, Dh), k / v (B, S, Hkv, Dh) -> (B, S, H, Dh)."""
    B, S, H, Dh = q.shape
    g = H // k.shape[2]
    qf = rounded(q, prec).float().transpose(1, 2)                       # B H S Dh
    kf = rounded(k, prec).float().repeat_interleave(g, dim=2).transpose(1, 2)
    vf = rounded(v, prec).float().repeat_interleave(g, dim=2).transpose(1, 2)
    scores = (qf @ kf.transpose(-1, -2)) * Dh ** -0.5
    causal = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
    probs = torch.softmax(scores.masked_fill(~causal, float("-inf")), dim=-1)
    return (rounded(probs, prec) @ vf).transpose(1, 2).to(q.dtype)


def node_loss(p: dict, tokens: torch.Tensor, labels: torch.Tensor, cfg: dict,
              prec: str) -> torch.Tensor:
    """Mean next-token cross entropy of one node's weights on (B, S) tokens."""
    B, S = tokens.shape
    H, Hkv, Dh = cfg["num_attention_heads"], cfg["num_key_value_heads"], cfg["head_dim"]
    eps, theta = cfg["rms_norm_eps"], float(cfg["rope_theta"])
    table = p["embed.table"]
    x = torch.nn.functional.embedding(tokens, table)
    for i in range(cfg["num_hidden_layers"]):
        w = lambda name: p[f"layers.{i}.{name}"]  # noqa: E731
        h = _rms(x, w("ln1.scale"), eps)
        q = _rms(mm(h, w("attn.wq"), prec).view(B, S, H, Dh), w("attn.q_norm.scale"), eps)
        k = _rms(mm(h, w("attn.wk"), prec).view(B, S, Hkv, Dh), w("attn.k_norm.scale"), eps)
        v = mm(h, w("attn.wv"), prec).view(B, S, Hkv, Dh)
        a = _attention(_rope(q, theta), _rope(k, theta), v, prec)
        x = x + mm(a.reshape(B, S, H * Dh), w("attn.wo"), prec)
        h = _rms(x, w("ln2.scale"), eps)
        gate = torch.nn.functional.silu(mm(h, w("mlp.w_gate"), prec))
        x = x + mm(gate * mm(h, w("mlp.w_up"), prec), w("mlp.w_down"), prec)
    x = _rms(x, p["final_norm.scale"], eps)
    logits = mm(x, table.T, prec).float()
    nll = torch.logsumexp(logits, -1) - logits.gather(-1, labels[..., None])[..., 0]
    return nll.mean()


def step(params: dict, tokens: torch.Tensor, labels: torch.Tensor, W: torch.Tensor, cfg: dict,
         lr: float, prec: str = "bfloat16", fault: str | None = None):
    """One D-SGD step of stacked (n, ...) weights on (n, B, S) tokens.
    Returns the new weights, the mean loss over nodes and every node's
    gradient (stacked)."""
    n = tokens.shape[0]
    if fault == "alter":
        labels = torch.roll(labels, 1, dims=-1)
    if fault == "half_batch":
        tokens, labels = tokens[:, : tokens.shape[1] // 2], labels[:, : labels.shape[1] // 2]
    losses, grads = [], {k: torch.empty_like(v) for k, v in params.items()}
    for i in range(n):
        leaves = {k: v[i].detach().requires_grad_() for k, v in params.items()}
        loss = node_loss(leaves, tokens[i], labels[i], cfg, prec)
        for (k, _), g in zip(leaves.items(), torch.autograd.grad(loss, list(leaves.values()))):
            grads[k][i] = g
        losses.append(loss.detach())
        del leaves, loss
    loss = torch.stack(losses).mean()
    if fault == "unchanged":
        return params, loss, grads
    new = {}
    for k, v in params.items():
        half = v - lr * grads[k]
        if fault == "no_mix":
            new[k] = half
        else:
            new[k] = torch.einsum("ij,j...->i...", W, half.float()).to(v.dtype)
        del half
    return new, loss, grads


def readings(params0: dict, batches: dict, W: torch.Tensor, cfg: dict, lr: float, steps: int,
             prec: str = "bfloat16", fault: str | None = None) -> dict:
    """What the comparison reads after ``steps`` steps: each step's loss, the
    norm of each weight's gradient at the last step (over all nodes) and of
    its change over the steps."""
    p, losses, grad_norms = params0, [], None
    for t in range(steps):
        p, loss, grads = step(p, batches["tokens"][t], batches["labels"][t], W, cfg, lr, prec,
                              fault)
        losses.append(float(loss))
        grad_norms = {k: float(g.float().norm()) for k, g in grads.items()}
        del grads
    change = {k: float((p[k].float() - params0[k].float()).norm()) for k in params0}
    return {"losses": losses, "grad_norms": grad_norms, "change_norms": change}
