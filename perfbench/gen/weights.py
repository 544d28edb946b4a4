"""The LM cell's weights, made from the seed on the device in one draw.

Named and laid out as the checkpoint both sides read: the token table
``embed.table`` (vocab, d), tied to the head; per layer ``ln1.scale``,
``attn.wq`` (d, H Dh), ``attn.wk`` / ``attn.wv`` (d, Hkv Dh), ``attn.wo``
(H Dh, d), ``attn.q_norm.scale`` / ``attn.k_norm.scale`` (Dh),
``ln2.scale``, ``mlp.w_gate`` / ``mlp.w_up`` (d, ff), ``mlp.w_down`` (ff,
d); ``final_norm.scale``. Matrices multiply as ``x @ W``. Normal draws:
std ``init_std`` for the table, fan-in scaled for the projections; the
norms' scales are ones. Every node starts from the same weights.
"""

from __future__ import annotations

import torch


def shapes(cfg: dict) -> list[tuple[str, tuple[int, ...], float]]:
    """(name, shape, std) of every weight; std 0 marks a norm's ones."""
    d, ff, V = cfg["hidden_size"], cfg["intermediate_size"], cfg["vocab_size"]
    H, Hkv, Dh = cfg["num_attention_heads"], cfg["num_key_value_heads"], cfg["head_dim"]
    out = [("embed.table", (V, d), cfg["init_std"])]
    for i in range(cfg["num_hidden_layers"]):
        p = f"layers.{i}."
        out += [
            (p + "ln1.scale", (d,), 0.0),
            (p + "attn.wq", (d, H * Dh), d ** -0.5),
            (p + "attn.wk", (d, Hkv * Dh), d ** -0.5),
            (p + "attn.wv", (d, Hkv * Dh), d ** -0.5),
            (p + "attn.wo", (H * Dh, d), (H * Dh) ** -0.5),
            (p + "attn.q_norm.scale", (Dh,), 0.0),
            (p + "attn.k_norm.scale", (Dh,), 0.0),
            (p + "ln2.scale", (d,), 0.0),
            (p + "mlp.w_gate", (d, ff), d ** -0.5),
            (p + "mlp.w_up", (d, ff), d ** -0.5),
            (p + "mlp.w_down", (ff, d), ff ** -0.5),
        ]
    out.append(("final_norm.scale", (d,), 0.0))
    return out


def make(cfg: dict, n_nodes: int, seed: int, device: torch.device,
         dtype: torch.dtype = torch.bfloat16) -> dict[str, torch.Tensor]:
    """Every weight stacked over ``n_nodes`` identical nodes: (n, ...)."""
    table = shapes(cfg)
    total = sum(torch.Size(s).numel() for _, s, std in table if std > 0)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn((total,), generator=gen, device=device)
    out, at = {}, 0
    for name, shape, std in table:
        if std > 0:
            k = torch.Size(shape).numel()
            w = (flat[at:at + k].view(shape) * std).to(dtype)
            at += k
        else:
            w = torch.ones(shape, dtype=dtype, device=device)
        out[name] = w[None].expand((n_nodes,) + tuple(shape)).clone()
    del flat
    return out
