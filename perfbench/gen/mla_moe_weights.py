"""The MLA-and-experts LM cell's weights (DeepSeek-V2), made from the seed
on the device in one draw, as ``weights.py`` makes qwen3's.

Named and laid out as the checkpoint both sides read: the token table
``embed.table`` (vocab, d) and the untied head ``embed.unembed`` (d,
vocab); per layer ``ln1.scale``, MLA's ``attn.wq`` (d, H (dn + dr)),
``attn.w_dkv`` (d, r), ``attn.w_krope`` (d, dr), ``attn.kv_norm.scale``
(r), ``attn.w_uk`` (r, H dn), ``attn.w_uv`` (r, H dv), ``attn.wo`` (H dv,
d), ``ln2.scale``; a leading dense layer's ``mlp.w_gate`` / ``mlp.w_up``
(d, ff) and ``mlp.w_down`` (ff, d); an expert layer's ``mlp.router`` (d,
E published), the held experts' ``mlp.routed.w_gate`` / ``w_up`` (G, d,
F) and ``w_down`` (G, F, d), and the shared experts' one SwiGLU
``mlp.shared.*`` of width ``n_shared_experts`` F; ``final_norm.scale``.
Matrices multiply as ``x @ W``. Normal draws: std ``init_std`` for the
table, fan-in scaled for the projections and the head; the norms' scales
are ones. Every node starts from the same weights.
"""

from __future__ import annotations

import torch


def shapes(cfg: dict) -> list[tuple[str, tuple[int, ...], float]]:
    """(name, shape, std) of every weight; std 0 marks a norm's ones."""
    d, V = cfg["hidden_size"], cfg["vocab_size"]
    H, r = cfg["num_attention_heads"], cfg["kv_lora_rank"]
    dn, dr, dv = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"]
    ff, F = cfg["intermediate_size"], cfg["moe_intermediate_size"]
    G, shared = cfg["n_routed_experts"], cfg["n_shared_experts"] * cfg["moe_intermediate_size"]
    out = [("embed.table", (V, d), cfg["init_std"]), ("embed.unembed", (d, V), d ** -0.5)]
    for i in range(cfg["num_hidden_layers"]):
        p = f"layers.{i}."
        out += [
            (p + "ln1.scale", (d,), 0.0),
            (p + "attn.wq", (d, H * (dn + dr)), d ** -0.5),
            (p + "attn.w_dkv", (d, r), d ** -0.5),
            (p + "attn.w_krope", (d, dr), d ** -0.5),
            (p + "attn.w_uk", (r, H * dn), r ** -0.5),
            (p + "attn.w_uv", (r, H * dv), r ** -0.5),
            (p + "attn.wo", (H * dv, d), (H * dv) ** -0.5),
            (p + "attn.kv_norm.scale", (r,), 0.0),
            (p + "ln2.scale", (d,), 0.0),
        ]
        if i < cfg["first_k_dense_replace"]:
            out += [(p + "mlp.w_gate", (d, ff), d ** -0.5), (p + "mlp.w_up", (d, ff), d ** -0.5),
                    (p + "mlp.w_down", (ff, d), ff ** -0.5)]
        else:
            out += [
                (p + "mlp.router", (d, cfg["n_routed_experts_published"]), d ** -0.5),
                (p + "mlp.routed.w_gate", (G, d, F), d ** -0.5),
                (p + "mlp.routed.w_up", (G, d, F), d ** -0.5),
                (p + "mlp.routed.w_down", (G, F, d), F ** -0.5),
                (p + "mlp.shared.w_gate", (d, shared), d ** -0.5),
                (p + "mlp.shared.w_up", (d, shared), d ** -0.5),
                (p + "mlp.shared.w_down", (shared, d), shared ** -0.5),
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
