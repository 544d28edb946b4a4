"""Training FLOPs of DeepSeek-V2 at a chip's expert share (the benchmark's
count, from the configuration file's numbers), and the needed operations
of its two distinctive parts: MLA's attention in the flash kernels and the
held experts' grouped products."""


def mla_projection_params(cfg: dict) -> int:
    """A layer's MLA projections with a full-rank q: ``wq``, ``w_dkv``,
    ``w_krope``, ``w_uk``, ``w_uv``, ``wo``."""
    d, H, r = cfg["hidden_size"], cfg["num_attention_heads"], cfg["kv_lora_rank"]
    dn, dr, dv = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"]
    return d * H * (dn + dr) + d * r + d * dr + r * H * dn + r * H * dv + H * dv * d


def active_params(cfg: dict) -> float:
    """N_active: the weights a token multiplies by on this chip: every
    layer's MLA projections, the dense layers' MLP, each expert layer's
    router, shared experts and ``K G / E`` of one routed expert (a token's
    expected share of the held experts), and the head (the lookup
    multiplies nothing)."""
    d, F = cfg["hidden_size"], cfg["moe_intermediate_size"]
    L, dense = cfg["num_hidden_layers"], cfg["first_k_dense_replace"]
    E, K, G = cfg["n_routed_experts_published"], cfg["num_experts_per_tok"], cfg["n_routed_experts"]
    moe = (d * E + 3 * d * F * cfg["n_shared_experts"] + K * G / E * 3 * d * F)
    return (L * mla_projection_params(cfg) + dense * 3 * d * cfg["intermediate_size"]
            + (L - dense) * moe + d * cfg["vocab_size"])


def attention_flops_per_token(cfg: dict, seq_len: int) -> float:
    """6 L H (d_qk + d_v) S: the scores and values of forward and backward
    over the whole sequence, at the published head dims (192 and 128, not
    the kernels' padded 256)."""
    dqk = cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]
    return 6.0 * cfg["num_hidden_layers"] * cfg["num_attention_heads"] * (
        dqk + cfg["v_head_dim"]) * seq_len


def train_flops_per_token(cfg: dict, seq_len: int) -> float:
    """6 N_active + 6 L H (d_qk + d_v) S (recomputation not counted)."""
    return 6.0 * active_params(cfg) + attention_flops_per_token(cfg, seq_len)


def flash_flops(cfg: dict, sequences: int, seq_len: int) -> float:
    """The needed operations of MLA's causal attention over ``sequences``
    sequences, forward and backward, in every layer: per head and kept
    (query, key) pair, 2 (d_qk + d_v) forward and twice that backward (the
    backward's recomputed scores not counted)."""
    dqk = cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]
    pairs = seq_len * (seq_len + 1) // 2
    return (3.0 * 2 * (dqk + cfg["v_head_dim"]) * pairs * cfg["num_attention_heads"]
            * sequences * cfg["num_hidden_layers"])


def expert_flops(cfg: dict, rows: int) -> float:
    """The needed operations of the held experts' products over ``rows``
    routed choices: 3 GEMMs of 2 d F a row forward, twice that backward
    (the backward's recomputed forward not counted)."""
    return 3.0 * 3 * 2 * cfg["hidden_size"] * cfg["moe_intermediate_size"] * rows
