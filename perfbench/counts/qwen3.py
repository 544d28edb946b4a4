"""Training FLOPs of a dense GQA transformer with tied embeddings (the
benchmark's count, from the configuration file's numbers)."""


def multiplying_params(cfg: dict) -> int:
    """N: the weights a token multiplies by: each layer's q, k, v, o and
    gated MLP, and the tied head (the lookup multiplies nothing)."""
    d, ff = cfg["hidden_size"], cfg["intermediate_size"]
    q = cfg["num_attention_heads"] * cfg["head_dim"]
    kv = cfg["num_key_value_heads"] * cfg["head_dim"]
    layer = d * q + 2 * d * kv + q * d + 3 * d * ff
    return cfg["num_hidden_layers"] * layer + d * cfg["vocab_size"]


def train_flops_per_token(cfg: dict, seq_len: int) -> float:
    """6 N + 12 L H Q S: the products of forward and backward, attention's
    scores and values at the whole sequence (recomputation not counted)."""
    attn = 12 * cfg["num_hidden_layers"] * cfg["num_attention_heads"] * cfg["head_dim"] * seq_len
    return 6.0 * multiplying_params(cfg) + attn
