"""recurrentgemma-2b [hybrid] -- 26L d_model=2560 10H (MQA kv=1) d_ff=7680
vocab=256000. Griffin block pattern: (RG-LRU, RG-LRU, local attention),
window 2048, GeGLU MLP after every temporal block, head_dim 256.
[arXiv:2402.19427]
"""

from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-2b",
        arch_type="hybrid",
        num_layers=26,
        d_model=2560,
        num_heads=10,
        num_kv_heads=1,
        head_dim=256,
        d_ff=7680,
        vocab_size=256000,
        layer_pattern=("rglru", "rglru", "local_attn"),
        sliding_window=2048,
        mlp_type="geglu",
        tie_embeddings=True,
        embedding_scale=True,
        rnn_width=2560,
        conv_width=4,
        dtype="bfloat16",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-smoke",
        arch_type="hybrid",
        num_layers=3,
        d_model=128,
        num_heads=4,
        num_kv_heads=1,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        layer_pattern=("rglru", "rglru", "local_attn"),
        sliding_window=8,
        mlp_type="geglu",
        tie_embeddings=True,
        embedding_scale=True,
        rnn_width=128,
        conv_width=4,
    )
