"""qwen3-0.6b [dense] -- 28L d_model=1024 16H (GQA kv=8) d_ff=3072
vocab=151936. qk-norm, head_dim 128, tied embeddings. [hf:Qwen/Qwen3-8B card]
"""

from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-0.6b",
        arch_type="dense",
        num_layers=28,
        d_model=1024,
        num_heads=16,
        num_kv_heads=8,
        head_dim=128,
        d_ff=3072,
        vocab_size=151936,
        qk_norm=True,
        rope_theta=1e6,
        layer_pattern=("attn",),
        mlp_type="swiglu",
        tie_embeddings=True,
        dtype="bfloat16",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-smoke",
        arch_type="dense",
        num_layers=2,
        d_model=128,
        num_heads=4,
        num_kv_heads=2,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        qk_norm=True,
        rope_theta=1e6,
        layer_pattern=("attn",),
        mlp_type="swiglu",
        tie_embeddings=True,
    )
