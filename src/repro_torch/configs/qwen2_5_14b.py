"""qwen2.5-14b [dense] -- 48L d_model=5120 40H (GQA kv=8) d_ff=13824
vocab=152064. GQA with QKV bias, SwiGLU, RoPE theta 1e6.
[hf:Qwen/Qwen2.5-0.5B family card]
"""

from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-14b",
        arch_type="dense",
        num_layers=48,
        d_model=5120,
        num_heads=40,
        num_kv_heads=8,
        head_dim=128,
        d_ff=13824,
        vocab_size=152064,
        attn_bias=True,
        rope_theta=1e6,
        layer_pattern=("attn",),
        mlp_type="swiglu",
        tie_embeddings=False,
        dtype="bfloat16",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-smoke",
        arch_type="dense",
        num_layers=2,
        d_model=160,
        num_heads=5,
        num_kv_heads=1,
        head_dim=32,
        d_ff=288,
        vocab_size=512,
        attn_bias=True,
        rope_theta=1e6,
        layer_pattern=("attn",),
        mlp_type="swiglu",
        tie_embeddings=False,
    )
