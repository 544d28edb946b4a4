"""qwen3-moe-30b-a3b [moe] -- 48L d_model=2048 32H (GQA kv=4) d_ff=768
vocab=151936, MoE 128 experts top-8. [hf:Qwen/Qwen3-30B-A3B]

Qwen3-MoE details: head_dim 128, per-head q/k RMSNorm, no QKV bias, no
shared experts, expert FFN width 768 (the assigned d_ff), RoPE theta 1e6.
"""

from repro_torch.models.common import ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-30b-a3b",
        arch_type="moe",
        num_layers=48,
        d_model=2048,
        num_heads=32,
        num_kv_heads=4,
        head_dim=128,
        d_ff=768,
        vocab_size=151936,
        qk_norm=True,
        rope_theta=1e6,
        layer_pattern=("attn",),
        mlp_type="swiglu",
        moe=MoEConfig(num_experts=128, top_k=8, d_ff_expert=768),
        tie_embeddings=False,
        dtype="bfloat16",
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-smoke",
        arch_type="moe",
        num_layers=2,
        d_model=128,
        num_heads=4,
        num_kv_heads=2,
        head_dim=32,
        d_ff=96,
        vocab_size=512,
        qk_norm=True,
        rope_theta=1e6,
        layer_pattern=("attn",),
        mlp_type="swiglu",
        moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=96, capacity_factor=8.0),
        tie_embeddings=False,
    )
