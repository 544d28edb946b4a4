"""gemma2-2b [dense] -- 26L d_model=2304 8H (GQA kv=4) d_ff=9216
vocab=256000. Alternating local(4096)/global attention, attention softcap
50, final-logit softcap 30, pre+post block RMSNorms, GeGLU, head_dim 256.
[arXiv:2408.00118]
"""

from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma2-2b",
        arch_type="dense",
        num_layers=26,
        d_model=2304,
        num_heads=8,
        num_kv_heads=4,
        head_dim=256,
        d_ff=9216,
        vocab_size=256000,
        layer_pattern=("local_attn", "attn"),
        sliding_window=4096,
        attn_logit_softcap=50.0,
        final_logit_softcap=30.0,
        post_block_norms=True,
        mlp_type="geglu",
        tie_embeddings=True,
        embedding_scale=True,
        dtype="bfloat16",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="gemma2-smoke",
        arch_type="dense",
        num_layers=2,
        d_model=128,
        num_heads=4,
        num_kv_heads=2,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        layer_pattern=("local_attn", "attn"),
        sliding_window=8,
        attn_logit_softcap=50.0,
        final_logit_softcap=30.0,
        post_block_norms=True,
        mlp_type="geglu",
        tie_embeddings=True,
        embedding_scale=True,
    )
