"""gemma-2b [dense] -- 18L d_model=2048 8H (MQA kv=1) d_ff=16384
vocab=256000. GeGLU, head_dim=256, tied embeddings, embedding scaling.
[arXiv:2403.08295]
"""

from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma-2b",
        arch_type="dense",
        num_layers=18,
        d_model=2048,
        num_heads=8,
        num_kv_heads=1,
        head_dim=256,
        d_ff=16384,
        vocab_size=256000,
        layer_pattern=("attn",),
        mlp_type="geglu",
        tie_embeddings=True,
        embedding_scale=True,
        dtype="bfloat16",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="gemma-2b-smoke",
        arch_type="dense",
        num_layers=2,
        d_model=128,
        num_heads=4,
        num_kv_heads=1,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        layer_pattern=("attn",),
        mlp_type="geglu",
        tie_embeddings=True,
        embedding_scale=True,
    )
