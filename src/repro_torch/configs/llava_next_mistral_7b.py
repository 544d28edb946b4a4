"""llava-next-mistral-7b [vlm] -- 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=32000 (Mistral-7B backbone). The SigLIP/CLIP vision tower + projector
is a STUB: ``registry.make_inputs`` provides precomputed anyres patch embeddings
(2880 patches = 5 tiles x 576) prepended to the text sequence.
[hf:llava-hf/llava-v1.6-mistral-7b-hf]
"""

from repro_torch.models.common import ModelConfig, VisionStubConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llava-next-mistral-7b",
        arch_type="vlm",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        vocab_size=32000,
        rope_theta=1e6,
        layer_pattern=("attn",),
        mlp_type="swiglu",
        vision=VisionStubConfig(num_patches=2880),
        tie_embeddings=False,
        dtype="bfloat16",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="llava-smoke",
        arch_type="vlm",
        num_layers=2,
        d_model=128,
        num_heads=4,
        num_kv_heads=2,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        rope_theta=1e6,
        layer_pattern=("attn",),
        mlp_type="swiglu",
        vision=VisionStubConfig(num_patches=16),
        tie_embeddings=False,
    )
