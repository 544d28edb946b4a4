"""whisper-small [audio] -- 12L(enc)+12L(dec) d_model=768 12H (MHA kv=12)
d_ff=3072 vocab=51865. Encoder-decoder; the mel+conv frontend is a STUB:
``registry.make_inputs`` provides precomputed (B, 1500, 768) frame
embeddings. [arXiv:2212.04356]

Whisper's decoder max target length is 448 (``make_inputs`` caps the
decoder length there), so the decode_32k / long_500k shapes do not apply.
"""

from repro_torch.models.common import AudioStubConfig, EncoderConfig, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-small",
        arch_type="audio",
        num_layers=12,
        d_model=768,
        num_heads=12,
        num_kv_heads=12,
        head_dim=64,
        d_ff=3072,
        vocab_size=51865,
        layer_pattern=("attn",),
        mlp_type="gelu",
        encoder=EncoderConfig(num_layers=12, num_frames=1500),
        audio=AudioStubConfig(num_mel_bins=80),
        tie_embeddings=True,
        norm_eps=1e-5,
        dtype="bfloat16",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="whisper-smoke",
        arch_type="audio",
        num_layers=2,
        d_model=64,
        num_heads=2,
        num_kv_heads=2,
        head_dim=32,
        d_ff=128,
        vocab_size=512,
        layer_pattern=("attn",),
        mlp_type="gelu",
        encoder=EncoderConfig(num_layers=2, num_frames=50),
        audio=AudioStubConfig(num_mel_bins=80),
        tie_embeddings=True,
        norm_eps=1e-5,
    )
