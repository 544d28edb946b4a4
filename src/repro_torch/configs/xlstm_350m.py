"""xlstm-350m [ssm] -- 24L d_model=1024 4H d_ff=0 vocab=50304.
sLSTM + mLSTM blocks. [arXiv:2405.04517]

Block pattern choice (the reference's): 3 mLSTM : 1 sLSTM
(layer % 4 == 3 -> sLSTM), matching the paper's mLSTM-dominant ratios.
``d_ff = 0``: xLSTM blocks carry their own internal projections
(mLSTM up-factor 2, sLSTM FFN factor 4/3).
"""

from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-350m",
        arch_type="ssm",
        num_layers=24,
        d_model=1024,
        num_heads=4,
        num_kv_heads=4,
        d_ff=0,
        vocab_size=50304,
        layer_pattern=("mlstm", "mlstm", "mlstm", "slstm"),
        tie_embeddings=True,
        conv_width=4,
        dtype="bfloat16",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-smoke",
        arch_type="ssm",
        num_layers=2,
        d_model=64,
        num_heads=2,
        num_kv_heads=2,
        d_ff=0,
        vocab_size=512,
        layer_pattern=("mlstm", "slstm"),
        tie_embeddings=True,
        conv_width=4,
    )
