"""deepseek-v2-236b [moe] -- 60L d_model=5120 128H d_ff=1536 (expert width)
vocab=102400. MLA with kv_lora=512, decoupled RoPE 64; MoE with 2 shared +
160 routed experts, top-6. [arXiv:2405.04434]

On one 80 GB card: 244.19 B parameters (about 8.1 GB of bfloat16 per
layer) do not fit whole, so ``chip_smoke.py`` runs the published widths
cut to 4 layers.

This is the reference's config, and departs from the published
``config.json`` (https://huggingface.co/deepseek-ai/DeepSeek-V2): no
leading dense layer (``first_k_dense_replace`` 1 there), the top-k gate
values renormalised (``norm_topk_prob`` false there), no routing scale
(``routed_scaling_factor`` 16 there), a full-rank q projection (q LoRA of
rank 1536 there), no YaRN rotary scaling (factor 40 there), and the
Switch-style auxiliary loss at 0.01. Its parity with the reference holds
it so; ``deepseek_v2_lite.py`` carries the published forms.
"""

from repro_torch.models.common import MLAConfig, ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-236b",
        arch_type="moe",
        num_layers=60,
        d_model=5120,
        num_heads=128,
        num_kv_heads=128,
        head_dim=128,
        d_ff=1536,
        vocab_size=102400,
        layer_pattern=("attn",),
        mlp_type="swiglu",
        mla=MLAConfig(
            kv_lora_rank=512,
            qk_nope_head_dim=128,
            qk_rope_head_dim=64,
            v_head_dim=128,
        ),
        moe=MoEConfig(
            num_experts=160,
            top_k=6,
            d_ff_expert=1536,
            num_shared_experts=2,
            d_ff_shared=3072,
        ),
        tie_embeddings=False,
        dtype="bfloat16",
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-smoke",
        arch_type="moe",
        num_layers=2,
        d_model=128,
        num_heads=4,
        num_kv_heads=4,
        head_dim=32,
        d_ff=96,
        vocab_size=512,
        layer_pattern=("attn",),
        mlp_type="swiglu",
        mla=MLAConfig(
            kv_lora_rank=32,
            qk_nope_head_dim=16,
            qk_rope_head_dim=8,
            v_head_dim=16,
        ),
        moe=MoEConfig(
            num_experts=4,
            top_k=2,
            d_ff_expert=96,
            capacity_factor=8.0,
            num_shared_experts=1,
            d_ff_shared=96,
        ),
        tie_embeddings=False,
    )
