"""deepseek-v2-lite [moe] -- 27L d_model=2048 16H vocab=102400: layer 0
dense (SwiGLU 10944), layers 1-26 MoE (64 routed experts of width 1408,
top-6, 2 shared); MLA with kv_lora=512, no q LoRA, dn 128, dr 64, dv 128;
YaRN rotary scaling (factor 40 over 4096 positions). [arXiv:2405.04434;
https://huggingface.co/deepseek-ai/DeepSeek-V2-Lite/blob/main/config.json]

Against the published ``config.json``: the router is ``MoEGate``'s greedy
form (float32 logits, softmax over all 64, top-6 weights not renormalised,
``routed_scaling_factor`` 1), the auxiliary loss sequence-wise with
coefficient 0.001 (``aux_loss_alpha``, which the catalog's copy of the
file leaves out; the paper's V2-Lite value), the two shared experts one
SwiGLU of width 2 x 1408 (exact for two experts). ``config()`` holds all
64 experts and runs them grouped, dropping no choice (``held_experts``
64); a device holding one chip's share sets ``held_experts`` /
``first_expert`` and keeps the router's 64 outputs. Without q LoRA the
port's full-rank ``wq`` is the model's own. MLA's full sequence trains in
the flash kernels, zero-padded from (192, 128) to 256 (``mla.flash``).

For a loader of the published weights: the port rotates split halves of
the 64 rope dims (``layers.apply_rope``), the published model interleaved
pairs; the two agree up to a fixed permutation of the rope columns of
``wq`` and of ``w_krope`` (even columns first, then odd).
"""

from repro_torch.models.common import MLAConfig, ModelConfig, MoEConfig, YarnConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-lite",
        arch_type="moe",
        num_layers=27,
        d_model=2048,
        num_heads=16,
        num_kv_heads=16,
        head_dim=128,
        d_ff=1408,
        vocab_size=102400,
        layer_pattern=("attn",),
        mlp_type="swiglu",
        mla=MLAConfig(
            kv_lora_rank=512,
            q_lora_rank=0,
            qk_nope_head_dim=128,
            qk_rope_head_dim=64,
            v_head_dim=128,
            flash=True,
        ),
        moe=MoEConfig(
            num_experts=64,
            top_k=6,
            d_ff_expert=1408,
            num_shared_experts=2,
            d_ff_shared=2816,
            router_aux_coef=0.001,
            norm_topk_prob=False,
            routed_scaling_factor=1.0,
            router_f32=True,
            aux_loss="seq",
            held_experts=64,
            first_expert=0,
        ),
        first_dense_layers=1,
        dense_d_ff=10944,
        rope_theta=10000.0,
        rope_scaling=YarnConfig(factor=40.0, original_max_position_embeddings=4096,
                                beta_fast=32.0, beta_slow=1.0, mscale=0.707,
                                mscale_all_dim=0.707),
        norm_eps=1e-6,
        tie_embeddings=False,
        dtype="bfloat16",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-lite-smoke",
        arch_type="moe",
        num_layers=3,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        head_dim=16,
        d_ff=32,
        vocab_size=256,
        layer_pattern=("attn",),
        mlp_type="swiglu",
        mla=MLAConfig(kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
                      flash=True),
        moe=MoEConfig(num_experts=8, top_k=3, d_ff_expert=32, num_shared_experts=2,
                      d_ff_shared=64, router_aux_coef=0.001, norm_topk_prob=False,
                      router_f32=True, aux_loss="seq", held_experts=8),
        first_dense_layers=1,
        dense_d_ff=96,
        rope_scaling=YarnConfig(),
        tie_embeddings=False,
    )
