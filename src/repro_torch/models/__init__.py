"""The LM stack of the port: configs' models as ``nn.Module``s.

Every family of the reference: the pieces recurrentgemma-2b and the dense
GQA families run (RMS norm, rope, MLPs, embeddings, GQA attention with
full and ring caches, the RG-LRU block, the decoder assembly and its
losses), those of the MoE families (the capacity-dispatch MoE block,
``moe``, and DeepSeek-V2's multi-head latent attention with its latent
cache), the xLSTM blocks (``xlstm``: mLSTM, and sLSTM with its captured
time loop), whisper's encoder-decoder (``whisper``: layer norms,
sinusoidal positions, cross-attention) and the VLM's stub patch
embeddings (``transformer``).
"""

from . import (
    attention,
    common,
    kvcache,
    layers,
    moe,
    registry,
    rglru,
    transformer,
    whisper,
    xlstm,
)
from .common import ModelConfig, active_param_count, param_count
from .registry import init_model, loss_fn, make_inputs, model_forward

__all__ = [
    "attention",
    "common",
    "kvcache",
    "layers",
    "moe",
    "registry",
    "rglru",
    "transformer",
    "whisper",
    "xlstm",
    "ModelConfig",
    "param_count",
    "active_param_count",
    "init_model",
    "loss_fn",
    "make_inputs",
    "model_forward",
]
