"""The LM stack of the port: configs' models as ``nn.Module``s.

Ported so far: the pieces recurrentgemma-2b and the dense GQA families
run (RMS norm, rope, MLPs, embeddings, GQA attention with full and ring
caches, the RG-LRU block, the decoder assembly and its losses) and those
of the MoE families (the capacity-dispatch MoE block, ``moe``, and
DeepSeek-V2's multi-head latent attention with its latent cache). xLSTM,
whisper and the VLM stub wait for ROADMAP queue 1 item 12.
"""

from . import attention, common, kvcache, layers, moe, registry, rglru, transformer
from .common import ModelConfig, param_count
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
    "ModelConfig",
    "param_count",
    "init_model",
    "loss_fn",
    "make_inputs",
    "model_forward",
]
