"""Architecture configs: one module per architecture the port runs.

``get_config(name)`` returns the exact full config; ``get_smoke_config(name)``
returns the reduced same-family variant the CPU tests use. Names are the
reference's (``repro/configs/__init__.py``), hyphenated or as module names.

The port runs every architecture of the reference: the dense GQA
families (qwen3-0.6b, gemma-2b, gemma2-2b, qwen2.5-14b), recurrentgemma-2b,
the MoE families (qwen3-moe-30b-a3b; deepseek-v2-236b, with MLA and shared
experts), xlstm-350m, whisper-small (encoder-decoder) and
llava-next-mistral-7b (stub patch embeddings). ``PORT_IDS`` are the port's
own architectures, beyond the reference's ten (``ARCH_IDS``):
deepseek-v2-lite. An unknown name raises ``ValueError``.

Input shapes (the reference's):
  train_4k     seq 4096,   global batch 256   (train_step)
  prefill_32k  seq 32768,  global batch 32    (serve prefill)
  decode_32k   seq 32768,  global batch 128   (serve decode: 1 new token)
  long_500k    seq 524288, global batch 1     (sub-quadratic decode)
"""

from __future__ import annotations

import importlib

from repro_torch.models.common import ModelConfig

__all__ = ["ARCH_IDS", "PORT_IDS", "PORTED", "INPUT_SHAPES", "get_config",
           "get_smoke_config", "all_configs"]

# canonical ids (hyphenated) -> module names, as in the reference
ARCH_IDS = {
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "gemma-2b": "gemma_2b",
    "qwen2.5-14b": "qwen2_5_14b",
    "xlstm-350m": "xlstm_350m",
    "deepseek-v2-236b": "deepseek_v2_236b",
    "gemma2-2b": "gemma2_2b",
    "qwen3-0.6b": "qwen3_0_6b",
    "whisper-small": "whisper_small",
    "llava-next-mistral-7b": "llava_next_mistral_7b",
    "recurrentgemma-2b": "recurrentgemma_2b",
}
PORTED = tuple(ARCH_IDS.values())
# the port's own architectures: canonical id -> module name
PORT_IDS = {
    "deepseek-v2-lite": "deepseek_v2_lite",
}

INPUT_SHAPES = {
    "train_4k": {"seq_len": 4096, "global_batch": 256, "kind": "train"},
    "prefill_32k": {"seq_len": 32768, "global_batch": 32, "kind": "prefill"},
    "decode_32k": {"seq_len": 32768, "global_batch": 128, "kind": "decode"},
    "long_500k": {"seq_len": 524288, "global_batch": 1, "kind": "decode_long"},
}


def _module(name: str):
    mod = {**ARCH_IDS, **PORT_IDS}.get(name, name).replace("-", "_").replace(".", "_")
    if mod not in PORTED and mod not in PORT_IDS.values():
        raise ValueError(f"unknown architecture {name!r}")
    return importlib.import_module(f"repro_torch.configs.{mod}")


def get_config(name: str) -> ModelConfig:
    return _module(name).config()


def get_smoke_config(name: str) -> ModelConfig:
    return _module(name).smoke_config()


def all_configs() -> dict[str, ModelConfig]:
    """The reference's ten architectures' full configs."""
    return {name: get_config(name) for name in ARCH_IDS}
