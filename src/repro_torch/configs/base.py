"""Config registry: ``get_config(arch_id)`` + the shape grid (the port of
the reference's ``configs/base.py``).

Shapes (assigned): every arch is exercised on
  train_4k     seq 4096,   global_batch 256   (train_step)
  prefill_32k  seq 32768,  global_batch 32    (prefill_step)
  decode_32k   cache 32768, global_batch 128  (serve_step: 1 new token)
  long_500k    cache 524288, global_batch 1   (serve_step; sub-quadratic only)
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, Optional, Tuple

from repro_torch.models.config import ModelConfig

ARCHS = [
    "qwen1_5_4b", "nemotron_4_15b", "codeqwen1_5_7b", "qwen3_0_6b",
    "rwkv6_7b", "llama_3_2_vision_11b", "qwen3_moe_30b_a3b", "grok_1_314b",
    "zamba2_7b", "whisper_tiny",
]

# canonical ids as assigned (hyphens) -> module names
ALIASES = {
    "qwen1.5-4b": "qwen1_5_4b",
    "nemotron-4-15b": "nemotron_4_15b",
    "codeqwen1.5-7b": "codeqwen1_5_7b",
    "qwen3-0.6b": "qwen3_0_6b",
    "rwkv6-7b": "rwkv6_7b",
    "llama-3.2-vision-11b": "llama_3_2_vision_11b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "grok-1-314b": "grok_1_314b",
    "zamba2-7b": "zamba2_7b",
    "whisper-tiny": "whisper_tiny",
}


@dataclasses.dataclass(frozen=True)
class ShapeCfg:
    name: str
    seq_len: int
    global_batch: int
    kind: str                 # train | prefill | decode


SHAPES: Dict[str, ShapeCfg] = {
    "train_4k": ShapeCfg("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCfg("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCfg("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCfg("long_500k", 524288, 1, "decode"),
}


def get_config(arch: str) -> ModelConfig:
    mod_name = ALIASES.get(arch, arch)
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.CONFIG


def shape_applicable(cfg: ModelConfig, shape: str) -> Tuple[bool, str]:
    """(runs?, reason-if-skipped) — the DESIGN.md skip policy."""
    if shape == "long_500k" and not cfg.sub_quadratic:
        return False, "full-attention family: 500k decode needs " \
                      "sub-quadratic attention (skip per spec)"
    return True, ""
