"""Unified model configuration covering the 10 assigned architectures, the
port of the reference's ``models/config.py`` (field for field)."""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | rwkv | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None        # defaults to d_model // n_heads
    qkv_bias: bool = False
    qk_norm: bool = False
    act: str = "swiglu"                   # swiglu | sq_relu | gelu
    rope_theta: float = 1e6
    norm_eps: float = 1e-6
    tie_embed: bool = False
    # --- MoE ---
    moe: bool = False
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    moe_virtual: int = 1          # virtual-expert F-split factor (grok on 16-TP)
    # --- RWKV6 ---
    rwkv_head_size: int = 64
    # --- Mamba2 / hybrid ---
    ssm_state: int = 0
    mamba_head_dim: int = 64
    attn_every: int = 0                   # shared attention block period (zamba2)
    # --- VLM ---
    cross_every: int = 0                  # cross-attn layer period
    n_img_tokens: int = 0
    # --- enc-dec (audio) ---
    encdec: bool = False
    enc_layers: int = 0
    n_frames: int = 0                     # stub frame-embedding count
    # --- numerics / perf knobs ---
    param_dtype: str = "float32"
    act_dtype: str = "float32"
    remat: bool = True
    scan_layers: bool = True
    flash_block_q: int = 512
    flash_block_kv: int = 1024
    loss_chunk: int = 512

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def sub_quadratic(self) -> bool:
        """Supports O(1)/O(log)-state decode at 500k context."""
        return self.family in ("rwkv", "hybrid")

    @property
    def has_decoder(self) -> bool:
        return True   # all assigned archs have an autoregressive decoder

    def reduced(self, **overrides) -> "ModelConfig":
        """A small same-family config for CPU smoke tests."""
        small = dict(
            n_layers=min(self.n_layers, 2 if not self.attn_every else
                         max(2, min(4, self.attn_every))),
            d_model=128, n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) or 2,
            d_ff=256, vocab=512,
            head_dim=32,
            moe_d_ff=64 if self.moe else 0,
            n_experts=4 if self.moe else 0,
            top_k=min(self.top_k, 2) if self.moe else 0,
            ssm_state=16 if self.ssm_state else 0,
            mamba_head_dim=16 if self.ssm_state else 64,
            attn_every=2 if self.attn_every else 0,
            cross_every=2 if self.cross_every else 0,
            n_img_tokens=8 if self.n_img_tokens else 0,
            enc_layers=2 if self.encdec else 0,
            n_frames=16 if self.encdec else 0,
            rwkv_head_size=32 if self.family == "rwkv" else 64,
            flash_block_q=16, flash_block_kv=32, loss_chunk=64,
        )
        small.update(overrides)
        return dataclasses.replace(self, **small)


def param_count(cfg: ModelConfig) -> int:
    """Approximate parameter count (reported in DESIGN/EXPERIMENTS)."""
    d, hd = cfg.d_model, cfg.hd
    qk = cfg.n_heads * hd
    kv = cfg.n_kv_heads * hd
    per_layer = d * qk + 2 * d * kv + qk * d          # attention
    if cfg.moe:
        per_layer += d * cfg.n_experts + \
            cfg.n_experts * (3 if cfg.act == "swiglu" else 2) * d * cfg.moe_d_ff
    elif cfg.family == "rwkv":
        per_layer = 6 * d * d + 2 * d * cfg.d_ff + d * cfg.d_ff
    elif cfg.family == "hybrid":
        d_in = 2 * d
        per_layer = d * (2 * d_in + 2 * cfg.ssm_state) + d_in * d
    else:
        per_layer += (3 if cfg.act == "swiglu" else 2) * d * cfg.d_ff
    total = cfg.n_layers * per_layer + 2 * cfg.vocab * d
    if cfg.cross_every:
        total += (cfg.n_layers // cfg.cross_every) * 2 * d * kv
    return total
