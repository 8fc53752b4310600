"""grok-1-314b [moe] — 8 experts top-2; virtual-expert F-split for the
16-wide model axis (see models/moe.py).  [hf:xai-org/grok-1]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="grok-1-314b", family="dense",
    n_layers=64, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=32768, vocab=131072,
    act="gelu", rope_theta=1e4,
    moe=True, n_experts=8, top_k=2, moe_d_ff=32768,
    moe_virtual=2,
    param_dtype="bfloat16", act_dtype="bfloat16",
)
