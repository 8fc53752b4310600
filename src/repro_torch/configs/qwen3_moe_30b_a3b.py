"""qwen3-moe-30b-a3b [moe] — 128 experts top-8, qk_norm. [hf:Qwen/Qwen3-30B-A3B]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b", family="dense",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=4,
    head_dim=128, d_ff=768, vocab=151936,
    qk_norm=True, act="swiglu", rope_theta=1e6,
    moe=True, n_experts=128, top_k=8, moe_d_ff=768,
    param_dtype="bfloat16", act_dtype="bfloat16",
)
