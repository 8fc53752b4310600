"""qwen3-0.6b [dense] — qk_norm, GQA, head_dim 128.  [hf:Qwen/Qwen3 family]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-0.6b", family="dense",
    n_layers=28, d_model=1024, n_heads=16, n_kv_heads=8,
    head_dim=128, d_ff=3072, vocab=151936,
    qk_norm=True, act="swiglu", rope_theta=1e6,
    tie_embed=True,
    param_dtype="bfloat16", act_dtype="bfloat16",
)
