"""qwen1.5-4b [dense] — QKV bias.  [hf:Qwen/Qwen1.5-0.5B family; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-4b", family="dense",
    n_layers=40, d_model=2560, n_heads=20, n_kv_heads=20,
    d_ff=6912, vocab=151936,
    qkv_bias=True, act="swiglu", rope_theta=1e6,
    param_dtype="bfloat16", act_dtype="bfloat16",
)
