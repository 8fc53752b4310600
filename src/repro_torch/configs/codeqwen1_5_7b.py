"""codeqwen1.5-7b [dense] — qwen1.5 arch.  [hf:Qwen/CodeQwen1.5-7B]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="codeqwen1.5-7b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=32,
    d_ff=13440, vocab=92416,
    qkv_bias=True, act="swiglu", rope_theta=1e6,
    param_dtype="bfloat16", act_dtype="bfloat16",
)
