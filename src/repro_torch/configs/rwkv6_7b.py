"""rwkv6-7b [ssm] — Finch, data-dependent decay, attn-free. [arXiv:2404.05892]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-7b", family="rwkv",
    n_layers=32, d_model=4096, n_heads=64, n_kv_heads=64,
    d_ff=14336, vocab=65536,
    rwkv_head_size=64,
    param_dtype="bfloat16", act_dtype="bfloat16",
)
