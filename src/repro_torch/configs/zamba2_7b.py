"""zamba2-7b [hybrid] — Mamba2 backbone + shared attention block every 6
layers.  [arXiv:2411.15242]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b", family="hybrid",
    n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32,
    d_ff=14336, vocab=32000,
    ssm_state=64, mamba_head_dim=64, attn_every=6,
    param_dtype="bfloat16", act_dtype="bfloat16",
)
