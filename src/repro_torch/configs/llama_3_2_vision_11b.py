"""llama-3.2-vision-11b [vlm] — cross-attn image layers every 5th layer;
stub patch-embedding frontend.  [hf:meta-llama/Llama-3.2-11B-Vision]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b", family="vlm",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab=128256,
    act="swiglu", rope_theta=5e5,
    cross_every=5, n_img_tokens=1600,
    param_dtype="bfloat16", act_dtype="bfloat16",
)
