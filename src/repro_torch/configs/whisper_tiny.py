"""whisper-tiny [audio] — enc-dec, conv frontend STUB (precomputed frame
embeddings).  [arXiv:2212.04356]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny", family="audio",
    n_layers=4, d_model=384, n_heads=6, n_kv_heads=6,
    d_ff=1536, vocab=51865,
    act="gelu", rope_theta=1e4,
    encdec=True, enc_layers=4, n_frames=1500,
    param_dtype="bfloat16", act_dtype="bfloat16",
)
