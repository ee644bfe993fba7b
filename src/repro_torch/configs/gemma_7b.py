"""Gemma-7B: GeGLU, head_dim 256, (1+g) RMSNorm, scaled embeddings
[arXiv:2403.08295]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma-7b", family="dense",
    n_layers=28, d_model=3072, n_heads=16, n_kv_heads=16,
    d_ff=24_576, vocab=256_000,
    head_dim=256, ffn_kind="geglu",
    emb_scale=True, norm_plus_one=True,
    rope_theta=10_000.0,
)
