"""RWKV-6 "Finch" 1.6B: attention-free, data-dependent decay
[arXiv:2404.05892]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6-1.6b", family="ssm",
    n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=7168, vocab=65_536,
    rwkv=True, rwkv_head_dim=64,
    sub_quadratic=True,
    tie_embeddings=False,
)
