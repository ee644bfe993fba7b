"""Minitron-4B: width/depth-pruned Nemotron [arXiv:2407.14679; hf]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="minitron-4b", family="dense",
    n_layers=32, d_model=3072, n_heads=24, n_kv_heads=8,
    d_ff=9216, vocab=256_000,
    ffn_kind="swiglu", rope_theta=10_000.0,
    tie_embeddings=False,
)
