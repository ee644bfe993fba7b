"""Jamba-1.5-Large (398B): Mamba+attention 1:7 interleave, MoE 16e top-2
every other layer [arXiv:2403.19887]."""
from repro_torch.configs.base import ArchConfig, MambaConfig, MoEConfig

CONFIG = ArchConfig(
    name="jamba-1.5-large-398b", family="hybrid",
    n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=24_576, vocab=65_536,
    # one attention layer per 8 (position 4 of each period, Jamba paper)
    block_pattern=("m", "m", "m", "m", "a", "m", "m", "m"),
    mamba=MambaConfig(d_state=16, d_conv=4, expand=2),
    moe=MoEConfig(n_experts=16, top_k=2, every=2),
    ffn_kind="swiglu", rope_theta=10_000.0,
    sub_quadratic=True,
    tie_embeddings=False,
)
