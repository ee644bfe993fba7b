"""Granite-3.0-8B: llama-style GQA [hf:ibm-granite/granite-3.0-8b-base]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="granite-3-8b", family="dense",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=12_800, vocab=49_155,
    ffn_kind="swiglu", rope_theta=10_000.0,
)
