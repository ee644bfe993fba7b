"""MiniCPM3-4B: deep-thin dense model with MLA [hf:openbmb/MiniCPM3-4B]."""
from repro_torch.configs.base import ArchConfig, MLAConfig

CONFIG = ArchConfig(
    name="minicpm3-4b", family="dense",
    n_layers=62, d_model=2560, n_heads=40, n_kv_heads=40,
    d_ff=6400, vocab=73_448,
    head_dim=64,
    mla=MLAConfig(q_lora=768, kv_lora=256, nope_dim=64, rope_dim=32,
                  v_dim=64),
    ffn_kind="swiglu", rope_theta=10_000.0,
)
