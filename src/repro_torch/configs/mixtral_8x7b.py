"""Mixtral-8x7B: 8-expert top-2 MoE with sliding-window attention
[arXiv:2401.04088]."""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="mixtral-8x7b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14_336, vocab=32_000,
    window=4096,
    moe=MoEConfig(n_experts=8, top_k=2, every=1),
    ffn_kind="swiglu", rope_theta=10_000.0,
    sub_quadratic=True,   # SWA ⇒ O(window) decode state
)
