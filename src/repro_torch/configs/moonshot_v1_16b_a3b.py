"""Moonlight-16B-A3B (moonshot): fine-grained MoE, 64 experts top-6
[hf:moonshotai/Moonlight-16B-A3B]."""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="moonshot-v1-16b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1408, vocab=163_840,
    moe=MoEConfig(n_experts=64, top_k=6, every=1),
    ffn_kind="swiglu", rope_theta=10_000.0,
)
