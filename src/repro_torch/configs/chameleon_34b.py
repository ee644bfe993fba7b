"""Chameleon-34B: early-fusion VLM over a unified VQ-token vocabulary; the
image tokenizer is the stubbed frontend (inputs arrive as discrete codes in
the shared vocab); qk-norm per the paper [arXiv:2405.09818]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="chameleon-34b", family="vlm",
    n_layers=48, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=22_016, vocab=65_536,
    qk_norm=True, ffn_kind="swiglu", rope_theta=10_000.0,
    tie_embeddings=False,
)
