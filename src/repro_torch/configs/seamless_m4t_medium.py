"""SeamlessM4T-medium backbone: 12L enc + 12L dec, frontend stubbed (encoder
consumes precomputed audio-frame embeddings) [arXiv:2308.11596]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-medium", family="encdec",
    n_layers=12, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=4096, vocab=256_206,
    encoder_layers=12, frontend_stub=True, enc_ratio=4,
    ffn_kind="gelu", rope_theta=10_000.0,
    tie_embeddings=False,
)
