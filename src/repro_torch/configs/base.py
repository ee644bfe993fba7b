"""Architecture configuration dataclasses.

Every architecture is an ``ArchConfig`` instance (exact published
dimensions); ``reduced()`` derives the small same-family variant used by CPU
tests. ``MLAConfig`` / ``MoEConfig`` / ``MambaConfig`` are plain data, so
``ArchConfig`` has the same fields as its counterpart in the reference
package. Every layer they configure is ported (MoE, MLA, the
sliding-window ring, mamba, rwkv, and the encoder-decoder's encoder and
cross-attention, ``encoder_layers > 0``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    q_lora: int = 768
    kv_lora: int = 256
    nope_dim: int = 64
    rope_dim: int = 32
    v_dim: int = 64
    absorb: bool = False


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    every: int = 1             # MoE replaces the FFN every N layers
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class MambaConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                # dense | moe | hybrid | ssm | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None      # default d_model // n_heads
    ffn_kind: str = "swiglu"
    # attention flavor
    window: Optional[int] = None        # sliding-window attention
    qk_norm: bool = False
    mla: Optional[MLAConfig] = None
    rope_theta: float = 10000.0
    # MoE / hybrid / rwkv
    moe: Optional[MoEConfig] = None
    block_pattern: Optional[Tuple[str, ...]] = None   # per-period, "a"/"m"
    mamba: Optional[MambaConfig] = None
    rwkv: bool = False
    rwkv_head_dim: int = 64
    # encoder-decoder
    encoder_layers: int = 0
    frontend_stub: bool = False
    enc_ratio: int = 4
    # misc
    emb_scale: bool = False             # gemma: embeddings × sqrt(d)
    norm_plus_one: bool = False         # gemma: (1+g) RMSNorm
    tie_embeddings: bool = True
    dtype: str = "bfloat16"
    sub_quadratic: bool = False
    # memory knobs: ``remat`` recomputes each period's activations in the
    # backward pass of a training step (torch.utils.checkpoint);
    # ``scan_layers`` is kept as data (the port always runs the unrolled
    # layer list)
    remat: bool = True
    scan_layers: bool = True
    # chunk sizes bounding working sets (seq must divide cleanly)
    attn_q_chunk: int = 1024
    mamba_chunk: int = 512
    rwkv_chunk: int = 32
    unroll_chunks: bool = False

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    def reduced(self) -> "ArchConfig":
        """Same-family tiny config for CPU tests."""
        small_moe = None
        if self.moe is not None:
            small_moe = dataclasses.replace(
                self.moe, n_experts=min(4, self.moe.n_experts),
                top_k=min(2, self.moe.top_k))
        small_mla = None
        if self.mla is not None:
            small_mla = MLAConfig(q_lora=16, kv_lora=8, nope_dim=8,
                                  rope_dim=4, v_dim=8)
        return dataclasses.replace(
            self,
            name=self.name + "-reduced",
            n_layers=min(4, self.n_layers) if self.block_pattern is None
            else len(self.block_pattern),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(4, max(1, self.n_kv_heads * 4
                                  // max(self.n_heads, 1))),
            head_dim=16 if self.mla is None else None,
            d_ff=128,
            vocab=256,
            window=min(self.window, 32) if self.window else None,
            moe=small_moe,
            mla=small_mla,
            rwkv_head_dim=16,
            encoder_layers=2 if self.encoder_layers else 0,
            mamba=MambaConfig(d_state=8) if self.mamba else None,
            scan_layers=self.scan_layers,
        )
