"""Primitive layers: norms, embeddings, rotary, quant-aware dense.

Params are plain nested dicts of tensors. Kernels are named ``w`` with shape
(in, out) (the quantization pipeline keys off this convention). ``linear``
transparently consumes a QuantizedTensor (SQuant serving format, (out,
in)-major): on a CUDA device through the dequant-matmul kernel, on the CPU
through its plain version.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.quant.qtypes import QuantizedTensor


def _init_dense(generator: torch.Generator, d_in: int, d_out: int,
                dtype=torch.float32, scale: Optional[float] = None,
                device=None):
    s = scale if scale is not None else 1.0 / math.sqrt(d_in)
    w = torch.randn((d_in, d_out), generator=generator, dtype=dtype,
                    device=device)
    return {"w": w.mul_(s)}


def linear(params, x: torch.Tensor, backend: str = "auto") -> torch.Tensor:
    """x @ W. Accepts two kernel formats:
    * ``{"w": (in, out) float}`` — dense (``torch.matmul``);
    * ``{"w": QuantizedTensor}`` — real-quantized (dequant-matmul kernel).
    The sharded ``w_q``/``w_q4`` dict format is not part of this package yet."""
    if "w_q" in params or "w_q4" in params:
        raise NotImplementedError(
            "not ported yet: the w_q/w_q4 serving-dict format (quant/apply)")
    w = params["w"]
    if isinstance(w, QuantizedTensor):
        from repro_torch.kernels import ops                  # lazy import
        lead = x.shape[:-1]
        x2 = x.reshape(-1, x.shape[-1])
        y = ops.dequant_matmul(x2, w, backend=backend)
        return y.reshape(*lead, -1)
    return x @ w.to(x.dtype)


def rms_norm(params, x: torch.Tensor, eps: float = 1e-6,
             plus_one: bool = False) -> torch.Tensor:
    """RMSNorm. ``plus_one=True`` uses the Gemma (1+g) parameterization."""
    dt = x.dtype
    xf = x.to(torch.float32)
    var = (xf * xf).mean(dim=-1, keepdim=True)
    xf = xf * torch.rsqrt(var + eps)
    g = params["gain"].to(torch.float32)
    g = 1.0 + g if plus_one else g
    return (xf * g).to(dt)


def init_norm(d: int, plus_one: bool = False, device=None):
    """RMSNorm gain: ones, or zeros under the (1+g) parameterization."""
    init = torch.zeros if plus_one else torch.ones
    return {"gain": init((d,), dtype=torch.float32, device=device)}


def embed(params, tokens: torch.Tensor) -> torch.Tensor:
    return params["embedding"][tokens]


def init_embedding(generator: torch.Generator, vocab: int, d: int,
                   dtype=torch.float32, device=None):
    e = torch.randn((vocab, d), generator=generator, dtype=dtype,
                    device=device)
    return {"embedding": e.mul_(0.02)}


def rope(positions: torch.Tensor, rope_dim: int, theta: float,
         dtype=torch.float32):
    """cos/sin of shape ``positions.shape + (rope_dim//2,)`` for positions
    ``(S,)`` shared across the batch or ``(B, S)`` per row."""
    inv = 1.0 / (theta ** (torch.arange(0, rope_dim, 2, dtype=torch.float32,
                                        device=positions.device) / rope_dim))
    freqs = positions.to(torch.float32)[..., None] * inv
    return torch.cos(freqs).to(dtype), torch.sin(freqs).to(dtype)


def apply_rotary(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
                 ) -> torch.Tensor:
    """x: (B, S, H, D); cos/sin: (S, D/2) shared across the batch, or
    (B, S, D/2) per-row. cos/sin are cast to x.dtype so rotary never promotes
    bf16 activations."""
    d2 = x.shape[-1] // 2
    x1, x2 = x[..., :d2], x[..., d2:]
    if cos.ndim == 3:
        c = cos.to(x.dtype)[:, :, None, :]
        s = sin.to(x.dtype)[:, :, None, :]
    else:
        c = cos.to(x.dtype)[None, :, None, :]
        s = sin.to(x.dtype)[None, :, None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
