"""Primitive layers: norms, embeddings, rotary, quant-aware dense.

Params are plain nested dicts of tensors. Kernels are named ``w`` with shape
(in, out) (the quantization pipeline keys off this convention). ``linear``
transparently consumes a QuantizedTensor (SQuant serving format, (out,
in)-major) or the ``w_q``/``w_q4`` dict of ``quant.apply``: on a CUDA device
through the dequant-matmul kernel, on the CPU through its plain version.
Under tensor-parallel execution every layer here takes this rank's local
tensors (``distributed.sharding.tp_local``), never a DTensor.
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


def _is_dtensor(t) -> bool:
    return type(t).__name__ == "DTensor"


def linear(params, x: torch.Tensor, backend: str = "auto") -> torch.Tensor:
    """x @ W. Accepts three kernel formats:
    * ``{"w": (in, out) float}`` — dense (``torch.matmul``);
    * ``{"w": QuantizedTensor}`` — real-quantized (dequant-matmul kernel);
    * ``{"w_q"/"w_q4", "w_scale"}`` — the checkpointable serving format of
      ``quant.apply``, through the same kernel on a zero-copy
      ``QuantizedTensor`` view of its two tensors."""
    if "w_q" in params or "w_q4" in params:
        from repro_torch.quant.apply import qdict_view
        w = qdict_view(params)
    else:
        w = params["w"]
    if _is_dtensor(w.data if isinstance(w, QuantizedTensor) else w):
        raise TypeError("linear takes this rank's local tensors, not a "
                        "DTensor: run on distributed.sharding.tp_local's "
                        "tree")
    if isinstance(w, QuantizedTensor):
        from repro_torch.kernels import ops                  # lazy import
        lead = x.shape[:-1]
        x2 = x.reshape(-1, x.shape[-1])
        y = ops.dequant_matmul(x2, w, backend=backend)
        return y.reshape(*lead, -1)
    return x @ w.to(x.dtype)


def by_position(fn, x: torch.Tensor) -> torch.Tensor:
    """``fn`` applied to each position's rows of ``x`` (B, S, ...) as one
    contiguous (B, 1, ...) tensor, the results concatenated along positions.

    The speculative verify forward runs every operation whose per-row
    result may depend on how many rows share the call (kernel B picks its
    variant and split plan by row count, a reduction its block shape, a
    matmul library its algorithm) this way: each call then has the shape
    and the launch of a decode step over the same B rows, so row (b, j)
    comes out bit for bit as a decode step at that position gives it."""
    s = x.shape[1]
    if s == 1:
        return fn(x)
    return torch.cat([fn(x[:, j:j + 1].contiguous()) for j in range(s)],
                     dim=1)


def linear_by_position(params, x: torch.Tensor) -> torch.Tensor:
    """:func:`linear`, position by position (:func:`by_position`)."""
    return by_position(lambda t: linear(params, t), x)


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


def embed(params, tokens: torch.Tensor, vocab: int) -> torch.Tensor:
    """The rows of ``tokens``. Where the active 'model' axis shards the
    vocabulary, the local table holds this rank's range of ``vocab`` rows:
    the other tokens look up zeros and the sum over 'model'
    (``shard_act``) puts every row together, bit for bit."""
    from repro_torch.distributed.sharding import (model_axis, shard_act,
                                                  vocab_parallel)
    e = params["embedding"]
    if not vocab_parallel(vocab):
        return e[tokens]
    rows = e.shape[0]
    ids = tokens - model_axis()[1] * rows
    mine = (ids >= 0) & (ids < rows)
    x = torch.where(mine[..., None], e[ids.clamp(0, rows - 1)],
                    torch.zeros((), dtype=e.dtype, device=e.device))
    return shard_act(x)


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
