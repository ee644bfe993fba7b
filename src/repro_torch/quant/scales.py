"""Data-free quantization scale selection.

Per the paper (Sec. 4), SQuant uses per-channel symmetric weight scales; the
range can come from the channel max ("max") or an MSE-optimal clip search
("mse") — both are data-free (they look only at the weights).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.quant.qtypes import qmax_for_bits

_EPS = 1e-12


def _absmax(w2d: torch.Tensor) -> torch.Tensor:
    # max |w| (exact in any order) in one read, no |w| copy
    return torch.linalg.vector_norm(w2d, ord=float("inf"), dim=-1,
                                    keepdim=True)


def _div(x: torch.Tensor, qmax: int) -> torch.Tensor:
    """``x / qmax`` as a true division on every device. (On a CUDA tensor
    PyTorch divides by a Python number as a multiplication by its float32
    reciprocal, one ulp away from the division on some rows.)"""
    # a 0-d tensor made on the device: no host copy, no synchronization
    return x / torch.full((), float(qmax), dtype=x.dtype, device=x.device)


def max_scale(w2d: torch.Tensor, bits: int) -> torch.Tensor:
    """Per-row symmetric max scale. w2d: (..., M, N) → (..., M, 1)."""
    return _div(torch.clamp_min(_absmax(w2d), _EPS), qmax_for_bits(bits))


def mse_scale(w2d: torch.Tensor, bits: int, num_candidates: int = 40,
              lo: float = 0.4) -> torch.Tensor:
    """Per-row scale minimizing rounding MSE over a clip-ratio grid.

    Data-free: the search objective is the weight-space MSE of
    clip(round(w/s)) * s, evaluated per row over ``num_candidates`` clip
    ratios in [lo, 1.0]. Candidates are visited one at a time (first minimum
    wins, as an argmin over the stacked candidates would pick), so peak
    memory is one extra copy of the weights, not ``num_candidates`` copies.
    """
    qmax = qmax_for_bits(bits)
    base = torch.clamp_min(_absmax(w2d), _EPS)
    ratios = torch.linspace(lo, 1.0, num_candidates, dtype=torch.float32)
    best_err = None
    best = None
    for r in ratios.tolist():
        s = _div(base * torch.tensor(r, dtype=w2d.dtype), qmax)
        q = torch.clamp(torch.round(w2d / s), -qmax, qmax)
        err = ((q * s - w2d) ** 2).sum(dim=-1, keepdim=True)
        if best is None:
            best, best_err = s, err
        else:
            take = err < best_err
            best = torch.where(take, s, best)
            best_err = torch.where(take, err, best_err)
    return best


def compute_scale(w2d: torch.Tensor, bits: int, method: str = "max",
                  group_size: Optional[int] = None) -> torch.Tensor:
    """Scale for a (M, N) matrix (leading batch dims pass through).

    group_size=None → per-channel (M, 1)  [SQuant's setting]
    group_size=G    → per-group (M, N//G) [serving-format option; not used by
                      the SQuant flip math, which requires a uniform scale
                      per channel]
    """
    fn = {"max": max_scale, "mse": mse_scale}[method]
    if group_size is None:
        return fn(w2d, bits)
    m, n = w2d.shape
    if n % group_size != 0:
        raise ValueError(f"N={n} not divisible by group_size={group_size}")
    wg = w2d.reshape(m * (n // group_size), group_size)
    return fn(wg, bits).reshape(m, n // group_size)
