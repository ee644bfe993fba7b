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


# The default clip-ratio grid, ``jnp.linspace(0.4, 1.0, 40)`` of the
# reference as float32 bit patterns, read once from JAX 0.9.0 on the CPU.
# JAX computes ``start * (1 - i/div) + stop * (i/div)`` in float32, but XLA's
# compile of that expression differs from the same float32 arithmetic done
# op by op at 5 of the 40 values, and no float32 formula in torch reproduces
# all 40 (``torch.linspace`` differs at 6), so the grid is a table.
_MSE_GRID_0_4_40 = (
    0x3ecccccd, 0x3ed4ad4b, 0x3edc8dc9, 0x3ee46e47, 0x3eec4ec5, 0x3ef42f43,
    0x3efc0fc1, 0x3f01f820, 0x3f05e85f, 0x3f09d89e, 0x3f0dc8dd, 0x3f11b91b,
    0x3f15a95b, 0x3f199999, 0x3f1d89d9, 0x3f217a17, 0x3f256a57, 0x3f295a96,
    0x3f2d4ad5, 0x3f313b14, 0x3f352b53, 0x3f391b92, 0x3f3d0bd1, 0x3f40fc10,
    0x3f44ec4f, 0x3f48dc8e, 0x3f4ccccd, 0x3f50bd0c, 0x3f54ad4b, 0x3f589d8a,
    0x3f5c8dc9, 0x3f607e08, 0x3f646e47, 0x3f685e86, 0x3f6c4ec5, 0x3f703f04,
    0x3f742f43, 0x3f781f82, 0x3f7c0fc1, 0x3f800000)


def mse_grid(lo: float = 0.4, num_candidates: int = 40) -> torch.Tensor:
    """The clip ratios ``mse_scale`` tries, float32 on the CPU: the
    reference's exact grid for the default ``(0.4, 40)``; any other grid is
    ``torch.linspace``, which may differ from the reference's
    ``jnp.linspace`` in the last bit."""
    if (lo, num_candidates) == (0.4, 40):
        return torch.tensor(_MSE_GRID_0_4_40,
                            dtype=torch.int32).view(torch.float32)
    return torch.linspace(lo, 1.0, num_candidates, dtype=torch.float32)


def mse_scale(w2d: torch.Tensor, bits: int, num_candidates: int = 40,
              lo: float = 0.4) -> torch.Tensor:
    """Per-row scale minimizing rounding MSE over a clip-ratio grid.

    Data-free: the search objective is the weight-space MSE of
    clip(round(w/s)) * s, evaluated per row over ``num_candidates`` clip
    ratios in [lo, 1.0] (:func:`mse_grid`: the reference's grid bit for bit
    at the defaults; elsewhere it may differ in the last bit). Candidates
    are visited one at a time (first minimum wins, as an argmin over the
    stacked candidates would pick), so peak memory is one extra copy of the
    weights, not ``num_candidates`` copies.
    """
    qmax = qmax_for_bits(bits)
    base = torch.clamp_min(_absmax(w2d), _EPS)
    ratios = mse_grid(lo, num_candidates)
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
