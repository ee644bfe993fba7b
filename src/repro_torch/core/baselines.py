"""Data-free quantization baselines the paper compares against.

* ``rtn``              — rounding-to-nearest (== SQuant-E): the DFQ default.
* ``equalize_pair``    — DFQ cross-layer weight equalization (Nagel et al. '19).
* ``bias_correction``  — DFQ bias correction given E[x] (from BN stats or 0).
* ``synthesize_inputs``— ZeroQ-style statistic-matching input distillation
                         (needs back-prop: the "No BP ✗" column of Table 1).
* ``adaround``         — AdaRound (Nagel et al. '20) layer-wise learned
                         rounding; combined with ``synthesize_inputs`` it is
                         the "data-free AdaRound" baseline of Table 5.

Gradients come from ``torch.autograd``; the optimizer is a hand-written Adam
(β = 0.9 / 0.999, ε = 1e-8), as in the reference package.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from repro_torch.quant.qtypes import QuantizedTensor, from_codes, qmax_for_bits
from repro_torch.quant.scales import compute_scale


# ---------------------------------------------------------------------------
# Rounding-to-nearest
# ---------------------------------------------------------------------------

def rtn(w2d: torch.Tensor, bits: int, scale: Optional[torch.Tensor] = None,
        scale_method: str = "max") -> QuantizedTensor:
    """Per-channel symmetric rounding quantization of an (M, N) matrix."""
    qmax = qmax_for_bits(bits)
    if scale is None:
        scale = compute_scale(w2d, bits, scale_method)
    codes = torch.clamp(torch.round(w2d / scale), -qmax, qmax)
    return from_codes(codes.to(torch.int8), scale, bits)


# ---------------------------------------------------------------------------
# DFQ: cross-layer equalization + bias correction
# ---------------------------------------------------------------------------

def equalize_pair(w1: torch.Tensor, w2: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Cross-layer equalization for y = W2·f(W1·x), f positive-homogeneous.

    w1: (H, I) rows feed hidden units; w2: (O, H) columns consume them.
    Scales s_h = sqrt(r1_h / r2_h) equalize per-channel ranges:
    W1' = W1 / s, W2' = W2 * s (Nagel et al. 2019, Sec. 4.1).
    """
    r1 = w1.abs().amax(dim=1)
    r2 = w2.abs().amax(dim=0)
    s = torch.sqrt(torch.clamp_min(r1, 1e-12) / torch.clamp_min(r2, 1e-12))
    s = torch.clamp(s, 1e-4, 1e4)
    return w1 / s[:, None], w2 * s[None, :], s


def bias_correction(w_fp: torch.Tensor, w_q: torch.Tensor,
                    mu_x: torch.Tensor) -> torch.Tensor:
    """Expected-output correction  b += −(W_q − W_fp)·E[x]  (DFQ Sec. 4.2)."""
    return -(w_q - w_fp) @ mu_x


# ---------------------------------------------------------------------------
# Adam (hand-written, the reference's constants)
# ---------------------------------------------------------------------------

def _adam_step(p, g, m, v, t: int, lr: float):
    m = 0.9 * m + 0.1 * g
    v = 0.999 * v + 0.001 * g * g
    # the bias corrections in float32, as the reference computes them
    f32 = np.float32
    mh = m / float(f32(1) - f32(0.9) ** f32(t))
    vh = v / float(f32(1) - f32(0.999) ** f32(t))
    return p - lr * mh / (torch.sqrt(vh) + 1e-8), m, v


# ---------------------------------------------------------------------------
# ZeroQ-style statistic-matching input synthesis (needs BP)
# ---------------------------------------------------------------------------

def synthesize_inputs(stat_fn: Callable[[torch.Tensor], torch.Tensor],
                      target_stats: torch.Tensor, shape: Tuple[int, ...],
                      generator: torch.Generator, iters: int = 100,
                      lr: float = 0.1) -> torch.Tensor:
    """Distill synthetic inputs x so stat_fn(x) matches target statistics.

    ``stat_fn`` maps an input batch to a vector of network statistics (e.g.
    per-layer pre-activation mean/var — the BN-statistics analogue). Plain
    Adam on the input, starting from 0.5·N(0, 1) drawn from ``generator``
    (on its device); this is the paper's "data-generative" DFQ family.
    """
    x = 0.5 * torch.randn(shape, generator=generator,
                          device=generator.device)
    m = torch.zeros_like(x)
    v = torch.zeros_like(x)
    for t in range(1, iters + 1):
        xv = x.detach().requires_grad_(True)
        with torch.enable_grad():
            loss = torch.mean((stat_fn(xv) - target_stats) ** 2)
            (g,) = torch.autograd.grad(loss, xv)
        x, m, v = _adam_step(x, g, m, v, t, lr)
    return x.detach()


# ---------------------------------------------------------------------------
# AdaRound (layer-wise learned rounding)
# ---------------------------------------------------------------------------

def _rect_sigmoid(alpha, zeta=1.1, gamma=-0.1):
    return torch.clamp(torch.sigmoid(alpha) * (zeta - gamma) + gamma,
                       0.0, 1.0)


def adaround(w2d: torch.Tensor, x: torch.Tensor, bits: int,
             iters: int = 600, lr: float = 3e-2, beta_range=(20.0, 2.0),
             reg_weight: float = 0.01, warmup: float = 0.2,
             scale: Optional[torch.Tensor] = None) -> QuantizedTensor:
    """AdaRound: learn up/down rounding to minimize output MSE on ``x``.

    w2d: (M, N); x: (S, N) calibration inputs (real or synthetic).
    Output-MSE objective ‖xWᵀ − xW̃ᵀ‖² + λ·f_reg per Nagel et al. 2020:
    the rectified-sigmoid relaxation starts at the soft (exact) weights, the
    annealed regularizer polarizes h to {0,1}, and the reconstruction term
    picks the better side for borderline elements. λ is normalized by the
    initial hard-rounding reconstruction error so the balance is
    scale-invariant.
    """
    qmax = qmax_for_bits(bits)
    if scale is None:
        scale = compute_scale(w2d, bits, "max")
    ws = w2d / scale
    floor = torch.floor(ws)
    resid = ws - floor                      # in [0, 1)
    # init so that _rect_sigmoid(alpha) ≈ resid (paper's init)
    p = torch.clamp((resid + 0.1) / 1.2, 1e-4, 1 - 1e-4)
    alpha = torch.log(p / (1 - p))
    y_ref = x @ w2d.T
    # normalize λ: hard-rounding reconstruction error sets the scale
    hard = torch.clamp(floor + (resid > 0.5).to(floor.dtype), -qmax,
                       qmax) * scale
    rec0 = torch.mean((x @ hard.T - y_ref) ** 2)
    lam = reg_weight * torch.clamp_min(rec0, 1e-12)

    def loss(a, beta, reg_on):
        h = _rect_sigmoid(a)
        qw = torch.clamp(floor + h, -qmax, qmax) * scale
        rec = torch.mean((x @ qw.T - y_ref) ** 2)
        reg = torch.mean(1 - torch.abs(2 * h - 1) ** beta)
        return rec + reg_on * lam * reg

    b0, b1 = beta_range
    m = torch.zeros_like(alpha)
    v = torch.zeros_like(alpha)
    f32 = np.float32
    for t in range(1, iters + 1):
        # the schedule in float32 arithmetic, as the reference's traced loop
        # computes it
        frac = f32(t) / f32(iters)
        beta = float(f32(b0) + f32(b1 - b0) * frac)
        reg_on = 1.0 if frac > warmup else 0.0
        a = alpha.detach().requires_grad_(True)
        with torch.enable_grad():
            (g,) = torch.autograd.grad(loss(a, beta, reg_on), a)
        alpha, m, v = _adam_step(alpha, g, m, v, t, lr)
    h_final = (_rect_sigmoid(alpha) > 0.5).to(floor.dtype)
    codes = torch.clamp(floor + h_final, -qmax, qmax)
    return from_codes(codes.to(torch.int8), scale, bits)
