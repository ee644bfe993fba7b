"""SQuant: on-the-fly data-free quantization via diagonal Hessian approximation.

PyTorch implementation of Algorithms 1-4 of the paper (Guo et al., ICLR
2022), fully vectorized over output channels and kernels/groups — no Python
loop touches a weight element, no autodiff, no data. This module is also the
plain version of the fused CUDA kernel in ``kernels/squant_flip.py``: the
kernel is held against ``squant_codes`` on the same inputs.

Terminology (paper → here)
--------------------------
* output channel  → row ``m`` of the 2-D weight view ``(M, N_flat)``
* kernel          → a contiguous *group* of ``G`` elements within a row.
  For conv weights ``(M, N, K)`` the natural grouping is G=K (paper exact).
  For FC/LLM matrices the paper sets K=1 and skips SQuant-K; ``group_size=G``
  lets contiguous input groups play the kernel role. ``group_size=None``
  reproduces the paper's FC path: SQuant-E followed by SQuant-C over the row.

Stages
------
SQuant-E  rounding: ``q0 = clip(round(w/s))``, element perturbation
          ``δ = q0 - w/s`` with |δ| ≤ 0.5 (r_e = 0.5).
SQuant-K  per group: flip ``k = ⌊|Σδ|⌉`` elements with sign(δ)=sign(Σδ),
          largest |δ| first (top-k; Appendix B.2) → |Σδ| ≤ 0.5 per group,
          |δ| < 1 per element (r_e relaxed to 1.0).
SQuant-C  per row over groups: each group exposes ONE candidate element
          (Algorithm 4) whose ±1 flip moves the group sum by −sign(candidate);
          flip the top-``⌊|Σ_groups Σδ|⌉`` candidates whose sign matches the
          row sum → |row Σδ| ≤ 0.5, per-group |Σδ| ≤ 1.0 (r_k relaxed to 1.0).

The C level uses the true row sum of post-K group sums (Appendix-B proofs).
Post-K, a group's candidate is the max-|δ| element whose δ sign matches the
post-K group sum (for over-flipped groups that is the weakest flipped
element; for under-flipped groups the (k+1)-th strongest unflipped one).

``round`` is half-to-even (``torch.round``), ``w / s`` is a true division,
and top-k ties go to the lower index (stable argsort) — the three choices
that decide whether two implementations agree bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.quant.qtypes import QuantizedTensor, from_codes, qmax_for_bits
from repro_torch.quant.scales import compute_scale


@dataclasses.dataclass(frozen=True)
class SQuantConfig:
    """Configuration for one SQuant invocation."""
    bits: int = 4
    group_size: Optional[int] = 128  # None → paper's FC path (E&C only)
    enable_k: bool = True            # SQuant-K (kernel/group-wise)
    enable_c: bool = True            # SQuant-C (output-channel-wise)
    scale_method: str = "max"        # "max" | "mse"

    def tag(self) -> str:
        lv = "E" + ("K" if self.enable_k else "") + ("C" if self.enable_c else "")
        return f"squant-{lv}-w{self.bits}g{self.group_size}"


# ---------------------------------------------------------------------------
# Core flip machinery (vectorized Algorithm 2)
# ---------------------------------------------------------------------------

def _ranks_desc(score: torch.Tensor) -> torch.Tensor:
    """Rank (0 = largest) of each element along the last axis.

    Double stable argsort; ties go to the lower index.
    """
    order = torch.argsort(-score, dim=-1, stable=True)
    return torch.argsort(order, dim=-1, stable=True)


def _flip_once(q: torch.Tensor, delta: torch.Tensor, in_range: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One SQuantFlip (Algorithm 2) over the last axis.

    Args:
      q:      integer codes (float carrier), shape (..., L)
      delta:  perturbation q - w/s, shape (..., L)
      in_range: bool, True where a flip (q - sign(δ)) stays on the grid.

    Returns (q', delta', flip_mask). After the call the last-axis sum of
    delta' satisfies |Σδ'| ≤ 0.5 (up to clipping-induced eligibility loss).
    """
    e = delta.sum(dim=-1)                             # accumulated perturbation
    k = torch.round(e.abs()).to(torch.int32)          # ⌊|e|⌉ flips
    # Eligible: same sign as e (strict — δ=0 never flips), flip stays on grid.
    eligible = (delta * e[..., None] > 0) & in_range
    k = torch.minimum(k, eligible.sum(dim=-1).to(torch.int32))
    score = torch.where(eligible, delta.abs(), -1.0)
    flip = (_ranks_desc(score) < k[..., None]) & eligible
    step = torch.where(flip, torch.sign(delta), 0.0)
    return q - step, delta - step, flip


def _c_stage(q: torch.Tensor, delta: torch.Tensor, in_range: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """SQuant-C over groups: (M, NG, G) → flip ≤1 candidate per group.

    Implements Algorithm 4 (perturbation update) + Algorithm 2 at the
    channel level, vectorized.
    """
    e1 = delta.sum(dim=-1)                            # (M, NG) post-K sums
    sgn1 = torch.sign(e1)[..., None]
    # Candidate per group: max |δ| among elements whose δ sign matches the
    # post-K group sum. Groups with e1 == 0 admit any sign.
    match = torch.where(sgn1 == 0.0, delta != 0.0, delta * sgn1 > 0.0)
    cscore = torch.where(match & in_range, delta.abs(), -1.0)   # (M, NG, G)
    # first index of the maximum (torch.argmax does not promise the first)
    cmax = cscore.amax(dim=-1, keepdim=True)
    g = cscore.shape[-1]
    iota = torch.arange(g, device=delta.device)
    cand_idx = torch.where(cscore == cmax, iota, g).amin(dim=-1)  # (M, NG)
    cand_val = torch.gather(delta, -1, cand_idx[..., None])[..., 0]
    has_cand = cmax[..., 0] > 0.0

    e_row = e1.sum(dim=-1)                            # (M,) channel sum
    k_c = torch.round(e_row.abs()).to(torch.int32)
    elig = has_cand & (cand_val * e_row[..., None] > 0.0)
    k_c = torch.minimum(k_c, elig.sum(dim=-1).to(torch.int32))
    gscore = torch.where(elig, cand_val.abs(), -1.0)
    gflip = (_ranks_desc(gscore) < k_c[..., None]) & elig     # (M, NG)

    onehot = (iota == cand_idx[..., None]) & gflip[..., None]
    step = torch.where(onehot, torch.sign(cand_val)[..., None], 0.0)
    return q - step, delta - step, gflip


# ---------------------------------------------------------------------------
# Public entry points
# ---------------------------------------------------------------------------

def _as_groups(w2d: torch.Tensor, group_size: Optional[int]
               ) -> Tuple[torch.Tensor, int]:
    """(M, N) → (M, NG, G) with zero padding; returns the pad length."""
    m, n = w2d.shape
    g = group_size if group_size is not None else n
    pad = (-n) % g
    if pad:
        w2d = torch.nn.functional.pad(w2d, (0, pad))
    return w2d.reshape(m, (n + pad) // g, g), pad


def squant_codes(w2d: torch.Tensor, scale: torch.Tensor, *, bits: int,
                 group_size: Optional[int], enable_k: bool, enable_c: bool):
    """Run progressive SQuant; returns (codes int8 (M,N), delta, stats dict).

    ``delta`` is the final scaled perturbation q - w/s (analysis output).
    Padding elements (zeros) round to code 0 with δ=0 and are never eligible
    for flips, so they do not perturb group or channel sums.
    """
    m, n = w2d.shape
    qmax = qmax_for_bits(bits)
    ws = w2d.to(torch.float32) / scale.reshape(m, 1).to(torch.float32)
    wg, pad = _as_groups(ws, group_size)

    # --- SQuant-E: rounding -------------------------------------------------
    q = torch.clamp(torch.round(wg), -qmax, qmax)
    delta = q - wg

    def in_range(qc, d):
        tgt = qc - torch.sign(d)
        return (tgt >= -qmax) & (tgt <= qmax)

    zero = torch.zeros((), dtype=torch.int32, device=w2d.device)
    flips_k, flips_c = zero, zero
    # --- SQuant-K: per-group flips -------------------------------------
    if enable_k and (group_size is not None):
        q, delta, fk = _flip_once(q, delta, in_range(q, delta))
        flips_k = fk.sum().to(torch.int32)
    # --- SQuant-C: per-row flips over groups ---------------------------
    if enable_c:
        if group_size is None or not enable_k:
            # Paper FC path (K skipped, Sec. 3.4) and the E&C ablation: the
            # whole row is one "kernel" — a row-level SQuantFlip.
            qf, df = q.reshape(m, -1), delta.reshape(m, -1)
            qf, df, fc = _flip_once(qf, df, in_range(qf, df))
            q, delta = qf.reshape(q.shape), df.reshape(delta.shape)
        else:
            q, delta, fc = _c_stage(q, delta, in_range(q, delta))
        flips_c = fc.sum().to(torch.int32)

    q = q.reshape(m, n + pad)[:, :n]
    delta = delta.reshape(m, n + pad)[:, :n]
    stats = {
        "flips_k": flips_k,
        "flips_c": flips_c,
        "row_case": delta.sum(dim=-1).abs(),
        "max_abs_delta": delta.abs().max(),
    }
    return q.to(torch.int8), delta, stats


def squant(w: torch.Tensor, cfg: SQuantConfig,
           scale: Optional[torch.Tensor] = None
           ) -> Tuple[QuantizedTensor, dict]:
    """Quantize a weight tensor with SQuant.

    Accepts (M, N) FC weights or (M, N, K) conv-layout weights (kernels =
    trailing K). Returns (QuantizedTensor, stats).
    """
    shape = tuple(w.shape)
    if w.ndim == 3:                       # conv: groups are true kernels
        m, n, k = shape
        w2d = w.reshape(m, n * k)
        group_size = None if k == 1 else k
    elif w.ndim == 2:
        m, n = shape
        w2d = w
        group_size = cfg.group_size
        if group_size is not None and group_size >= n:
            group_size = None             # degenerate: one group == row
    else:
        raise ValueError(f"squant expects 2-D or 3-D weights, got {shape}")

    if scale is None:
        scale = compute_scale(w2d, cfg.bits, cfg.scale_method)
    codes, delta, stats = squant_codes(
        w2d, scale, bits=cfg.bits, group_size=group_size,
        enable_k=cfg.enable_k, enable_c=cfg.enable_c)
    qt = from_codes(codes.reshape(shape), scale, cfg.bits, group_size=None)
    stats = dict(stats)
    stats["group_size"] = group_size
    return qt, stats


def dequantize(qt: QuantizedTensor, dtype=torch.float32) -> torch.Tensor:
    return qt.dequantize(dtype)
