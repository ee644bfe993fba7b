"""Hessian machinery: Eq. (5) decomposition (Algorithm 3), the precise
objective Eq. (6), and the approximation-precision (AP) analysis of
Appendix A.3.

Data enters ONLY here, and only to *validate* the data-free approximation,
as in the paper's appendix experiment. The quantizer itself
(``core/squant.py``) never sees activations.

Everything is float64 torch on the input tensor's device, except the flip
recorder of the in-order diagnostic (:func:`_record_flips`), a sequential
loop over the layer on the host.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch

from repro_torch.core.squant import squant_codes
from repro_torch.quant.qtypes import qmax_for_bits
from repro_torch.quant.scales import max_scale


def _f64(a, device=None) -> torch.Tensor:
    return torch.as_tensor(a, device=device).to(torch.float64)


# ---------------------------------------------------------------------------
# E[x xᵀ] and Algorithm 3 decomposition
# ---------------------------------------------------------------------------

def second_moment(x) -> torch.Tensor:
    """E[x xᵀ] from samples x of shape (num_samples, NK)."""
    x = _f64(x)
    return x.T @ x / x.shape[0]


@dataclasses.dataclass
class HessianCoeffs:
    """Coefficients of the E+K+C decomposition for one layer.

    c: scalar (channel-wise), k: (N,) per kernel, e: (N, K) per element.
    All strictly positive by construction (Algorithm 3).
    """
    c: float
    k: torch.Tensor
    e: torch.Tensor

    @property
    def group_size(self) -> int:
        return self.e.shape[1]


def decompose(h, group_size: int, eps: float = 0.1,
              eps_k: float = 0.1) -> HessianCoeffs:
    """Algorithm 3: E[xxᵀ] ≈ E + K + C with positive coefficients.

    ``h`` is (NK, NK); kernels are contiguous blocks of ``group_size``.
    """
    h = _f64(h)
    nk = h.shape[0]
    if nk % group_size != 0:
        raise ValueError(f"H dim {nk} not divisible by group {group_size}")
    n, g = nk // group_size, group_size
    habs = h.abs()
    c = max(float((1.0 - eps) * habs.min()), 1e-12)
    blocks = habs.reshape(n, g, n, g).diagonal(dim1=0, dim2=2)   # (g, g, n)
    k = torch.clamp_min((1.0 - eps_k) * (blocks.amin(dim=(0, 1)) - c), 1e-12)
    e = torch.clamp_min(habs.diagonal().reshape(n, g) - c - k[:, None],
                        1e-12)
    return HessianCoeffs(c=c, k=k, e=e)


def reconstruction(co: HessianCoeffs) -> torch.Tensor:
    """E + K + C as a dense (NK, NK) matrix."""
    g = co.e.shape[1]
    blk = torch.block_diag(*[torch.full((g, g), float(kv), dtype=torch.float64,
                                        device=co.e.device) for kv in co.k])
    out = co.c + blk
    return out + torch.diag(co.e.reshape(-1))


# ---------------------------------------------------------------------------
# Objectives
# ---------------------------------------------------------------------------

def precise_objective(delta_row, co: HessianCoeffs) -> float:
    """Eq. (6): Σ e_ni δ² + Σ_n k_n (Σ_i δ)² + c (Σ δ)² for one channel."""
    n, g = co.e.shape
    d = _f64(delta_row, co.e.device).reshape(n, g)
    t1 = float(torch.sum(co.e * d * d))
    ks = d.sum(dim=1)
    t2 = float(torch.sum(co.k * ks * ks))
    t3 = co.c * float(d.sum()) ** 2
    return t1 + t2 + t3


def exact_objective(delta_row, h) -> float:
    """Eq. (4): δ H δᵀ with the measured E[xxᵀ]."""
    h = _f64(h)
    d = _f64(delta_row, h.device)
    return float(d @ h @ d)


def approx_objective(delta_row, group_size: int) -> float:
    """Eq. (8): coefficients dropped (the data-free objective)."""
    d = _f64(delta_row).reshape(-1, group_size)
    return (float(torch.sum(d * d)) + float(torch.sum(d.sum(1) ** 2))
            + float(d.sum()) ** 2)


# ---------------------------------------------------------------------------
# The sequential flip recorder (the in-order diagnostic's flip log)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class FlipEvent:
    m: int                 # output channel
    flat_idx: int          # flat index within the row
    stage: str             # "K" | "C"
    sign: float            # sign of δ before the flip (mutation is -sign)
    delta_before: float    # element δ before flip
    kernel_sum_before: float
    row_sum_before: float


def _topk_desc_stable(scores: np.ndarray, k: int) -> np.ndarray:
    """Indices of the k largest scores; ties go to the lower index."""
    return np.argsort(-scores, kind="stable")[:k]


def _record_flips(ws: np.ndarray, bits: int, g: int, enable_c: bool
                  ) -> Tuple[np.ndarray, np.ndarray, List[FlipEvent]]:
    """SQuant E, K and (optionally) C of the scaled float64 rows ``ws`` (M,
    N), one flip at a time, in the paper's order, recording each flip: the
    element, the stage, and δ, its group's sum and its row's sum before it.
    Ties go to the lower index, as in ``core.squant``. Returns (codes,
    final δ, log)."""
    m_sz, n_sz = ws.shape
    qmax = qmax_for_bits(bits)
    ng = n_sz // g
    q = np.clip(np.round(ws), -qmax, qmax)
    delta = q - ws
    row_sum = delta.sum(axis=1)
    log: List[FlipEvent] = []

    def flip_ok(mm, idx):
        return -qmax <= q[mm, idx] - np.sign(delta[mm, idx]) <= qmax

    def do_flip(mm, idx, stage):
        d = delta[mm, idx]
        s = np.sign(d)
        grp = idx // g
        ks = delta[mm, grp * g:(grp + 1) * g].sum()
        log.append(FlipEvent(mm, int(idx), stage, float(s), float(d),
                             float(ks), float(row_sum[mm])))
        q[mm, idx] -= s
        delta[mm, idx] -= s
        row_sum[mm] -= s

    for m in range(m_sz):                       # SQuant-K, per kernel
        for n in range(ng):
            p = delta[m, n * g:(n + 1) * g].copy()
            e = p.sum()
            p[e * p <= 0] = 0.0
            for j in range(g):
                if p[j] != 0 and not flip_ok(m, n * g + j):
                    p[j] = 0.0
            k = min(int(np.round(abs(e))), int(np.count_nonzero(p)))
            for j in _topk_desc_stable(np.abs(p), k):
                do_flip(m, n * g + j, "K")
    if enable_c:                                # SQuant-C (Algorithm 4)
        for m in range(m_sz):
            cand_idx = np.full(ng, -1)
            cand_val = np.zeros(ng)
            for n in range(ng):
                d = delta[m, n * g:(n + 1) * g]
                s1 = np.sign(d.sum())
                match = d != 0 if s1 == 0 else d * s1 > 0
                for j in range(g):
                    if match[j] and not flip_ok(m, n * g + j):
                        match[j] = False
                if not match.any():
                    continue
                j = int(np.argmax(np.where(match, np.abs(d), -1.0)))
                cand_idx[n] = n * g + j
                cand_val[n] = d[j]
            e_row = delta[m].sum()
            elig = (cand_idx >= 0) & (cand_val * e_row > 0)
            k_c = min(int(np.round(abs(e_row))), int(elig.sum()))
            sc = np.where(elig, np.abs(cand_val), -1.0)
            for n in _topk_desc_stable(sc, k_c):
                do_flip(m, int(cand_idx[n]), "C")
    return q.astype(np.int8), delta, log


# ---------------------------------------------------------------------------
# Approximation precision (Appendix A.3, Table 6)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class APReport:
    flipped: int
    correct: int          # flips the precise objective Eq. (6) also prefers
    correct_exact: int    # flips the EXACT Eq. (4) objective δE[xxᵀ]δᵀ prefers
    correct_inorder: int  # running-order Δ Eq.(6) < 0 (secondary diagnostic)
    by_stage: dict

    @property
    def ap(self) -> float:
        return self.correct / max(self.flipped, 1)

    @property
    def ap_exact(self) -> float:
        return self.correct_exact / max(self.flipped, 1)

    @property
    def ap_inorder(self) -> float:
        return self.correct_inorder / max(self.flipped, 1)


def approximation_precision(w2d, x_samples, bits: int, group_size: int,
                            scale=None, enable_c: bool = True) -> APReport:
    """Run SQuant on ``w2d`` (M, NK); score every flip against Eq. (6) whose
    coefficients come from real activation samples ``x_samples`` (S, NK)
    (Algorithm 3 on the measured E[xxᵀ]).

    A flip is *correct* if Eq. (6), as a function of that element's grid
    point with every other element held at the SQuant solution, prefers the
    flipped point over the rounded one (Table 6's "same optimization
    direction as the precise objective"); *correct_exact* scores it the same
    way against Eq. (4) with the measured E[xxᵀ]. The running-order Δ
    variant is a secondary diagnostic: it penalizes flips whose benefit is
    realized only after later flips rebalance the kernel/channel sums.

    The codes are ``core.squant.squant_codes``'; the flip log and the final
    δ come from the sequential recorder on the float64 rows ``w / s``, whose
    codes must be the same (ValueError otherwise)."""
    w = torch.as_tensor(w2d)
    dev = w.device
    m_sz = w.shape[0]
    g = group_size
    qmax = qmax_for_bits(bits)
    if scale is None:
        scale = max_scale(w.to(torch.float32), bits)
    scale = torch.as_tensor(scale, device=dev).reshape(m_sz, 1)
    h = second_moment(torch.as_tensor(x_samples, device=dev))
    co = decompose(h, g)
    codes, _, _ = squant_codes(w, scale, bits=bits, group_size=g,
                               enable_k=True, enable_c=enable_c)
    ws = w.to(torch.float64) / scale.to(torch.float64)
    rec_codes, rec_delta, log = _record_flips(ws.cpu().numpy(), bits, g,
                                              enable_c)
    if not np.array_equal(codes.cpu().numpy(), rec_codes):
        raise ValueError("the flip recorder's codes differ from "
                         "squant_codes' on this layer")
    delta = torch.from_numpy(rec_delta).to(dev)
    q0 = torch.clamp(torch.round(ws), -qmax, qmax)
    mu = codes.to(torch.float64) - q0              # ±1 at flipped elements

    dg = delta.reshape(m_sz, -1, g)
    e_n = dg.sum(-1)                                # (M, NG) final sums
    e_row = delta.sum(-1)                           # (M,)
    mug = mu.reshape(m_sz, -1, g)
    ecoef = co.e[None]
    kcoef = co.k[None, :, None]
    # f(final) - f(unflipped): negative → the precise objective keeps the flip
    diff = (ecoef * (dg ** 2 - (dg - mug) ** 2)
            + kcoef * (e_n[..., None] ** 2 - (e_n[..., None] - mug) ** 2)
            + co.c * (e_row[:, None, None] ** 2
                      - (e_row[:, None, None] - mug) ** 2))
    flips = mug != 0
    correct = int(torch.sum((diff <= 1e-12) & flips))

    # exact objective Eq. (4): f(δ) − f(δ − μ e_j) = 2μ(Hδ)_j − μ² H_jj
    hd = delta @ h                                  # (M, NK)
    diff_exact = 2.0 * mu * hd - (mu ** 2) * torch.diagonal(h)[None, :]
    correct_exact = int(torch.sum((diff_exact <= 1e-12) & (mu != 0)))

    # secondary: in-order Δ from the flip log
    ce, ck = co.e.cpu().numpy(), co.k.cpu().numpy()
    fin_ok = (diff <= 1e-12).cpu().numpy()
    correct_inorder = 0
    by_stage: dict = {}
    for ev in log:
        n, i = ev.flat_idx // g, ev.flat_idx % g
        s = ev.sign
        dp = (ce[n, i] * (1 - 2 * s * ev.delta_before)
              + ck[n] * (1 - 2 * s * ev.kernel_sum_before)
              + co.c * (1 - 2 * s * ev.row_sum_before))
        st = by_stage.setdefault(ev.stage, [0, 0])
        st[0] += 1
        if fin_ok[ev.m, n, i]:
            st[1] += 1
        if dp < 0:
            correct_inorder += 1
    return APReport(flipped=int(torch.sum(flips)), correct=correct,
                    correct_exact=correct_exact,
                    correct_inorder=correct_inorder,
                    by_stage={k: tuple(v) for k, v in by_stage.items()})
