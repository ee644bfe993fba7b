"""Plain PyTorch versions of the CUDA kernels, gathered under the names the
reference package uses.

``squant_ref`` delegates to the vectorized core (itself held bit-exact
against the sequential NumPy transcription of Algorithms 1-4 by the tests),
so the chain of evidence is
  CUDA kernel == vectorized torch core == sequential NumPy pseudocode.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.dequant_matmul import (  # noqa: F401
    dequant_matmul_plain as dequant_matmul_ref)
from repro_torch.kernels.squant_flip import (  # noqa: F401
    squant_flip_plain as squant_ref)


def explain_code_differences(w2d, scale, codes, ref_codes, *, bits: int,
                             group_size: int, enable_k: bool = True,
                             enable_c: bool = True, tol: float = 1e-4):
    """Judge rows where two SQuant implementations disagree.

    ``round(|Σδ|)`` decides how many elements flip, and a float32 sum taken
    in another order can land on the other side of ``k + 0.5``; two eligible
    elements of equal |δ| can swap places. A differing row is *explained*
    when the plain version's own sums show such a tie (a pre-K group sum or
    the post-K row sum within ``tol`` of a half-integer, or two equal nonzero
    |δ| inside one group) AND ``codes`` still satisfies the paper's
    invariants on that row (|δ| < 1, group |Σδ| ≤ 1 (0.5 without C), row
    |Σδ| ≤ 0.5, each ``+ tol``). The invariants assume a scale without
    clipping (``compute_scale``).

    Returns ``{"rows": M, "rows_differing": d, "unexplained": u}``.
    """
    from repro_torch.core.squant import _as_groups, squant_codes

    bad = (codes != ref_codes).any(dim=1).nonzero()[:, 0]
    out = {"rows": int(codes.shape[0]), "rows_differing": int(bad.numel()),
           "unexplained": 0}
    if bad.numel() == 0:
        return out
    w = w2d[bad].to(torch.float32)
    s = scale.reshape(-1, 1)[bad].to(torch.float32)
    r, n = w.shape
    t = w / s
    d0 = torch.clamp(torch.round(t), -(2 ** (bits - 1) - 1),
                     2 ** (bits - 1) - 1) - t
    dg, _ = _as_groups(d0.double(), group_size)

    def near_half(x):
        frac = x.abs() - x.abs().floor()
        return (frac - 0.5).abs() < tol

    tie = torch.zeros(r, dtype=torch.bool, device=w.device)
    if enable_k:
        tie |= near_half(dg.sum(-1)).any(-1)
        a = dg.abs().sort(dim=-1).values
        tie |= ((a[..., 1:] == a[..., :-1]) & (a[..., 1:] > 0)).any(-1).any(-1)
    if enable_c:
        _, dk, _ = squant_codes(w, s, bits=bits, group_size=group_size,
                                enable_k=enable_k, enable_c=False)
        tie |= near_half(dk.double().sum(-1))
    delta = codes[bad].double() - t.double()
    ok = delta.abs().amax(-1) < 1.0 + tol
    if enable_k:
        gsum = _as_groups(delta, group_size)[0].sum(-1).abs().amax(-1)
        ok &= gsum <= (1.0 if enable_c else 0.5) + tol
    if enable_c:
        ok &= delta.sum(-1).abs() <= 0.5 + tol
    out["unexplained"] = int((~(tie & ok)).sum())
    return out
