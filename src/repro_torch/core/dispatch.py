"""Backend dispatch for the batched quantization pipeline.

``quantize_tree`` groups same-(shape, dtype) leaves into buckets; this module
turns one bucket into int8 codes + per-row scales with a fixed, small number
of asynchronous dispatches — no host sync. A bucket comes in one of two
forms (``core.pipeline.plan_buckets`` decides which):

* native — the list of B ``(in, out)`` leaves as they are stored
  (``quantize_codes_native``): one scale pass and one flip launch over them,
  nothing copied;
* stacked — a ``(B, M, N)`` stack of ``(out, in)``-major views
  (``quantize_codes_batched``).

The ``backend`` string is threaded down to ``kernels/ops``:

* ``"ref"``   — the vectorized torch core (``core.squant.squant_codes``) on
                whatever device the bucket lies; an explicit request.
* ``"cuda"``  — the fused CUDA kernel, one launch per bucket (the batch is
                flattened into rows — SQuant is row-independent, so
                ``(B, M, N) → (B*M, N)`` is exact, not approximate).
* ``"auto"``  — follows the bucket's device: CUDA tensor → the kernel, CPU
                tensor → the torch core. Never the torch core on a CUDA tensor.

Scales follow ONE formula regardless of backend and form (``_scales``; on
the native form the scale pass computes the same bits), so flip decisions
(which compare ``w/s`` against the integer grid) are bitwise comparable
across backends. RTN has no custom kernel (it is a pure
elementwise round); it runs on torch ops regardless of backend.

The serial per-layer path in ``core.pipeline`` calls these same helpers with
``B=1``, which makes batched-vs-serial bit-exactness hold by construction.
Row-sharded dispatch over several devices is not part of this module yet.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from repro_torch.kernels import ops
from repro_torch.quant.qtypes import qmax_for_bits
from repro_torch.quant.scales import _EPS, compute_scale

BACKENDS = ("auto", "ref", "cuda")

_METHOD_FLAGS = {
    "squant":    (True, True),
    "squant_e":  (False, False),
    "squant_ek": (True, False),
    "squant_ec": (False, True),
}


def resolve_backend(backend: str, device=None) -> str:
    """Validate and resolve ``"auto"`` against the device the work lies on."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; options {BACKENDS}")
    if backend == "auto" and device is not None:
        return "cuda" if torch.device(device).type == "cuda" else "ref"
    return backend


def _scales(ws: torch.Tensor, bits: int, scale_method: str) -> torch.Tensor:
    """The single scale source for all backends. (B, M, N) → (B, M, 1).

    For ``"max"`` the bucket scale is ``absmax * fl32(1/qmax)``, not
    ``absmax / qmax``: the reference pipeline computes its bucket scales
    under ``jit``, where the division by the constant becomes a
    multiplication by its float32 reciprocal — one ulp away from the eager
    ``quant.scales.max_scale`` on most rows. Matching it keeps codes and
    scales of a whole tree bit-comparable with the reference pipeline.
    """
    if scale_method == "max":
        absmax = ws.abs().amax(dim=-1, keepdim=True)
        return torch.clamp_min(absmax, _EPS) * (1.0 / qmax_for_bits(bits))
    return compute_scale(ws, bits, scale_method)


def _rtn(ws: torch.Tensor, scales: torch.Tensor, bits: int) -> torch.Tensor:
    qmax = qmax_for_bits(bits)
    return torch.clamp(torch.round(ws / scales), -qmax, qmax).to(torch.int8)


def quantize_codes_batched(ws: torch.Tensor, *, method: str, bits: int,
                           group_size: Optional[int], scale_method: str = "max",
                           backend: str = "ref"
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantize one stacked bucket.

    Args:
      ws: (B, M, N) stack of same-shape row-major weight matrices.
      group_size: effective kernel/group size for this bucket (None → whole
        row, the paper's FC path), already clamped by the caller.

    Returns ``(codes int8 (B, M, N), scales (B, M, 1))``. Everything is
    dispatched asynchronously; the caller owns the single end-of-pipeline
    sync.
    """
    scales = _scales(ws, bits, scale_method)
    if method == "rtn":
        codes = _rtn(ws, scales, bits)
    else:
        enable_k, enable_c = _METHOD_FLAGS[method]
        codes = ops.squant_flip_batched(
            ws, scales, bits=bits, group_size=group_size,
            enable_k=enable_k, enable_c=enable_c, backend=backend)
    return codes, scales


def quantize_codes_native(leaves: Sequence[torch.Tensor], *, method: str,
                          bits: int, group_size: int,
                          scale_method: str = "max", backend: str = "ref"
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantize one bucket of B same-shape ``(in, out)`` leaves where they
    are stored (output channel ``c`` is the column ``leaf[:, c]``).

    Returns ``(codes int8 (B, out, in), scales (B, out, 1))``, the same
    values ``quantize_codes_batched`` gives for the stack of ``leaf.T``. The
    ``"max"`` scales come from one pass over the leaves; other scale methods
    keep ``compute_scale`` on the transposed stack. ``method`` is one the
    flip kernel implements (``squant``, ``squant_e``, ``squant_ek``).
    """
    b = len(leaves)
    if scale_method == "max":
        scales = ops.squant_scales(leaves, bits, backend=backend)
    else:
        scales = compute_scale(torch.stack([leaf.T for leaf in leaves]),
                               bits, scale_method).reshape(b, -1)
    enable_k, enable_c = _METHOD_FLAGS[method]
    codes = ops.squant_flip_leaves(leaves, scales, bits=bits,
                                   group_size=group_size, enable_k=enable_k,
                                   enable_c=enable_c, backend=backend)
    return codes, scales.reshape(b, -1, 1)
