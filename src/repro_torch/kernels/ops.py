"""Public wrappers over the CUDA kernels.

Dispatch rule (stated here once, for every kernel of the package):

* a tensor on the CPU   → the kernel's plain PyTorch version;
* a tensor on a CUDA device → the hand-written kernel, or an exception if
  the kernel does not take the call (it never quietly runs something else);
* ``backend="ref"`` is an explicit request for the plain version on whatever
  device the tensor lies. Tests and the on-device comparison in
  ``chip_smoke.py`` use it; nothing in the package selects it as a fallback.

``backend="auto"`` means "follow the tensor's device" and ``backend="cuda"``
insists on the kernel (a CPU tensor then raises). ``force_backend("ref")``
is the same explicit request made for a whole block of code (a model
forward, a ``quantize_tree``) instead of one call: inside it every wrapper
here takes the plain version.
"""
from __future__ import annotations

import contextlib
import math
from typing import Optional

import torch

from repro_torch.kernels import dequant_matmul as _dm
from repro_torch.kernels import squant_flip as _sf
from repro_torch.quant.qtypes import QuantizedTensor


_forced: Optional[str] = None


@contextlib.contextmanager
def force_backend(backend: str):
    """Make every wrapper in this module use ``backend`` ("ref" or "cuda")
    inside the ``with`` block, whatever the call asked for. For comparing a
    whole path through the kernels with the same path through their plain
    versions; not thread-safe."""
    global _forced
    if backend not in ("ref", "cuda"):
        raise ValueError(f"force_backend takes 'ref' or 'cuda', got {backend!r}")
    prev, _forced = _forced, backend
    try:
        yield
    finally:
        _forced = prev


def _use_kernel(t: torch.Tensor, backend: str) -> bool:
    if backend not in ("auto", "ref", "cuda"):
        raise ValueError(f"unknown backend {backend!r}")
    if _forced is not None:
        backend = _forced
    if backend == "ref":
        return False
    if backend == "cuda":
        if not t.is_cuda:
            raise ValueError("backend='cuda' needs a CUDA tensor, got one on "
                             f"{t.device}")
        return True
    return t.is_cuda


def squant_flip(w2d: torch.Tensor, scale: torch.Tensor, *, bits: int,
                group_size: int, enable_k: bool = True, enable_c: bool = True,
                backend: str = "auto") -> torch.Tensor:
    """SQuant codes for an (M, N) matrix with per-channel scales (M, 1).

    The kernel implements the standard E, E&K and E&K&C configurations; the
    E&C-without-K ablation (row-level flip) has no kernel and runs on torch
    ops on either device.
    """
    if _use_kernel(w2d, backend) and (enable_k or not enable_c):
        return _sf.squant_flip(w2d.to(torch.float32),
                               scale.to(torch.float32), bits=bits,
                               group_size=group_size, enable_k=enable_k,
                               enable_c=enable_c)
    return _sf.squant_flip_plain(w2d, scale, bits=bits, group_size=group_size,
                                 enable_k=enable_k, enable_c=enable_c)


def squant_flip_batched(w3: torch.Tensor, scale3: torch.Tensor, *, bits: int,
                        group_size: Optional[int], enable_k: bool = True,
                        enable_c: bool = True, backend: str = "auto"
                        ) -> torch.Tensor:
    """SQuant codes for a (B, M, N) stack of same-shape matrices.

    This is the model-level batched entry point: ``quantize_tree`` stacks all
    same-(shape, dtype) layers of a network into one bucket and issues ONE
    dispatch here instead of one per layer.

    SQuant is row-independent (every stage — E rounding, K group flips, C
    channel flips — operates within a single output channel), so the batch is
    flattened into rows, ``(B, M, N) → (B·M, N)``; that is exact, not an
    approximation. Two configurations have no kernel, in this package as in
    the reference, and always run on torch ops (the vectorized core) on
    whatever device the stack lies: ``group_size=None`` (the whole-row FC
    path) and the E&C-without-K ablation.
    """
    b, m, n = w3.shape
    flat, sflat = w3.reshape(b * m, n), scale3.reshape(b * m, 1)
    if group_size is not None and (enable_k or not enable_c):
        codes = squant_flip(flat, sflat, bits=bits, group_size=group_size,
                            enable_k=enable_k, enable_c=enable_c,
                            backend=backend)
    else:
        _use_kernel(w3, backend)          # validates the backend string
        codes = _sf.squant_flip_plain(flat, sflat, bits=bits,
                                      group_size=group_size,
                                      enable_k=enable_k, enable_c=enable_c)
    return codes.reshape(b, m, n)


def dequant_matmul(x: torch.Tensor, qt: QuantizedTensor, *,
                   group_size: int = 128, backend: str = "auto"
                   ) -> torch.Tensor:
    """y = x @ dequant(qt).T for a (out, in)-major QuantizedTensor.

    One K-tile is one group: ``gs = group_size if N % group_size == 0 else N``.
    """
    m = qt.shape[0]
    n = math.prod(qt.shape[1:])
    scale = qt.scale.reshape(m, -1)
    gs = group_size if n % group_size == 0 else n
    if _use_kernel(x, backend):
        return _dm.dequant_matmul(x, qt.data, scale, bits=qt.bits,
                                  group_size=gs)
    return _dm.dequant_matmul_plain(x, qt.data, scale, bits=qt.bits,
                                    group_size=gs)
