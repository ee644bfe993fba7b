"""Quantized-weight matmul ``y = x @ dequant(Wq).T``: wrapper, launch counter,
plain version.

The CUDA source is ``csrc/dequant_matmul.cu`` — a weight-streaming variant
for small batches and a shared-memory tiled variant for large ones; see the
note at its head. ``Wq`` holds int8 codes ``(M, N)``, or (every ``bits <= 4``)
nibbles packed two-per-byte ``(M, N/2)``, low nibble = even column, with
``(M, 1)`` per-channel or ``(M, N/G)`` per-group float32 scales.

Dispatch rule: a CPU tensor takes the plain version; a CUDA tensor launches
the kernel or raises. There is no fallback from the kernel to the plain
version.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.quant.qtypes import unpack_int4

GEMV_MAX_BATCH = 16      # up to here the weight-streaming variant runs

launches = 0             # number of kernel launches (plain integer)


def dequant_matmul_plain(x: torch.Tensor, codes: torch.Tensor,
                         scale: torch.Tensor, *, bits: int,
                         group_size: int = 128) -> torch.Tensor:
    """Plain PyTorch version: dequantize, then one float32 matmul."""
    m = codes.shape[0]
    c = unpack_int4(codes) if bits <= 4 else codes
    c = c.to(torch.float32)
    n = c.shape[1]
    ng = n // group_size
    s = scale.to(torch.float32).reshape(m, -1).expand(m, ng)
    w = (c.reshape(m, ng, group_size) * s[..., None]).reshape(m, n)
    return (x.to(torch.float32) @ w.T).to(x.dtype)


_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load("dequant_matmul").dequant_matmul_launch
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p]
        _fn = fn
    return _fn


def dequant_matmul(x: torch.Tensor, codes: torch.Tensor, scale: torch.Tensor,
                   *, bits: int, group_size: int = 128) -> torch.Tensor:
    """y[B, M] = x[B, N] @ (codes[M, N] * scale).T, float32 accumulation,
    output in ``x.dtype`` (float32 or bfloat16)."""
    b, n = x.shape
    packed = bits <= 4
    m = codes.shape[0]
    n_codes = codes.shape[1] * (2 if packed else 1)
    if n_codes != n:
        raise ValueError(f"x has N={n} but codes unpack to {n_codes}")
    if n % group_size != 0:
        raise ValueError(f"N={n} not divisible by group_size={group_size}")
    ng = n // group_size
    scale = scale.reshape(m, -1)
    if scale.shape[1] not in (1, ng):
        raise ValueError(f"scale has {scale.shape[1]} columns; expected 1 or "
                         f"{ng}")
    if not x.is_cuda:
        return dequant_matmul_plain(x, codes, scale, bits=bits,
                                    group_size=group_size)
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"x must be float32 or bfloat16, got {x.dtype}")
    if codes.dtype != torch.int8 or scale.dtype != torch.float32:
        raise ValueError("codes must be int8 and scale float32")
    if codes.device != x.device or scale.device != x.device:
        raise ValueError("x, codes and scale must be on the same device")
    # is_contiguous() is a cheap check; contiguous() is a dispatched op
    if not x.is_contiguous():
        x = x.contiguous()
    if not codes.is_contiguous():
        codes = codes.contiguous()
    if not scale.is_contiguous():
        scale = scale.contiguous()
    out = torch.empty((b, m), dtype=x.dtype, device=x.device)
    if b == 0 or m == 0:
        return out
    global launches
    with _build.on_device(x.device):
        err = _kernel()(x.data_ptr(), codes.data_ptr(), scale.data_ptr(),
                        out.data_ptr(), b, m, n, scale.shape[1], group_size,
                        int(packed), int(x.dtype == torch.bfloat16),
                        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError("dequant_matmul kernel launch failed "
                           f"(cuda error {err})")
    launches += 1
    return out
