"""SQuant flip kernel (E → K → C fused): wrapper, launch counter, plain version.

The CUDA source is ``csrc/squant_flip.cu`` — one thread block per output
channel, warp top-k, int8 codes out; see the note at its head. The plain
PyTorch version of the same function is ``core.squant.squant_codes``.

Dispatch rule: a CPU tensor takes the plain version; a CUDA tensor launches
the kernel or raises. There is no fallback from the kernel to the plain
version.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

MAX_GROUP = 128          # elements per group the kernel holds in one warp
MAX_GROUPS = 3072        # group summaries that fit the kernel's shared memory

launches = 0             # number of kernel launches (plain integer)


def squant_flip_plain(w2d: torch.Tensor, scale: torch.Tensor, *, bits: int,
                      group_size: int, enable_k: bool = True,
                      enable_c: bool = True) -> torch.Tensor:
    """Plain PyTorch version: the vectorized core. Returns int8 codes."""
    from repro_torch.core.squant import squant_codes
    codes, _, _ = squant_codes(w2d, scale, bits=bits, group_size=group_size,
                               enable_k=enable_k, enable_c=enable_c)
    return codes


_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load("squant_flip").squant_flip_launch
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p]
        _fn = fn
    return _fn


def squant_flip(w2d: torch.Tensor, scale: torch.Tensor, *, bits: int,
                group_size: int, enable_k: bool = True,
                enable_c: bool = True) -> torch.Tensor:
    """SQuant codes (int8, (M, N)) for an (M, N) float32 matrix with one
    scale per row. Supports E, E&K and E&K&C with ``group_size <= 128``."""
    if not w2d.is_cuda:
        return squant_flip_plain(w2d, scale, bits=bits, group_size=group_size,
                                 enable_k=enable_k, enable_c=enable_c)
    if not 2 <= bits <= 8:
        raise ValueError(f"bits must be in [2, 8], got {bits}")
    if enable_c and not enable_k:
        raise ValueError("the kernel implements E, E&K and E&K&C; the "
                         "E&C-without-K ablation is a plain-version path")
    if w2d.ndim != 2 or w2d.dtype != torch.float32:
        raise ValueError("w2d must be a 2-D float32 tensor, got "
                         f"{tuple(w2d.shape)} {w2d.dtype}")
    m, n = w2d.shape
    if scale.device != w2d.device or scale.dtype != torch.float32 \
            or scale.numel() != m:
        raise ValueError("scale must be float32, one value per row, on the "
                         "same device as w2d")
    if not 1 <= group_size <= MAX_GROUP:
        raise ValueError(f"group_size must be in [1, {MAX_GROUP}] for the "
                         f"kernel, got {group_size}")
    ng = -(-n // group_size)
    if ng > MAX_GROUPS:
        raise ValueError(f"{ng} groups per row exceed the {MAX_GROUPS} the "
                         "kernel keeps in shared memory")
    w2d = w2d.contiguous()
    scale = scale.contiguous()
    out = torch.empty((m, n), dtype=torch.int8, device=w2d.device)
    if m == 0 or n == 0:
        return out
    global launches
    with _build.on_device(w2d.device):
        err = _kernel()(w2d.data_ptr(), scale.data_ptr(), out.data_ptr(),
                        m, n, group_size, bits, int(enable_k), int(enable_c),
                        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"squant_flip kernel launch failed (cuda error {err})")
    launches += 1
    return out
