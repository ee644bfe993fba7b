"""SQuant flip kernel (E → K → C fused) and the per-channel max scale:
wrappers, launch counters, plain versions.

The CUDA source is ``csrc/squant_flip.cu`` — a producer warp streams slabs
of 32 output channels through a shared-memory ring by cp.async, eight
consumer warps run the E/K/C chain on four channels each, int8 codes out;
see the note at its head. The plain PyTorch version of the same function is
``core.squant.squant_codes``.

Two entry points share the one kernel body:

* :func:`squant_flip_leaves` — B same-shape leaves as they are stored,
  ``(in, out)`` with output channel ``c`` the column ``leaf[:, c]``; codes
  come out ``(B, out, in)``. One launch per bucket: the leaves' pointers go
  to the kernel in a table (up to ``MAX_LEAVES`` a launch). The route
  (:func:`route`) is ``"cp16"`` — rows copied 16 bytes at a time — where
  every leaf's rows are 16-byte aligned (``out % 4 == 0``), else ``"cp4"``.
  ``cols=(c0, n)`` reads only output channels ``c0 .. c0 + n - 1`` of every
  leaf (codes ``(B, n, in)``): the pointers move to column ``c0``, the
  leaves' row stride stays ``out``, and the kernel's arithmetic is
  unchanged — how a rank's row slab of a sharded bucket, which may start
  and end inside a leaf, is read where it is stored.
* :func:`squant_flip` — one row-major ``(M, N)`` matrix (any strides),
  codes ``(M, N)``; always the ``"cp4"`` route.

:func:`squant_scales` is the scale pass over the same leaves:
``clamp_min(max_k |w[k, c]|, 1e-12) * fl32(1/qmax)``, bit-identical to
``core.dispatch._scales`` on the transposed stack.

Dispatch rule: a CPU tensor takes the plain version; a CUDA tensor launches
the kernel or raises. There is no fallback from the kernel to the plain
version, and no quiet copy: a leaf that is not float32 and contiguous is
refused.
"""
from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.quant.qtypes import qmax_for_bits
from repro_torch.quant.scales import _EPS

MAX_GROUP = 128          # elements per group (the rows of one ring stage)
MAX_LEAVES = 384         # leaf pointers in one launch's table (the .cu's)
ROUTES = ("cp16", "cp4")

launches = 0             # flip-kernel launches (plain integer)
launches_by_route = dict.fromkeys(ROUTES, 0)
scale_launches = 0       # scale-pass launches


def route(out_channels: int, aligned: bool) -> str:
    """The instance that takes (in, out) leaves: rows of ``out`` floats are
    copied 16 bytes at a time when they are 16-byte aligned — ``out % 4 ==
    0`` and every leaf's base on a 16-byte boundary — else 4 bytes."""
    return "cp16" if out_channels % 4 == 0 and aligned else "cp4"


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def squant_flip_plain(w2d: torch.Tensor, scale: torch.Tensor, *, bits: int,
                      group_size: int, enable_k: bool = True,
                      enable_c: bool = True) -> torch.Tensor:
    """Plain PyTorch version: the vectorized core. Returns int8 codes."""
    from repro_torch.core.squant import squant_codes
    codes, _, _ = squant_codes(w2d, scale, bits=bits, group_size=group_size,
                               enable_k=enable_k, enable_c=enable_c)
    return codes


def _col_range(leaves, cols):
    """``leaves`` cut to the output channels ``cols = (c0, n)`` (views)."""
    if cols is None:
        return list(leaves)
    c0, n = cols
    return [leaf[:, c0:c0 + n] for leaf in leaves]


def squant_flip_leaves_plain(leaves: Sequence[torch.Tensor],
                             scale: torch.Tensor, *, bits: int,
                             group_size: int, enable_k: bool = True,
                             enable_c: bool = True, cols=None
                             ) -> torch.Tensor:
    """Plain version of :func:`squant_flip_leaves`: the transposed stack
    through the vectorized core. Returns int8 codes (B, out, in)."""
    w = torch.stack([leaf.T for leaf in _col_range(leaves, cols)])
    b, m, n = w.shape
    codes = squant_flip_plain(w.reshape(b * m, n), scale.reshape(b * m, 1),
                              bits=bits, group_size=group_size,
                              enable_k=enable_k, enable_c=enable_c)
    return codes.reshape(b, m, n)


def squant_scales_plain(leaves: Sequence[torch.Tensor], bits: int,
                        cols=None) -> torch.Tensor:
    """Plain version of :func:`squant_scales`: (B, out) float32."""
    absmax = torch.stack([leaf.abs().amax(dim=0)
                          for leaf in _col_range(leaves, cols)])
    return torch.clamp_min(absmax, _EPS) * (1.0 / qmax_for_bits(bits))


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------

_fns = {}


def _lib():
    if not _fns:
        lib = _build.load("squant_flip")
        f = lib.squant_flip_launch
        f.restype = ctypes.c_int
        f.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                      ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                      ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                      ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                      ctypes.c_int, ctypes.c_void_p]
        s = lib.squant_scale_launch
        s.restype = ctypes.c_int
        s.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                      ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                      ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
        b = lib.squant_flip_scratch_bytes
        b.restype = ctypes.c_longlong
        b.argtypes = [ctypes.c_int] * 4
        _fns.update(flip=f, scale=s, scratch=b)
    return _fns


def _check_flags(bits, group_size, enable_k, enable_c):
    if not 2 <= bits <= 8:
        raise ValueError(f"bits must be in [2, 8], got {bits}")
    if enable_c and not enable_k:
        raise ValueError("the kernel implements E, E&K and E&K&C; the "
                         "E&C-without-K ablation is a plain-version path")
    if group_size is None or not 1 <= group_size <= MAX_GROUP:
        raise ValueError(f"group_size must be in [1, {MAX_GROUP}] for the "
                         f"kernel, got {group_size}")


def _check_leaves(leaves) -> List[torch.Tensor]:
    leaves = list(leaves)
    if not leaves:
        raise ValueError("no leaves")
    shape, dev = leaves[0].shape, leaves[0].device
    for leaf in leaves:
        if leaf.ndim != 2 or leaf.dtype != torch.float32 \
                or not leaf.is_contiguous() or leaf.shape != shape \
                or leaf.device != dev:
            raise ValueError(
                "the kernel takes same-shape, contiguous, 2-D float32 "
                f"(in, out) leaves on one device; got {tuple(leaf.shape)} "
                f"{leaf.dtype} on {leaf.device}"
                f"{'' if leaf.is_contiguous() else ' (not contiguous)'} "
                f"beside {tuple(shape)} on {dev} (refused, not copied)")
    return leaves


def _cols(leaves, cols) -> Tuple[int, int, int]:
    """``(c0, n, ld)``: the first channel, the channel count and the
    leaves' row stride of a launch over ``cols`` (default: every channel)."""
    ld = leaves[0].shape[1]
    c0, n = (0, ld) if cols is None else (int(cols[0]), int(cols[1]))
    if not (0 <= c0 and 0 <= n and c0 + n <= ld):
        raise ValueError(f"columns {c0}..{c0 + n} outside the leaves' {ld}")
    return c0, n, ld


def _stream():
    return torch.cuda.current_stream().cuda_stream


def _flip(ptrs, scale, out, sc, sk, nch, kin, group_size, bits, enable_k,
          enable_c, v16, dev):
    """Launch over ``ptrs`` in tables of MAX_LEAVES; returns the launches."""
    global launches
    fns = _lib()
    n = 0
    with _build.on_device(dev):
        for b0 in range(0, len(ptrs), MAX_LEAVES):
            part = ptrs[b0:b0 + MAX_LEAVES]
            sbytes = fns["scratch"](len(part), nch, kin, group_size)
            scratch = torch.empty(sbytes, dtype=torch.uint8, device=dev) \
                if sbytes else None
            table = (ctypes.c_void_p * len(part))(*part)
            err = fns["flip"](
                table, len(part), scale.data_ptr() + b0 * nch * 4,
                out.data_ptr() + b0 * nch * kin,
                scratch.data_ptr() if scratch is not None else None,
                sc, sk, nch, kin, group_size, bits, int(enable_k),
                int(enable_c), int(v16), _stream())
            if err != 0:
                raise RuntimeError(f"squant_flip kernel launch failed (cuda "
                                   f"error {err})")
            n += 1
    launches += n
    launches_by_route["cp16" if v16 else "cp4"] += n
    return n


def squant_flip_leaves(leaves: Sequence[torch.Tensor], scale: torch.Tensor,
                       *, bits: int, group_size: int, enable_k: bool = True,
                       enable_c: bool = True, cols=None) -> torch.Tensor:
    """SQuant codes (int8, (B, out, in)) of B same-shape float32 ``(in,
    out)`` leaves, read where they are stored, with scales (B, out[, 1]).
    Supports E, E&K and E&K&C with ``group_size <= 128``. ``cols=(c0, n)``
    quantizes output channels ``c0 .. c0 + n - 1`` only (codes (B, n, in),
    scales (B, n[, 1]))."""
    leaves = list(leaves)
    if not leaves or not leaves[0].is_cuda:
        return squant_flip_leaves_plain(leaves, scale, bits=bits,
                                        group_size=group_size,
                                        enable_k=enable_k, enable_c=enable_c,
                                        cols=cols)
    _check_flags(bits, group_size, enable_k, enable_c)
    leaves = _check_leaves(leaves)
    kin = leaves[0].shape[0]
    c0, nch, ld = _cols(leaves, cols)
    b, dev = len(leaves), leaves[0].device
    if scale.device != dev or scale.dtype != torch.float32 \
            or scale.numel() != b * nch or not scale.is_contiguous():
        raise ValueError("scale must be contiguous float32, one value per "
                         "leaf and output channel, on the leaves' device")
    out = torch.empty((b, nch, kin), dtype=torch.int8, device=dev)
    if kin == 0 or nch == 0:
        return out
    ptrs = [leaf.data_ptr() + 4 * c0 for leaf in leaves]
    v16 = route(nch, ld % 4 == 0 and all(p % 16 == 0 for p in ptrs)) \
        == "cp16"
    _flip(ptrs, scale, out, 1, ld, nch, kin, group_size, bits, enable_k,
          enable_c, v16, dev)
    return out


def squant_flip(w2d: torch.Tensor, scale: torch.Tensor, *, bits: int,
                group_size: int, enable_k: bool = True,
                enable_c: bool = True) -> torch.Tensor:
    """SQuant codes (int8, (M, N)) for an (M, N) float32 matrix with one
    scale per row. Supports E, E&K and E&K&C with ``group_size <= 128``.
    The matrix is read through its strides, so a transposed view is not
    copied."""
    if not w2d.is_cuda:
        return squant_flip_plain(w2d, scale, bits=bits, group_size=group_size,
                                 enable_k=enable_k, enable_c=enable_c)
    _check_flags(bits, group_size, enable_k, enable_c)
    if w2d.ndim != 2 or w2d.dtype != torch.float32:
        raise ValueError("w2d must be a 2-D float32 tensor, got "
                         f"{tuple(w2d.shape)} {w2d.dtype}")
    m, n = w2d.shape
    if scale.device != w2d.device or scale.dtype != torch.float32 \
            or scale.numel() != m:
        raise ValueError("scale must be float32, one value per row, on the "
                         "same device as w2d")
    out = torch.empty((m, n), dtype=torch.int8, device=w2d.device)
    if m == 0 or n == 0:
        return out
    _flip([w2d.data_ptr()], scale.contiguous(), out, w2d.stride(0),
          w2d.stride(1), m, n, group_size, bits, enable_k, enable_c, False,
          w2d.device)
    return out


def squant_scales(leaves: Sequence[torch.Tensor], bits: int, cols=None
                  ) -> torch.Tensor:
    """Per-channel max scales (B, out) float32 of B same-shape float32
    ``(in, out)`` leaves, one pass over them; ``cols=(c0, n)``: channels
    ``c0 .. c0 + n - 1`` only, (B, n)."""
    global scale_launches
    leaves = list(leaves)
    if not leaves or not leaves[0].is_cuda:
        return squant_scales_plain(leaves, bits, cols)
    leaves = _check_leaves(leaves)
    kin = leaves[0].shape[0]
    c0, nch, ld = _cols(leaves, cols)
    dev = leaves[0].device
    out = torch.empty((len(leaves), nch), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    fn = _lib()["scale"]
    ptrs = [leaf.data_ptr() + 4 * c0 for leaf in leaves]
    with _build.on_device(dev):
        for b0 in range(0, len(ptrs), MAX_LEAVES):
            part = ptrs[b0:b0 + MAX_LEAVES]
            err = fn((ctypes.c_void_p * len(part))(*part), len(part),
                     out.data_ptr() + b0 * nch * 4, nch, kin, ld,
                     1.0 / qmax_for_bits(bits), _EPS, _stream())
            if err != 0:
                raise RuntimeError(f"squant_scale kernel launch failed (cuda "
                                   f"error {err})")
            scale_launches += 1
    return out
