"""Quantized tensor container + int4 packing + quantization-run reports.

A ``QuantizedTensor`` is a plain dataclass holding integer codes plus
dequantization scales. It is the in-memory serving format produced by every
quantizer in this package. The report dataclasses at the bottom
(``QuantReport`` and friends) are the wall-time / dispatch accounting emitted
by ``core.pipeline.quantize_tree``.

Conventions
-----------
* Codes are symmetric signed integers in ``[-qmax, qmax]`` with
  ``qmax = 2**(bits-1) - 1`` (paper's uniform symmetric grid).
* ``scale`` broadcasts against the *output-channel* (row) dimension:
  per-channel scale has shape ``(M, 1)``; per-group ``(M, G_count)`` where the
  code tensor is logically ``(M, G_count, group_size)``.
* Codes of EVERY ``bits <= 4`` width (4, 3 and 2) are stored packed
  two-per-byte in an int8 carrier (little-nibble-first).
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

import torch


def qmax_for_bits(bits: int) -> int:
    if not 2 <= bits <= 8:
        raise ValueError(f"bits must be in [2, 8], got {bits}")
    return 2 ** (bits - 1) - 1


def pack_int4(codes: torch.Tensor) -> torch.Tensor:
    """Pack int8 codes in [-8, 7] into int8 bytes, two nibbles per byte.

    Last dim must be even. Little-nibble-first: out[..., i] holds codes
    (2i) in bits 0-3 and (2i+1) in bits 4-7.
    """
    if codes.shape[-1] % 2 != 0:
        raise ValueError(f"last dim must be even, got {tuple(codes.shape)}")
    lo = codes[..., 0::2].to(torch.int32)
    hi = codes[..., 1::2].to(torch.int32)
    # (hi << 4) | (lo & 15) stays inside [-128, 127]: the cast never wraps
    return ((hi << 4) | (lo & 0x0F)).to(torch.int8)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_int4`; returns sign-extended int8 codes."""
    p = packed.to(torch.int32)
    lo = ((p & 0x0F) ^ 8) - 8          # sign-extend the low nibble
    hi = p >> 4                        # arithmetic shift sign-extends
    out = torch.stack([lo, hi], dim=-1).to(torch.int8)
    return out.reshape(*packed.shape[:-1], packed.shape[-1] * 2)


@dataclasses.dataclass
class QuantizedTensor:
    """Integer codes + scales. ``data`` is int8 (packed when bits<=4)."""

    data: torch.Tensor         # int8; (M, N) or (M, ceil(N/2)) when packed
    scale: torch.Tensor        # f32; broadcastable to (M, groups)
    bits: int = 8
    group_size: Optional[int] = None   # None → per-channel scale
    shape: tuple = ()                  # logical (unpacked) shape

    @property
    def packed(self) -> bool:
        return self.bits <= 4

    def codes(self) -> torch.Tensor:
        """Unpacked int8 codes with logical shape."""
        n = math.prod(self.shape[1:])
        if self.packed:
            flat = unpack_int4(self.data).reshape(self.shape[0], -1)
            return flat[:, :n].reshape(self.shape)
        return self.data.reshape(self.shape)

    def dequantize(self, dtype=torch.float32) -> torch.Tensor:
        c = self.codes().to(torch.float32)
        m = self.shape[0]
        rest = math.prod(self.shape[1:])
        if self.group_size is None:
            w = c.reshape(m, rest) * self.scale.reshape(m, 1)
        else:
            g = self.group_size
            ngroups = rest // g
            w = (c.reshape(m, ngroups, g)
                 * self.scale.reshape(m, ngroups, 1)).reshape(m, rest)
        return w.reshape(self.shape).to(dtype)

    def nbytes(self) -> int:
        """True serving footprint in bytes (codes + scales)."""
        return self.data.numel() + 4 * self.scale.numel()


# ---------------------------------------------------------------------------
# Quantization-run reports (filled by core.pipeline.quantize_tree)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class LayerReport:
    path: str
    shape: Tuple[int, ...]
    millis: float              # batched mode: amortized bucket dispatch time
    method: str
    bits: int
    bucket: str = ""           # bucket key this layer was quantized in


@dataclasses.dataclass
class BucketReport:
    key: str                   # "(M, N)xB dtype gG"
    num_layers: int
    dispatch_millis: float     # host time to stack + dispatch this bucket
    route: str = "stacked"     # "native": leaves read where they are stored


@dataclasses.dataclass
class ShardReport:
    """Per-device row accounting for a sharded pipeline (fields kept for the
    report format; the single-device pipeline leaves ``shards`` empty)."""
    device: int
    rows: int
    pad_rows: int


@dataclasses.dataclass
class QuantReport:
    layers: List[LayerReport]
    total_millis: float
    method: str
    bits: int
    backend: str = "ref"
    dispatch_millis: float = 0.0
    sync_millis: float = 0.0
    buckets: List[BucketReport] = dataclasses.field(default_factory=list)
    mesh_axis: str = ""
    mesh_size: int = 1
    shards: List[ShardReport] = dataclasses.field(default_factory=list)

    def summary(self) -> str:
        s = (f"{self.method} w{self.bits}: {len(self.layers)} layers in "
             f"{self.total_millis:.1f} ms "
             f"({self.total_millis / max(len(self.layers), 1):.2f} ms/layer)")
        if self.buckets:
            s += (f" [{len(self.buckets)} buckets, backend={self.backend}, "
                  f"dispatch {self.dispatch_millis:.1f} ms + "
                  f"sync {self.sync_millis:.1f} ms]")
        if self.mesh_size > 1:
            rows = sum(sh.rows for sh in self.shards)
            s += (f" [sharded {self.mesh_axis}={self.mesh_size}, "
                  f"{rows} rows]")
        return s


def from_codes(codes: torch.Tensor, scale: torch.Tensor, bits: int,
               group_size: Optional[int] = None) -> QuantizedTensor:
    """Build a QuantizedTensor from unpacked integer codes."""
    shape = tuple(codes.shape)
    m = shape[0]
    flat = codes.reshape(m, -1).to(torch.int8)
    if bits <= 4:
        if flat.shape[-1] % 2:
            flat = torch.nn.functional.pad(flat, (0, 1))
        data = pack_int4(flat)
    else:
        data = flat.contiguous()
    return QuantizedTensor(data=data, scale=scale.to(torch.float32),
                           bits=bits, group_size=group_size, shape=shape)
