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

Sharded dispatch (``quantize_codes_sharded``): SQuant's flip objective is
row-independent, so a bucket's ``B·M`` rows are split into contiguous equal
slabs over a mesh axis (``shard_rows``), each rank quantizes its own slab
with the helpers above, and the slabs are gathered — bit-identical to the
one-device path by construction.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

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
                          scale_method: str = "max", backend: str = "ref",
                          cols: Optional[Tuple[int, int]] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantize one bucket of B same-shape ``(in, out)`` leaves where they
    are stored (output channel ``c`` is the column ``leaf[:, c]``).

    Returns ``(codes int8 (B, out, in), scales (B, out, 1))``, the same
    values ``quantize_codes_batched`` gives for the stack of ``leaf.T``. The
    ``"max"`` scales come from one pass over the leaves; other scale methods
    keep ``compute_scale`` on the transposed stack. ``method`` is one the
    flip kernel implements (``squant``, ``squant_e``, ``squant_ek``).
    ``cols=(c0, n)`` quantizes output channels ``c0 .. c0 + n - 1`` only,
    read in place (codes (B, n, in)).
    """
    b = len(leaves)
    if scale_method == "max":
        scales = ops.squant_scales(leaves, bits, backend=backend, cols=cols)
    else:
        c0, n = (0, leaves[0].shape[1]) if cols is None else cols
        scales = compute_scale(torch.stack([leaf[:, c0:c0 + n].T
                                            for leaf in leaves]),
                               bits, scale_method).reshape(b, -1)
    enable_k, enable_c = _METHOD_FLAGS[method]
    codes = ops.squant_flip_leaves(leaves, scales, bits=bits,
                                   group_size=group_size, enable_k=enable_k,
                                   enable_c=enable_c, backend=backend,
                                   cols=cols)
    return codes, scales.reshape(b, -1, 1)


# ---------------------------------------------------------------------------
# Sharded bucket dispatch (multi-rank row partitioning)
# ---------------------------------------------------------------------------
# Every rank holds the whole bucket (the tree is replicated: each rank built
# or restored it); rank d of the mesh axis quantizes rows [d*per, (d+1)*per)
# of the flattened B*M rows, the tail ranks' pad rows are never made, and
# one all-gather over the axis gives every rank the whole codes and scales.

def shard_rows(total_rows: int, ndev: int):
    """Per-device (rows, pad_rows) for one sharded dispatch — the partition
    scheme ``quantize_codes_sharded`` implements (contiguous equal slabs,
    zero rows padding the tail devices)."""
    pad = (-total_rows) % ndev
    per = (total_rows + pad) // ndev
    out = []
    for d in range(ndev):
        real = max(0, min(per, total_rows - d * per))
        out.append((real, per - real))
    return out


def slab_pieces(row0: int, row1: int, m: int
                ) -> List[Tuple[int, int, int, int]]:
    """Rows ``[row0, row1)`` of B leaves of ``m`` rows each, flattened
    leaf-major, as pieces ``(b0, b1, c0, n)``: rows ``c0 .. c0 + n - 1`` of
    leaves ``b0 .. b1 - 1``. A whole run of leaves is one piece; a slab that
    starts or ends inside a leaf adds a piece for that leaf's part — at most
    three pieces a slab."""
    pieces, r = [], row0
    while r < row1:
        b, c = divmod(r, m)
        if c == 0 and row1 - r >= m:
            nb = (row1 - r) // m
            pieces.append((b, b + nb, 0, m))
            r += nb * m
        else:
            n = min(m - c, row1 - r)
            pieces.append((b, b + 1, c, n))
            r += n
    return pieces


def quantize_codes_sharded(ws, *, method: str, bits: int,
                           group_size: Optional[int],
                           scale_method: str = "max", backend: str = "ref",
                           mesh, mesh_axis: str = "data"
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantize one bucket with its rows partitioned over ``mesh_axis`` of
    ``mesh`` (a ``DeviceMesh``); every rank of the axis must call it.

    ``ws`` is the bucket in either form: a ``(B, M, N)`` stack (the stacked
    route; a rank's slab is a row range of it), or a list of B ``(in, out)``
    leaves (the native route; a rank's slab is a column range of one or
    more stored leaves, read in place by ``quantize_codes_native``'s
    kernels with a first column and a column count beside the leaves'
    unchanged row stride). The rows are split by :func:`shard_rows`; the
    slabs (padded to equal height with zero rows) are all-gathered over the
    axis. Returns the whole ``(codes int8 (B, M, N), scales (B, M, 1))`` on
    every rank, bit-identical to the one-device helpers.
    """
    from repro_torch.distributed import group as dgroup
    from repro_torch.distributed.sharding import mesh_axis_sizes
    sizes = mesh_axis_sizes(mesh)
    if mesh_axis not in sizes:
        raise ValueError(f"mesh has no {mesh_axis!r} axis; axes: "
                         f"{tuple(sizes)}")
    if mesh.get_coordinate() is None:
        raise ValueError("this rank is not in the mesh")
    ndev = int(sizes[mesh_axis])
    d = mesh.get_local_rank(mesh_axis)
    native = isinstance(ws, (list, tuple))
    if native:
        b, (n, m) = len(ws), ws[0].shape          # leaves are (in, out)
        dev = ws[0].device
    else:
        b, m, n = ws.shape
        dev = ws.device
    rows = b * m
    slabs = shard_rows(rows, ndev)
    per = sum(slabs[0])
    r0 = min(d * per, rows)
    r1 = r0 + slabs[d][0]
    codes: List[torch.Tensor] = []
    scales: List[torch.Tensor] = []
    if r1 > r0:
        if native:        # one scale and one flip launch a piece
            for b0, b1, c0, cn in slab_pieces(r0, r1, m):
                cd, sc = quantize_codes_native(
                    list(ws[b0:b1]), method=method, bits=bits,
                    group_size=group_size, scale_method=scale_method,
                    backend=backend, cols=(c0, cn))
                codes.append(cd.reshape(-1, n))
                scales.append(sc.reshape(-1, 1))
        else:
            cd, sc = quantize_codes_batched(
                ws.reshape(rows, n)[r0:r1][None], method=method, bits=bits,
                group_size=group_size, scale_method=scale_method,
                backend=backend)
            codes, scales = [cd[0]], [sc[0]]
    # float32 on the wire, as every rank's slab must be (a tail rank may
    # hold pad rows only); from_codes keeps scales in float32 regardless
    scales = [sc.to(torch.float32) for sc in scales]
    if slabs[d][1]:
        codes.append(torch.zeros((slabs[d][1], n), dtype=torch.int8,
                                 device=dev))
        scales.append(torch.zeros((slabs[d][1], 1), dtype=torch.float32,
                                  device=dev))
    slab_c = codes[0] if len(codes) == 1 else torch.cat(codes)
    slab_s = scales[0] if len(scales) == 1 else torch.cat(scales)
    axis_group = mesh.get_group(mesh_axis)
    all_c = torch.empty((ndev * per, n), dtype=torch.int8, device=dev)
    all_s = torch.empty((ndev * per, 1), dtype=torch.float32, device=dev)
    dgroup.all_gather_into(all_c, slab_c, axis_group)
    dgroup.all_gather_into(all_s, slab_s, axis_group)
    return (all_c[:rows].reshape(b, m, n), all_s[:rows].reshape(b, m, 1))
