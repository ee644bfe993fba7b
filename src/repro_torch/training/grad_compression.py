"""Cross-pod gradient compression: int8 ring all-reduce with error feedback.

Why: at multi-pod scale the pod-to-pod links are the thin resource. A plain
DP all-reduce ships float32 (or bf16) gradients across pods every step.
Here the cross-pod leg is a ring all-reduce (reduce-scatter + all-gather,
one ``send``/``recv`` hop a step: ``distributed.group.ring_hop``) whose wire
payload is **int8 codes + one float32 scale per block** — ≈4× fewer
cross-pod bytes — while the in-pod reduction stays in float32. The
quantization residual is carried in an error-feedback buffer (added back
before the next step's compression), which keeps SGD convergence intact
(Karimireddy et al., 2019).

Arithmetic, as the reference computes it (its ring and its train step run
under ``jit``): a block's scale is ``max(amax, 1e-20) * fl32(1/127)`` —
XLA turns the division by the constant 127 into that multiplication — and
its codes ``round(x / scale)``, a true division by the tensor, rounded half
to even (``torch.round``, as ``jnp.round``). XLA also contracts ``a ± codes
* scale`` (the ring's accumulate, the error feedback's residual) into one
fused multiply-add, rounded once: ``_fma`` computes it exactly in float64
(an int8 code times a float32 scale is exact there) and rounds once to
float32. Flattening visits dict keys in sorted order and list items by
index, the reference's tree order.
"""
from __future__ import annotations

from typing import Any, List, Tuple

import torch

BLOCK = 2048  # error-feedback / scale block size (f32 overhead: 1/2048)

_INV_127 = 1.0 / 127.0


def _quant_block(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (nblocks, BLOCK) f32 → (codes int8, scale f32 (nblocks, 1))."""
    amax = x.abs().amax(dim=1, keepdim=True)
    scale = torch.clamp_min(amax, 1e-20) * _INV_127
    return torch.round(x / scale).to(torch.int8), scale


def _dequant(codes: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return (codes.to(torch.float32).reshape(-1, BLOCK) * scale).reshape(-1)


def _fma(a: torch.Tensor, codes: torch.Tensor, scale: torch.Tensor,
         sign: float) -> torch.Tensor:
    """``a + sign * codes * scale`` rounded once to float32 (flat ``a``;
    codes (nblocks, BLOCK), scale (nblocks, 1))."""
    prod = codes.to(torch.float64).reshape(-1, BLOCK) * scale.to(
        torch.float64)
    return (a.to(torch.float64) + sign * prod.reshape(-1)).to(torch.float32)


def _leaves(tree: Any) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [] if tree is None else [tree]


def _rebuild(tree: Any, it) -> Any:
    if isinstance(tree, dict):
        new = {k: _rebuild(tree[k], it) for k in sorted(tree)}
        return {k: new[k] for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, it) for v in tree)
    return None if tree is None else next(it)


def _flatten_pad(tree: Any) -> Tuple[torch.Tensor, Any, int]:
    leaves = _leaves(tree)
    flat = torch.cat([l.reshape(-1).to(torch.float32) for l in leaves])
    n = flat.shape[0]
    pad = (-n) % BLOCK
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    return flat, (tree, [tuple(l.shape) for l in leaves],
                  [l.dtype for l in leaves], n), pad


def _unflatten(flat: torch.Tensor, meta) -> Any:
    tree, shapes, dtypes, n = meta
    flat = flat[:n]
    out = []
    off = 0
    for shp, dt in zip(shapes, dtypes):
        sz = 1
        for s in shp:
            sz *= s
        out.append(flat[off:off + sz].reshape(shp).to(dt))
        off += sz
    return _rebuild(tree, iter(out))


def ring_allreduce_i8(flat: torch.Tensor, group) -> torch.Tensor:
    """Sum ``flat`` (this rank's float32 vector, length divisible by
    R * BLOCK) over the R ranks of ``group`` with int8 wire payloads.

    Ring reduce-scatter (R-1 hops) + ring all-gather (R-1 hops); every hop
    re-quantizes its chunk (int8 + per-block f32 scales). Every rank of the
    group must call it; every rank ends with the same bits.
    """
    import torch.distributed as dist
    from repro_torch.distributed.group import ring_hop
    r = dist.get_world_size(group)
    idx = dist.get_rank(group)
    chunks = flat.reshape(r, -1)                       # (R, C)
    nblk = chunks.shape[1] // BLOCK

    def quant_chunk(c):
        return _quant_block(c.reshape(-1, BLOCK))

    def recv_bufs():
        return (torch.empty((nblk, BLOCK), dtype=torch.int8,
                            device=flat.device),
                torch.empty((nblk, 1), dtype=torch.float32,
                            device=flat.device))

    # ---- reduce-scatter: after R-1 hops, rank i holds the sum of chunk i+1
    acc = chunks.clone()
    for hop in range(r - 1):
        send_idx = (idx - hop) % r                # chunk being forwarded
        codes, scale = quant_chunk(acc[send_idx])
        rc, rs = recv_bufs()
        ring_hop([codes, scale], [rc, rs], group)
        recv_idx = (idx - hop - 1) % r
        acc[recv_idx] = _fma(acc[recv_idx], rc, rs, 1.0)

    # ---- all-gather: quantize each reduced chunk ONCE and circulate the
    # codes verbatim so every rank reconstructs bit-identical values
    # (including the owner, which uses its own quantized image).
    own_idx = (idx + 1) % r
    codes, scale = quant_chunk(acc[own_idx])
    out = torch.zeros_like(chunks)
    out[own_idx] = _dequant(codes, scale)
    cur_idx = own_idx
    for hop in range(r - 1):
        rc, rs = recv_bufs()
        ring_hop([codes, scale], [rc, rs], group)
        codes, scale = rc, rs
        cur_idx = (cur_idx - 1) % r
        out[cur_idx] = _dequant(codes, scale)
    return out.reshape(-1)


def compress_local(grads: Any, error: Any) -> Tuple[torch.Tensor, Any]:
    """Local half of the compressed all-reduce.

    Flattens grads+error (BLOCK-padded) and computes the next error-feedback
    buffer. No collectives. Returns ``(flat, new_error_tree)``; the error
    tree is rebuilt with the *error's* own meta so its leaves keep their
    shapes step to step.
    """
    flat, _, _ = _flatten_pad(grads)
    eflat, emeta, _ = _flatten_pad(error)
    flat = flat + eflat
    codes, scale = _quant_block(flat.reshape(-1, BLOCK))
    return flat, _unflatten(_fma(flat, codes, scale, -1.0), emeta)


def ring_pad(flat: torch.Tensor, axis_size: int) -> torch.Tensor:
    """Zero-pad so the ring's chunks divide evenly across ``axis_size``."""
    pad = (-flat.shape[0]) % (axis_size * BLOCK)
    return torch.nn.functional.pad(flat, (0, pad)) if pad else flat


def flat_meta(template: Any):
    """The ``_unflatten`` meta for a tree of tensors (or anything with a
    ``shape`` and ``dtype``) — what rebuilds the gradient tree from the
    reduced flat vector."""
    leaves = _leaves(template)
    shapes = [tuple(l.shape) for l in leaves]
    n = 0
    for shp in shapes:
        sz = 1
        for s in shp:
            sz *= s
        n += sz
    return (template, shapes, [l.dtype for l in leaves], n)


def unflatten_grads(flat: torch.Tensor, template: Any) -> Any:
    """Rebuild a gradient tree shaped like ``template`` from the reduced
    flat vector (inverse of the flatten in ``compress_local``)."""
    return _unflatten(flat, flat_meta(template))
