"""Paged decode attention: wrapper, launch counter, plain version.

One new query token per slot attends over K/V read *through a block table*
from a shared block pool (what :class:`repro_torch.serving.kvcache.
PagedKVCache` feeds in):

* ``k_pool``/``v_pool``: ``(num_blocks, block_size, KV, D)``, the pool;
* ``block_tables``: ``(B, nb)`` int32, per-slot physical block ids in
  logical order; unused entries point at the reserved trash block 0;
* ``lengths``: ``(B,)`` int32, each slot's current position (its new K/V is
  already written), so columns ``> lengths[b]`` are masked.

The CUDA source is ``csrc/paged_attention.cu`` (one template for this pool
and the int8 one of :mod:`repro_torch.kernels.paged_attention_quant`); see
the note at its head. The plain version gathers each slot's blocks to a
contiguous view and runs the grouped einsum of the contiguous decode path
with an *added* mask, op for op as the reference oracle does, so on the CPU
paged decode gives the contiguous decode's numbers.

Dispatch rule: a CPU tensor takes the plain version; a CUDA tensor launches
the kernel or raises. There is no fallback from the kernel to the plain
version.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

NEG_INF = -2.0 ** 30   # finite: exp(NEG_INF - m) underflows to exactly 0.0

launches = 0             # number of kernel launches (plain integer)


def paged_attention_plain(q: torch.Tensor, k_pool: torch.Tensor,
                          v_pool: torch.Tensor, block_tables: torch.Tensor,
                          lengths: torch.Tensor, *, scale: float
                          ) -> torch.Tensor:
    """q: (B, H, D); pools: (N, bs, KV, D); block_tables: (B, nb);
    lengths: (B,). Returns (B, H, D) in q's dtype."""
    b, h, d = q.shape
    kv = k_pool.shape[2]
    bs = k_pool.shape[1]
    nb = block_tables.shape[1]
    t = nb * bs
    bt = block_tables.to(torch.int64)
    kc = k_pool[bt].reshape(b, t, kv, d).to(q.dtype)
    vc = v_pool[bt].reshape(b, t, kv, d).to(q.dtype)
    valid = torch.arange(t, device=q.device)[None, :] <= lengths[:, None]
    mask = torch.where(valid, 0.0, NEG_INF).to(torch.float32)
    mask = mask[:, None, None, None, :]                 # (B,1,1,S=1,T)
    rep = h // kv
    qg = q[:, None].reshape(b, 1, kv, rep, d)
    scores = torch.einsum("bskrd,btkd->bkrst", qg, kc) * scale
    scores = scores.to(torch.float32)
    scores = scores + mask
    p = torch.softmax(scores, dim=-1).to(vc.dtype)
    out = torch.einsum("bkrst,btkd->bskrd", p, vc)
    return out.reshape(b, 1, h, d)[:, 0]


def check_args(q, k_pool, v_pool, block_tables, lengths, pool_dtypes):
    """Validate a launch of either paged kernel; returns (b, kv, rep, d,
    nb, bs) and the tensors made contiguous."""
    if q.ndim != 3 or k_pool.ndim != 4 or k_pool.shape != v_pool.shape:
        raise ValueError(f"q must be (B, H, D) and the pools (N, bs, KV, D) "
                         f"alike; got {tuple(q.shape)}, {tuple(k_pool.shape)},"
                         f" {tuple(v_pool.shape)}")
    b, h, d = q.shape
    _, bs, kv, dk = k_pool.shape
    if dk != d or h % kv != 0:
        raise ValueError(f"head_dim {d} vs pool {dk}, or H={h} not a "
                         f"multiple of KV={kv}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"q must be float32 or bfloat16, got {q.dtype}")
    if k_pool.dtype not in pool_dtypes or v_pool.dtype != k_pool.dtype:
        raise ValueError(f"pools must be {pool_dtypes}, got {k_pool.dtype} "
                         f"and {v_pool.dtype}")
    if block_tables.ndim != 2 or block_tables.shape[0] != b \
            or block_tables.dtype != torch.int32:
        raise ValueError("block_tables must be (B, nb) int32")
    if lengths.shape != (b,) or lengths.dtype != torch.int32:
        raise ValueError("lengths must be (B,) int32")
    for t in (k_pool, v_pool, block_tables, lengths):
        if t.device != q.device:
            raise ValueError("every operand must be on q's device")
    out = [t if t.is_contiguous() else t.contiguous()
           for t in (q, k_pool, v_pool, block_tables, lengths)]
    return (b, kv, h // kv, d, block_tables.shape[1], bs), out


_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load("paged_attention").paged_attention_launch
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + \
            [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        _fn = fn
    return _fn


def paged_attention(q: torch.Tensor, k_pool: torch.Tensor,
                    v_pool: torch.Tensor, block_tables: torch.Tensor,
                    lengths: torch.Tensor, *, scale: float) -> torch.Tensor:
    """Block-table decode attention, (B, H, D) out in q's dtype. The pools
    must have q's dtype (float32 or bfloat16)."""
    if not q.is_cuda:
        return paged_attention_plain(q, k_pool, v_pool, block_tables,
                                     lengths, scale=scale)
    (b, kv, rep, d, nb, bs), (q, k_pool, v_pool, block_tables, lengths) = \
        check_args(q, k_pool, v_pool, block_tables, lengths, (q.dtype,))
    out = torch.empty_like(q)
    if b == 0:
        return out
    global launches
    with _build.on_device(q.device):
        err = _kernel()(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                        block_tables.data_ptr(), lengths.data_ptr(),
                        out.data_ptr(), b, kv, rep, d, nb, bs, float(scale),
                        int(q.dtype == torch.bfloat16),
                        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"paged_attention kernel launch failed (cuda "
                           f"error {err})")
    launches += 1
    return out
