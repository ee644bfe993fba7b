"""Paged decode attention on an int8 KV pool: wrapper, launch counter,
plain version.

The quantized sibling of :mod:`repro_torch.kernels.paged_attention`: the
pool holds int8 K/V codes plus one float32 scale per (position, kv-head)
(``(num_blocks, block_size, KV)``), written by ``models.attention.
_quant_tok``. The kernel is the ``QUANT`` instance of the template in
``csrc/paged_attention.cu``: codes are widened in registers, ``k_scale`` is
multiplied into the scores after the QK dot and ``v_scale`` into the softmax
weights before the PV dot, so no dequantized tile is formed.

The plain version mirrors the reference oracle's op order (codes dot →
k-scale fold → mask → softmax → v-scale fold → codes dot → divide by the
sum). Greedy tokens on this pool are tolerance-equivalent to the fp pool,
not identical (``serving.equivalence``).

Dispatch rule: a CPU tensor takes the plain version; a CUDA tensor launches
the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.paged_attention import NEG_INF, check_args

launches = 0             # number of kernel launches (plain integer)


def paged_attention_quant_plain(q: torch.Tensor, k_pool: torch.Tensor,
                                v_pool: torch.Tensor, k_scale: torch.Tensor,
                                v_scale: torch.Tensor,
                                block_tables: torch.Tensor,
                                lengths: torch.Tensor, *, scale: float
                                ) -> torch.Tensor:
    """q: (B, H, D); code pools (N, bs, KV, D) int8; scale pools
    (N, bs, KV) float32; block_tables (B, nb); lengths (B,). Returns
    (B, H, D) in q's dtype."""
    b, h, d = q.shape
    kv = k_pool.shape[2]
    bs = k_pool.shape[1]
    nb = block_tables.shape[1]
    t = nb * bs
    bt = block_tables.to(torch.int64)
    kc = k_pool[bt].reshape(b, t, kv, d).to(torch.float32)
    vc = v_pool[bt].reshape(b, t, kv, d).to(torch.float32)
    ks = k_scale[bt].reshape(b, t, kv).permute(0, 2, 1)
    vs = v_scale[bt].reshape(b, t, kv).permute(0, 2, 1)
    valid = torch.arange(t, device=q.device)[None, :] <= lengths[:, None]
    rep = h // kv
    qg = q.to(torch.float32).reshape(b, kv, rep, d)
    scores = torch.einsum("bkrd,btkd->bkrt", qg, kc) * scale
    scores = scores * ks[:, :, None, :]                      # fold k_scale
    scores = torch.where(valid[:, None, None, :], scores, NEG_INF)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    l = p.sum(dim=-1, keepdim=True)
    pw = p * vs[:, :, None, :]                               # fold v_scale
    out = torch.einsum("bkrt,btkd->bkrd", pw, vc) / l
    return out.to(q.dtype).reshape(b, h, d)


_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load("paged_attention").paged_attention_quant_launch
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + \
            [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        _fn = fn
    return _fn


def paged_attention_quant(q: torch.Tensor, k_pool: torch.Tensor,
                          v_pool: torch.Tensor, k_scale: torch.Tensor,
                          v_scale: torch.Tensor, block_tables: torch.Tensor,
                          lengths: torch.Tensor, *, scale: float
                          ) -> torch.Tensor:
    """Block-table decode attention over int8 codes, (B, H, D) out in q's
    dtype (float32 or bfloat16)."""
    if not q.is_cuda:
        return paged_attention_quant_plain(q, k_pool, v_pool, k_scale,
                                           v_scale, block_tables, lengths,
                                           scale=scale)
    (b, kv, rep, d, nb, bs), (q, k_pool, v_pool, block_tables, lengths) = \
        check_args(q, k_pool, v_pool, block_tables, lengths, (torch.int8,))
    if k_scale.shape != k_pool.shape[:3] or v_scale.shape != k_scale.shape \
            or k_scale.dtype != torch.float32 \
            or v_scale.dtype != torch.float32 \
            or k_scale.device != q.device or v_scale.device != q.device:
        raise ValueError("scale pools must be float32 (N, bs, KV) on q's "
                         "device")
    k_scale = k_scale.contiguous()
    v_scale = v_scale.contiguous()
    out = torch.empty_like(q)
    if b == 0:
        return out
    global launches
    with _build.on_device(q.device):
        err = _kernel()(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                        k_scale.data_ptr(), v_scale.data_ptr(),
                        block_tables.data_ptr(), lengths.data_ptr(),
                        out.data_ptr(), b, kv, rep, d, nb, bs, float(scale),
                        int(q.dtype == torch.bfloat16),
                        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"paged_attention_quant kernel launch failed "
                           f"(cuda error {err})")
    launches += 1
    return out
