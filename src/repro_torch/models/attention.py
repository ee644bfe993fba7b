"""Attention: dense grouped-query attention with a contiguous KV cache.

Grouped-query attention uses the grouped einsum form at decode (no
materialized KV repeat) and the repeated-KV, query-chunked form at prefill —
the same einsums, in the same order, as the reference package, so the
softmax and mask arithmetic match (``scaled_dot_product_attention`` is
deliberately not used). Masked columns use the finite ``NEG_INF`` so they
contribute exact zeros.

Ported here: ``prefill`` and scalar-position ``decode`` on an fp cache.
Not ported yet (each raises ``NotImplementedError`` naming itself): MLA,
sliding-window ring caches, the ``chunk`` and ``verify`` modes, block-table
(paged) decode, per-row decode positions and int8 KV caches.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.models.layers import (_init_dense, apply_rotary, init_norm,
                                       linear, rms_norm)

NEG_INF = -2.0 ** 30


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_attention(generator, cfg, device=None) -> Dict[str, Any]:
    if cfg.mla is not None:
        raise NotImplementedError("not ported yet: MLA attention")
    d = cfg.d_model
    hd = cfg.head_dim
    p = {
        "wq": _init_dense(generator, d, cfg.n_heads * hd, device=device),
        "wk": _init_dense(generator, d, cfg.n_kv_heads * hd, device=device),
        "wv": _init_dense(generator, d, cfg.n_kv_heads * hd, device=device),
        "wo": _init_dense(generator, cfg.n_heads * hd, d, device=device),
    }
    if cfg.qk_norm:
        p["q_ln"] = init_norm(hd, device=device)
        p["k_ln"] = init_norm(hd, device=device)
    return p


# ---------------------------------------------------------------------------
# KV cache (fp)
# ---------------------------------------------------------------------------

def init_kv_cache(batch: int, max_len: int, n_kv: int, head_dim: int,
                  dtype=torch.bfloat16, quantize: bool = False,
                  window: Optional[int] = None, device=None) -> Dict[str, Any]:
    if quantize:
        raise NotImplementedError("not ported yet: int8 KV cache (quantize_kv)")
    if window:
        raise NotImplementedError("not ported yet: sliding-window ring cache")
    shape = (batch, max_len, n_kv, head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _cache_write(cache, k, v, pos: int):
    """Write new k/v (B, S, KV, D) at absolute position ``pos``. Updates the
    cache tensors in place (the reference returns fresh arrays; here a round's
    cache is owned by that round) and returns the same dict."""
    s = k.shape[1]
    if pos + s > cache["k"].shape[1]:
        raise ValueError(f"cache write [{pos}, {pos + s}) exceeds the cache "
                         f"length {cache['k'].shape[1]}")
    cache["k"][:, pos:pos + s] = k.to(cache["k"].dtype)
    cache["v"][:, pos:pos + s] = v.to(cache["v"].dtype)
    return cache


def _cache_read(cache) -> Tuple[torch.Tensor, torch.Tensor]:
    return cache["k"], cache["v"]


# ---------------------------------------------------------------------------
# core attention math
# ---------------------------------------------------------------------------

def _grouped_attention(q, k, v, mask, softmax_scale) -> torch.Tensor:
    """q: (B,S,H,D), k/v: (B,T,KV,Dv); H = KV * rep. mask: (S,T) or
    (B,1,1,S,T) additive. Used for decode (S small): no KV repeat."""
    b, s, h, dq = q.shape
    kv = k.shape[2]
    rep = h // kv
    qg = q.reshape(b, s, kv, rep, dq)
    scores = torch.einsum("bskrd,btkd->bkrst", qg, k) * softmax_scale
    scores = scores.to(torch.float32)
    if mask is not None:
        if mask.ndim == 2:
            mask = mask[None, None, None]
        scores = scores + mask
    p = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkrst,btkd->bskrd", p, v)
    return out.reshape(b, s, h, v.shape[-1])


Q_CHUNK = 1024   # query-block size bounding the (B,H,Cq,T) score tensor


def _chunked_attention(q, k, v, *, scale, causal: bool,
                       q_chunk: int = Q_CHUNK, row0: int = 0) -> torch.Tensor:
    """Prefill attention: KV repeated to H heads and queries processed in
    blocks — the (B, H, Cq, T) block, not (B, H, S, T), bounds the working
    set. Softmax sees the full key axis per row, so this is exact.

    q: (B,S,H,D); k/v: (B,T,KV,Dv) — repeated internally when KV < H.
    """
    b, s, h, dq = q.shape
    t, kv = k.shape[1], k.shape[2]
    if kv != h:
        rep = h // kv
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    cols = torch.arange(t, device=q.device)

    def block(qc, roff):
        scores = torch.einsum("bshd,bthd->bhst", qc, k) * scale
        scores = scores.to(torch.float32)
        if causal:
            rows = roff + torch.arange(qc.shape[1], device=q.device)
            ok = cols[None, :] <= rows[:, None]
            scores = torch.where(ok[None, None], scores, NEG_INF)
        p = torch.softmax(scores, dim=-1).to(v.dtype)
        return torch.einsum("bhst,bthd->bshd", p, v)

    if s <= q_chunk or s % q_chunk != 0:
        return block(q, row0)
    outs = [block(q[:, i:i + q_chunk], row0 + i)
            for i in range(0, s, q_chunk)]
    return torch.cat(outs, dim=1)


def causal_mask(s: int, t: Optional[int] = None, device=None) -> torch.Tensor:
    t = t or s
    qi = torch.arange(s, device=device)[:, None] + (t - s)
    ki = torch.arange(t, device=device)[None, :]
    return torch.where(ki <= qi, 0.0, NEG_INF).to(torch.float32)


# ---------------------------------------------------------------------------
# public entry point
# ---------------------------------------------------------------------------

def attention(params, x, *, cfg, rope, mode: str = "prefill",
              cache: Optional[dict] = None, pos=None,
              block_tables=None) -> Tuple[torch.Tensor, Optional[dict]]:
    """Self-attention.

    mode: "train"/"prefill" (full sequence, causal mask; prefill also fills
    the cache) or "decode" (a single new token against the cache at the
    integer position ``pos`` shared by the whole batch).
    """
    if cfg.mla is not None:
        raise NotImplementedError("not ported yet: MLA attention")
    if cfg.window:
        raise NotImplementedError("not ported yet: sliding-window attention")
    if block_tables is not None:
        raise NotImplementedError("not ported yet: block-table (paged) decode")
    if mode in ("chunk", "verify"):
        raise NotImplementedError(f"not ported yet: attention mode {mode!r}")
    if cache is not None and "k_scale" in cache:
        raise NotImplementedError("not ported yet: int8 KV cache (_quant_tok)")
    b, s, d = x.shape
    hd = cfg.head_dim
    cos_t, sin_t = rope                      # (s, hd/2) for current tokens
    q = linear(params["wq"], x).reshape(b, s, cfg.n_heads, hd)
    k = linear(params["wk"], x).reshape(b, s, cfg.n_kv_heads, hd)
    v = linear(params["wv"], x).reshape(b, s, cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        q = rms_norm(params["q_ln"], q)
        k = rms_norm(params["k_ln"], k)
    q = apply_rotary(q, cos_t, sin_t)
    k = apply_rotary(k, cos_t, sin_t)
    scale = hd ** -0.5

    if mode in ("train", "prefill"):
        out = _chunked_attention(q, k, v, scale=scale, causal=True,
                                 q_chunk=cfg.attn_q_chunk)
        if mode == "prefill":
            cache = _cache_write(cache, k, v, 0)
    elif mode == "decode":
        if not isinstance(pos, int):
            raise NotImplementedError(
                "not ported yet: per-row decode positions (pos must be the "
                "integer clock shared by the batch)")
        cache = _cache_write(cache, k, v, pos)
        kc, vc = _cache_read(cache)
        si = torch.arange(kc.shape[1], device=x.device)
        mask = torch.where(si <= pos, 0.0, NEG_INF)[None, None, None, None, :]
        out = _grouped_attention(q, kc.to(q.dtype), vc.to(q.dtype), mask,
                                 scale)
    else:
        raise ValueError(f"unknown attention mode {mode!r}")
    out = out.reshape(b, s, cfg.n_heads * hd)
    return linear(params["wo"], out), cache
