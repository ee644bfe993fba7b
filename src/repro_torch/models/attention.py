"""Attention: dense grouped-query attention with contiguous and paged KV
caches, optionally int8.

Grouped-query attention uses the grouped einsum form at decode (no
materialized KV repeat) and the repeated-KV, query-chunked form at prefill —
the same einsums, in the same order, as the reference package, so the
softmax and mask arithmetic match (``scaled_dot_product_attention`` is
deliberately not used). Masked columns use the finite ``NEG_INF`` so they
contribute exact zeros.

Modes: ``prefill``, ``decode`` and ``chunk`` (a partial prefill continued
at the cache clock) on a contiguous cache, whose decode takes the integer
clock shared by the batch or a per-row position vector (the speculative
drafter's cache); paged ``decode`` through block tables (per-slot positions;
the new row is written through the table, then the paged-attention kernel
reads the pool); and paged ``verify``, speculative decoding's multi-position
forward. KV caches hold the model dtype, or int8 codes with one float32
scale per (position, kv-head) (``quantize_kv``, written by
:func:`_quant_tok`). Caches are updated in place: the caller owns them.

Not ported yet (each raises ``NotImplementedError`` naming itself): MLA and
sliding-window ring caches.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.models.layers import (_init_dense, apply_rotary,
                                       by_position, init_norm, linear,
                                       linear_by_position, rms_norm)

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
# KV cache (optionally int8)
# ---------------------------------------------------------------------------

def init_kv_cache(batch: int, max_len: int, n_kv: int, head_dim: int,
                  dtype=torch.bfloat16, quantize: bool = False,
                  window: Optional[int] = None, device=None) -> Dict[str, Any]:
    if window:
        raise NotImplementedError("not ported yet: sliding-window ring cache")
    shape = (batch, max_len, n_kv, head_dim)
    if quantize:
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_scale": torch.zeros(shape[:3], dtype=torch.float32,
                                       device=device),
                "v_scale": torch.zeros(shape[:3], dtype=torch.float32,
                                       device=device)}
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _quant_tok(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., KV, D) → int8 codes + one float32 scale per (..., KV).

    Per-(token, head) absmax scales with a 1e-6 floor, so all-zero rows
    quantize to exact zeros. The scale is ``amax / 127`` (a division), codes
    are ``round(x / scale)`` (a division, never a multiply by a reciprocal;
    ``torch.round`` is half-to-even like ``jnp.round``), clipped to
    [-127, 127] before the int8 cast so 128.0 can never wrap to -128. The
    arithmetic runs in ``x``'s dtype, as in the reference."""
    amax = x.abs().amax(dim=-1)
    scale = torch.clamp_min(amax, 1e-6) / 127.0
    codes = torch.clamp(torch.round(x / scale[..., None]), -127.0, 127.0)
    return codes.to(torch.int8), scale.to(torch.float32)


def _cache_write(cache, k, v, pos: int):
    """Write new k/v (B, S, KV, D) at absolute position ``pos`` (quantized
    per (token, head) on an int8 cache). Updates the cache tensors in place
    (the reference returns fresh arrays; here the caller owns the cache) and
    returns the same dict."""
    s = k.shape[1]
    if pos + s > cache["k"].shape[1]:
        raise ValueError(f"cache write [{pos}, {pos + s}) exceeds the cache "
                         f"length {cache['k'].shape[1]}")
    if "k_scale" in cache:
        kq, ks = _quant_tok(k)
        vq, vs = _quant_tok(v)
        cache["k"][:, pos:pos + s] = kq
        cache["v"][:, pos:pos + s] = vq
        cache["k_scale"][:, pos:pos + s] = ks
        cache["v_scale"][:, pos:pos + s] = vs
        return cache
    cache["k"][:, pos:pos + s] = k.to(cache["k"].dtype)
    cache["v"][:, pos:pos + s] = v.to(cache["v"].dtype)
    return cache


def _cache_write_at(cache, k, v, pos):
    """Write new k/v (B, S, KV, D) at positions ``pos .. pos + S - 1`` along
    the position axis with ``index_copy_`` (quantized per (token, head) on
    an int8 cache), in place. ``pos`` is a host integer or a 0-d int64
    device tensor (a captured chunk forward's clock): the same values land
    in the same places either way. Bounds are the host caller's to check
    (``LM.check_chunk``): it knows the integer."""
    rows = pos + torch.arange(k.shape[1], device=k.device)
    if "k_scale" in cache:
        kq, ks = _quant_tok(k)
        vq, vs = _quant_tok(v)
        cache["k"].index_copy_(1, rows, kq)
        cache["v"].index_copy_(1, rows, vq)
        cache["k_scale"].index_copy_(1, rows, ks)
        cache["v_scale"].index_copy_(1, rows, vs)
        return cache
    cache["k"].index_copy_(1, rows, k.to(cache["k"].dtype))
    cache["v"].index_copy_(1, rows, v.to(cache["v"].dtype))
    return cache


def _cache_read(cache) -> Tuple[torch.Tensor, torch.Tensor]:
    """The cache's K/V; an int8 cache comes back dequantized in float32."""
    if "k_scale" in cache:
        k = cache["k"].to(torch.float32) * cache["k_scale"][..., None]
        v = cache["v"].to(torch.float32) * cache["v_scale"][..., None]
        return k, v
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
                       q_chunk: int = Q_CHUNK, row0=0) -> torch.Tensor:
    """Prefill attention: KV repeated to H heads and queries processed in
    blocks — the (B, H, Cq, T) block, not (B, H, S, T), bounds the working
    set. Softmax sees the full key axis per row, so this is exact.

    q: (B,S,H,D); k/v: (B,T,KV,Dv) — repeated internally when KV < H.
    ``row0``: the absolute position of q's first row (an integer or a 0-d
    device tensor).
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
    the cache), "decode" (a single new token per row), or "chunk" (a
    partial-prefill continuation: ``s`` prompt tokens written at the clock
    ``pos``, a host integer or a 0-d int64 device tensor, attending over
    the already-filled cache prefix with the prefill einsums, so a chunked
    prefill matches the monolithic one).

    Decode on a contiguous cache takes the integer clock ``pos`` shared by
    the batch, or a per-row position vector (B,) on the device (the
    speculative drafter's cache: each row writes and masks at its own
    position). ``block_tables`` (B, nb) switches decode to the paged layout:
    the cache leaves are a block pool ``(num_blocks, block_size, KV, D)``
    shared by all slots, ``pos`` is the per-slot position vector (B,) on the
    device, and slot ``b`` reaches its K/V through its table row.

    ``verify`` (paged, fp pool only): slot b's S tokens are written through
    its table at ``pos[b] .. pos[b]+S-1``, then row (b, j) attends over
    positions ``0 .. pos[b]+j``. The products, norms and the kernel run
    position by position on the B rows (``layers.by_position``), each call
    a decode step's, so every row is bit for bit the decode step's at that
    position; elementwise work runs on all rows at once.
    """
    if cfg.mla is not None:
        raise NotImplementedError("not ported yet: MLA attention")
    if cfg.window:
        raise NotImplementedError("not ported yet: sliding-window attention")
    if mode == "verify":
        if block_tables is None:
            raise NotImplementedError(
                "verify mode requires the paged KV layout (block tables); "
                "the contiguous cache has one shared clock and cannot "
                "score per-slot multi-position runs")
        if "k_scale" in cache:
            raise NotImplementedError(
                "verify mode requires an fp KV pool (speculative "
                "acceptance is gated off quantize_kv)")
        lin = linear_by_position
    else:
        lin = linear
    b, s, d = x.shape
    hd = cfg.head_dim
    cos_t, sin_t = rope                      # (s, hd/2) for current tokens
    q = lin(params["wq"], x).reshape(b, s, cfg.n_heads, hd)
    k = lin(params["wk"], x).reshape(b, s, cfg.n_kv_heads, hd)
    v = lin(params["wv"], x).reshape(b, s, cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        rows = by_position if mode == "verify" else (lambda fn, t: fn(t))
        q = rows(lambda t: rms_norm(params["q_ln"], t), q)
        k = rows(lambda t: rms_norm(params["k_ln"], t), k)
    q = apply_rotary(q, cos_t, sin_t)
    k = apply_rotary(k, cos_t, sin_t)
    scale = hd ** -0.5

    if mode in ("train", "prefill"):
        out = _chunked_attention(q, k, v, scale=scale, causal=True,
                                 q_chunk=cfg.attn_q_chunk)
        if mode == "prefill":
            cache = _cache_write(cache, k, v, 0)
    elif mode == "chunk":
        # partial-prefill continuation: write this chunk at the clock (an
        # integer or a 0-d device tensor), then run the prefill einsum
        # against the whole cache with the rows' absolute positions masking
        # the unwritten suffix (exact zeros)
        cache = _cache_write_at(cache, k, v, pos)
        kc, vc = _cache_read(cache)
        out = _chunked_attention(q, kc.to(q.dtype), vc.to(q.dtype),
                                 scale=scale, causal=True,
                                 q_chunk=cfg.attn_q_chunk, row0=pos)
    elif mode == "decode" and block_tables is not None:
        # paged decode, s == 1: slot b's new row lands in physical block
        # bt[b, pos//bs] at offset pos % bs (retired slots point at the
        # trash block and are masked by length; their duplicate writes into
        # it race harmlessly), then the kernel attends through the table
        from repro_torch.kernels import ops                  # lazy import
        bs_blk = cache["k"].shape[1]
        rows = torch.arange(b, device=x.device)
        pos_l = pos.to(torch.int64)
        phys = block_tables[rows, pos_l // bs_blk].to(torch.int64)
        off = pos_l % bs_blk
        if "k_scale" in cache:
            kq, ks = _quant_tok(k[:, 0])
            vq, vs = _quant_tok(v[:, 0])
            cache["k"][phys, off] = kq
            cache["v"][phys, off] = vq
            cache["k_scale"][phys, off] = ks
            cache["v_scale"][phys, off] = vs
            out = ops.paged_attention_quant(
                q[:, 0], cache["k"], cache["v"], cache["k_scale"],
                cache["v_scale"], block_tables, pos, scale=scale)[:, None]
        else:
            cache["k"][phys, off] = k[:, 0].to(cache["k"].dtype)
            cache["v"][phys, off] = v[:, 0].to(cache["v"].dtype)
            out = ops.paged_attention(q[:, 0], cache["k"], cache["v"],
                                      block_tables, pos, scale=scale)[:, None]
    elif mode == "verify":
        # slot b's S rows land at pos[b]+j through its table (retired slots'
        # all-trash tables take theirs into the trash block), then one
        # kernel launch per position j over the B slots at lengths pos+j:
        # the launch, shapes and split plan of a decode step there
        from repro_torch.kernels import ops                  # lazy import
        bs_blk = cache["k"].shape[1]
        idx = pos.to(torch.int64)[:, None] + torch.arange(s, device=x.device)
        rows = torch.arange(b, device=x.device)[:, None]
        phys = block_tables[rows, idx // bs_blk].to(torch.int64)
        off = idx % bs_blk
        cache["k"][phys, off] = k.to(cache["k"].dtype)
        cache["v"][phys, off] = v.to(cache["v"].dtype)
        out = torch.stack([
            ops.paged_attention(q[:, j].contiguous(), cache["k"], cache["v"],
                                block_tables, pos + j, scale=scale)
            for j in range(s)], dim=1)
    elif mode == "decode" and not isinstance(pos, int):
        # per-row positions on a contiguous cache (the drafter's): row b
        # writes at pos[b] and masks every column past it
        if "k_scale" in cache:
            raise NotImplementedError(
                "per-row decode positions are not implemented for "
                "sliding-window or quantized contiguous caches")
        rows = torch.arange(b, device=x.device)
        pos_l = pos.to(torch.int64)
        cache["k"][rows, pos_l] = k[:, 0].to(cache["k"].dtype)
        cache["v"][rows, pos_l] = v[:, 0].to(cache["v"].dtype)
        si = torch.arange(cache["k"].shape[1], device=x.device)
        mask = torch.where(si[None, :] <= pos_l[:, None], 0.0, NEG_INF)
        out = _grouped_attention(q, cache["k"].to(q.dtype),
                                 cache["v"].to(q.dtype),
                                 mask[:, None, None, None, :], scale)
    elif mode == "decode":
        cache = _cache_write(cache, k, v, pos)
        kc, vc = _cache_read(cache)
        si = torch.arange(kc.shape[1], device=x.device)
        mask = torch.where(si <= pos, 0.0, NEG_INF)[None, None, None, None, :]
        out = _grouped_attention(q, kc.to(q.dtype), vc.to(q.dtype), mask,
                                 scale)
    else:
        raise ValueError(f"unknown attention mode {mode!r}")
    out = out.reshape(b, s, cfg.n_heads * hd)
    return lin(params["wo"], out), cache
