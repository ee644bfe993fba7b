"""Attention: grouped-query attention (dense, sliding-window) and
multi-head latent attention (MLA), with contiguous and paged KV caches,
optionally int8.

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

Sliding-window attention (``cfg.window``) keeps a ring of
``min(max_len, window)`` slots: token ``p`` lives in slot ``p % slots``
(:func:`_cache_write`, :func:`_ring_scatter`); a chunk continuation attends
over the ring as of chunk entry concatenated with the chunk's own keys,
each ring slot's absolute position reconstructed from the clock. MLA
(``cfg.mla``) caches the compressed ``c_kv`` and the shared rotary key
``k_rope`` (:func:`init_mla_cache`) and re-expands the whole cache through
``kv_up`` every chunk and decode step, or, with ``MLAConfig.absorb``,
attends in the compressed space (:func:`_mla_absorbed_decode`). Both serve
on contiguous caches only (the paged backend and ``verify`` are gated off
them, as in the reference).

Grouped-query attention reads its q and KV head counts from the local
weights' widths, so under tensor-parallel execution (``distributed.
sharding``) it runs this rank's heads on a cache of this rank's KV heads;
its row-parallel ``wo`` product comes back as partial sums, which the
block sums over 'model' (``models.transformer``).

Cross-attention (:func:`cross_attention`, the encoder-decoder's) attends a
decoder's rows over the encoder output, full multi-head and unmasked (or
under an encoder mask), projecting K/V from it at every call. Operands of
mixed dtypes promote as ``jnp`` promotes them (:func:`_promote`): a
bfloat16 decoder over a float32 encoder output runs in float32 from there.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.distributed.sharding import to_model
from repro_torch.models.layers import (_init_dense, apply_rotary,
                                       by_position, init_norm, linear,
                                       linear_by_position, rms_norm)
from repro_torch.quant.qtypes import QuantizedTensor

NEG_INF = -2.0 ** 30


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_attention(generator, cfg, device=None) -> Dict[str, Any]:
    d = cfg.d_model
    hd = cfg.head_dim
    if cfg.mla is not None:
        m = cfg.mla
        qk_dim = m.nope_dim + m.rope_dim
        return {
            "q_down": _init_dense(generator, d, m.q_lora, device=device),
            "q_norm": init_norm(m.q_lora, device=device),
            "q_up": _init_dense(generator, m.q_lora, cfg.n_heads * qk_dim,
                                device=device),
            "kv_down": _init_dense(generator, d, m.kv_lora + m.rope_dim,
                                   device=device),
            "kv_norm": init_norm(m.kv_lora, device=device),
            "kv_up": _init_dense(generator, m.kv_lora,
                                 cfg.n_heads * (m.nope_dim + m.v_dim),
                                 device=device),
            "wo": _init_dense(generator, cfg.n_heads * m.v_dim, d,
                              device=device),
        }
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


def init_cross_attention(generator, cfg, device=None) -> Dict[str, Any]:
    """Cross-attention (and the encoder's self-attention): full multi-head,
    K/V at ``n_heads``."""
    d, hd = cfg.d_model, cfg.head_dim
    return {
        "wq": _init_dense(generator, d, cfg.n_heads * hd, device=device),
        "wk": _init_dense(generator, d, cfg.n_heads * hd, device=device),
        "wv": _init_dense(generator, d, cfg.n_heads * hd, device=device),
        "wo": _init_dense(generator, cfg.n_heads * hd, d, device=device),
    }


# ---------------------------------------------------------------------------
# KV cache (optionally int8)
# ---------------------------------------------------------------------------

def init_kv_cache(batch: int, max_len: int, n_kv: int, head_dim: int,
                  dtype=torch.bfloat16, quantize: bool = False,
                  window: Optional[int] = None, device=None) -> Dict[str, Any]:
    """Zeroed K/V of ``max_len`` positions, or, with a ``window``, a ring of
    ``min(max_len, window)`` slots."""
    slots = min(max_len, window) if window else max_len
    shape = (batch, slots, n_kv, head_dim)
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


def _cache_write(cache, k, v, pos: int, window: Optional[int] = None):
    """Write new k/v (B, S, KV, D) at absolute position ``pos`` (quantized
    per (token, head) on an int8 cache). Updates the cache tensors in place
    (the reference returns fresh arrays; here the caller owns the cache) and
    returns the same dict.

    With a ``window`` the cache is a ring: a write of at least ``slots``
    tokens keeps the last ``slots``, rolled so token ``p`` sits at slot
    ``p % slots``; a shorter one lands at ``pos % slots``. A write that
    would run past the cache's end raises (the reference's
    ``dynamic_update_slice`` would clamp it; its callers never do that)."""
    slots = cache["k"].shape[1]
    s = k.shape[1]
    if window and s >= slots:
        shift = (pos + s) % slots
        k = torch.roll(k[:, -slots:], shift, dims=1)
        v = torch.roll(v[:, -slots:], shift, dims=1)
        idx, s = 0, slots
    else:
        idx = pos % slots if window else pos
    if idx + s > slots:
        raise ValueError(f"cache write [{idx}, {idx + s}) exceeds the cache "
                         f"length {slots}")
    if "k_scale" in cache:
        kq, ks = _quant_tok(k)
        vq, vs = _quant_tok(v)
        cache["k"][:, idx:idx + s] = kq
        cache["v"][:, idx:idx + s] = vq
        cache["k_scale"][:, idx:idx + s] = ks
        cache["v_scale"][:, idx:idx + s] = vs
        return cache
    cache["k"][:, idx:idx + s] = k.to(cache["k"].dtype)
    cache["v"][:, idx:idx + s] = v.to(cache["v"].dtype)
    return cache


def _ring_scatter(cache, k, v, pos):
    """Scatter a chunk of ``s`` tokens into a ring cache at slots ``(pos +
    i) % slots`` (in place); unlike :func:`_cache_write` it handles a chunk
    that straddles the ring's end. ``pos`` is a host integer or a 0-d int64
    device tensor. A chunk wider than the ring keeps its newest ``slots``
    tokens only, so the index holds no duplicate (``index_copy_`` under
    duplicate indices is not deterministic on CUDA)."""
    slots = cache["k"].shape[1]
    if k.shape[1] >= slots:
        off = k.shape[1] - slots
        k, v, pos = k[:, off:], v[:, off:], pos + off
    idx = (pos + torch.arange(k.shape[1], device=k.device)) % slots
    if "k_scale" in cache:
        kq, ks = _quant_tok(k)
        vq, vs = _quant_tok(v)
        cache["k"].index_copy_(1, idx, kq)
        cache["v"].index_copy_(1, idx, vq)
        cache["k_scale"].index_copy_(1, idx, ks)
        cache["v_scale"].index_copy_(1, idx, vs)
        return cache
    cache["k"].index_copy_(1, idx, k.to(cache["k"].dtype))
    cache["v"].index_copy_(1, idx, v.to(cache["v"].dtype))
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

def _promote(a: torch.Tensor, b: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``a`` and ``b`` in their common dtype (``torch.result_type``), as
    ``jnp.einsum`` promotes operands of mixed dtypes (a bfloat16 query
    against float32 keys gives float32 scores); ``torch.einsum`` would
    raise instead."""
    dt = torch.result_type(a, b)
    return a.to(dt), b.to(dt)


def _grouped_attention(q, k, v, mask, softmax_scale) -> torch.Tensor:
    """q: (B,S,H,D), k/v: (B,T,KV,Dv); H = KV * rep. mask: (S,T) or
    (B,1,1,S,T) additive. Used for decode (S small): no KV repeat. Mixed
    dtypes promote as in the reference (:func:`_promote`)."""
    b, s, h, dq = q.shape
    kv = k.shape[2]
    rep = h // kv
    qg, k = _promote(q.reshape(b, s, kv, rep, dq), k)
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
                       window: Optional[int] = None,
                       q_chunk: int = Q_CHUNK, row0=0) -> torch.Tensor:
    """Prefill attention: KV repeated to H heads and queries processed in
    blocks — the (B, H, Cq, T) block, not (B, H, S, T), bounds the working
    set. Softmax sees the full key axis per row, so this is exact.

    q: (B,S,H,D); k/v: (B,T,KV,Dv) — repeated internally when KV < H.
    ``row0``: the absolute position of q's first row (an integer or a 0-d
    device tensor). ``window``: a causal row also masks the keys ``window``
    or more positions behind it. Mixed dtypes promote as in the reference
    (:func:`_promote`).
    """
    b, s, h, dq = q.shape
    t, kv = k.shape[1], k.shape[2]
    if kv != h:
        rep = h // kv
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    cols = torch.arange(t, device=q.device)

    def block(qc, roff):
        scores = torch.einsum("bshd,bthd->bhst", *_promote(qc, k)) * scale
        scores = scores.to(torch.float32)
        if causal:
            rows = roff + torch.arange(qc.shape[1], device=q.device)
            ok = cols[None, :] <= rows[:, None]
            if window is not None:
                ok &= cols[None, :] > rows[:, None] - window
            scores = torch.where(ok[None, None], scores, NEG_INF)
        p = torch.softmax(scores, dim=-1).to(v.dtype)
        return torch.einsum("bhst,bthd->bshd", p, v)

    if s <= q_chunk or s % q_chunk != 0:
        return block(q, row0)
    outs = [block(q[:, i:i + q_chunk], row0 + i)
            for i in range(0, s, q_chunk)]
    return torch.cat(outs, dim=1)


def causal_mask(s: int, t: Optional[int] = None,
                window: Optional[int] = None, device=None) -> torch.Tensor:
    t = t or s
    qi = torch.arange(s, device=device)[:, None] + (t - s)
    ki = torch.arange(t, device=device)[None, :]
    ok = ki <= qi
    if window is not None:
        ok &= ki > qi - window
    return torch.where(ok, 0.0, NEG_INF).to(torch.float32)


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
        if mode == "verify":
            raise NotImplementedError(
                "'verify' mode is not implemented for MLA attention")
        return _mla_attention(params, x, cfg=cfg, rope=rope, mode=mode,
                              cache=cache, pos=pos)
    if mode == "verify" and cfg.window:
        raise NotImplementedError(
            "'verify' mode is not implemented for sliding-window "
            "ring-buffer caches")
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
    # the head counts are the local weights' widths: under tensor-parallel
    # execution this rank's q and KV heads (contiguous column shards keep
    # GQA's grouping, q heads j*rep .. (j+1)*rep-1 over KV head j)
    q = lin(params["wq"], x).reshape(b, s, -1, hd)
    k = lin(params["wk"], x).reshape(b, s, -1, hd)
    v = lin(params["wv"], x).reshape(b, s, -1, hd)
    if cfg.qk_norm:
        rows = by_position if mode == "verify" else (lambda fn, t: fn(t))
        # a replicated gain on the local heads: its gradient sums over
        # 'model' (to_model)
        q_ln = {"gain": to_model(params["q_ln"]["gain"])}
        k_ln = {"gain": to_model(params["k_ln"]["gain"])}
        q = rows(lambda t: rms_norm(q_ln, t), q)
        k = rows(lambda t: rms_norm(k_ln, t), k)
    q = apply_rotary(q, cos_t, sin_t)
    k = apply_rotary(k, cos_t, sin_t)
    scale = hd ** -0.5

    if mode in ("train", "prefill"):
        out = _chunked_attention(q, k, v, scale=scale, causal=True,
                                 window=cfg.window, q_chunk=cfg.attn_q_chunk)
        if mode == "prefill":
            cache = _cache_write(cache, k, v, 0, cfg.window)
    elif mode == "chunk" and cfg.window:
        # ring continuation: the chunk's queries attend over the ring as of
        # chunk entry concatenated with the chunk's own keys, attention
        # before the ring write (writing first would evict keys the chunk's
        # earliest rows still need). Slot j's absolute key position is the
        # largest p < pos with p % slots == j (floor division: negative
        # means never written this admission, masked), so a reused side
        # cache's stale rows contribute exact zeros
        kc, vc = _cache_read(cache)
        slots = kc.shape[1]
        j = torch.arange(slots, device=x.device)
        kpos_ring = j + torch.div(pos - j - 1, slots,
                                  rounding_mode="floor") * slots
        rows = pos + torch.arange(s, device=x.device)
        kpos = torch.cat([kpos_ring, rows])
        ok = ((kpos[None, :] >= 0) & (kpos[None, :] <= rows[:, None])
              & (kpos[None, :] > rows[:, None] - cfg.window))
        mask = torch.where(ok, 0.0, NEG_INF).to(torch.float32)
        k_all = torch.cat([kc.to(q.dtype), k.to(q.dtype)], dim=1)
        v_all = torch.cat([vc.to(q.dtype), v.to(q.dtype)], dim=1)
        out = _grouped_attention(q, k_all, v_all, mask, scale)
        cache = _ring_scatter(cache, k, v, pos)
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
        if cfg.window or "k_scale" in cache:
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
        cache = _cache_write(cache, k, v, pos, cfg.window)
        kc, vc = _cache_read(cache)
        slots = kc.shape[1]
        si = torch.arange(slots, device=x.device)
        if cfg.window:
            valid = (si <= pos % slots) | (pos >= slots)
        else:
            valid = si <= pos
        mask = torch.where(valid, 0.0, NEG_INF)[None, None, None, None, :]
        out = _grouped_attention(q, kc.to(q.dtype), vc.to(q.dtype), mask,
                                 scale)
    else:
        raise ValueError(f"unknown attention mode {mode!r}")
    out = out.reshape(b, s, -1)
    return lin(params["wo"], out), cache


# ---------------------------------------------------------------------------
# multi-head latent attention (MLA)
# ---------------------------------------------------------------------------

def _latent_write(cache, c_kv, k_rope, pos):
    """Write compressed rows ``c_kv`` (B, S, kv_lora) and rotary keys
    ``k_rope`` (B, S, 1, rope_dim) at positions ``pos .. pos + S - 1`` of
    an MLA cache, in place. ``pos`` is a host integer (bounds-checked here)
    or a 0-d int64 device tensor (bounds are its caller's)."""
    s = c_kv.shape[1]
    if isinstance(pos, int) and pos + s > cache["c_kv"].shape[1]:
        raise ValueError(f"cache write [{pos}, {pos + s}) exceeds the cache "
                         f"length {cache['c_kv'].shape[1]}")
    rows = pos + torch.arange(s, device=c_kv.device)
    cache["c_kv"].index_copy_(1, rows, c_kv.to(cache["c_kv"].dtype))
    cache["k_rope"].index_copy_(1, rows, k_rope.to(cache["k_rope"].dtype))
    return cache


def _mla_attention(params, x, *, cfg, rope, mode, cache, pos):
    """Multi-head latent attention with a compressed KV cache.

    Train and prefill expand the current tokens' latents; chunk and decode
    write ``c_kv``/``k_rope`` at the clock and re-expand the whole cache
    through ``kv_up`` (B·max_len rows a step), masking the unwritten
    suffix by absolute position (its zero rows normalize to zeros and are
    masked before the softmax, so they contribute exact zeros)."""
    m = cfg.mla
    b, s, _ = x.shape
    h = cfg.n_heads
    cos_t, sin_t = rope                      # (s, rope_dim/2)
    qk_dim = m.nope_dim + m.rope_dim

    q = linear(params["q_up"],
               rms_norm(params["q_norm"], linear(params["q_down"], x)))
    q = q.reshape(b, s, h, qk_dim)
    q_nope, q_rope = q[..., :m.nope_dim], q[..., m.nope_dim:]

    ckv_full = linear(params["kv_down"], x)            # (B,S,kv_lora+rope)
    c_kv, k_rope = ckv_full[..., :m.kv_lora], ckv_full[..., m.kv_lora:]
    k_rope = k_rope.reshape(b, s, 1, m.rope_dim)

    q_rope = apply_rotary(q_rope, cos_t, sin_t)
    k_rope = apply_rotary(k_rope, cos_t, sin_t)

    def expand_kv(c_kv_in, k_rope_in):
        t = c_kv_in.shape[1]
        kv = linear(params["kv_up"], rms_norm(params["kv_norm"], c_kv_in))
        kv = kv.reshape(b, t, h, m.nope_dim + m.v_dim)
        k_nope, v = kv[..., :m.nope_dim], kv[..., m.nope_dim:]
        k = torch.cat([k_nope, k_rope_in.to(k_nope.dtype).expand(
            b, t, h, m.rope_dim)], dim=-1)
        return k, v

    qfull = torch.cat([q_nope, q_rope], dim=-1)
    scale = qk_dim ** -0.5
    if mode in ("train", "prefill"):
        k, v = expand_kv(c_kv, k_rope)
        out = _chunked_attention(qfull, k, v, scale=scale, causal=True,
                                 window=cfg.window, q_chunk=cfg.attn_q_chunk)
        if mode == "prefill":
            cache = _latent_write(cache, c_kv, k_rope, 0)
    elif mode == "chunk":
        cache = _latent_write(cache, c_kv, k_rope, pos)
        k, v = expand_kv(cache["c_kv"].to(x.dtype),
                         cache["k_rope"].to(x.dtype))
        out = _chunked_attention(qfull, k, v, scale=scale, causal=True,
                                 q_chunk=cfg.attn_q_chunk, row0=pos)
    elif mode == "decode":
        if isinstance(pos, torch.Tensor) and pos.ndim:
            raise NotImplementedError(
                "per-row decode positions are not implemented for MLA "
                "caches")
        cache = _latent_write(cache, c_kv, k_rope, pos)
        ckv_all = cache["c_kv"].to(x.dtype)
        krope_all = cache["k_rope"].to(x.dtype)
        t = ckv_all.shape[1]
        mask = torch.where(torch.arange(t, device=x.device) <= pos, 0.0,
                           NEG_INF)[None, None, None, None, :]
        if m.absorb:
            out = _mla_absorbed_decode(params, qfull, ckv_all, krope_all,
                                       mask, scale, m, h)
        else:
            k, v = expand_kv(ckv_all, krope_all)
            out = _grouped_attention(qfull, k, v, mask, scale)
    else:
        raise ValueError(f"unknown attention mode {mode!r}")
    out = out.reshape(b, s, h * m.v_dim)
    return linear(params["wo"], out), cache


def _mla_absorbed_decode(params, qfull, ckv_all, krope_all, mask, scale,
                         m, h: int):
    """Weight-absorbed MLA decode: attention in the compressed kv_lora
    space (``MLAConfig.absorb``).

    scores[h,s] = (W_uk[h]ᵀ q_nope[h]) · n(c_s)  +  q_rope[h] · k_rope_s
    out[h]      = W_uv[h] @ Σ_s p[h,s] · n(c_s)

    A quantized ``kv_up`` is dequantized in the activations' dtype and
    transposed to (kv_lora, out), as the reference does; the products are
    torch ops (no kernel B launch)."""
    q_nope = qfull[..., :m.nope_dim]               # (B,1,H,nope)
    q_rope = qfull[..., m.nope_dim:]               # (B,1,H,rope)
    w_up = params["kv_up"]["w"]                    # (kv_lora, H*(nope+v))
    if isinstance(w_up, QuantizedTensor):
        w_up = w_up.dequantize(qfull.dtype).T
    w_up = w_up.reshape(m.kv_lora, h, m.nope_dim + m.v_dim)
    w_uk = w_up[..., :m.nope_dim]                  # (kv_lora, H, nope)
    w_uv = w_up[..., m.nope_dim:]                  # (kv_lora, H, v)
    ckv_n = rms_norm(params["kv_norm"], ckv_all)   # normalize once per step
    q_tilde = torch.einsum("bshn,chn->bshc", q_nope, w_uk.to(qfull.dtype))
    s_nope = torch.einsum("bshc,btc->bhst", q_tilde, ckv_n.to(qfull.dtype))
    s_rope = torch.einsum("bshr,btor->bhst", q_rope,
                          krope_all.to(qfull.dtype))
    scores = (s_nope + s_rope).to(torch.float32) * scale
    scores = scores + mask[:, :, 0]               # (B,H,1,T)
    p = torch.softmax(scores, dim=-1).to(qfull.dtype)
    attended = torch.einsum("bhst,btc->bshc", p, ckv_n.to(qfull.dtype))
    return torch.einsum("bshc,chv->bshv", attended, w_uv.to(qfull.dtype))


def init_mla_cache(batch: int, max_len: int, cfg, dtype=torch.bfloat16,
                   device=None) -> Dict[str, Any]:
    """Zeroed compressed cache: ``c_kv`` (B, max_len, kv_lora) and the
    shared rotary key ``k_rope`` (B, max_len, 1, rope_dim)."""
    m = cfg.mla
    return {"c_kv": torch.zeros((batch, max_len, m.kv_lora), dtype=dtype,
                                device=device),
            "k_rope": torch.zeros((batch, max_len, 1, m.rope_dim),
                                  dtype=dtype, device=device)}


# ---------------------------------------------------------------------------
# cross-attention (encoder-decoder)
# ---------------------------------------------------------------------------

def cross_attention(params, x, enc_out, *, cfg,
                    enc_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Attention of ``x`` (B, S, d) over the encoder output ``enc_out`` (B,
    T, d), full multi-head and unmasked, or masked by ``enc_mask`` (B, T;
    True = attend) through the grouped form. K/V are projected from
    ``enc_out`` at every call (a decode step recomputes them; there is no
    cross-KV cache, as in the reference). ``x`` and ``enc_out`` may differ
    in dtype: the products promote as ``jnp`` does, so a bfloat16 ``x``
    over a float32 ``enc_out`` gives a float32 result."""
    b, s, _ = x.shape
    hd = cfg.head_dim
    t = enc_out.shape[1]
    q = linear(params["wq"], x).reshape(b, s, cfg.n_heads, hd)
    k = linear(params["wk"], enc_out).reshape(b, t, cfg.n_heads, hd)
    v = linear(params["wv"], enc_out).reshape(b, t, cfg.n_heads, hd)
    if enc_mask is not None:
        mask = torch.where(enc_mask, 0.0, NEG_INF)[:, None, None, None, :]
        out = _grouped_attention(q, k, v, mask, hd ** -0.5)
    else:
        out = _chunked_attention(q, k, v, scale=hd ** -0.5, causal=False,
                                 q_chunk=cfg.attn_q_chunk)
    return linear(params["wo"], out.reshape(b, s, cfg.n_heads * hd))
