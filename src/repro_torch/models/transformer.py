"""Block assembly: uniform decoder stacks, hybrid (Jamba) period stacks,
RWKV stacks, and the encoder-decoder's encoder and cross-attention.

The stack is always the unrolled form ``{"list": [period, ...]}`` with
``period = {"b0": block, "b1": block, ...}`` (one block per entry of
``layer_plan``); ``unstack_stack`` converts a stacked ``{"periods": ...}``
tree (the reference package's scan layout, leading axis = period) into it.

Block kinds:
  "a"    attention block : x += attn(ln1(x)); x += ffn_or_moe(ln2(x))
  "m"    mamba block     : x += mamba(ln1(x)); x += ffn_or_moe(ln2(x))
  "rwkv" rwkv block      : x += timemix(ln1(x)); x += channelmix(ln2(x))

The attention is grouped-query (dense or sliding-window) or MLA
(``models.attention``); the FFN is a dense one or, where ``layer_plan``
says so, a mixture of experts (``models.moe``). A mamba or rwkv layer's
cache is its recurrent state (``models.mamba``, ``models.rwkv``).

Tensor-parallel (under ``distributed.sharding.activate_mesh`` with a
'model' axis above 1; every block kind): the normed input of the mixer
(attention, mamba, rwkv's time and channel mix) and of the FFN enters the
column-parallel products through ``to_model``, and each block's
row-parallel partial sum ``h`` is summed over 'model' before the residual
add (``shard_act``; summing after the add would count ``x`` once per
rank). rwkv's channel mix sums its own (its ``wr`` gate multiplies the
sum) and returns its output whole. Heads and FFN widths 'model' does not
divide lie on replica groups (``sharding.replica_groups``; the attention's
and the FFN's own docstrings), so each still adds one copy to the sum. An
MoE FFN is expert-parallel there: its partial output (this rank's
experts) is summed the same way.

An encoder-decoder config (``cfg.is_encdec``) gives each decoder block a
cross-attention over the encoder output (``xln``, ``xattn``: x +=
xattn(xln(x), enc_out), after the self-attention and before the FFN), and
the model an encoder (:func:`init_encoder`, :func:`apply_encoder`):
bidirectional attention blocks over precomputed frame embeddings, held as a
list of layers ``{"layers": [layer, ...], "final_norm": ...}`` (the
reference stacks them; ``convert.from_jax_params`` unrolls its tree).
Under 'model' the encoder's layers and each cross-attention run like the
decoder's blocks (this rank's heads and FFN columns, the partial sums
summed before the residual add); the encoder's output is whole on every
rank.

FSDP (ZeRO-3) over 'data' (under a train step's
``distributed.sharding.activate_fsdp``): each period's parameters, and
each encoder layer's, are gathered over 'data' where it starts
(``sharding.gather_params``), inside its remat region, so the backward's
recompute gathers them again instead of keeping them, and their
gradients leave as this rank's reduce-scattered shards. Under FSDP a
period always recomputes, whatever ``cfg.remat`` says: a rank holds its
shards and one period's gathered leaves, never the whole gathered tree.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.utils.checkpoint

from repro_torch.distributed.sharding import (activate_fsdp, activate_mesh,
                                              activate_routing, current_fsdp,
                                              current_mesh, current_routing,
                                              gather_params, model_axis,
                                              replica_groups, shard_act,
                                              to_model)
from repro_torch.models import attention as attn_lib
from repro_torch.models import ffn as ffn_lib
from repro_torch.models import mamba as mamba_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models import rwkv as rwkv_lib
from repro_torch.models.layers import (by_position, init_norm, linear,
                                       linear_by_position, rms_norm, rope)


def rope_values(positions: torch.Tensor, rope_dim: int, theta: float,
                dtype=torch.float32) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions: (S,) shared across the batch, or (B, S) per-row. Returns
    cos/sin of shape ``positions.shape + (rope_dim//2,)``."""
    return rope(positions, rope_dim, theta, dtype)


def _rope_dim(cfg) -> int:
    return cfg.mla.rope_dim if cfg.mla is not None else cfg.head_dim


# ---------------------------------------------------------------------------
# single block
# ---------------------------------------------------------------------------

def init_block(generator, cfg, kind: str, use_moe: bool,
               cross: bool = False, device=None) -> Dict[str, Any]:
    d = cfg.d_model
    po = cfg.norm_plus_one
    p = {"ln1": init_norm(d, plus_one=po, device=device),
         "ln2": init_norm(d, plus_one=po, device=device)}
    if cross:
        p["xln"] = init_norm(d, plus_one=po, device=device)
        p["xattn"] = attn_lib.init_cross_attention(generator, cfg,
                                                   device=device)
    if kind == "a":
        p["attn"] = attn_lib.init_attention(generator, cfg, device=device)
    elif kind == "m":
        m = cfg.mamba
        p["mixer"] = mamba_lib.init_mamba(
            generator, d, d_state=m.d_state, d_conv=m.d_conv,
            expand=m.expand, dt_rank=m.dt_rank, device=device)
    elif kind == "rwkv":
        p["tm"] = rwkv_lib.init_rwkv_timemix(generator, d, cfg.rwkv_head_dim,
                                             device=device)
        p["cm"] = rwkv_lib.init_rwkv_channelmix(generator, d, cfg.d_ff,
                                                device=device)
        return p
    else:
        raise ValueError(kind)
    if use_moe:
        p["moe"] = moe_lib.init_moe(generator, d, cfg.d_ff,
                                    cfg.moe.n_experts, cfg.ffn_kind,
                                    device=device)
    else:
        p["ffn"] = ffn_lib.init_ffn(generator, d, cfg.d_ff, cfg.ffn_kind,
                                    device=device)
    return p


def apply_block(p, x, *, cfg, kind: str, use_moe: bool, rope, mode: str,
                cache: Optional[dict], pos, enc_out=None, block_tables=None
                ) -> Tuple[torch.Tensor, Optional[dict],
                           Optional[torch.Tensor]]:
    """Returns (x, new_cache, moe_aux): the MoE load-balancing loss of this
    block (a float32 0-d tensor), None for a dense FFN and in verify
    mode. A block with ``xattn`` attends over ``enc_out`` after its
    self-attention; a float32 ``enc_out`` promotes a bfloat16 residual
    stream to float32 there, as in the reference."""
    aux = None
    if mode == "verify" and kind != "a":
        # the speculative multi-position verify scores every draft row as
        # if it were a lockstep decode step; a recurrent mixer would need a
        # per-row state rewind for that, so verify stays attention-only
        raise NotImplementedError(
            f"{mode!r} mode is not implemented for {kind!r} blocks")
    po = cfg.norm_plus_one
    if kind == "rwkv":
        h, st_tm = rwkv_lib.rwkv_timemix(
            p["tm"], to_model(rms_norm(p["ln1"], x, plus_one=po)),
            head_dim=cfg.rwkv_head_dim, chunk=cfg.rwkv_chunk, state=cache,
            mode=mode)
        x = x + shard_act(h)
        h, st_cm = rwkv_lib.rwkv_channelmix(
            p["cm"], to_model(rms_norm(p["ln2"], x, plus_one=po)),
            state=cache, mode=mode)
        x = x + h
        new_cache = None
        if st_tm is not None:
            new_cache = {**st_tm, **(st_cm or {})}
        return x, new_cache, aux
    if mode == "verify":
        # the norms and products position by position (a decode step's
        # calls, see attention's verify mode); residual adds and the
        # activation on all rows
        def norm(g, t):
            return by_position(lambda u: rms_norm(g, u, plus_one=po), t)
        lin = linear_by_position
    else:
        def norm(g, t):
            return rms_norm(g, t, plus_one=po)
        lin = linear
    if kind == "a":
        h, new_cache = attn_lib.attention(
            p["attn"], to_model(norm(p["ln1"], x)), cfg=cfg, rope=rope,
            mode=mode, cache=cache, pos=pos, block_tables=block_tables)
    else:  # mamba
        h, new_cache = mamba_lib.mamba(
            p["mixer"], to_model(norm(p["ln1"], x)),
            d_state=cfg.mamba.d_state, state=cache, mode=mode,
            chunk=cfg.mamba_chunk,
            dt_rank=cfg.mamba.dt_rank or max(1, cfg.d_model // 16))
    x = x + shard_act(h)
    if "xattn" in p:
        # enc_out, whole on every rank, entered through to_model once
        # (models.model)
        x = x + shard_act(attn_lib.cross_attention(
            p["xattn"], to_model(rms_norm(p["xln"], x, plus_one=po)),
            enc_out, cfg=cfg))
    h2 = norm(p["ln2"], x)
    if use_moe:
        # dropless at decode and verify: with no capacity competition each
        # token's expert mix does not depend on its batch; prefill and chunk
        # route with capacity, per chunk (the "moe" agreement budget)
        def moe(t):
            return moe_lib.moe_ffn(
                p["moe"], t, n_experts=cfg.moe.n_experts,
                top_k=cfg.moe.top_k, kind=cfg.ffn_kind,
                capacity_factor=cfg.moe.capacity_factor,
                dropless=mode in ("decode", "verify"))
        # under 'model' the experts' output is this rank's partial sum
        # (moe_ffn puts the experts' input through to_model itself: the
        # router's input must not be, see models.moe)
        if mode == "verify":
            # each position's rows are a decode step's exact call (the aux
            # loss of a serving forward is not used)
            x = x + shard_act(by_position(lambda t: moe(t)[0], h2))
        else:
            y, aux = moe(h2)
            x = x + shard_act(y)
    else:
        h = ffn_lib.ffn(p["ffn"], to_model(h2), cfg.ffn_kind, lin=lin,
                        d_ff=cfg.d_ff)
        x = x + shard_act(h)
    return x, new_cache, aux


# ---------------------------------------------------------------------------
# layer pattern
# ---------------------------------------------------------------------------

def layer_plan(cfg) -> Tuple[Tuple[str, bool], ...]:
    """(kind, use_moe) per layer in one stack period."""
    if cfg.rwkv:
        pattern = (("rwkv", False),)
    elif cfg.block_pattern is not None:
        period = len(cfg.block_pattern)
        moe_every = cfg.moe.every if cfg.moe else 0
        pattern = tuple(
            (k, bool(moe_every) and (i % moe_every == moe_every - 1))
            for i, k in enumerate(cfg.block_pattern))
        assert cfg.n_layers % period == 0
    elif cfg.moe is not None and cfg.moe.every > 1:
        ev = cfg.moe.every
        pattern = tuple(("a", i % ev == ev - 1) for i in range(ev))
    elif cfg.moe is not None:
        pattern = (("a", True),)
    else:
        pattern = (("a", False),)
    return pattern


def n_periods(cfg) -> int:
    return cfg.n_layers // len(layer_plan(cfg))


# ---------------------------------------------------------------------------
# stack init / apply
# ---------------------------------------------------------------------------

def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def unstack_stack(stack: Dict[str, Any], periods: int) -> Dict[str, Any]:
    """{"periods": stacked} → {"list": [...]}: the converter for trees whose
    leaves carry a leading layer axis."""
    if "list" in stack:
        return stack
    return {"list": [_tree_map(lambda a: a[i], stack["periods"])
                     for i in range(periods)]}


def init_stack(generator, cfg, device=None) -> Dict[str, Any]:
    pattern = layer_plan(cfg)
    return {"list": [{f"b{i}": init_block(generator, cfg, kind, moe,
                                          cross=cfg.is_encdec, device=device)
                      for i, (kind, moe) in enumerate(pattern)}
                     for _ in range(n_periods(cfg))]}


def init_layer_cache(cfg, batch: int, max_len: int, kind: str,
                     quantize_kv: bool = False, dtype=torch.bfloat16,
                     device=None):
    """One layer's cache: an rwkv layer's token-shift rows (in ``dtype``)
    and wkv state (float32), a mamba layer's state (float32 ``h`` and
    ``conv`` tail), an MLA stack's compressed cache (taken before
    ``quantize_kv`` is read, as in the reference: an MLA cache stays in the
    model dtype whatever ``quantize_kv`` says), else K/V, a ring of
    ``min(max_len, window)`` slots under a sliding window. Under a
    'model' axis the heads and channels are this rank's: the KV heads,
    rwkv's wkv heads and mamba's ``d_inner`` (the token-shift rows and an
    MLA cache stay whole). The KV heads are this rank's replica-group
    shard: ``n_kv / gcd(n_kv, tp)`` heads (``sharding.replica_groups``),
    held alike by the ``tp / gcd(n_kv, tp)`` ranks that share them, where
    the reference's cache rule puts 'model' on ``head_dim`` instead."""
    tp = model_axis()[0]
    if kind == "rwkv":
        d, hd = cfg.d_model, cfg.rwkv_head_dim
        return {"x_tm": torch.zeros((batch, d), dtype=dtype, device=device),
                "x_cm": torch.zeros((batch, d), dtype=dtype, device=device),
                "wkv": torch.zeros((batch, d // hd // tp, hd, hd),
                                   dtype=torch.float32, device=device)}
    if kind == "m":
        m = cfg.mamba
        return mamba_lib.init_mamba_state(
            batch, cfg.d_model, m.d_state, m.d_conv, m.expand,
            device=device, d_inner=m.expand * cfg.d_model // tp)
    if cfg.mla is not None:
        # whole on every rank under 'model' (see models.attention)
        return attn_lib.init_mla_cache(batch, max_len, cfg, dtype,
                                       device=device)
    kv = cfg.n_kv_heads // replica_groups(cfg.n_kv_heads, tp)[0]
    return attn_lib.init_kv_cache(batch, max_len, kv,
                                  cfg.head_dim, dtype, quantize_kv,
                                  cfg.window, device=device)


def init_cache(cfg, batch: int, max_len: int, quantize_kv: bool = False,
               dtype=torch.bfloat16, device=None) -> Dict[str, Any]:
    pattern = layer_plan(cfg)
    caches = {"list": [{f"b{i}": init_layer_cache(cfg, batch, max_len, kind,
                                                   quantize_kv, dtype, device)
                        for i, (kind, _) in enumerate(pattern)}
                       for _ in range(n_periods(cfg))]}
    caches["pos"] = 0            # the batch's shared clock, a host integer
    return caches


def apply_stack(stack, x, *, cfg, rope, mode: str, caches, pos,
                enc_out=None, block_tables=None
                ) -> Tuple[torch.Tensor, Any, Optional[torch.Tensor]]:
    """Run all layers. Returns (x, new_caches, moe_aux): in train mode the
    mean over periods of each period's summed MoE aux loss (a float32 0-d
    tensor, zero for a dense stack), else None. ``pos`` is the integer
    clock of a contiguous cache or the per-slot position vector of a paged
    one; ``block_tables`` (paged decode) reaches every layer's pool;
    ``enc_out`` (an encoder-decoder's encoder output) every cross-attention.

    In train mode with ``cfg.remat`` and autograd recording, each period
    runs under ``torch.utils.checkpoint`` (the reference's
    ``jax.checkpoint``): its activations are recomputed in the backward
    pass instead of kept, which changes memory, not numbers."""
    if "list" not in stack:
        raise ValueError("apply_stack takes the unrolled {'list': [...]} "
                         "stack; convert a stacked tree with unstack_stack")
    pattern = layer_plan(cfg)
    needs_cache = mode in ("prefill", "decode", "chunk", "verify")

    # the aux loss is summed in train mode only: a serving forward does not
    # use it, and the sums would add kernels to every captured step
    train = mode == "train"

    def run_period(pp, xin, pc):
        pp = gather_params(pp)
        aux_sum = torch.zeros((), dtype=torch.float32, device=xin.device) \
            if train else None
        new_c = {}
        for i, (kind, moe) in enumerate(pattern):
            c_in = None if pc is None else pc.get(f"b{i}")
            xin, c_out, aux = apply_block(pp[f"b{i}"], xin, cfg=cfg,
                                          kind=kind, use_moe=moe, rope=rope,
                                          mode=mode, cache=c_in, pos=pos,
                                          enc_out=enc_out,
                                          block_tables=block_tables)
            if train and aux is not None:
                aux_sum = aux_sum + aux
            if c_out is not None:
                new_c[f"b{i}"] = c_out
        return xin, new_c, aux_sum

    # the backward pass may recompute a period on another thread (CUDA's
    # autograd worker): it runs under the mesh, routing group and FSDP plan
    # active here
    mesh, routing, fsdp = current_mesh(), current_routing(), current_fsdp()
    # under FSDP a period always recomputes: what frees its gathered leaves
    remat = train and (cfg.remat or fsdp is not None) and \
        torch.is_grad_enabled()

    def recompute(p_, x_):
        with activate_mesh(mesh), activate_routing(routing), \
                activate_fsdp(fsdp):
            return run_period(p_, x_, None)[::2]
    new_list = []
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device) \
        if train else None
    for li, pp in enumerate(stack["list"]):
        pc = caches["list"][li] if needs_cache else None
        if remat:
            x, aux = torch.utils.checkpoint.checkpoint(
                recompute, pp, x, use_reentrant=False)
            new_c = None
        else:
            x, new_c, aux = run_period(pp, x, pc)
        if train:
            aux_total = aux_total + aux
        new_list.append(new_c if new_c else pc)
    aux = aux_total / max(len(stack["list"]), 1) if train else None
    return x, ({"list": new_list} if needs_cache else None), aux


# ---------------------------------------------------------------------------
# encoder (seamless: bidirectional over stubbed frame embeddings)
# ---------------------------------------------------------------------------

def init_encoder(generator, cfg, device=None) -> Dict[str, Any]:
    """``cfg.encoder_layers`` blocks of full multi-head self-attention and
    an FFN of ``cfg.ffn_kind``, as a list, and the final norm."""
    d = cfg.d_model

    def one():
        return {"ln1": init_norm(d, device=device),
                "attn": attn_lib.init_cross_attention(generator, cfg,
                                                      device=device),
                "ln2": init_norm(d, device=device),
                "ffn": ffn_lib.init_ffn(generator, d, cfg.d_ff, cfg.ffn_kind,
                                        device=device)}

    return {"layers": [one() for _ in range(cfg.encoder_layers)],
            "final_norm": init_norm(d, device=device)}


def apply_encoder(enc, frames, *, cfg) -> torch.Tensor:
    """frames: (B, T, d) precomputed frontend embeddings (the audio
    frontend is a stub) → (B, T, d) in ``frames``' dtype. Unmasked
    attention, no rotary (the reference computes a rope it never uses) and
    norms without ``plus_one``, as in the reference. With ``cfg.remat`` and
    autograd recording, each layer runs under ``torch.utils.checkpoint``
    (the reference's ``jax.checkpoint`` of its scan body). Under 'model'
    each layer runs this rank's heads and FFN columns, as a decoder block
    does (:func:`apply_block`), and the output is whole on every rank."""
    def body(pp, x):
        pp = gather_params(pp)
        h = to_model(rms_norm(pp["ln1"], x))
        x = x + shard_act(attn_lib.cross_attention(pp["attn"], h, h,
                                                   cfg=cfg))
        return x + shard_act(ffn_lib.ffn(
            pp["ffn"], to_model(rms_norm(pp["ln2"], x)), cfg.ffn_kind,
            d_ff=cfg.d_ff))

    # the backward pass may recompute a layer on another thread (CUDA's
    # autograd worker): it runs under the mesh and FSDP plan active here
    mesh, fsdp = current_mesh(), current_fsdp()

    def recompute(pp, x):
        with activate_mesh(mesh), activate_fsdp(fsdp):
            return body(pp, x)
    remat = (cfg.remat or fsdp is not None) and torch.is_grad_enabled()
    x = frames
    for pp in enc["layers"]:
        if remat:
            x = torch.utils.checkpoint.checkpoint(recompute, pp, x,
                                                  use_reentrant=False)
        else:
            x = body(pp, x)
    return rms_norm(enc["final_norm"], x)
