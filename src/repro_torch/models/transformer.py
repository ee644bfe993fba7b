"""Block assembly for uniform decoder stacks.

The stack is always the unrolled form ``{"list": [period, ...]}`` with
``period = {"b0": block}``; ``unstack_stack`` converts a stacked
``{"periods": ...}`` tree (the reference package's scan layout, leading axis
= layer) into it.

Block kind "a": x += attn(ln1(x)); x += ffn_or_moe(ln2(x)). The FFN is a
dense one or, where ``layer_plan`` says so, a mixture of experts
(``models.moe``). Mamba and rwkv blocks are not ported yet (each raises
``NotImplementedError`` naming itself).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.models import attention as attn_lib
from repro_torch.models import ffn as ffn_lib
from repro_torch.models import moe as moe_lib
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

def init_block(generator, cfg, kind: str, use_moe: bool, device=None
               ) -> Dict[str, Any]:
    if kind != "a":
        raise NotImplementedError(
            f"not ported yet: block kind {kind!r} (moe={use_moe})")
    d = cfg.d_model
    po = cfg.norm_plus_one
    p = {"ln1": init_norm(d, plus_one=po, device=device),
         "ln2": init_norm(d, plus_one=po, device=device),
         "attn": attn_lib.init_attention(generator, cfg, device=device)}
    if use_moe:
        p["moe"] = moe_lib.init_moe(generator, d, cfg.d_ff,
                                    cfg.moe.n_experts, cfg.ffn_kind,
                                    device=device)
    else:
        p["ffn"] = ffn_lib.init_ffn(generator, d, cfg.d_ff, cfg.ffn_kind,
                                    device=device)
    return p


def apply_block(p, x, *, cfg, kind: str, use_moe: bool, rope, mode: str,
                cache: Optional[dict], pos, block_tables=None
                ) -> Tuple[torch.Tensor, Optional[dict]]:
    """Returns (x, new_cache). The MoE auxiliary loss is computed and
    dropped (it matters to training only)."""
    if kind != "a":
        raise NotImplementedError(
            f"not ported yet: block kind {kind!r} (moe={use_moe})")
    po = cfg.norm_plus_one
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
    h, new_cache = attn_lib.attention(
        p["attn"], norm(p["ln1"], x), cfg=cfg, rope=rope, mode=mode,
        cache=cache, pos=pos, block_tables=block_tables)
    x = x + h
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
                dropless=mode in ("decode", "verify"))[0]
        # verify: each position's rows are a decode step's exact call
        x = x + (by_position(moe, h2) if mode == "verify" else moe(h2))
    else:
        x = x + ffn_lib.ffn(p["ffn"], h2, cfg.ffn_kind, lin=lin)
    return x, new_cache


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
                                          device=device)
                      for i, (kind, moe) in enumerate(pattern)}
                     for _ in range(n_periods(cfg))]}


def init_layer_cache(cfg, batch: int, max_len: int, kind: str,
                     quantize_kv: bool = False, dtype=torch.bfloat16,
                     device=None):
    if kind != "a":
        raise NotImplementedError(f"not ported yet: {kind!r} layer state")
    if cfg.mla is not None:
        raise NotImplementedError("not ported yet: MLA cache")
    return attn_lib.init_kv_cache(batch, max_len, cfg.n_kv_heads,
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
                block_tables=None) -> Tuple[torch.Tensor, Any]:
    """Run all layers. Returns (x, new_caches). ``pos`` is the integer clock
    of a contiguous cache or the per-slot position vector of a paged one;
    ``block_tables`` (paged decode) reaches every layer's pool."""
    if "list" not in stack:
        raise ValueError("apply_stack takes the unrolled {'list': [...]} "
                         "stack; convert a stacked tree with unstack_stack")
    pattern = layer_plan(cfg)
    needs_cache = mode in ("prefill", "decode", "chunk", "verify")
    new_list = []
    for li, pp in enumerate(stack["list"]):
        pc = caches["list"][li] if needs_cache else None
        new_c = {}
        for i, (kind, moe) in enumerate(pattern):
            c_in = None if pc is None else pc.get(f"b{i}")
            x, c_out = apply_block(pp[f"b{i}"], x, cfg=cfg, kind=kind,
                                   use_moe=moe, rope=rope, mode=mode,
                                   cache=c_in, pos=pos,
                                   block_tables=block_tables)
            if c_out is not None:
                new_c[f"b{i}"] = c_out
        new_list.append(new_c if new_c else pc)
    return x, ({"list": new_list} if needs_cache else None)
