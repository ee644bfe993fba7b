"""In-house AdamW, leaf by leaf on nested dicts and lists of tensors.

States (m, v) are float32 whatever the parameter's dtype (bfloat16 params
train stably with float32 moments); the update runs in float32 and is cast
back to each parameter's dtype. The schedule, the global norm and the bias
corrections are 0-d float32 tensors on the parameters' device, so a step
reads nothing back to the host.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0
    warmup_steps: int = 100
    decay_steps: int = 10_000
    min_lr_ratio: float = 0.1


def tree_leaves(tree: Any) -> List[torch.Tensor]:
    """The tensors of a tree of dicts and lists, dict keys in sorted order
    (the reference's flattening order)."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in tree_leaves(v)]
    return [tree]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and of the trees of the same
    structure in ``rest``; the structure (dict key order too) is kept."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def adamw_init(params: Any) -> Dict[str, Any]:
    """Zero float32 moments shaped like ``params`` on their devices, and the
    step counter, a 0-d int32 tensor."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    dev = tree_leaves(params)[0].device
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    """A 0-d float32 tensor on ``like``'s device, made there (no host copy).
    Dividing by it is a true division on every device (on a CUDA tensor
    PyTorch divides by a Python number as a multiplication by its float32
    reciprocal)."""
    return torch.full((), float(x), dtype=torch.float32, device=like.device)


def _schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Learning rate at ``step`` (0-d int32): linear warmup, then cosine
    decay to ``min_lr_ratio`` at ``decay_steps``; a 0-d float32 tensor."""
    s = step.to(torch.float32)
    warm = torch.clamp_max((s + 1) / _f32(max(cfg.warmup_steps, 1), s), 1.0)
    prog = torch.clamp((s - cfg.warmup_steps)
                       / _f32(max(cfg.decay_steps - cfg.warmup_steps, 1), s),
                       0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32."""
    leaves = tree_leaves(tree)
    total = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    for g in leaves:
        total = total + torch.sum(torch.square(g.to(torch.float32)))
    return torch.sqrt(total)


def decay_mask(params: Any, stacked: bool = False) -> Any:
    """Which leaves of ``params`` take weight decay (a tree of bools): those
    of two or more dimensions in the reference's layout. With ``stacked``
    (the reference's ``scan_layers`` stack of more than one period) a leaf
    of ``params["stack"]["list"]`` has the layer axis in front there, so a
    1-D norm gain is a (periods, d) leaf and decays. An encoder-decoder's
    encoder layers (``params["encoder"]["layers"]``) are stacked there
    whatever the config says, so their norm gains always decay."""
    mask = tree_map(lambda p: p.ndim >= 2, params)
    if not isinstance(params, dict):
        return mask
    if stacked and "list" in params.get("stack", {}):
        mask["stack"] = dict(mask["stack"], list=tree_map(
            lambda p: p.ndim >= 1, params["stack"]["list"]))
    if "layers" in params.get("encoder", {}):
        mask["encoder"] = dict(mask["encoder"], layers=tree_map(
            lambda p: p.ndim >= 1, params["encoder"]["layers"]))
    return mask


def adamw_update(params: Any, grads: Any, state: Dict[str, Any],
                 cfg: AdamWConfig, decay: Any = None
                 ) -> Tuple[Any, Dict[str, Any], Dict]:
    """One AdamW step: gradients clipped to ``clip_norm`` by their global
    norm, bias-corrected moments, decoupled weight decay on the leaves that
    ``decay`` (a tree of bools, :func:`decay_mask`) marks; by default on
    leaves of two or more dimensions only. Returns (new params, new state,
    {"lr", "grad_norm"}); the inputs are not modified."""
    if decay is None:
        decay = decay_mask(params)
    step = state["step"]
    lr = _schedule(cfg, step)
    gnorm = global_norm(grads)
    if cfg.clip_norm is not None:
        scale = torch.clamp_max(_f32(cfg.clip_norm, gnorm)
                                / (gnorm + 1e-9), 1.0)
    else:
        scale = None
    t = (step + 1).to(torch.float32)
    bc1 = 1 - torch.pow(_f32(cfg.b1, t), t)
    bc2 = 1 - torch.pow(_f32(cfg.b2, t), t)

    def upd(p, g, m, v, d):
        g = g.to(torch.float32)
        if scale is not None:
            g = g * scale
        m = cfg.b1 * m + (1 - cfg.b1) * g
        v = cfg.b2 * v + (1 - cfg.b2) * g * g
        u = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        if d:                                # decoupled WD
            u = u + cfg.weight_decay * p.to(torch.float32)
        newp = p.to(torch.float32) - lr * u
        return newp.to(p.dtype), m, v

    # leaves of ``new`` are (param, m, v) triples in ``params``' structure
    new = tree_map(upd, params, grads, state["m"], state["v"], decay)
    new_p, new_m, new_v = (tree_map(lambda _, o: o[i], params, new)
                           for i in range(3))
    new_state = {"m": new_m, "v": new_v, "step": step + 1}
    return new_p, new_state, {"lr": lr, "grad_norm": gnorm}
