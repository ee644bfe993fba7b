"""Model-level on-the-fly quantization of a whole parameter tree.

Walks a parameter tree (nested dicts / lists of tensors), quantizes every
matmul weight with the requested data-free method, and returns
(new_tree, report). This is the "on-the-fly framework" of Sec. 3.4: no data,
no back-prop, wall time recorded (Table 3's protocol).

Execution modes:

* ``batched=True`` (default) — leaves are grouped into same-(2-D view shape,
  dtype, group) buckets (``plan_buckets``); each bucket is quantized with ONE
  asynchronous dispatch, and the whole tree synchronizes with the device
  ONCE at the end. On a CUDA device a bucket of 2-D float32 leaves takes the
  *native* route: the kernels read the ``(in, out)`` leaves where they are
  stored, one scale pass and one flip launch per bucket, nothing stacked.
  Every other bucket (conv and expert leaves, other dtypes, the whole-row
  and E&C-without-K configurations, RTN, and every bucket on the CPU) takes
  the *stacked* route: the ``(out, in)`` views are stacked, in chunks of at
  most ``_MAX_STACK_BYTES``, and quantized as rows (see ``core.dispatch``).
  ``QuantReport`` carries the per-bucket wall times and routes plus a
  dispatch/sync breakdown.
* ``batched=False`` — the per-layer reference path: one quantization call and
  one device sync per leaf, always through the torch core. Kept as the
  bit-exactness oracle and the serial baseline.

``backend`` selects the implementation for the batched path
(``"auto" | "ref" | "cuda"``, see ``core.dispatch.BACKENDS``).

Conventions (shared with ``repro_torch.models``):
* dense kernels are dict leaves named ``w`` with shape (in, out);
* expert kernels are named ``w`` with shape (experts, in, out);
* conv kernels (test CNNs) are named ``w_conv`` with shape (KH, KW, in, out);
* 1-D vectors (norm gains, biases) are never quantized.

SQuant semantics: rows are OUTPUT channels, so (in, out) kernels are
transposed to (out, in) before quantization. The stored QuantizedTensor keeps
the (out, in) layout — the serving layer (``models.layers.linear`` /
``kernels.dequant_matmul``) consumes it directly.

Dict keys are visited in sorted order and list items by index, so bucket and
report order do not depend on how a tree was assembled.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core.dispatch import (quantize_codes_batched,
                                       quantize_codes_native, resolve_backend)
from repro_torch.quant.qtypes import (BucketReport, LayerReport, QuantReport,
                                      from_codes)

METHODS = ("rtn", "squant", "squant_e", "squant_ek", "squant_ec")


def _sync(device: torch.device) -> None:
    """Wait for the work issued on the calling thread's stream (all of a
    quantization's; a device-wide synchronization would also wait for, and
    on another thread's CUDA-graph capture, disturb, other streams).
    Module-level so tests can count synchronizations: the batched path
    calls this exactly once per ``quantize_tree``, the serial path once per
    quantized leaf."""
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()


def is_quantizable(path: Tuple[str, ...], leaf: Any) -> bool:
    if not isinstance(leaf, torch.Tensor):
        return False
    if "router" in path:       # MoE routers: tiny + precision-sensitive
        return False
    name = path[-1] if path else ""
    if name == "w" and leaf.ndim in (2, 3):
        return True
    if name == "w_conv" and leaf.ndim == 4:
        return True
    return False


# ---------------------------------------------------------------------------
# tree walking (nested dict / list / tuple; everything else is a leaf)
# ---------------------------------------------------------------------------

def _flatten(tree: Any, path: Tuple[str, ...] = ()) -> List[Tuple[Tuple, Any]]:
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(_flatten(tree[k], path + (str(k),)))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out.extend(_flatten(v, path + (str(i),)))
        return out
    return [(path, tree)]


def _rebuild(tree: Any, leaves) -> Any:
    """Same structure as ``tree`` with leaves taken from the iterator, in
    ``_flatten`` order."""
    if isinstance(tree, dict):
        new = {k: _rebuild(tree[k], leaves) for k in sorted(tree)}
        return {k: new[k] for k in tree}          # keep the caller's key order
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, leaves) for v in tree)
    return next(leaves)


# ---------------------------------------------------------------------------
# Leaf planning: every quantizable leaf maps to a 2-D (out, in)-major view
# ---------------------------------------------------------------------------

def _view_shape(shape: Tuple[int, ...], method: str,
                group_size: Optional[int]
                ) -> Tuple[Tuple[int, int], Tuple[int, ...], Optional[int]]:
    """Return ``((M, N), qt_shape, eff_group)`` for a kernel leaf's shape:
    its ``(out, in)``-major 2-D view, the stored QuantizedTensor shape, and
    the effective group.

    ``eff_group`` mirrors the clamping in ``core.squant.squant`` exactly
    (group >= row length degenerates to the whole-row FC path; conv kernels
    use K=KH*KW as the natural group) so batched results are bit-identical to
    the per-layer path.
    """
    if len(shape) == 2:                      # (in, out) -> (out, in)
        mn = qt_shape = (shape[1], shape[0])
    elif len(shape) == 3:                    # (E, in, out) -> (E*out, in)
        e, i, o = shape
        mn = qt_shape = (e * o, i)
    elif len(shape) == 4:                    # conv (KH,KW,in,out) -> (out, in*K)
        kh, kw, ci, co = shape
        k = kh * kw
        if method == "rtn":
            return (co, ci * k), (co, ci * k), None
        return (co, ci * k), (co, ci, k), (None if k == 1 else k)
    else:
        raise ValueError(f"unsupported kernel rank {len(shape)}")
    if method == "rtn":
        return mn, qt_shape, None
    eff = None if (group_size is None or group_size >= mn[1]) else group_size
    return mn, qt_shape, eff


def _plan_leaf(leaf: torch.Tensor, method: str, group_size: Optional[int]
               ) -> Tuple[torch.Tensor, Tuple[int, ...], Optional[int]]:
    """Return ``(w2d, qt_shape, eff_group)`` for one kernel leaf: the
    ``(out, in)``-major view of ``_view_shape``."""
    mn, qt_shape, eff = _view_shape(tuple(leaf.shape), method, group_size)
    if leaf.ndim == 2:
        w2d = leaf.T
    elif leaf.ndim == 3:
        w2d = leaf.permute(0, 2, 1).reshape(mn)
    else:
        w2d = leaf.permute(3, 2, 0, 1).reshape(mn)
    return w2d, qt_shape, eff


# ---------------------------------------------------------------------------
# Bucket planning: a pure function of the leaves' shapes and dtypes
# ---------------------------------------------------------------------------

# Cap on the transient buffer of a stacked bucket: buckets whose stack would
# exceed this many bytes are dispatched in chunks, bounding peak memory at
# params + one chunk instead of params + the largest bucket. Still one device
# sync per tree.
_MAX_STACK_BYTES = 1 << 30

# methods whose flip the kernel implements (E, E&K, E&K&C)
_NATIVE_METHODS = ("squant", "squant_e", "squant_ek")


@dataclasses.dataclass
class BucketPlan:
    """One bucket: its key ``((M, N), dtype, eff_group)``, the positions of
    its leaves in the planned list, its route (``"native"`` or
    ``"stacked"``) and the dispatches it takes (``chunks``, lists of
    positions; one for a native bucket)."""
    key: Tuple
    entries: List[int]
    route: str
    chunks: List[List[int]]


def plan_buckets(leaves: Sequence[Tuple[Tuple[int, ...], str, int, bool]],
                 method: str, group_size: Optional[int], native: bool
                 ) -> List[BucketPlan]:
    """Group leaves given as ``(shape, dtype name, element size,
    contiguous)`` into buckets, in first-seen order, and route each.

    A bucket is native when ``native`` (a CUDA device under the kernel
    backend) and every leaf in it is a contiguous 2-D float32 ``(in, out)``
    leaf of a grouped, kernel-implemented method; it is then one dispatch.
    Any other bucket is stacked, in chunks of at most ``_MAX_STACK_BYTES``
    of stacked weights.
    """
    groups: Dict[Tuple, List[int]] = {}
    ok: Dict[Tuple, bool] = {}
    sizes: Dict[Tuple, int] = {}
    for pos, (shape, dtype, itemsize, contiguous) in enumerate(leaves):
        mn, _, eff = _view_shape(tuple(shape), method, group_size)
        key = (mn, dtype, eff)
        groups.setdefault(key, []).append(pos)
        sizes[key] = mn[0] * mn[1] * itemsize
        ok[key] = ok.get(key, True) and native and len(shape) == 2 \
            and dtype == "float32" and contiguous and eff is not None \
            and method in _NATIVE_METHODS
    plans = []
    for key, pos in groups.items():
        if ok[key]:
            plans.append(BucketPlan(key, pos, "native", [pos]))
            continue
        chunk = max(1, min(len(pos), _MAX_STACK_BYTES // max(sizes[key], 1)))
        plans.append(BucketPlan(key, pos, "stacked",
                                [pos[c:c + chunk]
                                 for c in range(0, len(pos), chunk)]))
    return plans


def _restore_dense(wq: torch.Tensor, leaf_shape: Tuple[int, ...]
                   ) -> torch.Tensor:
    """Fake-quant restore: (out, in)-major dequantized weights -> leaf layout."""
    if len(leaf_shape) == 2:
        return wq.T
    if len(leaf_shape) == 3:
        e, i, o = leaf_shape
        return wq.reshape(e, o, i).permute(0, 2, 1)
    kh, kw, ci, co = leaf_shape
    return wq.reshape(co, ci, kh, kw).permute(2, 3, 1, 0)


# ---------------------------------------------------------------------------
# Serial per-layer path (one dispatch + one device sync per leaf)
# ---------------------------------------------------------------------------

def _quantize_tree_serial(flat, pred, method, bits, group_size,
                          scale_method, dequantize, device):
    """Per-layer baseline: same dispatch helpers as the batched path, called
    with B=1 and synchronized after every leaf."""
    out_leaves = []
    reports: List[LayerReport] = []
    t_total = 0.0
    for path, leaf in flat:
        if not pred(path, leaf):
            out_leaves.append(leaf)
            continue
        t0 = time.perf_counter()
        leaf = leaf.to(device)
        w2d, qt_shape, eff = _plan_leaf(leaf, method, group_size)
        codes, scales = quantize_codes_batched(
            w2d[None], method=method, bits=bits, group_size=eff,
            scale_method=scale_method, backend="ref")
        qt = from_codes(codes[0].reshape(qt_shape), scales[0], bits)
        _sync(device)
        ms = (time.perf_counter() - t0) * 1e3
        t_total += ms
        reports.append(LayerReport("/".join(path), tuple(leaf.shape), ms,
                                   method, bits))
        if dequantize:
            out_leaves.append(_restore_dense(qt.dequantize(leaf.dtype),
                                             tuple(leaf.shape)))
        else:
            out_leaves.append(qt)
    return out_leaves, QuantReport(reports, t_total, method, bits,
                                   backend="ref")


# ---------------------------------------------------------------------------
# Batched path: one dispatch per bucket (or stack chunk) -> one sync total
# ---------------------------------------------------------------------------

def _quantize_tree_batched(flat, pred, method, bits, group_size,
                           scale_method, dequantize, backend, device):
    t_begin = time.perf_counter()
    out_leaves: List[Any] = [None] * len(flat)
    todo = []                                  # (leaf index, path, leaf)
    for idx, (path, leaf) in enumerate(flat):
        if not pred(path, leaf):
            out_leaves[idx] = leaf
            continue
        todo.append((idx, path, leaf.to(device)))
    plans = plan_buckets(
        [(tuple(leaf.shape), str(leaf.dtype).replace("torch.", ""),
          leaf.element_size(), leaf.is_contiguous()) for _, _, leaf in todo],
        method, group_size, native=device.type == "cuda" and backend == "cuda")

    layer_reports: List[LayerReport] = []
    bucket_reports: List[BucketReport] = []
    for plan in plans:
        eff = plan.key[2]
        for chunk in plan.chunks:
            entries = [todo[p] for p in chunk]
            tag = f"({plan.key[0][0]},{plan.key[0][1]})x{len(entries)} " \
                  f"{plan.key[1]} g{eff}"
            tb0 = time.perf_counter()
            if plan.route == "native":
                codes, scales = quantize_codes_native(
                    [e[2] for e in entries], method=method, bits=bits,
                    group_size=eff, scale_method=scale_method,
                    backend=backend)
            else:
                views = [_plan_leaf(e[2], method, group_size)[0]
                         for e in entries]
                # a singleton needs no stack
                ws = views[0][None] if len(views) == 1 else torch.stack(views)
                codes, scales = quantize_codes_batched(
                    ws, method=method, bits=bits, group_size=eff,
                    scale_method=scale_method, backend=backend)
            for bi, (idx, path, leaf) in enumerate(entries):
                qt_shape = _view_shape(tuple(leaf.shape), method,
                                       group_size)[1]
                qt = from_codes(codes[bi].reshape(qt_shape), scales[bi], bits)
                if dequantize:
                    out = _restore_dense(qt.dequantize(leaf.dtype),
                                         tuple(leaf.shape))
                else:
                    out = qt
                out_leaves[idx] = out
            bucket_ms = (time.perf_counter() - tb0) * 1e3
            bucket_reports.append(BucketReport(tag, len(entries), bucket_ms,
                                               route=plan.route))
            for idx, path, leaf in entries:
                layer_reports.append(LayerReport("/".join(path),
                                                 tuple(leaf.shape),
                                                 bucket_ms / len(entries),
                                                 method, bits, bucket=tag))
    dispatch_ms = (time.perf_counter() - t_begin) * 1e3

    t_sync0 = time.perf_counter()
    _sync(device)                             # the ONE device sync
    sync_ms = (time.perf_counter() - t_sync0) * 1e3
    # fold the sync into per-layer numbers so Σ layer.millis ≈ total
    for lr in layer_reports:
        lr.millis += sync_ms / max(len(todo), 1)

    total_ms = (time.perf_counter() - t_begin) * 1e3
    return out_leaves, QuantReport(layer_reports, total_ms, method, bits,
                                   backend=backend, dispatch_millis=dispatch_ms,
                                   sync_millis=sync_ms, buckets=bucket_reports)


def quantize_tree(params: Any, method: str = "squant", bits: int = 4,
                  group_size: Optional[int] = 128, scale_method: str = "max",
                  predicate: Optional[Callable] = None,
                  dequantize: bool = False, backend: str = "auto",
                  batched: bool = True, device=None
                  ) -> Tuple[Any, QuantReport]:
    """Quantize all matmul weights in a param tree.

    dequantize=True returns float weights (fake-quant — for accuracy evals on
    models whose forward pass expects dense tensors); otherwise leaves become
    QuantizedTensor (real serving format).

    device: where the quantization runs and where its outputs live. Default
    is the current CUDA device; quantizable leaves that lie elsewhere are
    moved there first. Pass ``device="cpu"`` to run on the CPU.

    backend: implementation for the batched path — one of
    ``core.dispatch.BACKENDS`` (``"auto"`` follows ``device``: the CUDA kernel
    on a CUDA device, the torch core on the CPU). batched=False is the
    per-layer loop (one dispatch and one device sync per leaf); it ignores
    ``backend`` and always runs the torch core.
    """
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r}; options {METHODS}")
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    backend = resolve_backend(backend, device)
    pred = predicate or is_quantizable
    flat = _flatten(params)
    if not batched:
        leaves, report = _quantize_tree_serial(
            flat, pred, method, bits, group_size, scale_method, dequantize,
            device)
    else:
        leaves, report = _quantize_tree_batched(
            flat, pred, method, bits, group_size, scale_method, dequantize,
            backend, device)
    return _rebuild(params, iter(leaves)), report
