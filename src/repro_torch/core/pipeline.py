"""Model-level on-the-fly quantization of a whole parameter tree.

Walks a parameter tree (nested dicts / lists of tensors), quantizes every
matmul weight with the requested data-free method, and returns
(new_tree, report). This is the "on-the-fly framework" of Sec. 3.4: no data,
no back-prop, wall time recorded (Table 3's protocol).

Execution modes:

* ``batched=True`` (default) — leaves are grouped into same-(2-D view shape,
  dtype, group) buckets; each bucket is stacked and quantized with ONE
  asynchronous dispatch (a single flattened kernel launch on a CUDA device,
  the vectorized torch core on the CPU, see ``core.dispatch``), and the whole
  tree synchronizes with the device ONCE at the end. ``QuantReport`` carries
  the per-bucket wall times plus a dispatch/sync breakdown.
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

import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.core.dispatch import quantize_codes_batched, resolve_backend
from repro_torch.quant.qtypes import (BucketReport, LayerReport, QuantReport,
                                      from_codes)

METHODS = ("rtn", "squant", "squant_e", "squant_ek", "squant_ec")


def _sync(device: torch.device) -> None:
    """Wait for the device. Module-level so tests can count
    synchronizations: the batched path calls this exactly once per
    ``quantize_tree``, the serial path once per quantized leaf."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


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

def _plan_leaf(leaf: torch.Tensor, method: str, group_size: Optional[int]
               ) -> Tuple[torch.Tensor, Tuple[int, ...], Optional[int]]:
    """Return ``(w2d, qt_shape, eff_group)`` for one kernel leaf.

    ``eff_group`` mirrors the clamping in ``core.squant.squant`` exactly
    (group >= row length degenerates to the whole-row FC path; conv kernels
    use K=KH*KW as the natural group) so batched results are bit-identical to
    the per-layer path.
    """
    if leaf.ndim == 2:                       # (in, out) -> (out, in)
        w2d = leaf.T
        qt_shape = (leaf.shape[1], leaf.shape[0])
    elif leaf.ndim == 3:                     # (E, in, out) -> (E*out, in)
        e, i, o = leaf.shape
        w2d = leaf.permute(0, 2, 1).reshape(e * o, i)
        qt_shape = (e * o, i)
    elif leaf.ndim == 4:                     # conv (KH,KW,in,out) -> (out, in*K)
        kh, kw, ci, co = leaf.shape
        k = kh * kw
        w2d = leaf.permute(3, 2, 0, 1).reshape(co, ci * k)
        if method == "rtn":
            return w2d, (co, ci * k), None
        return w2d, (co, ci, k), (None if k == 1 else k)
    else:
        raise ValueError(f"unsupported kernel rank {leaf.ndim}")
    if method == "rtn":
        return w2d, qt_shape, None
    n = w2d.shape[1]
    eff = None if (group_size is None or group_size >= n) else group_size
    return w2d, qt_shape, eff


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
# Batched path: bucket -> stack -> one dispatch per bucket -> one sync total
# ---------------------------------------------------------------------------

# Cap on the transient stacked-bucket buffer: buckets whose stack would
# exceed this many bytes are dispatched in chunks, bounding peak memory at
# params + one chunk instead of params + the largest bucket. Still one device
# sync per tree.
_MAX_STACK_BYTES = 1 << 30


def _quantize_tree_batched(flat, pred, method, bits, group_size,
                           scale_method, dequantize, backend, device):
    t_begin = time.perf_counter()
    out_leaves: List[Any] = [None] * len(flat)
    # bucket key -> list of (leaf index, path, leaf, w2d, qt_shape)
    buckets: Dict[Tuple, List] = {}
    for idx, (path, leaf) in enumerate(flat):
        if not pred(path, leaf):
            out_leaves[idx] = leaf
            continue
        leaf = leaf.to(device)
        w2d, qt_shape, eff = _plan_leaf(leaf, method, group_size)
        key = (tuple(w2d.shape), str(w2d.dtype).replace("torch.", ""), eff)
        buckets.setdefault(key, []).append(
            (idx, path, leaf, w2d, qt_shape))

    layer_reports: List[LayerReport] = []
    bucket_reports: List[BucketReport] = []
    n_q = sum(len(v) for v in buckets.values())
    for key, all_entries in buckets.items():
        (m, n), dtype, eff = key[0], key[1], key[2]
        layer_bytes = m * n * all_entries[0][3].element_size()
        chunk = max(1, min(len(all_entries), _MAX_STACK_BYTES // layer_bytes))
        for c0 in range(0, len(all_entries), chunk):
            entries = all_entries[c0:c0 + chunk]
            tag = f"({m},{n})x{len(entries)} {dtype} g{eff}"
            tb0 = time.perf_counter()
            if len(entries) == 1:                        # singleton: no copy
                ws = entries[0][3][None]
            else:
                ws = torch.stack([e[3] for e in entries])  # (B, M, N)
            codes, scales = quantize_codes_batched(
                ws, method=method, bits=bits, group_size=eff,
                scale_method=scale_method, backend=backend)
            for bi, (idx, path, leaf, _, qt_shape) in enumerate(entries):
                qt = from_codes(codes[bi].reshape(qt_shape), scales[bi], bits)
                if dequantize:
                    out = _restore_dense(qt.dequantize(leaf.dtype),
                                         tuple(leaf.shape))
                else:
                    out = qt
                out_leaves[idx] = out
            bucket_ms = (time.perf_counter() - tb0) * 1e3
            bucket_reports.append(BucketReport(tag, len(entries), bucket_ms))
            for idx, path, leaf, _, _ in entries:
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
        lr.millis += sync_ms / max(n_q, 1)

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
