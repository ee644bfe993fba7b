"""Quantized-weights serving format: the checkpointable, tree-shaped form.

``QuantizedTensor`` (``core.pipeline.quantize_tree`` output) is a container
object; the serving format of this module instead stores each kernel as two
plain tensors living in the params tree —

    {"w": (in, out) float}  →  {"w_q":  (out, in)  int8      [bits > 4]
                                "w_q4": (out, in/2) int8 packed [bits <= 4]
                                "w_scale": (out, 1) f32}

— with leading stack dimensions kept, so a checkpoint holds plain arrays
(``checkpoint.Checkpointer.save_serving``; int4 nibbles stay packed on disk)
and a stacked ``{"periods": ...}`` tree stays stacked. ``models.layers.
linear`` consumes the format directly, through the dequant-matmul kernel on
a CUDA device (a zero-copy ``QuantizedTensor`` view of the two tensors).

Quantization follows the reference's serving-format quantizer leaf by leaf:
the eager per-channel max scale ``max(absmax, 1e-12) / qmax``
(``quant.scales.max_scale``: a true division on every device, one ulp away
on some rows from the bucket scales of ``quantize_tree``, which multiply by
``fl32(1/qmax)``), then SQuant E, K and C with that scale
(kernel A on a CUDA device, one launch per leaf, reading the leaf where it
is stored; its plain version on the CPU), or RTN.
"""
from __future__ import annotations

import time
from typing import Any, Optional

import torch

from repro_torch.kernels import ops
from repro_torch.quant.qtypes import (QuantizedTensor, pack_int4,
                                      qmax_for_bits, unpack_int4)
from repro_torch.quant.scales import max_scale


def _is_meta(x) -> bool:
    return isinstance(x, torch.Tensor) and x.is_meta


def _qdict_shapes(leaf, bits: int):
    """Shape stand-ins (``device="meta"`` tensors) for one quantized kernel
    (stack dims preserved)."""
    *stack, d_in, d_out = leaf.shape
    key = "w_q4" if bits <= 4 else "w_q"
    qshape = tuple(stack) + ((d_out, d_in // 2) if bits <= 4
                             else (d_out, d_in))
    return {key: torch.empty(qshape, dtype=torch.int8, device="meta"),
            "w_scale": torch.empty(tuple(stack) + (d_out, 1),
                                   dtype=torch.float32, device="meta")}


def _quantize_leaf(leaf: torch.Tensor, bits: int, method: str,
                   group_size: Optional[int]):
    """Real quantization of one (possibly stacked) (in, out) kernel."""
    *stack, d_in, d_out = leaf.shape
    w3 = leaf.reshape(-1, d_in, d_out)                  # (L, in, out)
    # the reference's eager compute_scale on the (L*out, in) view, in the
    # leaf's dtype: max |w| over the input dim, then a true division
    scale = max_scale(w3.transpose(1, 2), bits)          # (L, out, 1)
    if method == "rtn":
        qmax = qmax_for_bits(bits)
        codes = torch.clamp(torch.round(w3.transpose(1, 2) / scale),
                            -qmax, qmax)
    elif group_size is None:
        # the whole-row FC path has no kernel: torch ops on either device
        codes = ops.squant_flip_batched(
            w3.transpose(1, 2).to(torch.float32),
            scale.to(torch.float32), bits=bits, group_size=None)
    else:
        # every other method name runs E, K and C, as the reference does
        w32 = w3.to(torch.float32)
        codes = ops.squant_flip_leaves(
            [w32[i] for i in range(w32.shape[0])],
            scale.to(torch.float32).contiguous(), bits=bits,
            group_size=group_size, enable_k=True, enable_c=True)
    codes = codes.to(torch.int8).contiguous()           # (L, out, in)
    if bits <= 4:
        data = pack_int4(codes).reshape(tuple(stack) + (d_out, d_in // 2))
        key = "w_q4"
    else:
        data = codes.reshape(tuple(stack) + (d_out, d_in))
        key = "w_q"
    return {key: data,
            "w_scale": scale.reshape(tuple(stack) + (d_out, 1))}


def _walk(node, path, bits, method, group_size, shapes_only):
    if isinstance(node, dict):
        out = {}
        for k, v in node.items():
            if (k == "w" and not isinstance(v, dict)
                    and hasattr(v, "shape") and len(v.shape) >= 2
                    and "router" not in path
                    and "embedding" not in path):
                if shapes_only or _is_meta(v):
                    out.update(_qdict_shapes(v, bits))
                else:
                    out.update(_quantize_leaf(v, bits, method, group_size))
            else:
                out[k] = _walk(v, path + (k,), bits, method, group_size,
                               shapes_only)
        return out
    if isinstance(node, list):
        return [_walk(v, path + (str(i),), bits, method, group_size,
                      shapes_only) for i, v in enumerate(node)]
    return node


def quantized_param_shapes(params_shape: Any, bits: int) -> Any:
    """The serving-format tree of ``device="meta"`` stand-ins."""
    return _walk(params_shape, (), bits, "squant", None, True)


def quantize_params_sharded(params: Any, bits: int, method: str = "squant",
                            group_size: Optional[int] = 128) -> Any:
    """Real weights → quantized serving tree (data-free, on the fly), on
    the device the weights lie on. (The name is the reference's; this
    package has no mesh, so nothing is sharded.)"""
    return _walk(params, (), bits, method, group_size, False)


def is_quantized_tree(tree: Any) -> bool:
    """True if any node carries serving-format quantized leaves."""
    if isinstance(tree, dict):
        return "w_q" in tree or "w_q4" in tree or \
            any(is_quantized_tree(v) for v in tree.values())
    if isinstance(tree, list):
        return any(is_quantized_tree(v) for v in tree)
    return False


def quant_tree_meta(bits: int, method: str, group_size: Optional[int],
                    report=None, quantize_ms: Optional[float] = None) -> dict:
    """Checkpoint metadata for a quantized serving tree: the bits/method
    contract restore validates against, plus a ``QuantReport`` digest when
    the tree came through ``core.pipeline.quantize_tree``."""
    meta = {"bits": bits, "method": method, "group_size": group_size,
            "packed_int4": bits <= 4,
            "leaf_format": ("w_q4" if bits <= 4 else "w_q") + "+w_scale"}
    if quantize_ms is not None:
        meta["quantize_ms"] = quantize_ms
    if report is not None:
        meta["report"] = {"layers": len(report.layers),
                          "total_ms": report.total_millis,
                          "backend": report.backend,
                          "mesh_size": report.mesh_size}
    return meta


def _first_tensor(tree: Any) -> Optional[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return tree
    children = tree.values() if isinstance(tree, dict) else \
        tree if isinstance(tree, (list, tuple)) else ()
    for v in children:
        t = _first_tensor(v)
        if t is not None:
            return t
    return None


def quantize_params_serving(params: Any, bits: int, method: str = "squant",
                            group_size: Optional[int] = 128):
    """``(serving_tree, quant_meta)`` — the checkpointable quantized form.

    Same tree as :func:`quantize_params_sharded`, timed up to a
    synchronization of the tree's CUDA device so the metadata records the
    data-free quantization cost (Table-3 protocol).
    """
    t0 = time.perf_counter()
    tree = quantize_params_sharded(params, bits, method=method,
                                   group_size=group_size)
    first = _first_tensor(tree)
    if first is not None and first.is_cuda:
        torch.cuda.synchronize(first.device)
    ms = (time.perf_counter() - t0) * 1e3
    return tree, quant_tree_meta(bits, method, group_size, quantize_ms=ms)


def qdict_view(params: dict) -> QuantizedTensor:
    """A quantized param dict as a ``QuantizedTensor`` over the same
    tensors (no copy): per-channel scales, logical shape (out, in)."""
    q4 = "w_q4" in params
    data = params["w_q4"] if q4 else params["w_q"]
    out, cols = data.shape
    # the kernel takes float32 scales (a no-op for the trees quantized
    # here; a bfloat16 leaf's scale is bfloat16, as in the reference)
    return QuantizedTensor(data=data,
                           scale=params["w_scale"].to(torch.float32),
                           bits=4 if q4 else 8, group_size=None,
                           shape=(out, cols * 2 if q4 else cols))


def dequant_kernel(params: dict, dtype) -> torch.Tensor:
    """(out, in) float kernel from a quantized param dict."""
    codes = unpack_int4(params["w_q4"]) if "w_q4" in params \
        else params["w_q"]
    return codes.to(dtype) * params["w_scale"].to(dtype)
