"""Carry a parameter tree from the reference (JAX) package into this one.

``from_jax_params`` takes the tree *after* it has been fetched to the host —
nested dicts / lists whose leaves are numpy arrays — so this module needs
numpy and torch only. It

* turns every array leaf into a tensor on ``device`` (bfloat16 arrives as an
  ``ml_dtypes`` numpy array: it is viewed as uint16 and re-viewed as
  ``torch.bfloat16``, bit for bit);
* unrolls a stacked ``{"periods": ...}`` layer stack (leading axis = layer)
  into the ``{"list": [...]}`` form this package runs, and an
  encoder-decoder's stacked ``{"encoder": {"layers": ...}}`` (the reference
  always stacks its encoder) into a list of layers; a quantized leaf of a
  stacked tree is one ``(L·out, in)`` QuantizedTensor (the reference
  quantizes a stacked leaf as a bank), whose rows are sliced back layer by
  layer;
* turns a quantized leaf — any object with ``data``, ``scale``, ``bits``,
  ``group_size`` and ``shape`` attributes, such as the reference package's
  ``QuantizedTensor`` holding numpy arrays — into this package's
  ``QuantizedTensor``;
* carries an AdamW state ``{"m", "v", "step"}`` across: ``m`` and ``v``
  (parameter-shaped trees, stacked or not) are unrolled like the params, and
  ``step`` stays a 0-d int32, so a run begun in either package continues in
  the other.
"""
from __future__ import annotations

import types
from typing import Any

import numpy as np
import torch

from repro_torch.quant.qtypes import QuantizedTensor

_QT_FIELDS = ("data", "scale", "bits", "group_size", "shape")


def _to_tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy())
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.ascontiguousarray(a).copy()).to(device)


def _is_quantized(x: Any) -> bool:
    if isinstance(x, (np.ndarray, np.generic, torch.Tensor)):
        return False
    return all(hasattr(x, f) for f in _QT_FIELDS)


def _convert(tree: Any, device) -> Any:
    if isinstance(tree, dict):
        return {k: _convert(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_convert(v, device) for v in tree)
    if _is_quantized(tree):
        gs = tree.group_size
        return QuantizedTensor(
            data=_to_tensor(tree.data, device),
            scale=_to_tensor(tree.scale, device).to(torch.float32),
            bits=int(tree.bits), group_size=None if gs is None else int(gs),
            shape=tuple(int(d) for d in tree.shape))
    if isinstance(tree, (np.ndarray, np.generic)) or hasattr(tree, "__array__"):
        return _to_tensor(tree, device)
    return tree


def _unstack(stacked: dict) -> list:
    """numpy-level stacked layers (leading axis = layer, or period) → a list
    of them. A quantized leaf is one ``(L·out, in)`` QuantizedTensor (the
    reference quantizes a stacked ``(L, in, out)`` leaf as a bank): layer
    ``l`` takes its rows ``[l·out, (l+1)·out)`` of codes and scales (SQuant
    and the scales are per output row, so each layer's rows are its own
    quantization). The layer count is read off the first array leaf."""
    def arrays(t):
        if isinstance(t, dict):
            for v in t.values():
                yield from arrays(v)
        elif isinstance(t, (list, tuple)):
            for v in t:
                yield from arrays(v)
        elif not _is_quantized(t):
            yield t

    n = int(np.asarray(next(arrays(stacked))).shape[0])

    def take(t, i):
        if isinstance(t, dict):
            return {k: take(v, i) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(take(v, i) for v in t)
        if _is_quantized(t):
            out = int(t.shape[0]) // n
            rows = slice(i * out, (i + 1) * out)
            return types.SimpleNamespace(
                data=np.asarray(t.data)[rows],
                scale=np.asarray(t.scale)[rows], bits=t.bits,
                group_size=t.group_size, shape=(out,) + tuple(t.shape[1:]))
        return np.asarray(t)[i]

    return [take(stacked, i) for i in range(n)]


def from_jax_params(tree: Any, device=None) -> Any:
    """Host-side (numpy-leaved) reference tree (params, or an AdamW state)
    → this package's, on ``device``: by default the current CUDA device, as
    every entry point of the package; pass ``device="cpu"`` for host
    tensors."""
    if device is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if isinstance(tree, dict) and set(tree) == {"m", "v", "step"}:
        return {"m": from_jax_params(tree["m"], device),
                "v": from_jax_params(tree["v"], device),
                "step": _to_tensor(tree["step"], device).to(torch.int32)}
    if isinstance(tree, dict) and isinstance(tree.get("stack"), dict) \
            and "periods" in tree["stack"]:
        tree = dict(tree)
        tree["stack"] = {"list": _unstack(tree["stack"]["periods"])}
    if isinstance(tree, dict) and isinstance(tree.get("encoder"), dict) \
            and isinstance(tree["encoder"].get("layers"), dict):
        tree = dict(tree)
        tree["encoder"] = dict(tree["encoder"],
                               layers=_unstack(tree["encoder"]["layers"]))
    return _convert(tree, device)
