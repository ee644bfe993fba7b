"""Carry a parameter tree from the reference (JAX) package into this one.

``from_jax_params`` takes the tree *after* it has been fetched to the host —
nested dicts / lists whose leaves are numpy arrays — so this module needs
numpy and torch only. It

* turns every array leaf into a tensor on ``device`` (bfloat16 arrives as an
  ``ml_dtypes`` numpy array: it is viewed as uint16 and re-viewed as
  ``torch.bfloat16``, bit for bit);
* unrolls a stacked ``{"periods": ...}`` layer stack (leading axis = layer)
  into the ``{"list": [...]}`` form this package runs;
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


def _unstack_periods(stack: dict) -> dict:
    """numpy-level ``{"periods": stacked}`` → ``{"list": [...]}``."""
    def leaves(t):
        if isinstance(t, dict):
            for v in t.values():
                yield from leaves(v)
        elif isinstance(t, (list, tuple)):
            for v in t:
                yield from leaves(v)
        elif _is_quantized(t):
            yield t.data
        else:
            yield t

    def take(t, i):
        if isinstance(t, dict):
            return {k: take(v, i) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(take(v, i) for v in t)
        if _is_quantized(t):
            raise ValueError("a stacked layer axis over quantized leaves is "
                             "not a layout either package produces")
        return np.asarray(t)[i]

    periods = int(np.asarray(next(leaves(stack["periods"]))).shape[0])
    return {"list": [take(stack["periods"], i) for i in range(periods)]}


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
        tree["stack"] = _unstack_periods(tree["stack"])
    return _convert(tree, device)
