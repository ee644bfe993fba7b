"""Checkpointing: ``.npz`` payloads + JSON index, async save, atomic commit —
for fp training state AND quantized serving trees, in the reference
package's on-disk layout (a checkpoint written by either package is read by
the other).

Layout:
    <dir>/step_000100/
        shard_00000.npz      (flat-key → array: ``params::a/b/0``, ``opt::…``)
        index.json           (tree keys, shapes, dtypes, format, quant meta)
        COMMITTED            (written last — a step dir without it, or with
                              an unparseable index.json, is invisible to
                              restore and to the serve reload watcher:
                              torn saves are harmless)

A save writes into ``step_….tmp`` and renames it when complete. Keys are the
leaves' paths in the reference's flattening order (dict keys sorted, list
indices, ``None`` dropped, Python scalars as 0-d arrays); restore turns
digit-keyed dicts back into lists. ``index.json`` records numpy dtype names.

bfloat16 has no numpy type here: a bfloat16 tensor is written as the
reference writes one (its 16 bits under the header ``'<V2'``, ``"bfloat16"``
in ``index.json``), and a ``V2`` leaf whose index dtype is ``"bfloat16"`` is
restored as ``torch.bfloat16`` bit for bit.

Quantized checkpoints (``save_serving`` with ``quant_meta``) hold the
serving-format ``w_q``/``w_q4``/``w_scale`` trees of ``quant.apply``
natively — int4 nibbles stay packed two-per-byte on disk — and record
``{"format": "quantized", "quant": {bits, method, group_size, …}}`` so
restore can refuse a tree that does not match the serve config instead of
silently serving garbage.

Not ported yet: reshard-on-restore (``shardings=``, ``mesh=``; M7).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
import zipfile
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.quant.qtypes import QuantizedTensor

_NOT_PORTED_RESHARD = "not ported yet: reshard-on-restore (M7)"


class CheckpointMetaError(ValueError):
    """A checkpoint's index.json is unreadable or contradicts the caller's
    expectations (e.g. quantized w4 restored into a w8 serve config)."""


# ---------------------------------------------------------------------------
# tree flattening, in the reference's order
# ---------------------------------------------------------------------------

def _children(node):
    """``[(key, child), ...]`` of an inner node, or None for a leaf."""
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if isinstance(node, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(node)]
    if isinstance(node, QuantizedTensor):       # a pytree node there
        return [("0", node.data), ("1", node.scale)]
    return None


def _flatten(tree: Any, prefix: str = "") -> Dict[str, Any]:
    """``{"a/b/0": leaf}`` in flattening order; ``None`` leaves dropped."""
    kids = _children(tree)
    if kids is None:
        return {} if tree is None else {prefix: tree}
    out = {}
    for k, v in kids:
        out.update(_flatten(v, f"{prefix}/{k}" if prefix else k))
    return out


def _unflatten(template: Any, leaves) -> Any:
    """``template``'s structure with its leaves taken in flattening order
    from the iterator ``leaves``."""
    if isinstance(template, dict):
        new = {k: _unflatten(template[k], leaves) for k in sorted(template)}
        return {k: new[k] for k in template}
    if isinstance(template, (list, tuple)):
        return type(template)(_unflatten(v, leaves) for v in template)
    if isinstance(template, QuantizedTensor):
        data, scale = next(leaves), next(leaves)
        return QuantizedTensor(data=data, scale=scale, bits=template.bits,
                               group_size=template.group_size,
                               shape=template.shape)
    return None if template is None else next(leaves)


# ---------------------------------------------------------------------------
# host arrays and the npz file
# ---------------------------------------------------------------------------

def _to_host(leaf, copy: bool) -> Tuple[np.ndarray, bool]:
    """``(array, is_bfloat16)``: a tensor's bytes on the host (a bfloat16
    tensor's 16 bits as int16), a copy where ``copy`` and the tensor
    already lies on the host."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        bf16 = t.dtype == torch.bfloat16
        if bf16:
            t = t.view(torch.int16)
        a = t.cpu().numpy()
        if copy and not leaf.is_cuda:
            a = a.copy()
        return a, bf16
    a = np.asarray(leaf)
    return (a.copy() if copy and a is leaf else a), a.dtype.name == "bfloat16"


def _write_npz(path: str, payload: Dict[str, Tuple[np.ndarray, bool]]):
    """``np.savez``'s file (a stored zip of ``.npy`` members, zip64 forced),
    written member by member without a second copy of each array; a
    bfloat16 member gets the header ``'<V2'``, as the reference's."""
    with zipfile.ZipFile(path, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for key, (a, bf16) in payload.items():
            shape = np.shape(a)         # ascontiguousarray makes 0-d 1-d
            a = np.ascontiguousarray(a)
            descr = "<V2" if bf16 else np.lib.format.dtype_to_descr(a.dtype)
            with zf.open(key + ".npy", "w", force_zip64=True) as fid:
                np.lib.format.write_array_header_1_0(
                    fid, {"descr": descr, "fortran_order": False,
                          "shape": shape})
                if a.nbytes:
                    fid.write(memoryview(a.reshape(-1).view(np.uint8)))


def _to_tensor(a: np.ndarray, dtype_name: str, device) -> torch.Tensor:
    """A restored array on ``device`` in one copy; a ``V2`` array whose
    index dtype is ``"bfloat16"`` becomes ``torch.bfloat16`` bit for bit."""
    if a.dtype.kind == "V":
        if dtype_name != "bfloat16" or a.dtype.itemsize != 2:
            raise CheckpointMetaError(f"a {a.dtype} leaf recorded as "
                                      f"{dtype_name!r} has no tensor type")
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def _default_device():
    return torch.device("cuda", torch.cuda.current_device())


def listify(node):
    """Convert dicts with integer-contiguous keys back to lists."""
    if not isinstance(node, dict):
        return node
    keys = list(node.keys())
    if keys and all(k.isdigit() for k in keys):
        idx = sorted(int(k) for k in keys)
        if idx == list(range(len(idx))):
            return [listify(node[str(i)]) for i in idx]
    return {k: listify(v) for k, v in node.items()}


class Checkpointer:
    """Saves and restores step directories under ``directory``.
    ``timings`` holds the last operation's split in milliseconds: a save's
    ``d2h_ms`` (the synchronous snapshot to host memory) and ``write_ms``
    (set when the write ends; ``wait()`` first for an async save), a
    restore's ``read_ms`` and ``h2d_ms``."""

    def __init__(self, directory: str, async_save: bool = True,
                 keep: int = 3):
        self.dir = directory
        self.async_save = async_save
        self.keep = keep
        self.timings: Dict[str, float] = {}
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------------ save
    def _snapshot(self, trees) -> Tuple[dict, dict]:
        t0 = time.perf_counter()
        payload, keys = {}, {}
        for name, tree in trees:
            flat = _flatten(tree)
            keys[name] = {"keys": sorted(flat)}
            for k, v in flat.items():
                payload[f"{name}::{k}"] = _to_host(v, self.async_save)
        self.timings = {"d2h_ms": (time.perf_counter() - t0) * 1e3}
        return payload, keys

    def save(self, step: int, params: Any, opt_state: Any):
        """Snapshot ``params`` and ``opt_state`` to host memory now; write
        them (on a thread when ``async_save``)."""
        self.wait()
        payload, keys = self._snapshot((("params", params),
                                        ("opt", opt_state)))
        self._dispatch(step, payload, {"step": step, "trees": keys})

    def save_serving(self, step: int, params: Any,
                     quant_meta: Optional[Dict[str, Any]] = None):
        """Save a serving weight tree (fp, or a quantized qdict tree from
        ``quant.apply.quantize_params_sharded``).

        ``quant_meta`` marks the checkpoint as quantized and must carry at
        least ``bits`` and ``method`` (plus group_size / QuantReport digest);
        packed int4 codes are written as-is — nibbles stay packed on disk.
        """
        fmt, quant = "fp", None
        if quant_meta is not None:
            missing = {"bits", "method"} - set(quant_meta)
            if missing:
                raise ValueError(f"quant_meta missing {sorted(missing)}")
            fmt, quant = "quantized", dict(quant_meta)
        self.wait()
        payload, keys = self._snapshot((("params", params),))
        self._dispatch(step, payload, {"step": step, "trees": keys,
                                       "format": fmt, "quant": quant})

    def _dispatch(self, step: int, payload, meta):
        if self.async_save:
            self._thread = threading.Thread(
                target=self._write_logged, args=(step, payload, meta),
                daemon=True)
            self._thread.start()
        else:
            self._write(step, payload, meta)

    def _write_logged(self, step, payload, meta):
        try:
            self._write(step, payload, meta)
        except BaseException as e:        # re-raised by wait()
            self._error = e

    def _write(self, step: int, payload, meta):
        t0 = time.perf_counter()
        final = os.path.join(self.dir, f"step_{step:08d}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp, exist_ok=True)
        _write_npz(os.path.join(tmp, "shard_00000.npz"), payload)
        meta["shapes"] = {k: list(a.shape) for k, (a, _) in payload.items()}
        meta["dtypes"] = {k: "bfloat16" if bf16 else str(a.dtype)
                          for k, (a, bf16) in payload.items()}
        with open(os.path.join(tmp, "index.json"), "w") as f:
            json.dump(meta, f)
        with open(os.path.join(tmp, "COMMITTED"), "w") as f:
            f.write(str(time.time()))
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()
        self.timings["write_ms"] = (time.perf_counter() - t0) * 1e3

    def _gc(self):
        """Keep the newest ``keep`` loadable steps; everything else —
        including torn/corrupt step dirs, which ``list_steps`` hides but
        which would otherwise accumulate forever — is deleted. Writers are
        atomic (payload + COMMITTED land in a ``.tmp`` dir, then one
        rename), so a non-``.tmp`` invalid dir is never an in-flight save."""
        keep = set(self.list_steps()[-self.keep:])
        for d in sorted(os.listdir(self.dir)):
            if not d.startswith("step_") or d.endswith(".tmp"):
                continue
            try:
                s = int(d.split("_")[1])
            except ValueError:
                continue
            if s not in keep:
                shutil.rmtree(os.path.join(self.dir, d), ignore_errors=True)

    def wait(self):
        """Wait for an async write; raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    # --------------------------------------------------------------- restore
    def list_steps(self):
        """Committed, loadable steps. A step dir missing COMMITTED (torn
        save) or whose index.json does not parse (torn/corrupt metadata) is
        skipped — both restore and the serve reload watcher key off this."""
        out = []
        for d in sorted(os.listdir(self.dir)):
            if not d.startswith("step_") or d.endswith(".tmp"):
                continue
            if not os.path.exists(os.path.join(self.dir, d, "COMMITTED")):
                continue
            try:
                with open(os.path.join(self.dir, d, "index.json")) as f:
                    json.load(f)
            except (OSError, ValueError):
                continue
            out.append(int(d.split("_")[1]))
        return out

    def read_meta(self, step: int) -> Dict[str, Any]:
        """Parsed index.json for a committed step."""
        d = os.path.join(self.dir, f"step_{step:08d}")
        if not os.path.exists(os.path.join(d, "COMMITTED")):
            raise CheckpointMetaError(f"step {step}: no COMMITTED marker "
                                      f"(torn save?) in {d}")
        try:
            with open(os.path.join(d, "index.json")) as f:
                return json.load(f)
        except (OSError, ValueError) as e:
            raise CheckpointMetaError(f"step {step}: unreadable index.json "
                                      f"({e})") from e

    def _read(self, step: int, keys=None, prefix: str = ""
              ) -> Dict[str, np.ndarray]:
        """The step's arrays (those named in ``keys``, else those whose key
        starts with ``prefix``), read into host memory; times
        ``read_ms``."""
        t0 = time.perf_counter()
        path = os.path.join(self.dir, f"step_{step:08d}", "shard_00000.npz")
        with np.load(path) as data:
            if keys is None:
                keys = [k for k in data.files if k.startswith(prefix)]
            out = {k: data[k] for k in keys}
        self.timings = {"read_ms": (time.perf_counter() - t0) * 1e3}
        return out

    def _place(self, arrays: Dict[str, np.ndarray], dtypes: Dict[str, str],
               device) -> Dict[str, torch.Tensor]:
        t0 = time.perf_counter()
        out = {k: _to_tensor(a, dtypes.get(k, str(a.dtype)), device)
               for k, a in arrays.items()}
        self.timings["h2d_ms"] = (time.perf_counter() - t0) * 1e3
        return out

    def restore(self, step: int, shardings: Optional[Any] = None,
                template: Optional[Tuple[Any, Any]] = None, device=None):
        """Returns (params, opt_state, step). ``template`` provides the tree
        structures; leaves go to ``device`` (default: the current CUDA
        device)."""
        if shardings is not None:
            raise NotImplementedError(_NOT_PORTED_RESHARD)
        meta = self.read_meta(step)
        if meta.get("format") == "quantized":
            raise CheckpointMetaError(
                f"step {step} is a quantized serving checkpoint "
                f"(quant={meta.get('quant')}); restore it with "
                f"restore_serving(), not the training-state restore()")
        if template is None:
            raise ValueError("restore requires a (params, opt) template")
        device = _default_device() if device is None else device
        keys = [[f"{name}::{k}" for k in _flatten(tmpl)]
                for name, tmpl in zip(("params", "opt"), template)]
        leaves = self._place(self._read(step, keys[0] + keys[1]),
                             meta.get("dtypes", {}), device)
        params, opt = (_unflatten(tmpl, (leaves[k] for k in ks))
                       for tmpl, ks in zip(template, keys))
        return params, opt, step

    def restore_latest(self, shardings=None, template=None, device=None):
        steps = self.list_steps()
        if not steps:
            return None
        if template is None:
            return self._restore_raw(steps[-1], device=device)
        return self.restore(steps[-1], shardings, template, device=device)

    def _restore_raw(self, step: int, to_torch: bool = True, device=None,
                     prefix: str = ""):
        """Tree-structure-free restore: rebuilds nested dicts (lists where
        the keys are 0..n-1) from the flat key paths. ``to_torch=False``
        keeps leaves as the host numpy arrays read (bfloat16 leaves as
        ``V2``); else they go to ``device`` (default: the current CUDA
        device). ``prefix="params::"`` reads the params tree only."""
        arrays = self._read(step, prefix=prefix)
        if to_torch:
            dtypes = self.read_meta(step).get("dtypes", {})
            arrays = self._place(arrays, dtypes, _default_device()
                                 if device is None else device)
        trees = {"params": {}, "opt": {}}
        for full_key, value in arrays.items():
            name, key = full_key.split("::", 1)
            node = trees[name]
            path = key.split("/")
            for p in path[:-1]:
                node = node.setdefault(p, {})
            node[path[-1]] = value
        return listify(trees["params"]), listify(trees["opt"]), step

    def restore_serving(self, step: Optional[int] = None,
                        expect: Optional[Dict[str, Any]] = None,
                        mesh=None, device=None
                        ) -> Tuple[Any, Dict[str, Any], int]:
        """Restore a serving weight tree → ``(params, meta, step)``.

        Loads the newest committed step when ``step`` is None (torn/corrupt
        dirs are invisible). Works for both fp checkpoints (training saves —
        the opt tree is ignored) and native quantized ones.

        ``expect`` carries the serve config's quant expectations
        (``{"quantize_weights": method|None, "weight_bits": int}``): a
        quantized checkpoint whose ``bits``/``method`` metadata mismatch it
        raises :class:`CheckpointMetaError` instead of silently serving
        garbage. fp checkpoints always pass (the caller re-quantizes).

        Leaves are read to host memory, then each goes to ``device``
        (default: the current CUDA device) in one copy, on the calling
        thread's current stream.
        """
        if mesh is not None:
            raise NotImplementedError(_NOT_PORTED_RESHARD)
        if step is None:
            steps = self.list_steps()
            if not steps:
                raise FileNotFoundError(f"no committed checkpoint in "
                                        f"{self.dir}")
            step = steps[-1]
        meta = self.read_meta(step)
        quant = meta.get("quant")
        if quant is not None and expect is not None:
            want_m = expect.get("quantize_weights")
            want_b = expect.get("weight_bits")
            if want_m is None:
                raise CheckpointMetaError(
                    f"step {step} holds {quant['method']} w{quant['bits']} "
                    f"weights but the serve config requests unquantized "
                    f"serving")
            if quant.get("bits") != want_b or quant.get("method") != want_m:
                raise CheckpointMetaError(
                    f"step {step} quant metadata mismatch: checkpoint is "
                    f"{quant.get('method')} w{quant.get('bits')}, serve "
                    f"config requests {want_m} w{want_b}")
        params, _, _ = self._restore_raw(step, device=device,
                                         prefix="params::")
        return params, meta, step
