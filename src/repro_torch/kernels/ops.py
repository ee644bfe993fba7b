"""Public wrappers over the CUDA kernels.

Dispatch rule (stated here once, for every kernel of the package):

* a tensor on the CPU   → the kernel's plain PyTorch version;
* a tensor on a CUDA device → the hand-written kernel, or an exception if
  the kernel does not take the call (it never quietly runs something else);
* ``backend="ref"`` is an explicit request for the plain version on whatever
  device the tensor lies. Tests and the on-device comparison in
  ``chip_smoke.py`` use it; nothing in the package selects it as a fallback.

``backend="auto"`` means "follow the tensor's device" and ``backend="cuda"``
insists on the kernel (a CPU tensor then raises). ``force_backend("ref")``
is the same explicit request made for a whole block of code (a model
forward, a ``quantize_tree``) instead of one call: inside it every wrapper
here takes the plain version.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import math
import re
from typing import Any, Dict, Iterable, Optional, Sequence

import torch

from repro_torch.kernels import dequant_matmul as _dm
from repro_torch.kernels import paged_attention as _pa
from repro_torch.kernels import paged_attention_quant as _paq
from repro_torch.kernels import squant_flip as _sf
from repro_torch.quant.qtypes import QuantizedTensor


_forced: Optional[str] = None


@contextlib.contextmanager
def force_backend(backend: str):
    """Make every wrapper in this module use ``backend`` ("ref" or "cuda")
    inside the ``with`` block, whatever the call asked for. For comparing a
    whole path through the kernels with the same path through their plain
    versions; not thread-safe."""
    global _forced
    if backend not in ("ref", "cuda"):
        raise ValueError(f"force_backend takes 'ref' or 'cuda', got {backend!r}")
    prev, _forced = _forced, backend
    try:
        yield
    finally:
        _forced = prev


def _use_kernel(t: torch.Tensor, backend: str) -> bool:
    if backend not in ("auto", "ref", "cuda"):
        raise ValueError(f"unknown backend {backend!r}")
    if _forced is not None:
        backend = _forced
    if backend == "ref":
        return False
    if backend == "cuda":
        if not t.is_cuda:
            raise ValueError("backend='cuda' needs a CUDA tensor, got one on "
                             f"{t.device}")
        return True
    return t.is_cuda


def squant_flip(w2d: torch.Tensor, scale: torch.Tensor, *, bits: int,
                group_size: int, enable_k: bool = True, enable_c: bool = True,
                backend: str = "auto") -> torch.Tensor:
    """SQuant codes for an (M, N) matrix with per-channel scales (M, 1).

    The kernel implements the standard E, E&K and E&K&C configurations; the
    E&C-without-K ablation (row-level flip) has no kernel and runs on torch
    ops on either device.
    """
    if _use_kernel(w2d, backend) and (enable_k or not enable_c):
        return _sf.squant_flip(w2d.to(torch.float32),
                               scale.to(torch.float32), bits=bits,
                               group_size=group_size, enable_k=enable_k,
                               enable_c=enable_c)
    return _sf.squant_flip_plain(w2d, scale, bits=bits, group_size=group_size,
                                 enable_k=enable_k, enable_c=enable_c)


def squant_flip_leaves(leaves: Sequence[torch.Tensor], scale: torch.Tensor, *,
                       bits: int, group_size: int, enable_k: bool = True,
                       enable_c: bool = True, backend: str = "auto"
                       ) -> torch.Tensor:
    """SQuant codes (B, out, in) for B same-shape ``(in, out)`` leaves read
    as they are stored, with per-channel scales (B, out[, 1]): the
    model-level entry point of ``quantize_tree``'s native route, one launch
    per bucket. The E&C-without-K ablation has no kernel and runs on torch
    ops on either device."""
    if _use_kernel(leaves[0], backend) and (enable_k or not enable_c):
        return _sf.squant_flip_leaves(leaves, scale, bits=bits,
                                      group_size=group_size,
                                      enable_k=enable_k, enable_c=enable_c)
    return _sf.squant_flip_leaves_plain(leaves, scale, bits=bits,
                                        group_size=group_size,
                                        enable_k=enable_k, enable_c=enable_c)


def squant_scales(leaves: Sequence[torch.Tensor], bits: int, *,
                  backend: str = "auto") -> torch.Tensor:
    """Per-channel max scales (B, out) of B same-shape ``(in, out)``
    leaves, bit-identical to ``core.dispatch._scales`` on their transposed
    stack."""
    if _use_kernel(leaves[0], backend):
        return _sf.squant_scales(leaves, bits)
    return _sf.squant_scales_plain(leaves, bits)


def squant_flip_batched(w3: torch.Tensor, scale3: torch.Tensor, *, bits: int,
                        group_size: Optional[int], enable_k: bool = True,
                        enable_c: bool = True, backend: str = "auto"
                        ) -> torch.Tensor:
    """SQuant codes for a (B, M, N) stack of same-shape matrices.

    This is the model-level batched entry point: ``quantize_tree`` stacks all
    same-(shape, dtype) layers of a network into one bucket and issues ONE
    dispatch here instead of one per layer.

    SQuant is row-independent (every stage — E rounding, K group flips, C
    channel flips — operates within a single output channel), so the batch is
    flattened into rows, ``(B, M, N) → (B·M, N)``; that is exact, not an
    approximation. Two configurations have no kernel, in this package as in
    the reference, and always run on torch ops (the vectorized core) on
    whatever device the stack lies: ``group_size=None`` (the whole-row FC
    path) and the E&C-without-K ablation.
    """
    b, m, n = w3.shape
    flat, sflat = w3.reshape(b * m, n), scale3.reshape(b * m, 1)
    if group_size is not None and (enable_k or not enable_c):
        codes = squant_flip(flat, sflat, bits=bits, group_size=group_size,
                            enable_k=enable_k, enable_c=enable_c,
                            backend=backend)
    else:
        _use_kernel(w3, backend)          # validates the backend string
        codes = _sf.squant_flip_plain(flat, sflat, bits=bits,
                                      group_size=group_size,
                                      enable_k=enable_k, enable_c=enable_c)
    return codes.reshape(b, m, n)


def dequant_matmul(x: torch.Tensor, qt: QuantizedTensor, *,
                   group_size: int = 128, backend: str = "auto"
                   ) -> torch.Tensor:
    """y = x @ dequant(qt).T for a (out, in)-major QuantizedTensor.

    One K-tile is one group: ``gs = group_size if N % group_size == 0 else N``.
    """
    m = qt.shape[0]
    n = math.prod(qt.shape[1:])
    scale = qt.scale.reshape(m, -1)
    gs = group_size if n % group_size == 0 else n
    if _use_kernel(x, backend):
        return _dm.dequant_matmul(x, qt.data, scale, bits=qt.bits,
                                  group_size=gs)
    return _dm.dequant_matmul_plain(x, qt.data, scale, bits=qt.bits,
                                    group_size=gs)


def paged_attention(q: torch.Tensor, k_pool: torch.Tensor,
                    v_pool: torch.Tensor, block_tables: torch.Tensor,
                    lengths: torch.Tensor, *, scale: float,
                    backend: str = "auto") -> torch.Tensor:
    """Block-table decode attention over a model-dtype pool (see
    :mod:`repro_torch.kernels.paged_attention`)."""
    if _use_kernel(q, backend):
        return _pa.paged_attention(q, k_pool, v_pool, block_tables, lengths,
                                   scale=scale)
    return _pa.paged_attention_plain(q, k_pool, v_pool, block_tables,
                                     lengths, scale=scale)


def paged_attention_quant(q: torch.Tensor, k_pool: torch.Tensor,
                          v_pool: torch.Tensor, k_scale: torch.Tensor,
                          v_scale: torch.Tensor, block_tables: torch.Tensor,
                          lengths: torch.Tensor, *, scale: float,
                          backend: str = "auto") -> torch.Tensor:
    """Block-table decode attention over an int8 pool with per-(position,
    kv-head) scales (see :mod:`repro_torch.kernels.paged_attention_quant`)."""
    if _use_kernel(q, backend):
        return _paq.paged_attention_quant(q, k_pool, v_pool, k_scale,
                                          v_scale, block_tables, lengths,
                                          scale=scale)
    return _paq.paged_attention_quant_plain(q, k_pool, v_pool, k_scale,
                                            v_scale, block_tables, lengths,
                                            scale=scale)


# ---------------------------------------------------------------------------
# launch counters: one view over every wrapper's plain-integer counts
# ---------------------------------------------------------------------------

_COUNTERS = ((_dm, "launches"), (_dm, "launches_by_variant"),
             (_pa, "launches"), (_paq, "launches"),
             (_sf, "launches"), (_sf, "launches_by_route"),
             (_sf, "scale_launches"))


def _counter_key(mod, name: str) -> str:
    return f"{mod.__name__.rsplit('.', 1)[-1]}.{name}"


def launch_counts() -> Dict[str, Any]:
    """A snapshot of every wrapper's launch counters, keyed
    ``"<module>.<counter>"`` (the by-variant and by-route dicts copied)."""
    out = {}
    for mod, name in _COUNTERS:
        v = getattr(mod, name)
        out[_counter_key(mod, name)] = dict(v) if isinstance(v, dict) else v
    return out


def launches_between(before: Dict[str, Any], after: Dict[str, Any]
                     ) -> Dict[str, Any]:
    """What was launched between two :func:`launch_counts` snapshots."""
    return combine_launches(after, before, -1)


def set_launch_counts(counts: Dict[str, Any]) -> None:
    """Put the counters back to a :func:`launch_counts` snapshot. A CUDA
    graph's capture calls the wrappers, which count, but runs nothing: the
    engine takes those counts back this way after every capture."""
    for mod, name in _COUNTERS:
        v = counts[_counter_key(mod, name)]
        setattr(mod, name, dict(v) if isinstance(v, dict) else v)


def combine_launches(base: Dict[str, Any], tally: Dict[str, Any],
                     times: int = 1) -> Dict[str, Any]:
    """``base`` plus ``times`` x ``tally`` (both :func:`launch_counts`
    form), as a new dict."""
    return {k: ({j: n + times * tally[k].get(j, 0) for j, n in v.items()}
                if isinstance(v, dict) else v + times * tally[k])
            for k, v in base.items()}


# the device symbol each wrapper launches once per call (a merge pass that
# follows it is not counted, as its wrapper does not count it)
_SYMBOL = re.compile(r"::(tcgemv_kernel|pf_kernel|gemv_kernel|tiled_kernel|"
                     r"paged_decode_split|squant_flip_kernel|"
                     r"squant_scale_kernel)(?:<([^()]*)>)?\(")
_VARIANT = {"tcgemv_kernel": "tcgemv", "pf_kernel": "mma",
            "gemv_kernel": "gemv", "tiled_kernel": "tiled"}


def count_kernels(names: Iterable[str]) -> Dict[str, Any]:
    """The :func:`launch_counts` that device kernels of these (demangled)
    names make, one count per wrapper call: kernel B's variant by its
    symbol, kernel C or D by ``paged_decode_split``'s QUANT argument,
    kernel A's route by ``squant_flip_kernel``'s V16 argument. Other
    kernels (PyTorch's, the merge passes) are not counted."""
    out = {k: ({j: 0 for j in v} if isinstance(v, dict) else 0)
           for k, v in launch_counts().items()}
    for nm in names:
        m = _SYMBOL.search(nm)
        if m is None:
            continue
        sym, args = m.group(1), [a.strip() for a in
                                 (m.group(2) or "").split(",")]
        if sym in _VARIANT:
            out["dequant_matmul.launches"] += 1
            out["dequant_matmul.launches_by_variant"][_VARIANT[sym]] += 1
        elif sym == "paged_decode_split":
            quant = args[2] == "true"
            out["paged_attention_quant.launches" if quant
                else "paged_attention.launches"] += 1
        elif sym == "squant_flip_kernel":
            out["squant_flip.launches"] += 1
            out["squant_flip.launches_by_route"][
                "cp16" if args[0] == "true" else "cp4"] += 1
        else:
            out["squant_flip.scale_launches"] += 1
    return out


class _KernelNodeParams(ctypes.Structure):
    # CUDA_KERNEL_NODE_PARAMS_v2 (cuda.h)
    _fields_ = [("func", ctypes.c_void_p)] + \
        [(f, ctypes.c_uint) for f in ("gx", "gy", "gz", "bx", "by", "bz",
                                      "smem")] + \
        [(f, ctypes.c_void_p) for f in ("params", "extra", "kern", "ctx")]


@functools.lru_cache(maxsize=None)
def _cxx():
    """The C++ runtime's demangler and C's ``free``."""
    cxx = ctypes.CDLL("libstdc++.so.6")
    cxx.__cxa_demangle.restype = ctypes.c_void_p
    return cxx.__cxa_demangle, ctypes.CDLL(None).free


def _demangle(name: bytes) -> str:
    demangle, free = _cxx()
    status = ctypes.c_int()
    p = demangle(name, None, None, ctypes.byref(status))
    if status.value != 0 or not p:
        return name.decode()
    try:
        return ctypes.string_at(p).decode()
    finally:
        free(ctypes.c_void_p(p))


@functools.lru_cache(maxsize=None)
def _driver():
    return ctypes.CDLL("libcuda.so.1")


def graph_kernel_names(raw_graph: int) -> list:
    """The demangled names of the kernel nodes of a ``cudaGraph_t`` (an
    address, as ``torch.cuda.CUDAGraph.raw_cuda_graph()`` gives it), read
    through the driver API: the kernels that every launch of the graph
    runs."""
    cu = _driver()

    def check(r, what):
        if r != 0:
            raise RuntimeError(f"{what} failed (CUresult {r})")

    g, n = ctypes.c_void_p(raw_graph), ctypes.c_size_t(0)
    check(cu.cuGraphGetNodes(g, None, ctypes.byref(n)), "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * n.value)()
    check(cu.cuGraphGetNodes(g, nodes, ctypes.byref(n)), "cuGraphGetNodes")
    names = []
    for node in nodes:
        kind = ctypes.c_int()
        check(cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)),
              "cuGraphNodeGetType")
        if kind.value != 0:                  # CU_GRAPH_NODE_TYPE_KERNEL
            continue
        prm = _KernelNodeParams()
        check(cu.cuGraphKernelNodeGetParams_v2(ctypes.c_void_p(node),
                                               ctypes.byref(prm)),
              "cuGraphKernelNodeGetParams")
        name = ctypes.c_char_p()
        if prm.func:
            check(cu.cuFuncGetName(ctypes.byref(name),
                                   ctypes.c_void_p(prm.func)),
                  "cuFuncGetName")
        else:
            check(cu.cuKernelGetName(ctypes.byref(name),
                                     ctypes.c_void_p(prm.kern)),
                  "cuKernelGetName")
        names.append(_demangle(name.value))
    return names


def graph_launches(graph: "torch.cuda.CUDAGraph") -> Dict[str, Any]:
    """What one replay of ``graph`` launches, read from the graph the driver
    holds (:func:`graph_kernel_names`) and counted by name
    (:func:`count_kernels`). ``graph`` must be captured with
    ``keep_graph=True``; nothing is launched."""
    return count_kernels(graph_kernel_names(graph.raw_cuda_graph()))
