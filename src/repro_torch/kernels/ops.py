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
    """The dispatch rule above for a call on ``t``: True where the kernel
    runs, False where the plain version does (ValueError for a CPU tensor
    under ``backend="cuda"``)."""
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
                       enable_c: bool = True, backend: str = "auto",
                       cols=None) -> torch.Tensor:
    """SQuant codes (B, out, in) for B same-shape ``(in, out)`` leaves read
    as they are stored, with per-channel scales (B, out[, 1]): the
    model-level entry point of ``quantize_tree``'s native route, one launch
    per bucket. ``cols=(c0, n)``: output channels ``c0 .. c0 + n - 1`` of
    every leaf only. The E&C-without-K ablation has no kernel and runs on
    torch ops on either device."""
    if _use_kernel(leaves[0], backend) and (enable_k or not enable_c):
        return _sf.squant_flip_leaves(leaves, scale, bits=bits,
                                      group_size=group_size,
                                      enable_k=enable_k, enable_c=enable_c,
                                      cols=cols)
    return _sf.squant_flip_leaves_plain(leaves, scale, bits=bits,
                                        group_size=group_size,
                                        enable_k=enable_k, enable_c=enable_c,
                                        cols=cols)


def squant_scales(leaves: Sequence[torch.Tensor], bits: int, *,
                  backend: str = "auto", cols=None) -> torch.Tensor:
    """Per-channel max scales (B, out) of B same-shape ``(in, out)``
    leaves, bit-identical to ``core.dispatch._scales`` on their transposed
    stack; ``cols=(c0, n)``: channels ``c0 .. c0 + n - 1`` only."""
    if _use_kernel(leaves[0], backend):
        return _sf.squant_scales(leaves, bits, cols)
    return _sf.squant_scales_plain(leaves, bits, cols)


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


def expert_matmul(x: torch.Tensor, bank: dict, *, backend: str = "auto"
                  ) -> torch.Tensor:
    """x: (E, C, din) through a quantized expert bank → (E, C, dout).

    ``bank`` is an MoE bank as stored: ``{"w": QuantizedTensor}`` with
    ``(E*out, in)`` codes (``core.pipeline``) or the ``w_q``/``w_q4`` dict
    with ``(E, out, in)`` codes (``quant.apply``). The kernel: one
    dequant-matmul launch per expert on its ``(C, din)`` rows (contiguous,
    so 16-byte aligned for the tensor-core variants) and a zero-copy view
    of its codes. The plain version is the reference's form: the bank
    dequantized to the activation dtype and one batched ``torch.matmul``.
    """
    from repro_torch.quant.apply import dequant_bank, expert_view  # cycle
    e = x.shape[0]
    if _use_kernel(x, backend):
        x = x.contiguous()
        return torch.stack([dequant_matmul(x[i], expert_view(bank, i, e),
                                           backend="cuda")
                            for i in range(e)])
    return torch.matmul(x, dequant_bank(bank, e, x.dtype).transpose(1, 2))


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
             (_dm, "launches_by_shape"),
             (_pa, "launches"), (_paq, "launches"),
             (_sf, "launches"), (_sf, "launches_by_route"),
             (_sf, "scale_launches"))


# counters keyed by what was launched, with no fixed set of keys: a key
# that counts nothing is absent, never 0, so two counts compare equal
_OPEN = {"dequant_matmul.launches_by_shape"}


def _counter_key(mod, name: str) -> str:
    return f"{mod.__name__.rsplit('.', 1)[-1]}.{name}"


def launch_counts() -> Dict[str, Any]:
    """A snapshot of every wrapper's launch counters, keyed
    ``"<module>.<counter>"`` (the by-variant, by-shape and by-route dicts
    copied)."""
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
    out = {}
    for k, v in base.items():
        if not isinstance(v, dict):
            out[k] = v + times * tally[k]
            continue
        by = {j: v.get(j, 0) + times * tally[k].get(j, 0)
              for j in {**v, **tally[k]}}
        out[k] = {j: n for j, n in by.items() if n} if k in _OPEN else by
    return out


# the device symbol each wrapper launches once per call (a merge pass that
# follows it is not counted, as its wrapper does not count it)
_SYMBOL = re.compile(r"::(tcgemv_kernel|pf_kernel|gemv_kernel|tiled_kernel|"
                     r"paged_decode_split|squant_flip_kernel|"
                     r"squant_scale_kernel)(?:<([^()]*)>)?\(")
_VARIANT = {"tcgemv_kernel": "tcgemv", "pf_kernel": "mma",
            "gemv_kernel": "gemv", "tiled_kernel": "tiled"}
# the position of the F32 template argument of the tensor-core symbols: a
# "true" there is the float32 instance, variant "<variant>32"
_F32_ARG = {"tcgemv_kernel": 2, "pf_kernel": 3}
# the position of M among each kernel-B symbol's arguments (N follows it)
_M_ARG = {"tcgemv_kernel": 6, "pf_kernel": 6, "gemv_kernel": 5,
          "tiled_kernel": 5}


def count_kernels(kernels: Iterable) -> Dict[str, Any]:
    """The :func:`launch_counts` that device kernels make, one count per
    wrapper call. Each item is a demangled name, or a pair of a name and
    the kernel's (M, N) arguments (None where it has none), as
    :func:`graph_kernels` reads them: kernel B's variant by its symbol and
    its F32 template argument (and by its (M, N) where given), kernel C or D by
    ``paged_decode_split``'s QUANT argument, kernel A's route by
    ``squant_flip_kernel``'s V16 argument. Other kernels (PyTorch's, the
    merge passes) are not counted."""
    out = {k: ({} if k in _OPEN else {j: 0 for j in v})
           if isinstance(v, dict) else 0
           for k, v in launch_counts().items()}
    for item in kernels:
        nm, mn = (item, None) if isinstance(item, str) else item
        m = _SYMBOL.search(nm)
        if m is None:
            continue
        sym, args = m.group(1), [a.strip() for a in
                                 (m.group(2) or "").split(",")]
        if sym in _VARIANT:
            var = _VARIANT[sym]
            f = _F32_ARG.get(sym)
            if f is not None and len(args) > f and args[f] == "true":
                var += "32"
            out["dequant_matmul.launches"] += 1
            out["dequant_matmul.launches_by_variant"][var] += 1
            if mn is not None:
                by = out["dequant_matmul.launches_by_shape"]
                key = _dm.shape_key(var, *mn)
                by[key] = by.get(key, 0) + 1
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


def graph_kernels(raw_graph: int) -> list:
    """The kernel nodes of a ``cudaGraph_t`` (an address, as
    ``torch.cuda.CUDAGraph.raw_cuda_graph()`` gives it), read through the
    driver API: the kernels that every launch of the graph runs, as
    (demangled name, (M, N)) pairs; (M, N) are a kernel-B node's arguments
    read from the node, None for any other kernel."""
    cu = _driver()

    def check(r, what):
        if r != 0:
            raise RuntimeError(f"{what} failed (CUresult {r})")

    g, n = ctypes.c_void_p(raw_graph), ctypes.c_size_t(0)
    check(cu.cuGraphGetNodes(g, None, ctypes.byref(n)), "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * n.value)()
    check(cu.cuGraphGetNodes(g, nodes, ctypes.byref(n)), "cuGraphGetNodes")
    out = []
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
        nm = _demangle(name.value)
        sym = _SYMBOL.search(nm)
        mn = None
        if sym is not None and sym.group(1) in _M_ARG:
            if not prm.params:
                raise RuntimeError(f"the graph's {nm} node holds no "
                                   "argument pointers")
            args = ctypes.cast(prm.params, ctypes.POINTER(ctypes.c_void_p))
            i = _M_ARG[sym.group(1)]
            mn = (ctypes.c_int.from_address(args[i]).value,
                  ctypes.c_int.from_address(args[i + 1]).value)
        out.append((nm, mn))
    return out


def graph_launches(graph: "torch.cuda.CUDAGraph") -> Dict[str, Any]:
    """What one replay of ``graph`` launches, read from the graph the driver
    holds (:func:`graph_kernels`) and counted by name and kernel B's
    (M, N) (:func:`count_kernels`). ``graph`` must be captured with
    ``keep_graph=True``; nothing is launched."""
    return count_kernels(graph_kernels(graph.raw_cuda_graph()))
