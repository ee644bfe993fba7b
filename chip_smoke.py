#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (written for an H100).

Run from the repository root with no arguments:

    python3 chip_smoke.py

It needs one CUDA device, ``nvcc`` and nothing from the network. It
1. prints the card's name and power limit, the torch/CUDA versions, and builds
   the three CUDA sources of ``src/repro_torch/kernels/csrc`` (in parallel);
2. holds each kernel against its plain PyTorch version on the card, at the
   shapes the main paths use plus ragged ones (kernel A on (in, out) leaves
   as stored, at each bucket's real leaf count and shape, with its scale
   pass held bit for bit against ``core.dispatch._scales``; kernel B also at
   17, 43 and 64 prefill rows, two launches bit-identical; kernels C and D
   also at one slot and at long contexts), and times kernel, plain version,
   the bound and one library call (B, C, D and their yardsticks with a cold
   L2; B summed over one layer at the decode batch and at each prefill row
   count); also at phase 10's shapes: kernel A on its expert buckets read
   in place, kernel B at its expert banks' shapes (2048 -> 1408, 1408 ->
   2048) at 8 rows (``tcgemv``) and at a monolithic admission's capacity
   (``mma``), summed over one layer's 192 expert launches beside the
   reference's form (each bank dequantized, one batched matmul), kernel C
   at 16/16 heads (rep 1);
3. drives the round-scheduler path at the full width of granite-3-8b: random
   weights from a seed, SQuant w8 quantization of the whole tree (one
   kernel-A launch and one scale pass per bucket, every bucket read where it
   is stored; the quantize breakdown and its peak memory printed), six
   requests served real-quantized through ``ServeEngine`` (round scheduler,
   contiguous KV cache), with the kernels' launch counters read around it;
4. does the same with 4-bit weights at a reduced depth;
5. runs prefill + 8 decode steps at full width and 2 layers in float32 (and
   again in bfloat16, teacher-forced, with kernel B's launches by variant
   checked), and the paged continuous path at 2 layers in float32 and, with
   32-row admission chunks, in bfloat16 (teacher-forced, launches by
   variant checked), once through the kernels and once through their plain
   versions, and compares codes, logits and tokens;
6. drives this slice's main path at full width and full depth: SQuant w8,
   the continuous scheduler on the paged KV cache with chunked admission,
   its decode step and each chunk width captured as CUDA graphs (one
   capture each, counted in ``trace_counts``), twelve chat requests sharing
   a 192-token system prefix (prefix hits, copy-on-write, mid-flight
   admission, retirement), launch counters read around the run, the block
   pool checked after it; the same requests twice more on that engine (no
   capture for a shape seen before), a fresh set of requests (new widths
   captured while requests wait), and once on the same configuration run
   eagerly (``capture=False``): greedy tokens bit-identical, and launch
   counts equal, the captured run's read as what the wrappers issued plus
   what each graph launches in a replay, read by kernel name from its nodes
   through the driver, times its replays; then every chunk width captured
   (the cost of capturing them all up front); then teacher-forced greedy
   agreement against the contiguous continuous engine (in bfloat16 also
   the float32 oracle's top-2 logit margin at every disagreement);
7. does the same traffic with the int8 KV pool at a reduced depth, with the
   same captured-vs-eager checks, held to the reference's ``int8_kv``
   agreement budget against the fp paged pool;
8. serves phase 6's traffic and configuration with self-speculative
   decoding at full width and depth: the w4 tree of the same fp weights
   drafts four tokens a cycle, the w8 tree verifies them in one forward
   (its verify forward and the draft chain captured as CUDA graphs, one per
   width); a first run (launches held to the eager run's and to what the
   path implies), a second, a repeat that captures nothing, an eager run
   and the verifier-only engine: tokens of every request bit-identical to
   verifier-only decode (also in float32 at 2 layers), acceptance,
   tokens per second against the verifier alone in the same call;
9. native quantized serving checkpoints: (a) phase 6's fp tree quantized
   into the ``w_q`` + ``w_scale`` serving format by ``quant.apply`` on the
   card (kernel A, one launch a leaf), saved as a native w8 checkpoint
   (``checkpoint.Checkpointer.save_serving``) in a temporary directory,
   the device copies freed, restored onto the card and served in phase 6's
   configuration, captured: tokens bit-identical to the never-saved tree,
   leaves byte-equal, kernel B launches those of phase 6; quantize, save,
   restore and stage times; (b) live reload at 4 layers: the engine watches
   a directory while a writer saves an fp step, a native w8 step, a torn
   step and a w4 step, requests flowing: every completion full length,
   sources ``ckpt:1`` then ``ckpt:2``, the w4 step rejected, the torn one
   unseen, tokens after the last swap those of a fresh engine on the
   restored tree; what a device-wide synchronization does to another
   thread's capture, in a process of its own; (c) the quantize and serve
   CLIs as processes (serve swaps in the quantize CLI's checkpoint);
10. a fine-grained mixture of experts, ``moonshot-v1-16b-a3b`` (64
   experts top-6) at full width and 16 of its 48 layers (the cut is listed
   in the phase's line: 48 layers of float32 weights do not fit one card):
   (a) SQuant w8 of the whole tree, every expert bank quantized where it is
   stored (native route, nothing stacked), phase 6's serve configuration
   and traffic, captured, repeated and eager (tokens bit-identical,
   launches equal; kernel B's launches split into experts and attention by
   variant, every expert launch ``tcgemv``); (b) 2 layers in float32
   through the kernels against the plain versions; (c) 2 layers in float32,
   teacher-forced agreement against a one-slot contiguous oracle that
   admits in the same 64-token chunks, held to the reference's ``moe``
   budget (0.85), and, printed beside it, against the monolithic one; (d)
   the Hessian analysis
   (approximation precision) and the AdaRound and RTN baselines on one
   layer on the card.
The phases run in the order 1, 4, 3, 6, 7, 8, 9, 10, 2, 5: the short w4
run pays the one-time start-up costs, and phase 2 times the kernels at the
shapes phases 3, 6, 8 and 10 produced. The last three lines are the card line, the ``kernels``
line and the ``ok`` line.
Every line it prints is one JSON object, apart from the card line. Any failed
phase raises: the script then exits non-zero and prints no final ``ok`` line.
Depth can be cut with ``--layers`` (phases 3 and 6), ``--layers4`` (phase 4),
``--layers7`` (phase 7), ``--layers8`` (phase 8), ``--layers9`` (phase
9a) and ``--layers10`` (phase 10a); widths are never cut.
"""
import argparse
import dataclasses
import json
import math
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}   # CUDA cores / tensor cores
A_OPS_PER_ELEMENT = 6          # divide, round, two clamps, subtract, add to the sum
L2_COLD_BYTES = 2 * 50e6       # twice the H100's 50 MB L2: cycling input sets
                               # whose reads exceed it times cold launches

KERNEL_A = {"name": "squant_flip", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/squant_flip.cu",
            "replaces": "src/repro/kernels/squant_flip.py:66",
            "also_replaces": "src/repro/kernels/squant_flip.py:97"}
KERNEL_B = {"name": "dequant_matmul", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/dequant_matmul.cu",
            "replaces": "src/repro/kernels/dequant_matmul.py:35"}
KERNEL_C = {"name": "paged_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
            "replaces": "src/repro/kernels/paged_attention.py:79"}
KERNEL_SCALE = {"name": "squant_scale", "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/squant_flip.cu",
                "replaces": "src/repro/core/dispatch.py:60",
                "note": "the bucket scales kernel A divides by; the reference "
                        "computes them with jnp ops (no Pallas kernel)"}
KERNEL_D = {"name": "paged_attention_quant", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
            "replaces": "src/repro/kernels/paged_attention_quant.py:88"}


def emit(obj):
    print(json.dumps(obj), flush=True)


def time_ms(fns, iters, graph=True):
    """Mean milliseconds of one call, cycling through ``fns`` (several
    closures over different buffers, so a small operand is not served from
    the L2 cache by the previous iteration), between two CUDA events.

    ``graph=True`` records the calls into a CUDA graph and times its replay:
    that is the device's time, free of the host's cost of issuing each call
    (tens of microseconds in Python, more than a small kernel runs).
    ``graph=False`` times the calls as a program makes them."""
    for f in fns:
        f()
    torch.cuda.synchronize()
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for i in range(iters):
                fns[i % len(fns)]()
        g.replay()
        torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    if graph:
        g.replay()
    else:
        for i in range(iters):
            fns[i % len(fns)]()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def host_ms(fns, iters):
    """Mean host milliseconds to issue one call from Python, until the call
    returns (not until its kernels end): what an eager decode step pays per
    call. Few enough calls that the launch queue never fills."""
    for f in fns:
        f()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(iters):
        fns[i % len(fns)]()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t * 1e3 / iters


# ---------------------------------------------------------------------------
# phase 2a: kernel A against its plain version
# ---------------------------------------------------------------------------

def check_kernel_a(dev, gen, buckets, moe_buckets=()):
    """Kernel A against its plain version (exact and random inputs, heavy
    clipping), then the native-layout launches at each bucket of the main
    path's tree (``buckets``: (leaves, in, out)) and of phase 10's
    (``moe_buckets``: (leaves, experts, in, out), an expert bucket's
    leaves the expert slices of its banks, read where they are stored):
    every leaf against the plain versions, the scale pass and the flip
    timed against their bytes bound."""
    from repro_torch.kernels import squant_flip as sf
    from repro_torch.kernels.ref import explain_code_differences
    from repro_torch.quant.scales import compute_scale

    stages = {"E": (False, False), "EK": (True, False), "EKC": (True, True)}
    cmp_shapes = [(4096, 4096, 128), (12800, 4096, 128), (4096, 12800, 128),
                  (37, 1000, 128)]
    worst = 0
    ties = {"rows": 0, "rows_differing": 0, "unexplained": 0}
    for (m, n, g) in cmp_shapes:
        for bits in (4, 8):
            for tag, (ek, ec) in stages.items():
                kw = dict(bits=bits, group_size=g, enable_k=ek, enable_c=ec)
                # (i) exact inputs: weights on a binary grid, power-of-two
                # scale -> every sum is exact in float32 in any order
                w = torch.randint(-400, 401, (m, n), generator=gen,
                                  device=dev).float() / 64.0
                s = torch.full((m, 1), 2.0 ** (-1 if bits == 8 else 0),
                               device=dev)
                got = sf.squant_flip(w, s, **kw)
                want = sf.squant_flip_plain(w, s, **kw)
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    raise AssertionError(f"kernel A != plain on exact inputs "
                                         f"{(m, n, g, bits, tag)}")
                # (ii) random normal weights through compute_scale
                w = torch.randn((m, n), generator=gen, device=dev)
                s = compute_scale(w, bits, "max")
                got = sf.squant_flip(w, s, **kw)
                want = sf.squant_flip_plain(w, s, **kw)
                res = explain_code_differences(w, s, got, want, **kw)
                worst = max(worst, int((got.int() - want.int()).abs().max()))
                for k in ties:
                    ties[k] += res[k]
                if res["unexplained"]:
                    raise AssertionError(f"kernel A differs from plain beyond "
                                         f"the tie rule at "
                                         f"{(m, n, g, bits, tag)}: {res}")
                del w, s, got, want
    # heavy clipping: codes pile up at +-qmax, eligibility needs the grid test
    w = torch.randn((64, 1024), generator=gen, device=dev) * 4.0
    w = torch.round(w * 16) / 16
    s = torch.full((64, 1), 0.5, device=dev)
    for bits in (4, 8):
        if not torch.equal(sf.squant_flip(w, s, bits=bits, group_size=128),
                           sf.squant_flip_plain(w, s, bits=bits,
                                                group_size=128)):
            raise AssertionError("kernel A != plain under heavy clipping")

    # the native-layout launches at each bucket's real B x (in, out) of the
    # main path's tree: random leaves, the scale pass and the flip timed,
    # every leaf held against the plain versions
    from repro_torch.core.dispatch import _scales
    a0 = dict(sf.launches_by_route)
    shapes, scale_rows = [], []
    tot = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
    stot = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0}
    kw = dict(bits=8, group_size=128)
    moe_tot = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "scale_ms": 0.0,
               "scale_bound_ms": 0.0}
    moe_rows = []
    for i, (nb, experts, kin, nch) in enumerate(
            [(nb, 1, kin, nch) for nb, kin, nch in buckets]
            + list(moe_buckets)):
        is_moe = i >= len(buckets)
        # an expert bucket: nb / experts banks (experts, in, out), each
        # expert's slice one (in, out) leaf
        leaves = [sl for _ in range(nb // experts)
                  for sl in torch.randn((experts, kin, nch), generator=gen,
                                        device=dev).unbind(0)]
        # exact inputs on the first leaf's shape: codes equal
        gw = torch.randint(-400, 401, (kin, nch), generator=gen,
                           device=dev).float() / 64.0
        gs = torch.full((1, nch), 0.5, device=dev)
        if not torch.equal(sf.squant_flip_leaves([gw], gs, **kw),
                           sf.squant_flip_leaves_plain([gw], gs, **kw)):
            raise AssertionError(f"kernel A (native) != plain on exact inputs "
                                 f"at {(kin, nch)}")
        del gw
        s = sf.squant_scales(leaves, 8)
        for b, leaf in enumerate(leaves):
            if not torch.equal(s[b], _scales(leaf.T[None], 8, "max")[0, :, 0]):
                raise AssertionError(f"scale pass != _scales at {(kin, nch)}")
        s_ms = time_ms([lambda: sf.squant_scales(leaves, 8)], 3)
        s_plain = time_ms([lambda: sf.squant_scales_plain(leaves, 8)], 1,
                          graph=False)
        lib_ms = time_ms([lambda: [torch.linalg.vector_norm(
            leaf, float("inf"), dim=0) for leaf in leaves]], 1, graph=False)
        s_bytes = nb * (kin * nch * 4 + nch * 4)
        s_bound = s_bytes / HBM_BYTES_PER_S * 1e3
        srow = {"leaves": nb, "in": kin, "out": nch, "ms": s_ms,
                "bound_ms": s_bound, "bound_share": s_bound / s_ms,
                "plain_ms": s_plain, "library_ms": lib_ms}
        if is_moe:
            moe_tot["scale_ms"] += s_ms
            moe_tot["scale_bound_ms"] += s_bound
        else:
            scale_rows.append(srow)
            stot["ms"] += s_ms
            stot["plain_ms"] += s_plain
            stot["bound_ms"] += s_bound
            stot["library_ms"] += lib_ms

        got = sf.squant_flip_leaves(leaves, s, **kw)
        again = sf.squant_flip_leaves(leaves, s, **kw)
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise AssertionError(f"kernel A (native) launches differ at "
                                 f"{(nb, kin, nch)}")
        del again
        plain_ms = 0.0
        for b, leaf in enumerate(leaves):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            want = sf.squant_flip_leaves_plain([leaf], s[b:b + 1], **kw)[0]
            e1.record()
            torch.cuda.synchronize()
            plain_ms += e0.elapsed_time(e1)
            res = explain_code_differences(leaf.T, s[b][:, None], got[b],
                                           want, **kw)
            worst = max(worst, int((got[b].int() - want.int()).abs().max()))
            for k in ties:
                ties[k] += res[k]
            if res["unexplained"]:
                raise AssertionError(f"kernel A (native) differs from plain "
                                     f"beyond the tie rule at "
                                     f"{(nb, kin, nch)}: {res}")
            del want
        ms = time_ms([lambda: sf.squant_flip_leaves(leaves, s, **kw)], 3)
        nbytes = nb * (kin * nch * 5 + nch * 4)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = A_OPS_PER_ELEMENT * nb * kin * nch / PEAK_FLOPS["float32"] * 1e3
        bound = max(t_bytes, t_ops)
        row = {"leaves": nb, "in": kin, "out": nch,
               "route": sf.route(nch, True), "ms": ms,
               "plain_ms": plain_ms, "bound_ms": bound,
               "bound_share": bound / ms,
               "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
        if is_moe:
            row.update(experts=experts, banks=nb // experts,
                       launches=-(-nb // sf.MAX_LEAVES), scale_ms=s_ms,
                       scale_bound_ms=s_bound)
            moe_rows.append(row)
            for k in ("ms", "plain_ms", "bound_ms"):
                moe_tot[k] += row[k]
        else:
            shapes.append(row)
            for k in tot:
                tot[k] += row[k]
        del leaves, s, got
        torch.cuda.empty_cache()
    routes = {k: sf.launches_by_route[k] - a0[k] for k in a0}
    if routes["cp16"] == 0:
        raise AssertionError(f"no native launch took the 16-byte route: "
                             f"{routes}")
    entry = dict(KERNEL_A, max_abs_err=worst, tolerance="codes equal; rows that "
                 "differ must be explained by a float32 tie (1e-4) and keep "
                 "the paper's invariants", tie_rule=ties,
                 numbers_are="sums over the launches of one quantize_tree of "
                 "the main path's model (one per bucket)", timing="ms: device "
                 "time (CUDA graph replay); plain_ms: eager calls, leaf by "
                 "leaf", library_ms=None, bound_by="bytes", shapes=shapes,
                 bound_share=tot["bound_ms"] / tot["ms"], **tot)
    if moe_rows:
        entry["moe_tree"] = dict(
            moe_tot, model=MOE_ARCH, buckets=moe_rows,
            bound_share=moe_tot["bound_ms"] / moe_tot["ms"],
            numbers_are="sums over the launches of one quantize_tree of "
            "phase 10's tree: the expert buckets read in place (the flip "
            "takes up to MAX_LEAVES slices a launch) and the attention "
            "bucket")
    scale = dict(KERNEL_SCALE, max_abs_err=0.0, tolerance="bit-identical to "
                 "core.dispatch._scales on every leaf", bound_by="bytes",
                 numbers_are="sums over the launches of one quantize_tree of "
                 "the main path's model (one per bucket)", timing="ms: device "
                 "time (CUDA graph replay); plain_ms and library_ms: eager "
                 "calls", library="torch.linalg.vector_norm(leaf, inf, "
                 "dim=0), one call a leaf", bound_share=stot["bound_ms"] /
                 stot["ms"], shapes=scale_rows, **stot)
    return entry, scale


# ---------------------------------------------------------------------------
# phase 2b: kernel B against its plain version
# ---------------------------------------------------------------------------

def _b_case(dev, gen, m, n, bits, per_group, copies=1):
    from repro_torch.quant.qtypes import pack_int4
    qmax = 2 ** (bits - 1) - 1
    out = []
    for _ in range(copies):
        codes = torch.randint(-qmax, qmax + 1, (m, n), generator=gen,
                              device=dev, dtype=torch.int8)
        data = pack_int4(codes) if bits <= 4 else codes
        # scales of the size SQuant gives weights of std 1/sqrt(N)
        sc = (torch.rand((m, n // 128 if per_group else 1), generator=gen,
                         device=dev) + 0.5) * (3.0 / math.sqrt(n) / qmax)
        out.append((data, sc))
    return out


def check_kernel_b(dev, gen, decode_batches, prefill_rows, draft_rows=(),
                   experts=None):
    """Kernel B against its plain version at the main paths' shapes, a
    ragged N and a ragged M, every variant and dtype (bfloat16 also at the
    prefill variant's 17, 43 and 64 rows: a chunk tail, a ragged chunk, a
    whole chunk); two launches bit-identical at every comparison; then times
    at the seven projections' shapes, bfloat16, int8, per-channel scales:
    the decode batches (the first, phase 6's, is the headline sum over one
    layer), the prefill rows (each summed over one layer too), 4-bit
    codes at the first decode batch, and 4-bit codes on the ``mma``
    variant at phase 8's drafter admission prefills (``draft_rows``, at
    (4096, 4096) and (12800, 4096)). Kernel and ``torch.matmul`` yardstick
    alike are timed by CUDA-graph replay with a cold L2: the calls cycle
    through input sets whose reads exceed twice the L2. ``experts`` (phase
    10's: ``n_experts``, ``banks`` as (name, out, in), ``rows``): kernel B
    at each expert bank's shape and each capacity in ``rows``, against the
    plain version, summed over one layer's launches (one per expert and
    bank) beside their bound, and beside the reference's form of the same
    products: each bank dequantized and one batched ``torch.matmul``."""
    from repro_torch.kernels import dequant_matmul as dm
    from repro_torch.kernels import ops

    launches_before = ops.launch_counts()
    layer = [("wq", 4096, 4096), ("wk", 1024, 4096), ("wv", 1024, 4096),
             ("wo", 4096, 4096), ("wi", 12800, 4096), ("wg", 12800, 4096),
             ("wdown", 4096, 12800)]
    mn = sorted({(m, n) for _, m, n in layer})
    worst = {"float32": 0.0, "bfloat16": 0.0}
    worst_rel = {"float32": 0.0, "bfloat16": 0.0}
    n_cmp = 0
    for (m, n) in mn + [(100, 1000), (1000, 4096)]:
        for b in sorted({1, 8, 16, 17, 43, 64, 512} | set(decode_batches)):
            for bits in (8, 4):
                for dt in (torch.float32, torch.bfloat16):
                    if dt == torch.float32 and b in (17, 43, 64):
                        continue
                    for per_group in (False, True):
                        if per_group and n % 128:
                            continue
                        (data, sc), = _b_case(dev, gen, m, n, bits, per_group)
                        x = torch.randn((b, n), generator=gen,
                                        device=dev).to(dt)
                        gs = 128 if n % 128 == 0 else n
                        y = dm.dequant_matmul(x, data, sc, bits=bits,
                                              group_size=gs).float()
                        r = dm.dequant_matmul_plain(x, data, sc, bits=bits,
                                                    group_size=gs).float()
                        torch.cuda.synchronize()
                        # float32: 1e-4 relative plus 1e-4 of the output's
                        # magnitude (the float32 sum over N = 4096..12800
                        # terms is taken in another order than the plain
                        # version's matmul); bfloat16: 2e-2 both, one
                        # rounding of the output
                        tol = 1e-4 if dt == torch.float32 else 2e-2
                        scale_ = max(float(r.abs().max()), 1.0)
                        err = float((y - r).abs().max())
                        name = str(dt).replace("torch.", "")
                        worst[name] = max(worst[name], err)
                        worst_rel[name] = max(worst_rel[name], err / scale_)
                        if not torch.allclose(y, r, rtol=tol, atol=tol * scale_):
                            raise AssertionError(
                                f"kernel B != plain at {(b, m, n, bits, name, per_group)}"
                                f": max abs err {err}, max |ref| {scale_}")
                        if not torch.equal(
                                y, dm.dequant_matmul(x, data, sc, bits=bits,
                                                     group_size=gs).float()):
                            raise AssertionError(
                                f"kernel B: two launches differ at "
                                f"{(b, m, n, bits, name, per_group)}")
                        n_cmp += 1

    def timed(m, n, b, bits, dt):
        wbytes = m * n // (2 if bits <= 4 else 1)
        n_sets = max(2, min(64, math.ceil(L2_COLD_BYTES / wbytes)))
        cases = _b_case(dev, gen, m, n, bits, False, n_sets)
        x = torch.randn((b, n), generator=gen, device=dev).to(dt)
        y = dm.dequant_matmul(x, *cases[0], bits=bits, group_size=128).float()
        r = dm.dequant_matmul_plain(x, *cases[0], bits=bits,
                                    group_size=128).float()
        tol = 1e-4 if dt == torch.float32 else 2e-2
        if not torch.allclose(y, r, rtol=tol,
                              atol=tol * max(float(r.abs().max()), 1.0)):
            raise AssertionError(f"kernel B != plain at the main path's "
                                 f"{(b, m, n, bits)}")
        var, splits, ups = dm.launch_plan(x, cases[0][0], m, 1, 128, bits)
        iters = max(40 if b <= 16 else 6, 2 * n_sets)
        calls = [(lambda d=d, s=s: dm.dequant_matmul(
            x, d, s, bits=bits, group_size=128)) for d, s in cases]
        ms = time_ms(calls, iters)
        wrapper_ms = time_ms(calls, iters, graph=False)
        call_host_ms = host_ms(calls, iters)
        plain_ms = time_ms([(lambda d=d, s=s: dm.dequant_matmul_plain(
            x, d, s, bits=bits, group_size=128)) for d, s in cases[:2]], 4,
            graph=False)
        # the library's call for the same function: one matmul on weights
        # dequantized beforehand (timed only; the port never calls it), on
        # enough copies that its reads too exceed twice the L2
        esz = 2 if dt == torch.bfloat16 else 4
        n_lib = max(2, math.ceil(L2_COLD_BYTES / (m * n * esz)))
        deq = [(dm.unpack_int4(d) if bits <= 4 else d).to(dt) * s.to(dt)
               for d, s in (cases[i % n_sets] for i in range(n_lib))]
        lib_calls = [(lambda w=w: torch.matmul(x, w.T)) for w in deq]
        lib_ms = time_ms(lib_calls, max(iters, 2 * n_lib))
        lib_host_ms = host_ms(lib_calls, max(iters, 2 * n_lib))
        del deq, cases
        name = str(dt).replace("torch.", "")
        nbytes = wbytes + m * 4 + b * n * esz + b * m * esz
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = 2.0 * b * m * n / PEAK_FLOPS[name] * 1e3
        bound = max(t_bytes, t_ops)
        return {"m": m, "n": n, "batch": b, "bits": bits, "dtype": name,
                "variant": var, "splits": splits, "units_per_split": ups,
                "input_sets": n_sets,
                "library_input_sets": n_lib,
                "ms": ms, "eager_call_ms": wrapper_ms,
                "host_ms": call_host_ms, "plain_ms": plain_ms,
                "library_ms": lib_ms, "library_host_ms": lib_host_ms,
                "bound_ms": bound,
                "bound_share": bound / ms,
                "bound_by": "bytes" if t_bytes >= t_ops else "operations"}

    shapes = []
    tot = {"ms": 0.0, "eager_call_ms": 0.0, "host_ms": 0.0, "plain_ms": 0.0,
           "bound_ms": 0.0, "library_ms": 0.0, "library_host_ms": 0.0}
    head = decode_batches[0]
    per_mn = {}
    for (m, n) in mn:
        per_mn[(m, n)] = timed(m, n, head, 8, torch.bfloat16)
        shapes.append(per_mn[(m, n)])
        torch.cuda.empty_cache()
    for _, m, n in layer:                 # one decode step of one layer
        for k in tot:
            tot[k] += per_mn[(m, n)][k]
    for (m, n) in mn:                     # the rest of the main paths' shapes
        for b in list(decode_batches[1:]) + list(prefill_rows):
            per_mn[(b, m, n)] = timed(m, n, b, 8, torch.bfloat16)
            shapes.append(per_mn[(b, m, n)])
        shapes.append(timed(m, n, head, 4, torch.bfloat16))
        torch.cuda.empty_cache()
    # kernel B int4 on the mma variant at the drafter's admission prefill
    # rows (phase 8): compared with the plain version and timed
    draft_prefill = []
    for b in draft_rows:
        for (m, n) in ((4096, 4096), (12800, 4096)):
            row = timed(m, n, b, 4, torch.bfloat16)
            if row["variant"] != "mma":
                raise AssertionError(f"int4 at {b} rows took {row}")
            draft_prefill.append(row)
        torch.cuda.empty_cache()
    # one layer's seven projections at each prefill row count (an admission
    # chunk of phase 6, the round path's prefills)
    prefill_layers = {}
    for b in prefill_rows:
        rows = [per_mn[(b, m, n)] for _, m, n in layer]
        lt = {k: sum(r[k] for r in rows) for k in (
            "ms", "library_ms", "bound_ms", "plain_ms")}
        prefill_layers[str(b)] = dict(
            lt, bound_share=lt["bound_ms"] / lt["ms"],
            library_bound_share=lt["bound_ms"] / lt["library_ms"],
            faster_than_library_each=all(r["ms"] < r["library_ms"]
                                         for r in rows),
            variant=sorted({r["variant"] for r in rows}),
            splits={f"({r['m']},{r['n']})": r["splits"] for r in rows})
    expert_layer = None
    if experts is not None:
        expert_layer = {}
        e = experts["n_experts"]
        for c in experts["rows"]:
            per = {}
            for _, m, n in experts["banks"]:
                if (m, n) not in per:
                    per[(m, n)] = timed(m, n, c, 8, torch.bfloat16)
                    torch.cuda.empty_cache()
            lt = {k: e * sum(per[(m, n)][k] for _, m, n in experts["banks"])
                  for k in ("ms", "library_ms", "bound_ms", "plain_ms")}
            yard = sum(_bank_matmul_ms(dev, gen, e, m, n, c)
                       for _, m, n in experts["banks"])
            expert_layer[str(c)] = dict(
                lt, launches=e * len(experts["banks"]),
                bound_share=lt["bound_ms"] / lt["ms"],
                dequant_bank_matmul_ms=yard,
                variant=sorted({r["variant"] for r in per.values()}),
                per_launch=list(per.values()))
            if expert_layer[str(c)]["variant"] != [_variant(c)]:
                raise AssertionError(f"expert launches at {c} rows took "
                                     f"{expert_layer[str(c)]['variant']}")
    # comparisons and timings are not the path's launches
    ops.set_launch_counts(launches_before)
    entry = dict(KERNEL_B, experts=expert_layer, max_abs_err=worst["bfloat16"],
                 max_abs_err_float32=worst["float32"],
                 max_rel_err=worst_rel,
                 tolerance="float32: rtol 1e-4, atol 1e-4*max|ref| (sum order "
                 "over N up to 12800); bfloat16: rtol 2e-2, atol 2e-2*max|ref|;"
                 " two launches: output bits equal",
                 comparisons=n_cmp,
                 numbers_are=f"sums over the seven projections of one layer in "
                 f"one decode step: batch {head}, bfloat16, int8 codes, "
                 f"per-channel scales; prefill_layers: the same sums at each "
                 f"prefill row count",
                 timing="ms, library_ms: device time (CUDA graph replay) with "
                 "a cold L2: the calls cycle through input sets whose reads "
                 "exceed twice the L2; eager_call_ms: the wrapper called from "
                 "Python, host cost included; host_ms, library_host_ms: host "
                 "time to issue one call (perf_counter, no sync); plain_ms: "
                 "eager calls",
                 bound_share=tot["bound_ms"] / tot["ms"],
                 bound_by="bytes", prefill_layers=prefill_layers,
                 draft_prefill_int4=draft_prefill,
                 shapes=shapes, **tot)
    return entry


def _bank_matmul_ms(dev, gen, e, m, n, c):
    """Device ms of the plain version of one expert bank's product on the
    card, the reference's form: the ``(e*m, n)`` int8 bank dequantized to
    bfloat16 and one batched ``torch.matmul`` on ``(e, c, n)`` rows
    (``ops.expert_matmul`` under ``force_backend("ref")``), two banks
    cycled (each ``e*m*n`` bytes, past the L2)."""
    from repro_torch.kernels import ops
    from repro_torch.quant.qtypes import QuantizedTensor
    banks = [{"w": QuantizedTensor(data=d, scale=sc, bits=8,
                                   shape=(e * m, n))}
             for d, sc in _b_case(dev, gen, e * m, n, 8, False, 2)]
    x = torch.randn((e, c, n), generator=gen, device=dev).to(torch.bfloat16)
    with ops.force_backend("ref"):
        ms = time_ms([(lambda b=b: ops.expert_matmul(x, b)) for b in banks],
                     4)
    del banks
    torch.cuda.empty_cache()
    return ms


# ---------------------------------------------------------------------------
# phases 3 and 4: the main path
# ---------------------------------------------------------------------------

def make_requests(seed, vocab, lengths, max_new):
    import numpy as np
    from repro_torch.serving import Request
    rng = np.random.default_rng(seed)
    return [Request(rng.integers(0, vocab, size=n).tolist(), max_new,
                    request_id=i) for i, n in enumerate(lengths)]


def drive(dev, seed, layers, bits, lengths, max_batch, max_new, phase):
    from repro_torch.configs import get_config
    from repro_torch.kernels import dequant_matmul as dm
    from repro_torch.kernels import squant_flip as sf
    from repro_torch.models.model import build_model
    from repro_torch.serving import ServeConfig, ServeEngine

    full = get_config("granite-3-8b")
    cfg = dataclasses.replace(full, n_layers=layers)
    model = build_model(cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    t0 = time.perf_counter()
    params = model.init(gen, device=dev)
    torch.cuda.synchronize()
    init_ms = (time.perf_counter() - t0) * 1e3

    sf.launches = sf.scale_launches = 0
    sf.launches_by_route = dict.fromkeys(sf.ROUTES, 0)
    dm.launches = 0
    dm.launches_by_variant = dict.fromkeys(dm.VARIANTS, 0)
    weights_bytes = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    eng = ServeEngine(model, params, ServeConfig(
        max_batch=max_batch, max_len=256, quantize_weights="squant",
        weight_bits=bits, dequantize_for_compute=False), device=dev)
    quant_peak_gb = (torch.cuda.max_memory_allocated() - weights_bytes) / 1e9
    scale_launches = sf.scale_launches
    a_routes = dict(sf.launches_by_route)
    del params
    torch.cuda.empty_cache()
    rep = eng.quant_report
    reqs = make_requests(seed, cfg.vocab, lengths, max_new)
    outs = eng.generate(reqs)
    torch.cuda.synchronize()
    a_launches, b_launches = sf.launches, dm.launches     # read right after

    st = eng.stats()
    forwards = 0
    rounds = []
    for i, rl in enumerate(st["round_log"]):
        chunk = lengths[i * max_batch:(i + 1) * max_batch]
        # no EOS: a round samples max_new times and, like the reference
        # scheduler, runs a decode forward after every sample
        steps = max_new
        forwards += 1 + steps               # 1 prefill + max_new decodes
        rounds.append({"requests": rl["requests"], "prompt_len": max(chunk),
                       "prefill_ms": rl["prefill_ms"],
                       "decode_ms": rl["decode_ms"],
                       "ms_per_decode_step": rl["decode_ms"] / steps})
    if st["scheduler"].steps != len(rounds) * max_new:
        raise AssertionError(f"sampling steps {st['scheduler'].steps} != "
                             f"{len(rounds) * max_new}")
    # one kernel-A launch and one scale pass per bucket, every bucket read
    # where it is stored (the native route): nothing stacked
    want_a = len(rep.buckets)
    want_b = 7 * layers * forwards
    if not all("g128" in b.key for b in rep.buckets):
        raise AssertionError("a bucket of the full-width tree is not grouped")
    if not all(b.route == "native" for b in rep.buckets):
        raise AssertionError(f"a bucket took the stacked route: "
                             f"{[(b.key, b.route) for b in rep.buckets]}")
    if a_launches != want_a or a_launches == 0 or scale_launches != want_a:
        raise AssertionError(f"kernel A launches {a_launches} (scale pass "
                             f"{scale_launches}), path implies {want_a}")
    if b_launches != want_b or b_launches == 0:
        raise AssertionError(f"kernel B launches {b_launches}, path implies {want_b}")
    for o, r in zip(outs, reqs):
        if len(o.tokens) != r.max_new_tokens or \
                not all(0 <= t < cfg.vocab for t in o.tokens):
            raise AssertionError(f"request {r.request_id}: bad tokens {o.tokens}")
    # the served tree gives finite logits of the right shape
    cache = eng.model.init_cache(1, 64, device=dev)
    lg, _ = eng.model.prefill(eng.params, {"tokens": torch.tensor(
        [reqs[0].prompt[:16]], device=dev)}, cache)
    if tuple(lg.shape) != (1, cfg.vocab) or not bool(torch.isfinite(lg).all()):
        raise AssertionError("logits of the served tree are not finite")
    buckets = []                            # (leaves, in, out)
    for b in rep.buckets:                   # "(M,N)xB dtype gG", M = out
        mn, rest = b.key.split(")x")
        m, n = (int(v) for v in mn[1:].split(","))
        buckets.append((int(rest.split(" ")[0]), n, m))
    emit({"phase": phase, "model": cfg.name, "layers": layers,
          "full_depth": layers == full.n_layers, "d_model": cfg.d_model,
          "d_ff": cfg.d_ff, "vocab": cfg.vocab, "weight_bits": bits,
          "activation_dtype": cfg.dtype, "dense_weight_dtype": "float32",
          "init_ms": init_ms, "quant_report": rep.summary(),
          "quantize_total_ms": rep.total_millis,
          "quantize_dispatch_ms": rep.dispatch_millis,
          "quantize_sync_ms": rep.sync_millis,
          "staged_ms": eng.store.current.staged_ms,
          "quantize_buckets": [{"key": b.key, "route": b.route,
                                "dispatch_ms": b.dispatch_millis}
                               for b in rep.buckets],
          "quantize_peak_gb_above_weights": quant_peak_gb,
          "rounds": rounds, "tokens": [o.tokens for o in outs],
          "launches": {"squant_flip": a_launches,
                       "squant_flip_by_route": a_routes,
                       "squant_scale": scale_launches,
                       "dequant_matmul": b_launches,
                       "dequant_matmul_by_variant": dict(
                           dm.launches_by_variant)},
          "mma_plans": dm.cached_plans("mma"),
          "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9})
    eng.close()
    del eng, outs, cache, lg
    torch.cuda.empty_cache()
    return a_launches, b_launches, buckets, scale_launches


# ---------------------------------------------------------------------------
# phase 5: the slice through its kernels against the slice through the plain
# versions
# ---------------------------------------------------------------------------

def slice_vs_plain(dev, seed):
    from repro_torch.configs import get_config
    from repro_torch.core.pipeline import quantize_tree
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import explain_code_differences
    from repro_torch.models.model import build_model

    cfg = dataclasses.replace(get_config("granite-3-8b"), n_layers=2,
                              dtype="float32")
    model = build_model(cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    params = model.init(gen, device=dev)
    tree_k, _ = quantize_tree(params, method="squant", bits=8, device=dev)
    with ops.force_backend("ref"):
        tree_p, _ = quantize_tree(params, method="squant", bits=8, device=dev)
    ties = {"rows": 0, "rows_differing": 0, "unexplained": 0}
    for li in range(2):
        for grp in ("attn", "ffn"):
            for name, leaf in params["stack"]["list"][li]["b0"][grp].items():
                qk = tree_k["stack"]["list"][li]["b0"][grp][name]["w"]
                qp = tree_p["stack"]["list"][li]["b0"][grp][name]["w"]
                if not torch.equal(qk.scale, qp.scale):
                    raise AssertionError("scales differ between backends")
                res = explain_code_differences(
                    leaf["w"].T, qp.scale, qk.data, qp.data, bits=8,
                    group_size=128)
                for k in ties:
                    ties[k] += res[k]
    if ties["unexplained"]:
        raise AssertionError(f"codes differ beyond the tie rule: {ties}")
    del params
    torch.cuda.empty_cache()

    prompt = torch.randint(0, cfg.vocab, (2, 24), generator=gen, device=dev)

    def run(tree):
        cache = model.init_cache(2, 64, device=dev)
        lg, cache = model.prefill(tree, {"tokens": prompt}, cache)
        logits, toks = [lg], []
        for _ in range(8):
            nxt = lg.argmax(-1)
            toks.append(nxt.tolist())
            lg, cache = model.decode_step(tree, nxt[:, None], cache)
            logits.append(lg)
        return torch.stack(logits), toks

    lk, tk = run(tree_k)
    with ops.force_backend("ref"):
        lp, tp = run(tree_p)
    torch.cuda.synchronize()
    err = float((lk - lp).abs().max())
    mag = float(lp.abs().max())
    tol = 1e-3          # of the largest logit: float32 sum order, two layers
    if tk != tp:
        raise AssertionError(f"greedy tokens differ: {tk} vs {tp}")
    if err > tol * mag:
        raise AssertionError(f"logits differ by {err} (max |logit| {mag})")
    bf16 = bf16_slice_vs_plain(dev, model, tree_k, prompt)
    bf16["paged_chunked"] = bf16_paged_vs_plain(dev, seed, model, tree_k)
    paged = paged_vs_plain(dev, seed)
    emit({"phase": "5 slice vs plain versions", "layers": 2,
          "dtype": "float32", "codes_tie_rule": ties,
          "logits_max_abs_err": err, "logits_max_abs": mag,
          "tolerance": f"{tol} * max|logit|", "greedy_tokens_equal": True,
          "tokens": tk, "bfloat16": bf16, **paged})


def bf16_slice_vs_plain(dev, model, tree, prompt, steps=8):
    """The round path's prefill and decode steps with bfloat16 activations
    (the main path's dtype, where the decode linears take ``tcgemv``) on
    phase 5's quantized tree, through the kernels and under
    ``force_backend("ref")``, both fed the plain run's greedy tokens so they
    see one context: logits within 2e-2 of the largest (a bf16 rounding of
    every linear's output, taken after float32 sums in another order), and
    the kernels' launches by variant: every decode linear on ``tcgemv``,
    every prefill linear (2 x 24 rows) on ``mma``."""
    from repro_torch.kernels import dequant_matmul as dm
    from repro_torch.kernels import ops
    from repro_torch.models.model import build_model

    m16 = build_model(dataclasses.replace(model.cfg, dtype="bfloat16"))
    tree = _retyped(tree, torch.bfloat16)

    def run(feed=None):
        cache = m16.init_cache(prompt.shape[0], 64, device=dev)
        lg, cache = m16.prefill(tree, {"tokens": prompt}, cache)
        logits, fed = [lg], []
        for i in range(steps):
            nxt = lg.argmax(-1) if feed is None else feed[i]
            fed.append(nxt)
            lg, cache = m16.decode_step(tree, nxt[:, None], cache)
            logits.append(lg)
        return torch.stack(logits).float(), fed

    with ops.force_backend("ref"):
        lp, fed = run()
    dm.launches_by_variant = dict.fromkeys(dm.VARIANTS, 0)
    lk, _ = run(fed)
    torch.cuda.synchronize()
    by = dict(dm.launches_by_variant)
    linears = 7 * model.cfg.n_layers
    want = {"gemv": 0, "tcgemv": linears * steps, "mma": linears, "tiled": 0}
    if by != want:
        raise AssertionError(f"bf16 slice: kernel B launches by variant {by}, "
                             f"path implies {want}")
    if lk.shape != lp.shape or not bool(torch.isfinite(lk).all()):
        raise AssertionError(f"bf16 slice: logits {tuple(lk.shape)} not "
                             f"finite or not of shape {tuple(lp.shape)}")
    err = float((lk - lp).abs().max())
    mag = float(lp.abs().max())
    tol = 2e-2
    if err > tol * mag:
        raise AssertionError(f"bf16 slice: logits differ by {err} (max "
                             f"|logit| {mag})")
    same = float((lk.argmax(-1) == lp.argmax(-1)).float().mean())
    return {"logits_max_abs_err": err, "logits_max_abs": mag,
            "tolerance": f"{tol} * max|logit|", "launches_by_variant": by,
            "greedy_argmax_agreement": same}


def bf16_paged_vs_plain(dev, seed, model, tree, chunk=32):
    """The paged continuous path with chunked admission (chunks of
    ``chunk`` > 16 rows, so chunk forwards take kernel B's ``mma``) in
    bfloat16 on phase 5's quantized tree: once under
    ``force_backend("ref")``, then through the kernels with the
    scheduler's token override feeding the plain run's tokens, so both see
    one context. Logits of every chunk forward and of the live rows of
    every decode forward within 2e-2 of the largest, and kernel B's
    launches by variant exactly the path's: ``mma`` 7 x L per chunk forward
    of more than 16 rows, ``tcgemv`` 7 x L per other forward, no ``gemv``
    or ``tiled``."""
    from repro_torch.kernels import ops
    from repro_torch.models.model import build_model
    from repro_torch.serving import ServeEngine, WeightStore
    from repro_torch.serving.equivalence import (greedy_token_agreement,
                                                 oracle_tokens)

    m16 = build_model(dataclasses.replace(model.cfg, dtype="bfloat16"))
    tree16 = _retyped(tree, torch.bfloat16)
    reqs = chat_requests(seed, model.cfg.vocab, max_new=8, prefix=32)[:6]

    def run(oracle=None):
        eng = ServeEngine(m16, None, paged_config(
            max_slots=4, max_len=256, prefill_chunk=chunk),
            store=WeightStore(serving_params=tree16, device=dev), device=dev)
        sch = eng.scheduler

        def keep(a, o):
            # live slots only: retired rows read the trash block
            rows = [i for i, s in enumerate(sch.slots) if s is not None]
            return o[0][rows].float().cpu()

        dec = eng._decode = _Counted(eng._decode, keep)
        chk = eng._prefill_chunk = _Counted(
            eng._prefill_chunk, lambda a, o: (int(a[1]["tokens"].numel()),
                                              o[0].float().cpu()))
        c0 = ops.launch_counts()
        if oracle is None:
            toks = oracle_tokens(eng.generate(reqs))
        else:
            toks = greedy_token_agreement(eng, reqs, oracle)
        torch.cuda.synchronize()
        # what the wrappers issued plus what the replays launched (read
        # from the graphs' kernel nodes)
        launched = ops.combine_launches(
            ops.launches_between(c0, ops.launch_counts()),
            eng.replay_launches())
        eng.close()
        return (toks, torch.cat(dec.log), [r for r, _ in chk.log],
                torch.cat([lg[None] for _, lg in chk.log]), dec.calls,
                launched["dequant_matmul.launches_by_variant"])

    with ops.force_backend("ref"):
        oracle, dp, rows_p, cp, _, _ = run()
    rep, dk, rows_k, ck, n_dec, by = run(oracle)
    linears = 7 * model.cfg.n_layers
    big = sum(1 for r in rows_k if r > 16)
    want = {"gemv": 0, "tiled": 0, "mma": linears * big,
            "tcgemv": linears * (n_dec + len(rows_k) - big)}
    if rows_k != rows_p or dk.shape != dp.shape or big == 0:
        raise AssertionError(f"bf16 paged: the runs differ in shape (chunk "
                             f"rows {rows_k} vs {rows_p}, decode logits "
                             f"{tuple(dk.shape)} vs {tuple(dp.shape)})")
    if by != want:
        raise AssertionError(f"bf16 paged: kernel B launches by variant "
                             f"{by}, path implies {want}")
    if not (bool(torch.isfinite(dk).all()) and bool(torch.isfinite(ck).all())):
        raise AssertionError("bf16 paged: logits not finite")
    err = max(float((dk - dp).abs().max()), float((ck - cp).abs().max()))
    mag = max(float(dp.abs().max()), float(cp.abs().max()))
    tol = 2e-2
    if err > tol * mag:
        raise AssertionError(f"bf16 paged: logits differ by {err} (max "
                             f"|logit| {mag})")
    return {"logits_max_abs_err": err, "logits_max_abs": mag,
            "tolerance": f"{tol} * max|logit|", "prefill_chunk": chunk,
            "chunk_rows": rows_k, "decode_forwards": n_dec,
            "launches_by_variant": by,
            "greedy_argmax_agreement": rep.rate}


# ---------------------------------------------------------------------------
# phase 2c: kernels C and D against their plain versions
# ---------------------------------------------------------------------------

def _paged_inputs(dev, gen, b, kv, rep, d, bs, nb, lengths, dtype, quant,
                  poison=True):
    """Pools with spare blocks (trash block 0 included), distinct blocks per
    slot, table tails past a slot's length pointing at the trash block, and
    every position no slot reads unmasked poisoned with +1e6 (codes +127 and
    scales 1e6 for the int8 pool)."""
    from repro_torch.models.attention import _quant_tok
    n = b * nb + 2
    perm = torch.randperm(n - 1, generator=gen, device=dev)[:b * nb] + 1
    bt = perm.reshape(b, nb).to(torch.int32)
    live = torch.zeros(n, bs, dtype=torch.bool, device=dev)
    for i, L in enumerate(lengths):
        used = min(nb, L // bs + 1)
        bt[i, used:] = 0
        cols = torch.arange(used * bs, device=dev)
        cols = cols[cols <= L]
        live[bt[i, (cols // bs)].long(), cols % bs] = True
    q = torch.randn(b, kv * rep, d, generator=gen, device=dev).to(dtype)
    dead = ~live
    if quant:
        kq, ks = _quant_tok(torch.randn(n, bs, kv, d, generator=gen,
                                        device=dev))
        vq, vs = _quant_tok(torch.randn(n, bs, kv, d, generator=gen,
                                        device=dev))
        if poison:
            kq[dead], vq[dead], ks[dead], vs[dead] = 127, 127, 1e6, 1e6
        pools = [kq, vq, ks, vs]
    else:
        k = torch.randn(n, bs, kv, d, generator=gen, device=dev)
        v = torch.randn(n, bs, kv, d, generator=gen, device=dev)
        if poison:
            k[dead] += 1e6
            v[dead] += 1e6
        pools = [k.to(dtype), v.to(dtype)]
    return [q] + pools + [bt, torch.tensor(lengths, dtype=torch.int32,
                                           device=dev)]


def _paged_bytes_ops(c, quant, esz):
    """Bytes the kernel must move (K/V rows and scales of positions <=
    lengths once, q and the output once) and its flops."""
    b, h, d = c["b"], c["kv"] * c["rep"], c["d"]
    rows = sum(L + 1 for L in c["lengths"]) * c["kv"]
    per_row = 2 * d + 8 if quant else 2 * d * esz
    return (rows * per_row + 2 * b * h * d * esz,
            4.0 * sum(L + 1 for L in c["lengths"]) * h * d)


def _sdpa_inputs(args, c, quant, dt):
    """q and the slots' K/V gathered to a contiguous (B, KV, T, D) form (and
    dequantized, for the int8 pool), with the length mask: the library
    yardstick's operands, built outside its time."""
    q, pools, bt, ln = args[0], args[1:-2], args[-2], args[-1]
    b_, _, d_ = q.shape
    t = c["nb"] * c["bs"]
    kc = pools[0][bt.long()].reshape(b_, t, c["kv"], d_)
    vc = pools[1][bt.long()].reshape(b_, t, c["kv"], d_)
    if quant:
        kc = (kc.float() * pools[2][bt.long()].reshape(
            b_, t, c["kv"], 1)).to(dt)
        vc = (vc.float() * pools[3][bt.long()].reshape(
            b_, t, c["kv"], 1)).to(dt)
    mask = (torch.arange(t, device=q.device)[None, :]
            <= ln[:, None])[:, None, None, :]
    return (q[:, :, None, :], kc.transpose(1, 2).contiguous(),
            vc.transpose(1, 2).contiguous(), mask)


def check_kernels_cd(dev, gen, path_lengths, moe_lengths=None):
    """Kernels C and D against their plain versions at the main path's
    shape (B=8, H=32, KV=8, D=128, bs=16, nb=32, the per-slot lengths of a
    step of phase 6), at a ragged shape (rep=1, D=64, lengths {0, bs-1, bs,
    full}), at one slot (``single``: B=1, length 400, where the split
    matters most) and at long contexts (``long``: nb=256, lengths drawn
    from 1500-4095), and at phase 10's shape when ``moe_lengths`` is given
    (``moe``: B=8, H=KV=16, rep=1, D=128, the per-slot lengths of a step of
    phase 10), in bfloat16 and float32, with tails at the trash block
    and masked positions poisoned. Times by CUDA-graph replay with a cold
    L2: the timed calls cycle through enough independent input sets that
    the bytes they read exceed twice the 50 MB L2 (at most 128 sets, so the
    tiny ragged case stays warm), for the kernel and for the library
    yardstick alike (``scaled_dot_product_attention`` on K/V already
    gathered to contiguous form and, for D, already dequantized: the
    gather and the dequantization are not in its time)."""
    import torch.nn.functional as F

    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import paged_attention_quant as paq

    long_lengths = torch.randint(1500, 4096, (8,), generator=gen,
                                 device=dev).tolist()
    cases = [("path", dict(b=8, kv=8, rep=4, d=128, bs=16, nb=32,
                           lengths=list(path_lengths))),
             ("ragged", dict(b=4, kv=2, rep=1, d=64, bs=16, nb=4,
                             lengths=[0, 15, 16, 63])),
             ("single", dict(b=1, kv=8, rep=4, d=128, bs=16, nb=32,
                             lengths=[400])),
             ("long", dict(b=8, kv=8, rep=4, d=128, bs=16, nb=256,
                           lengths=long_lengths))]
    if moe_lengths is not None:
        cases.append(("moe", dict(b=8, kv=16, rep=1, d=128, bs=16, nb=32,
                                  lengths=list(moe_lengths))))
    entries = {}
    for quant in (False, True):
        mod = paq if quant else pa
        kern = paq.paged_attention_quant if quant else pa.paged_attention
        plain = paq.paged_attention_quant_plain if quant \
            else pa.paged_attention_plain
        shapes, worst = [], {"float32": 0.0, "bfloat16": 0.0}
        launches_before = mod.launches
        for tag, c in cases:
            for dt in (torch.bfloat16, torch.float32):
                name = str(dt).replace("torch.", "")
                esz = 2 if dt == torch.bfloat16 else 4
                nbytes, ops_ = _paged_bytes_ops(c, quant, esz)
                n_sets = max(2, min(128, math.ceil(L2_COLD_BYTES / nbytes)))
                sets = [_paged_inputs(dev, gen, c["b"], c["kv"], c["rep"],
                                      c["d"], c["bs"], c["nb"], c["lengths"],
                                      dt, quant) for _ in range(n_sets)]
                args = sets[0]
                scale = c["d"] ** -0.5
                got = kern(*args, scale=scale).float()
                want = plain(*args, scale=scale).float()
                torch.cuda.synchronize()
                # float32: both sum in float32 in another order; bfloat16:
                # the plain version rounds its products to bfloat16
                tol = 2e-5 if dt == torch.float32 else 2e-2
                err = float((got - want).abs().max())
                worst[name] = max(worst[name], err)
                if not bool(torch.isfinite(got).all()) or \
                        not torch.allclose(got, want, rtol=tol, atol=tol):
                    raise AssertionError(f"{mod.__name__} != plain at {tag} "
                                         f"{name}: max abs err {err}")
                # the same draw without poison gives the same output bits
                g2 = torch.Generator(device=dev)
                g2.manual_seed(1234)
                clean = _paged_inputs(dev, g2, c["b"], c["kv"], c["rep"],
                                      c["d"], c["bs"], c["nb"], c["lengths"],
                                      dt, quant, poison=False)
                g2.manual_seed(1234)
                dirty = _paged_inputs(dev, g2, c["b"], c["kv"], c["rep"],
                                      c["d"], c["bs"], c["nb"], c["lengths"],
                                      dt, quant, poison=True)
                if not torch.equal(kern(*clean, scale=scale),
                                   kern(*dirty, scale=scale)):
                    raise AssertionError(f"{mod.__name__}: poisoned masked "
                                         f"positions changed the output "
                                         f"({tag} {name})")
                del clean, dirty, got, want
                ms = time_ms([lambda a=a: kern(*a, scale=scale)
                              for a in sets], 200)
                plain_ms = time_ms([lambda: plain(*args, scale=scale)], 5,
                                   graph=False)
                lib = [_sdpa_inputs(a, c, quant, dt) for a in sets]
                lib_ms = time_ms([lambda x=x: F.scaled_dot_product_attention(
                    x[0], x[1], x[2], attn_mask=x[3], scale=scale,
                    enable_gqa=True) for x in lib], 200)
                t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
                t_ops = ops_ / PEAK_FLOPS["float32"] * 1e3
                bound = max(t_bytes, t_ops)
                sms, ctas = pa.card_ctas_per_sm(
                    quant, dt == torch.bfloat16, c["rep"], c["d"], dev.index)
                shapes.append({"case": tag, "dtype": name, "batch": c["b"],
                               "heads": c["kv"] * c["rep"],
                               "kv_heads": c["kv"], "head_dim": c["d"],
                               "block_size": c["bs"],
                               "blocks_per_slot": c["nb"],
                               "lengths": c["lengths"],
                               "ctas_per_sm": ctas,
                               "split_plan": pa.split_plan(
                                   c["b"], c["kv"], c["nb"], c["bs"], sms,
                                   ctas),
                               "input_sets": n_sets,
                               "l2_cold": n_sets * nbytes >= L2_COLD_BYTES,
                               "max_abs_err": err,
                               "ms": ms, "plain_ms": plain_ms,
                               "library_ms": lib_ms, "bound_ms": bound,
                               "bound_share": bound / ms,
                               "bound_by": "bytes" if t_bytes >= t_ops
                               else "operations"})
                del sets, args, lib
                torch.cuda.empty_cache()
        mod.launches = launches_before     # comparisons do not count
        head = shapes[0]                   # the path's shape in bfloat16
        entries[quant] = dict(
            KERNEL_D if quant else KERNEL_C,
            max_abs_err=worst["bfloat16"],
            max_abs_err_float32=worst["float32"],
            tolerance="float32: rtol=atol=2e-5; bfloat16: rtol=atol=2e-2 "
            "(the plain version rounds its products to bfloat16); poisoned "
            "masked positions: output bits equal",
            numbers_are="one call (split pass + merge pass) at the main "
            "path's shape (B=8, H=32, KV=8, D=128, bs=16, nb=32, bfloat16, "
            "lengths of a phase-6 decode step)",
            timing="ms, library_ms: device time (CUDA graph replay) with a "
            "cold L2: the calls cycle through input sets whose reads exceed "
            "twice the L2; plain_ms: eager calls; library_ms is "
            "scaled_dot_product_attention(enable_gqa=True) on K/V gathered "
            "beforehand" + (" and dequantized beforehand" if quant else "")
            + ": the gather" + (" and the dequantization are" if quant
                                 else " is") + " not in its time",
            ms=head["ms"], plain_ms=head["plain_ms"],
            library_ms=head["library_ms"], bound_ms=head["bound_ms"],
            bound_share=head["bound_share"],
            bound_by=head["bound_by"], shapes=shapes,
            moe=next(({k: r[k] for k in ("ms", "plain_ms", "library_ms",
                                          "bound_ms", "bound_share",
                                          "split_plan", "ctas_per_sm")}
                      for r in shapes if r["case"] == "moe"
                      and r["dtype"] == "bfloat16"), None))
    return entries[False], entries[True]


# ---------------------------------------------------------------------------
# phases 6 and 7: continuous scheduler + paged KV cache + chunked admission
# ---------------------------------------------------------------------------

def chat_requests(seed, vocab, max_new=32, prefix=192, bs=16):
    """Twelve chat requests: a shared 192-token system prefix (12 full
    blocks) and a user suffix of 8-160 tokens each for requests 0-7;
    requests 8-11 are second turns of requests 4-7 (their whole prompt plus
    8-40 new tokens), admitted while those are still decoding, so they share
    their full blocks and the partial tail block (copy-on-write)."""
    import numpy as np
    from repro_torch.serving import Request
    rng = np.random.default_rng(seed)
    system = rng.integers(0, vocab, size=prefix).tolist()
    prompts = []
    for i in range(8):
        n = int(rng.integers(8, 161))
        if i >= 4 and (prefix + n) % bs == 0:
            n += 1                        # keep a partial tail to share
        prompts.append(system + rng.integers(0, vocab, size=n).tolist())
    for i in range(4):
        n = int(rng.integers(8, 41))
        prompts.append(prompts[4 + i] + rng.integers(0, vocab,
                                                     size=n).tolist())
    return [Request(p, max_new, request_id=i) for i, p in enumerate(prompts)]


class _Counted:
    """Wraps an engine entry point: counts its calls, and optionally keeps
    what ``record(args, out)`` returns for each."""

    def __init__(self, fn, record=None):
        self.fn, self.record, self.calls, self.log = fn, record, 0, []

    def __call__(self, *args, **kw):
        self.calls += 1
        out = self.fn(*args, **kw)
        if self.record is not None:
            self.log.append(self.record(args, out))
        return out


def paged_config(**over):
    from repro_torch.serving import ServeConfig
    kw = dict(scheduler="continuous", kv_backend="paged", max_slots=8,
              max_len=512, block_size=16, prefill_chunk=64,
              quantize_weights="squant", weight_bits=8,
              dequantize_for_compute=False)
    kw.update(over)
    return ServeConfig(**kw)


def _retyped(tree, dtype):
    """The serving tree with its model-dtype leaves (the embedding, an
    untied fp head) cast to ``dtype``; quantized linears and float32 norms
    are shared as they are."""
    out = dict(tree)
    out["embedding"] = {"embedding": tree["embedding"]["embedding"].to(dtype)}
    head = tree.get("lm_head", {}).get("w")
    if isinstance(head, torch.Tensor):
        out["lm_head"] = {"w": head.to(dtype)}
    return out


def measure_agreement(dev, model, tree, reqs, quantize_kv, dtype,
                      **oracle_over):
    """Teacher-forced greedy agreement of the paged chunked engine (phase 6's
    serve config, ``quantize_kv`` as given) against its oracle on the same
    quantized tree, with activations in ``dtype``: the fp paged pool for an
    int8 pool, else the contiguous continuous engine without chunking and
    with ONE slot — a contiguous pool left-pads every prompt to the shared
    clock and the pad tokens are attended (the reference's semantics), so
    only a one-slot run sees the paged slots' context (positions 0..L-1).
    ``oracle_over`` changes the oracle's serve config. Returns the report
    and the oracle's seconds."""
    from repro_torch.models.model import build_model
    from repro_torch.serving import ServeEngine, WeightStore
    from repro_torch.serving.equivalence import (greedy_token_agreement,
                                                 oracle_tokens)

    name = str(dtype).replace("torch.", "")
    m = build_model(dataclasses.replace(model.cfg, dtype=name))
    store = WeightStore(serving_params=_retyped(tree, dtype), device=dev)
    ocfg = paged_config(**oracle_over) if quantize_kv else paged_config(
        **dict(dict(kv_backend="contiguous", prefill_chunk=0, max_slots=1),
               **oracle_over))
    t0 = time.perf_counter()
    eng = ServeEngine(m, None, ocfg, store=store, device=dev)
    oracle = oracle_tokens(eng.generate(reqs))
    torch.cuda.synchronize()
    oracle_s = time.perf_counter() - t0
    eng.close()
    eng = ServeEngine(m, None, paged_config(quantize_kv=quantize_kv),
                      store=store, device=dev)
    rep = greedy_token_agreement(eng, reqs, oracle)
    eng.close()
    return rep, oracle_s, oracle


def oracle_margins(dev, model, tree, reqs, forced):
    """The float32 one-slot contiguous oracle (measure_agreement's) teacher-
    forced on ``forced`` ({request id: tokens}): its top-1 minus top-2 logit
    at every sampled position, {(request id, position): margin}."""
    from repro_torch.models.model import build_model
    from repro_torch.serving import ServeEngine, WeightStore
    from repro_torch.serving import scheduler as sched

    m = build_model(dataclasses.replace(model.cfg, dtype="float32"))
    store = WeightStore(serving_params=_retyped(tree, torch.float32),
                        device=dev)
    eng = ServeEngine(m, None, paged_config(
        kv_backend="contiguous", prefill_chunk=0, max_slots=1), store=store,
        device=dev)
    margins, where = [], []
    real = sched.sample

    def sample(logits, *a, **kw):              # one slot: one row a step
        top = logits.float().topk(2, dim=-1).values[0]
        margins.append(float(top[0] - top[1]))
        return real(logits, *a, **kw)

    def override(rid, t, proposed):
        where.append((rid, t))
        toks = forced.get(rid)
        return None if toks is None or t >= len(toks) else int(toks[t])

    sched.sample = sample
    eng.scheduler.token_override = override
    try:
        eng.generate(reqs)
    finally:
        sched.sample = real
    if len(where) != len(margins):
        raise AssertionError(f"{len(margins)} sampling steps, {len(where)} "
                             "sampled positions: not one slot")
    eng.close()
    return dict(zip(where, margins))


def _percentiles(xs):
    """p50/p95/p99 of ``xs``, as ``ContinuousScheduler.stats`` gives them."""
    import numpy as np
    return {f"p{q}": float(np.percentile(np.asarray(xs, np.float64), q))
            for q in (50, 95, 99)} if xs else {}


def _quantiles(xs):
    import numpy as np
    if not xs:
        return None
    q = np.quantile(np.asarray(xs, np.float64), [0.0, 0.1, 0.5, 0.9, 1.0])
    return dict(zip(("min", "p10", "p50", "p90", "max"), q.tolist()))


def _tree_bytes(tree):
    """Bytes of the tensors of a parameter tree (nested dicts and lists)."""
    if torch.is_tensor(tree):
        return tree.numel() * tree.element_size()
    items = tree.values() if isinstance(tree, dict) else \
        tree if isinstance(tree, (list, tuple)) else ()
    return sum(_tree_bytes(t) for t in items)


def phase_memory(label, log):
    """Device memory still allocated after a phase, as it returns, after a
    garbage collection and after PyTorch's cuBLAS workspaces are freed,
    into ``log``, with the package's and this script's objects that only
    the collection freed (a reference cycle held them) and the device
    bytes of the tensors among them. Fails if anything is left after
    that: every phase closes what it made."""
    import gc
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    gc.set_debug(gc.DEBUG_SAVEALL)
    try:
        gc.collect()
        cyclic, cuda_bytes = {}, 0
        for o in gc.garbage:
            mod = getattr(type(o), "__module__", "") or ""
            if mod.startswith("repro_torch") or mod == __name__:
                name = f"{mod}.{type(o).__qualname__}"
                cyclic[name] = cyclic.get(name, 0) + 1
            elif torch.is_tensor(o) and o.is_cuda:
                cuda_bytes += o.numel() * o.element_size()
    finally:
        gc.set_debug(0)
        gc.garbage.clear()
    gc.collect()
    after_gc = torch.cuda.memory_allocated()
    # PyTorch keeps a cuBLAS workspace for every stream a matmul ran on
    # (each engine's capture stream, each store's staging stream)
    torch._C._cuda_clearCublasWorkspaces()
    torch.cuda.empty_cache()
    left = torch.cuda.memory_allocated()
    log.append({"after": label, "allocated_gb": held / 1e9,
                "allocated_gb_after_gc": after_gc / 1e9,
                "allocated_gb_after_cublas_workspaces": left / 1e9,
                "cyclic_objects": cyclic,
                "cyclic_cuda_tensor_gb": cuda_bytes / 1e9})
    if left:
        raise AssertionError(f"phase {label} left {left} bytes allocated "
                             f"on the device: {log[-1]}")


def _reset_launches(dm, pa, paq, sf):
    sf.launches = sf.scale_launches = dm.launches = pa.launches = \
        paq.launches = 0
    sf.launches_by_route = dict.fromkeys(sf.ROUTES, 0)
    dm.launches_by_variant = dict.fromkeys(dm.VARIANTS, 0)
    dm.launches_by_shape = {}


def _variant(rows):
    """Kernel B's variant for bfloat16 activations of ``rows`` rows on the
    path's aligned shapes (``dequant_matmul.variant``)."""
    return "tcgemv" if rows <= 16 else "mma"


def kernel_b_forward(cfg, layers, rows, dropless):
    """Kernel B launches by variant that one forward of ``rows`` tokens
    makes, split by part: ``attention`` (wq, wk, wv, wo of every layer) and
    ``ffn`` (wi, wg, wdown of a dense layer) or ``experts`` (the same three
    banks, one launch per expert on its capacity's rows: ``rows`` when
    ``dropless``, else the GShard capacity rounded up)."""
    from repro_torch.models.transformer import layer_plan
    plan = layer_plan(cfg) * (layers // len(layer_plan(cfg)))
    out = {"attention": {}, "ffn": {}, "experts": {}}

    def add(part, var, n):
        out[part][var] = out[part].get(var, 0) + n

    for _, moe in plan:
        add("attention", _variant(rows), 4)
        if not moe:
            add("ffn", _variant(rows), 3)
            continue
        e, k = cfg.moe.n_experts, cfg.moe.top_k
        cap = rows if dropless else min(rows, max(1, math.ceil(
            rows * k * cfg.moe.capacity_factor / e)))
        add("experts", _variant(cap), 3 * e)
    return {k: v for k, v in out.items() if v}


def kernel_b_parts(cfg, by_shape):
    """Kernel B's measured launches (``launches_by_shape``: by variant and
    weight (M, N), as the wrapper counts them and a graph's nodes hold
    them) by part, as :func:`kernel_b_forward` splits them: a shape of
    wq/wk/wv/wo is ``attention``, one of wi/wg/wdown ``experts`` in an MoE
    stack, else ``ffn``."""
    from repro_torch.models.transformer import layer_plan
    moe = [m for _, m in layer_plan(cfg)]
    if any(moe) and not all(moe):
        raise ValueError("dense and MoE layers share the FFN's shapes")
    q, kv = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
    part = {(q, cfg.d_model): "attention", (kv, cfg.d_model): "attention",
            (cfg.d_model, q): "attention"}
    for mn in ((cfg.d_ff, cfg.d_model), (cfg.d_model, cfg.d_ff)):
        if mn in part:
            raise ValueError(f"an FFN shape {mn} is an attention shape")
        part[mn] = "experts" if all(moe) else "ffn"
    out = {}
    for key, n in by_shape.items():
        if not n:
            continue
        var, shape = key.split()
        mn = tuple(int(v) for v in shape.split("x"))
        if mn not in part:
            raise AssertionError(f"kernel B launched at {mn}, no linear's "
                                 f"shape of {cfg.name}")
        by = out.setdefault(part[mn], {})
        by[var] = by.get(var, 0) + n
    return out


def _add_counts(a, b, times=1):
    out = {k: dict(v) for k, v in a.items()}
    for part, by in b.items():
        for var, n in by.items():
            out.setdefault(part, {})
            out[part][var] = out[part].get(var, 0) + times * n
    return out


def drive_continuous(dev, seed, layers, phase, quantize_kv=False,
                     arch="granite-3-8b", agreement=True,
                     capture_all_widths=True, reduced=None, before_close=None):
    """The continuous + paged + chunked path on granite-3-8b w8: one counted
    run through ``ServeEngine.generate`` (the main path, its decode step and
    chunk widths captured as CUDA graphs), two repeats of the same requests
    on that engine (captures only for chunk widths the first run did not
    have, none in the third), a fresh request set, the same configuration
    run eagerly (``capture=False``) on the same tree and requests (tokens
    bit-identical, launch counts equal: the main run's replays measured by
    ``ServeEngine.replay_launches``), every chunk width captured
    (``all_widths``), then the agreement check against its oracle engine,
    which shares the quantized tree (``agreement``). ``arch`` names the
    model, ``reduced`` the depth cut listed in the phase's line;
    ``before_close(engine)`` runs before the engine closes. Returns
    kernel A's, kernel B's and kernel C's (or D's) launches, the context
    lengths of the step with the most context, and the phase's line."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import dequant_matmul as dm
    from repro_torch.kernels import ops
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import paged_attention_quant as paq
    from repro_torch.kernels import squant_flip as sf
    from repro_torch.models.model import build_model
    from repro_torch.serving import ServeEngine, WeightStore
    from repro_torch.serving.equivalence import AGREEMENT_BUDGETS

    full = get_config(arch)
    cfg = dataclasses.replace(full, n_layers=layers)
    model = build_model(cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    t0 = time.perf_counter()
    params = model.init(gen, device=dev)
    torch.cuda.synchronize()
    init_ms = (time.perf_counter() - t0) * 1e3
    reqs = chat_requests(seed, cfg.vocab)
    kernel_mod = paq if quantize_kv else pa

    _reset_launches(dm, pa, paq, sf)
    weights_bytes = _tree_bytes(params)
    allocated = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    eng = ServeEngine(model, params, paged_config(quantize_kv=quantize_kv),
                      device=dev)
    quant_peak_gb = (torch.cuda.max_memory_allocated() - allocated) / 1e9
    del params
    torch.cuda.empty_cache()
    a_launches = sf.launches
    qrep = eng.quant_report
    quantize = {"report": qrep.summary(), "total_ms": qrep.total_millis,
                "dispatch_ms": qrep.dispatch_millis,
                "sync_ms": qrep.sync_millis,
                "staged_ms": eng.store.current.staged_ms,
                "buckets": [{"key": b.key, "route": b.route,
                             "dispatch_ms": b.dispatch_millis}
                            for b in qrep.buckets],
                "stacked_buckets": sum(b.route == "stacked"
                                       for b in qrep.buckets),
                "launches": {"squant_flip": a_launches,
                             "squant_flip_by_route": dict(
                                 sf.launches_by_route),
                             "squant_scale": sf.scale_launches},
                "peak_gb_above_weights": quant_peak_gb,
                "weights_gb": weights_bytes / 1e9,
                "allocated_gb_before": allocated / 1e9, "init_ms": init_ms}
    if quantize["stacked_buckets"] or not all("g128" in b.key
                                              for b in qrep.buckets):
        raise AssertionError(f"a bucket took the stacked route or is not "
                             f"grouped: {quantize['buckets']}")
    kv = eng.scheduler.kv
    dec = eng._decode = _Counted(eng._decode,
                                 lambda a, o: kv._lengths.copy().tolist())
    chk = eng._prefill_chunk = _Counted(
        eng._prefill_chunk, lambda a, o: int(a[1]["tokens"].numel()))
    pre = eng._prefill = _Counted(eng._prefill)
    torch.cuda.reset_peak_memory_stats()
    _reset_launches(dm, pa, paq, sf)
    t0 = time.perf_counter()
    outs = eng.generate(reqs)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    # the main run's launches: what the wrappers issued (eager warm-ups,
    # everything not replayed) plus what its replays launched, measured:
    # each graph's kernel nodes read from the driver, counted by name, held
    # to its capture's tally, times its replays
    issued = ops.launch_counts()
    replayed = eng.replay_launches()
    replays = {f"{name}{list(key)}": g.replays
               for name, gs in eng._graphs.items() for key, g in gs.items()}
    captured_launches = ops.combine_launches(issued, replayed)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    st = eng.stats()["scheduler"]
    graphs = eng.stats()["graphs"]
    tc = dict(eng.trace_counts)
    widths = sorted(set(chk.log))
    if tc != {"prefill": 0, "prefill_chunk": len(widths), "decode": 1,
              "admit": 0}:
        raise AssertionError(f"captures {tc}: expected one decode capture "
                             f"and one per chunk width {widths}")
    if chk.calls != st.chunk_steps or pre.calls != 0:
        raise AssertionError(f"chunk forwards {chk.calls} vs stats "
                             f"{st.chunk_steps}, monolithic {pre.calls}")
    # what the main run's launches must be: kernel B on every linear of
    # every forward (an MoE layer: once per expert and bank), through
    # tcgemv up to 16 rows (bfloat16), mma above, never gemv or tiled; C
    # (or D) once per layer and decode
    big = sum(1 for rows in chk.log if rows > 16)
    b_parts = _add_counts({}, kernel_b_forward(cfg, layers,
                                               eng.cfg.max_slots, True),
                          dec.calls)
    for rows in chk.log:
        b_parts = _add_counts(b_parts, kernel_b_forward(cfg, layers, rows,
                                                        False))
    want_by = {"gemv": 0, "tiled": 0, "mma": 0, "tcgemv": 0}
    for by in b_parts.values():
        for var, n in by.items():
            want_by[var] += n
    want_b, want_k = sum(want_by.values()), layers * dec.calls
    b_launches = captured_launches["dequant_matmul.launches"]
    b_by_variant = captured_launches["dequant_matmul.launches_by_variant"]
    k_launches = captured_launches[
        f"{kernel_mod.__name__.split('.')[-1]}.launches"]
    other = captured_launches[
        f"{(pa if quantize_kv else paq).__name__.split('.')[-1]}.launches"]
    if b_launches != want_b or b_launches == 0:
        raise AssertionError(f"kernel B launches {b_launches}, path implies "
                             f"{want_b}")
    if b_by_variant != want_by:
        raise AssertionError(f"kernel B by variant {b_by_variant}, path "
                             f"implies {want_by}")
    # the same launches by part, as counted: the wrappers' and the graph
    # nodes' (M, N) of every launch
    b_parts_measured = kernel_b_parts(
        cfg, captured_launches["dequant_matmul.launches_by_shape"])
    if b_parts_measured != {p: {v: n for v, n in by.items() if n}
                            for p, by in b_parts.items()}:
        raise AssertionError(f"kernel B by part {b_parts_measured}, path "
                             f"implies {b_parts}")
    if k_launches != want_k or k_launches == 0 or other:
        raise AssertionError(f"{kernel_mod.__name__} launches {k_launches} "
                             f"(other paged kernel {other}), path implies "
                             f"{want_k}")
    kv.check_invariants()
    kst = st.kv
    if kst["blocks_active"] or kst["blocks_reserved"]:
        raise AssertionError(f"blocks not returned after the run: {kst}")
    if not (kst["prefix_hits"] and kst["cow_copies"]):
        raise AssertionError(f"no prefix hit or no copy-on-write: {kst}")
    if st.admitted != len(reqs) or st.waves != 1 or st.pendings_started < 2:
        raise AssertionError(f"expected one fresh wave and mid-flight "
                             f"admissions: {st}")
    for o, r in zip(outs, reqs):
        if len(o.tokens) != r.max_new_tokens or \
                not all(0 <= t < cfg.vocab for t in o.tokens):
            raise AssertionError(f"request {r.request_id}: bad tokens")

    # the main run's forwards, before the repeats add to the counts
    n_dec, n_chk, dec_log = dec.calls, chk.calls, list(dec.log)
    # the same requests again: the prefix registry now shortens every
    # suffix, so the second run may use widths the first did not (one
    # capture each); the third repeats the second's shapes exactly
    repeats = []
    for _ in range(2):
        n0 = len(chk.log)
        before = dict(eng.trace_counts)
        steps0 = list(eng.scheduler.step_ms_log)
        t0 = time.perf_counter()
        eng.generate(reqs)
        torch.cuda.synchronize()
        steps = list(eng.scheduler.step_ms_log)[len(steps0):]
        widths_all = sorted(set(chk.log))
        new_widths = sorted(set(chk.log[n0:]) - set(chk.log[:n0]))
        repeats.append({"run_s": time.perf_counter() - t0,
                        "step_ms": _percentiles(steps),
                        "chunk_widths": sorted(set(chk.log[n0:])),
                        "new_captures": {k: eng.trace_counts[k] - before[k]
                                         for k in before}})
        if eng.trace_counts != dict(tc, prefill_chunk=len(widths_all)) \
                or repeats[-1]["new_captures"]["prefill_chunk"] \
                != len(new_widths):
            raise AssertionError(f"repeated run: captures "
                                 f"{eng.trace_counts}, chunk widths so far "
                                 f"{widths_all}")
    if any(repeats[-1]["new_captures"].values()):
        raise AssertionError(f"a run repeating the last one's shapes "
                             f"captured again: {repeats[-1]}")
    kv.check_invariants()
    # fresh traffic after those: another system prefix and other suffix
    # lengths, so new chunk widths are captured while requests wait
    fresh = chat_requests(seed + 1, cfg.vocab)
    before, ms0 = dict(eng.trace_counts), eng.capture_ms
    steps0 = list(eng.scheduler.step_ms_log)
    t0 = time.perf_counter()
    fresh_outs = eng.generate(fresh)
    torch.cuda.synchronize()
    fresh_run = {"run_s": time.perf_counter() - t0,
                 "step_ms": _percentiles(
                     list(eng.scheduler.step_ms_log)[len(steps0):]),
                 "prefill_ms_per_admission": _percentiles(
                     [o.prefill_ms for o in fresh_outs]),
                 "new_captures": {k: eng.trace_counts[k] - before[k]
                                  for k in before},
                 "capture_ms": eng.capture_ms - ms0}
    kv.check_invariants()

    # the same configuration eagerly, on the same tree and requests
    eager = ServeEngine(model, None, paged_config(quantize_kv=quantize_kv),
                        store=WeightStore(serving_params=eng.params,
                                          device=dev),
                        device=dev, capture=False)
    _reset_launches(dm, pa, paq, sf)
    t0 = time.perf_counter()
    eager_outs = eager.generate(reqs)
    torch.cuda.synchronize()
    eager_run_s = time.perf_counter() - t0
    eager_launches = ops.launch_counts()
    est = eager.stats()
    eager.close()
    del eager
    torch.cuda.empty_cache()
    differing = [r.request_id for o, e, r in zip(outs, eager_outs, reqs)
                 if o.tokens != e.tokens]
    if differing:
        raise AssertionError(f"captured tokens differ from the eager path's "
                             f"for requests {differing}")
    if est["trace_counts"] != dict.fromkeys(tc, 0):
        raise AssertionError(f"eager engine captured: {est['trace_counts']}")

    if eager_launches != captured_launches:
        raise AssertionError(f"launches captured {captured_launches} vs "
                             f"eager {eager_launches}")

    # the cost of capturing every chunk width up front: each width of 1 to
    # prefill_chunk not captured yet, driven once on the one-row side cache
    all_widths = None
    if capture_all_widths:
        side = kv.side_cache(1)
        rng = torch.Generator().manual_seed(seed)
        n0, ms0 = eng.trace_counts["prefill_chunk"], eng.capture_ms
        for n in range(1, eng.cfg.prefill_chunk + 1):
            t, clock = kv.chunk_inputs(torch.randint(
                0, cfg.vocab, (n,), generator=rng).numpy(), 0)
            chk.fn(eng.params, {"tokens": t}, dict(side, pos=clock))
        torch.cuda.synchronize()
        all_widths = {"widths": eng.cfg.prefill_chunk,
                      "captured_now": eng.trace_counts["prefill_chunk"] - n0,
                      "capture_ms_now": eng.capture_ms - ms0,
                      "graphs": eng.stats()["graphs"]}
        if eng.trace_counts["prefill_chunk"] != eng.cfg.prefill_chunk:
            raise AssertionError(f"captures {eng.trace_counts} after "
                                 f"driving every width 1.."
                                 f"{eng.cfg.prefill_chunk}")

    # agreement, measured with bfloat16 activations (the main path's) and
    # with float32 activations on the same quantized tree; the budget is
    # held in float32, where the random model's near-tied logits are not
    # flipped by bfloat16 rounding (PERF.md, ROADMAP "Faults")
    label = "int8 KV vs fp paged pool" if quantize_kv else \
        "paged vs contiguous (one slot)"
    budget = AGREEMENT_BUDGETS["int8_kv"] if quantize_kv else 0.98
    rep = rep16 = oracle_s = oracle32_s = near_ties = None
    if agreement:
        rep16, oracle_s, oracle16 = measure_agreement(
            dev, model, eng.params, reqs, quantize_kv, torch.bfloat16)
        rep, oracle32_s, _ = measure_agreement(dev, model, eng.params, reqs,
                                               quantize_kv, torch.float32)
    if agreement and not quantize_kv:
        # where the bf16 token differs from the bf16 oracle's: the float32
        # oracle's top-2 logit margin on the same (teacher-forced) context,
        # beside the margins at every compared position
        margin = oracle_margins(dev, model, eng.params, reqs, oracle16)
        missed = [margin[p] for p in rep16.mismatches if p in margin]
        near_ties = {"disagreements": len(rep16.mismatches),
                     "with_margin": len(missed),
                     "margin_at_disagreements": _quantiles(missed),
                     "margins_sorted": sorted(missed),
                     "margin_at_all_positions": _quantiles(
                         list(margin.values())),
                     "positions": len(margin)}
    entry = {"phase": phase, "model": cfg.name, "layers": layers,
             "full_depth": layers == full.n_layers, "reduced": reduced,
             "d_model": cfg.d_model, "d_ff": cfg.d_ff, "vocab": cfg.vocab,
             "moe": dataclasses.asdict(cfg.moe) if cfg.moe else None,
             "weight_bits": 8, "quantize_kv": quantize_kv,
             "quantize": quantize,
             "serve_config": {k: getattr(eng.cfg, k) for k in (
                 "scheduler", "kv_backend", "max_slots", "max_len",
                 "block_size", "prefill_chunk")},
             "requests": len(reqs),
             "prompt_lengths": [len(r.prompt) for r in reqs],
             "max_new_tokens": reqs[0].max_new_tokens,
             "run_s": run_s, "oracle_run_s_bfloat16": oracle_s,
             "oracle_run_s_float32": oracle32_s,
             "sampling_steps": st.steps, "decode_forwards": n_dec,
             "chunk_forwards": n_chk,
             "chunk_forwards_over_16_rows": big,
             "step_ms": st.step_ms,
             "trace_counts": tc, "chunk_widths": widths,
             "graphs": graphs,
             "repeat_runs_note": "the same requests again; the third run "
                                 "has every width it uses already captured",
             "repeat_runs": repeats,
             "fresh_run": fresh_run, "all_widths_captured": all_widths,
             "eager": {"run_s": eager_run_s,
                       "step_ms": est["scheduler"].step_ms,
                       "launches": eager_launches,
                       "tokens_equal_captured": True},
             "prefill_ms_per_admission": [o.prefill_ms for o in outs],
             "kv": kst, "peak_memory_gb": peak_gb,
             "launches": {"squant_flip": a_launches,
                          "dequant_matmul": b_launches,
                          "dequant_matmul_by_variant": b_by_variant,
                          "dequant_matmul_by_part": b_parts_measured,
                          "dequant_matmul_by_shape": {
                              k: v for k, v in captured_launches[
                                  "dequant_matmul.launches_by_shape"].items()
                              if v},
                          kernel_mod.__name__.split(".")[-1]: k_launches},
             "launches_issued_by_wrappers": issued,
             "launches_measured_in_replays": replayed,
             "replays": replays,
             "mma_plans": dm.cached_plans("mma"),
             "agreement": None if not agreement else {
                 "against": label, "budget": budget,
                 "gated": "float32 activations",
                 "rate": rep.rate, "matched": rep.matched,
                 "compared": rep.compared,
                 "rate_bfloat16": rep16.rate,
                 "matched_bfloat16": rep16.matched,
                 "bfloat16_disagreements_float32_margin": near_ties},
             "tokens": [o.tokens for o in outs]}
    emit(entry)
    if agreement and rep.rate < budget:
        raise AssertionError(f"{label}: teacher-forced greedy agreement "
                             f"{rep.rate:.4f} < {budget}")
    lengths = max(dec_log, key=sum)        # the step with the most context
    if before_close is not None:
        before_close(eng)
    eng.close()
    del eng, outs
    torch.cuda.empty_cache()
    return a_launches, b_launches, k_launches, lengths, entry


def paged_vs_plain(dev, seed, arch="granite-3-8b"):
    """The paged continuous path at 2 layers in float32, once through the
    kernels and once under ``force_backend("ref")``, on one quantized tree:
    greedy tokens equal, logits within 1e-3 of the largest."""
    from repro_torch.configs import get_config
    from repro_torch.core.pipeline import quantize_tree
    from repro_torch.kernels import ops
    from repro_torch.models.model import build_model
    from repro_torch.serving import ServeEngine, WeightStore

    cfg = dataclasses.replace(get_config(arch), n_layers=2, dtype="float32")
    model = build_model(cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    params = model.init(gen, device=dev)
    tree, _ = quantize_tree(params, method="squant", bits=8, device=dev)
    del params
    reqs = chat_requests(seed, cfg.vocab, max_new=8, prefix=32)[:6]

    def run():
        eng = ServeEngine(model, None, paged_config(
            max_slots=4, max_len=256, prefill_chunk=16),
            store=WeightStore(serving_params=tree, device=dev), device=dev)
        sch = eng.scheduler

        def keep(a, o):
            # only the rows of live slots: retired rows read the trash
            # block, whose content depends on the order of racing writes
            rows = [i for i, s in enumerate(sch.slots) if s is not None]
            return o[0][rows].float().cpu()

        dec = eng._decode = _Counted(eng._decode, keep)
        chk = eng._prefill_chunk = _Counted(eng._prefill_chunk,
                                            lambda a, o: o[0].float().cpu())
        outs = eng.generate(reqs)
        eng.close()
        return ([o.tokens for o in outs], torch.cat(dec.log),
                torch.cat([x[None] for x in chk.log]))

    tk, dk, ck = run()
    with ops.force_backend("ref"):
        tp, dp, cp = run()
    err = max(float((dk - dp).abs().max()), float((ck - cp).abs().max()))
    mag = max(float(dp.abs().max()), float(cp.abs().max()))
    tol = 1e-3          # of the largest logit: float32 sum order, two layers
    if tk != tp:
        raise AssertionError(f"paged path: greedy tokens differ: {tk} vs {tp}")
    if err > tol * mag:
        raise AssertionError(f"paged path: logits differ by {err} (max "
                             f"|logit| {mag})")
    return {"paged_logits_max_abs_err": err, "paged_logits_max_abs": mag,
            "paged_greedy_tokens_equal": True,
            "paged_decode_forwards": int(dk.shape[0])}


# ---------------------------------------------------------------------------
# phase 8: self-speculative decoding (w4 drafts, w8 verifier) on the paged
# continuous path
# ---------------------------------------------------------------------------

def _tokens_per_s(outs, run_s):
    return sum(len(o.tokens) for o in outs) / run_s


def _spec_path_launches(layers, chunk_rows, verify_s, chain_s, draft_rows):
    """What a speculative run's launches must be: kernel B seven times per
    layer and forward: the verify forward once per position (its B rows,
    ``tcgemv`` int8), the draft chain once per feed (``tcgemv`` int4), the
    chunk forwards as phase 6 (``mma`` above 16 rows), the drafter's
    admission prefill (``mma`` int4 above 16 rows); kernel C once per layer
    and verify position. No decode step runs."""
    big = sum(1 for r in chunk_rows if r > 16)
    draft_big = sum(1 for r in draft_rows if r > 16)
    tc8 = 7 * layers * (sum(verify_s) + len(chunk_rows) - big)
    tc4 = 7 * layers * (sum(chain_s) + len(draft_rows) - draft_big)
    mma8, mma4 = 7 * layers * big, 7 * layers * draft_big
    return {"by_variant": {"gemv": 0, "tiled": 0, "tcgemv": tc8 + tc4,
                           "mma": mma8 + mma4},
            "split": {"tcgemv_int8": tc8, "tcgemv_int4": tc4,
                      "mma_int8": mma8, "mma_int4": mma4},
            "paged_attention": layers * sum(verify_s)}


def _instrument_spec(eng):
    """Counters on a speculative engine's entry points: verify widths,
    chain widths, chunk widths, drafter admission rows, decode calls,
    cycle wall ms and each capture's ms by graph."""
    kv, spec = eng.scheduler.kv, eng.scheduler.spec
    rec = {"verify": _Counted(kv._verify, lambda a, o: int(a[1].shape[1])),
           "chain": _Counted(spec._chain, lambda a, o: int(a[1].shape[1])),
           "chunk": _Counted(eng._prefill_chunk,
                             lambda a, o: int(a[1]["tokens"].numel())),
           "draft_admit": _Counted(spec.admit_slot,
                                   lambda a, o: len(a[1])),
           "decode": _Counted(eng._decode), "cycle_ms": [],
           "capture_ms": []}
    kv._verify, spec._chain = rec["verify"], rec["chain"]
    eng._prefill_chunk, eng._decode = rec["chunk"], rec["decode"]
    spec.admit_slot = rec["draft_admit"]
    run_cycle, capture = spec.run_cycle, eng._capture

    def cycle(*a):
        t0 = time.perf_counter()
        out = run_cycle(*a)                  # ends in the cycle's host sync
        rec["cycle_ms"].append((time.perf_counter() - t0) * 1e3)
        return out

    def captured(fn, params, batch, caches, out, inputs):
        t0 = time.perf_counter()
        res = capture(fn, params, batch, caches, out, inputs)
        rec["capture_ms"].append(
            {"graph": getattr(fn, "__name__", type(fn).__name__),
             "tokens": list(inputs[0].shape),
             "ms": (time.perf_counter() - t0) * 1e3})
        return res
    spec.run_cycle, eng._capture = cycle, captured
    return rec


def _run_counted(eng, reqs, rec=None):
    """One counted run: outputs, seconds, this run's step ms, cycle ms and
    capture log (from ``rec``'s logs), new captures."""
    before = dict(eng.trace_counts)
    steps0 = len(eng.scheduler.step_ms_log)
    n = {k: len(v.log) if isinstance(v, _Counted) else len(v)
         for k, v in (rec or {}).items()}
    t0 = time.perf_counter()
    outs = eng.generate(reqs)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    run = {"run_s": run_s, "tokens_per_s": _tokens_per_s(outs, run_s),
           "step_ms": _percentiles(list(eng.scheduler.step_ms_log)[steps0:]),
           "new_captures": {k: eng.trace_counts[k] - before.get(k, 0)
                            for k in eng.trace_counts}}
    if rec:
        log = {k: (v.log if isinstance(v, _Counted) else v)[n[k]:]
               for k, v in rec.items()}
        run.update(cycle_ms=_percentiles(log["cycle_ms"]),
                   captures=log["capture_ms"],
                   verify_widths=sorted(set(log["verify"])),
                   chain_widths=sorted(set(log["chain"])))
    return outs, run


def drive_speculative(dev, seed, layers, profile=False):
    """Self-speculative decoding on phase 6's paged chunked configuration,
    granite-3-8b full width at ``layers`` layers, bfloat16: the w8 tree
    verifies what the w4 tree of the same fp weights drafts (``draft_k`` 4).
    A captured first run (the main path, launches counted), a second run
    (prefix hits give new chunk widths), a repeat that captures nothing,
    the same configuration eagerly (``capture=False``) and the
    verifier-only engine (phase 6's configuration) on the same trees and
    requests: tokens bit-identical everywhere, launches of the captured run
    equal to the eager run's and to what the path implies. Then the same
    pair in float32 at 2 layers. Returns the main run's kernel B and C
    launches and the drafter's admission prefill row counts."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import dequant_matmul as dm
    from repro_torch.kernels import ops
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import paged_attention_quant as paq
    from repro_torch.kernels import squant_flip as sf
    from repro_torch.models.model import build_model
    from repro_torch.serving import ServeEngine, WeightStore

    spec_kw = dict(speculative=True, draft_bits=4, draft_k=4)
    cfg = dataclasses.replace(get_config("granite-3-8b"), n_layers=layers)
    model = build_model(cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    params = model.init(gen, device=dev)
    reqs = chat_requests(seed, cfg.vocab)

    _reset_launches(dm, pa, paq, sf)
    t0 = time.perf_counter()
    eng = ServeEngine(model, params, paged_config(**spec_kw), device=dev)
    torch.cuda.synchronize()
    stage_ms = (time.perf_counter() - t0) * 1e3
    a_launches, a_scale = sf.launches, sf.scale_launches
    del params
    torch.cuda.empty_cache()
    tree, draft = eng.params, eng.store.current.draft_params

    def shared_store():
        # both trees of the pair, shared (no second quantization)
        return WeightStore(lambda _: (tree, None), fp_params=tree,
                           draft_quantize_fn=lambda _: draft, device=dev)

    rec = _instrument_spec(eng)
    torch.cuda.reset_peak_memory_stats()
    _reset_launches(dm, pa, paq, sf)
    outs, first = _run_counted(eng, reqs, rec)
    issued = ops.launch_counts()
    replayed = eng.replay_launches()
    captured_launches = ops.combine_launches(issued, replayed)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    st = eng.scheduler.stats()
    kv = eng.scheduler.kv
    kv.check_invariants()
    kst = st.kv
    if kst["blocks_active"] or kst["blocks_reserved"]:
        raise AssertionError(f"blocks not returned after the run: {kst}")
    want = _spec_path_launches(layers, rec["chunk"].log, rec["verify"].log,
                               rec["chain"].log, rec["draft_admit"].log)
    b_by = captured_launches["dequant_matmul.launches_by_variant"]
    c_n = captured_launches["paged_attention.launches"]
    if rec["decode"].calls or b_by != want["by_variant"] \
            or c_n != want["paged_attention"] \
            or captured_launches["paged_attention_quant.launches"]:
        raise AssertionError(f"launches {captured_launches}, decode calls "
                             f"{rec['decode'].calls}; the path implies "
                             f"{want}")
    tc = dict(eng.trace_counts)
    if tc["verify"] != len(first["verify_widths"]) \
            or tc["draft_chain"] != len(first["chain_widths"]) \
            or tc["decode"] or tc["prefill"] or tc["admit"] \
            or tc["spec_carry"] or tc["draft_prefill"] or tc["draft_admit"]:
        raise AssertionError(f"captures {tc}: expected one verify graph per "
                             f"S {first['verify_widths']} and one chain "
                             f"graph per k_eff {first['chain_widths']}")
    if not st.draft_tokens_accepted > 0:
        raise AssertionError(f"no draft token accepted: {st}")
    for o, r in zip(outs, reqs):
        if len(o.tokens) != r.max_new_tokens or \
                not all(0 <= t < cfg.vocab for t in o.tokens):
            raise AssertionError(f"request {r.request_id}: bad tokens")
    spec_stats = {k: st[k] for k in (
        "spec_cycles", "draft_tokens_proposed", "draft_tokens_accepted",
        "acceptance_rate", "accepted_len", "steps", "chunk_steps")}
    tokens_total = sum(len(o.tokens) for o in outs)
    # a slot's sampling steps per token it emitted (verifier-only: 1)
    steps_per_token = sum(o.steps for o in outs) / tokens_total

    # the second run meets the widths the prefix hits give; the third
    # repeats its shapes and must capture nothing
    _, second = _run_counted(eng, reqs, rec)
    outs3, repeat = _run_counted(eng, reqs, rec)
    if any(repeat["new_captures"].values()):
        raise AssertionError(f"the repeat captured: {repeat}")
    st3 = eng.scheduler.stats()
    graphs = eng.stats()["graphs"]

    # --profile: one verify forward and one draft chain, replayed at the
    # positions of eight admitted slots of the same traffic
    if profile:
        spec = eng.scheduler.spec
        slots = list(range(8))
        kv.admit([(i, r) for i, r in enumerate(reqs[:8])], slots, None,
                 tree)
        for i, r in zip(slots, reqs):
            spec.admit_slot.fn(i, r.prompt, draft)
            kv.ensure_rows(i, int(kv._lengths[i]), 5)
        kv._push_positions()
        t0_tok = kv.logits.argmax(-1).to(torch.int32)
        run = spec.propose(draft, t0_tok, 4)
        extra = {"layers": layers, "slots": 8, "draft_k": 4,
                 "context_lengths": kv._lengths.tolist()}

        def verify_step():
            (_, verdict), _ = kv._verify.fn(tree, run, kv._cache)
            verdict.cpu()

        def chain_step():
            spec._chain.fn(draft, run, spec._draft_cache)
            run.cpu()

        _profile_steps(verify_step, 4, "8 profile of a verify forward "
                       "(S = 5), captured", extra)
        _profile_steps(chain_step, 4, "8 profile of a draft chain (k = 4, "
                       "5 feeds of the w4 tree), captured", extra)
        for i in slots:
            kv.retire(i)
            spec.retire_slot(i)
        kv.check_invariants()

    # the same configuration eagerly, on the same pair and requests
    eager = ServeEngine(model, None, paged_config(**spec_kw),
                        store=shared_store(), device=dev, capture=False)
    _reset_launches(dm, pa, paq, sf)
    eager_outs, eager_run = _run_counted(eager, reqs)
    eager_launches = ops.launch_counts()
    est = eager.stats()
    eager.close()
    del eager
    if est["trace_counts"] != dict.fromkeys(tc, 0):
        raise AssertionError(f"eager engine captured: {est['trace_counts']}")
    if eager_launches != captured_launches:
        raise AssertionError(f"launches captured {captured_launches} vs "
                             f"eager {eager_launches}")

    # the verifier alone (phase 6's configuration), on the same w8 tree:
    # first run, second, and the repeat timed against the speculative one
    plain = ServeEngine(model, None, paged_config(),
                        store=WeightStore(serving_params=tree, device=dev),
                        device=dev)
    plain_outs, plain_first = _run_counted(plain, reqs)
    _, plain_second = _run_counted(plain, reqs)
    plain_outs3, plain_repeat = _run_counted(plain, reqs)
    plain_repeat["steps_per_token"] = sum(o.steps for o in plain_outs3) / \
        sum(len(o.tokens) for o in plain_outs3)
    plain.close()
    del plain
    torch.cuda.empty_cache()
    for label, got in (("captured", outs), ("eager", eager_outs),
                       ("repeat", outs3)):
        ref = plain_outs3 if label == "repeat" else plain_outs
        differing = [r.request_id for o, p, r in zip(got, ref, reqs)
                     if o.tokens != p.tokens]
        if differing:
            raise AssertionError(f"speculative ({label}) tokens differ from "
                                 f"verifier-only decode for requests "
                                 f"{differing}")

    eng.close()
    del eng, tree, draft, outs, outs3, eager_outs, plain_outs, plain_outs3
    torch.cuda.empty_cache()

    # float32 at 2 layers: speculative tokens == verifier-only tokens
    f32 = build_model(dataclasses.replace(cfg, n_layers=2, dtype="float32"))
    gen.manual_seed(seed)
    p32 = f32.init(gen, device=dev)
    s32 = ServeEngine(f32, p32, paged_config(**spec_kw), device=dev)
    v32 = ServeEngine(f32, None, paged_config(),
                      store=WeightStore(serving_params=s32.params,
                                        device=dev), device=dev)
    del p32
    o32, v32o = s32.generate(reqs), v32.generate(reqs)
    st32 = s32.scheduler.stats()
    differing32 = [r.request_id for a, b, r in zip(o32, v32o, reqs)
                   if a.tokens != b.tokens]
    s32.close()
    v32.close()
    del s32, v32
    torch.cuda.empty_cache()
    if differing32:
        raise AssertionError(f"float32, 2 layers: speculative tokens differ "
                             f"from verifier-only for requests {differing32}")

    emit({"phase": "8 speculative decoding, continuous + paged + chunked, "
          "granite-3-8b w8 verifier, w4 drafter", "model": cfg.name,
          "layers": layers,
          "full_depth": layers == get_config("granite-3-8b").n_layers,
          "serve_config": {k: getattr(paged_config(**spec_kw), k) for k in (
              "scheduler", "kv_backend", "max_slots", "max_len",
              "block_size", "prefill_chunk", "speculative", "draft_bits",
              "draft_k", "weight_bits")},
          "requests": len(reqs), "max_new_tokens": reqs[0].max_new_tokens,
          "stage_ms_w8_and_w4": stage_ms,
          "squant_flip_launches_stage": a_launches,
          "squant_scale_launches_stage": a_scale,
          "speculative": spec_stats,
          "steps_per_token": steps_per_token,
          "cycles_per_token": spec_stats["spec_cycles"] / tokens_total,
          "first_run": first, "second_run": second, "repeat_run": repeat,
          "repeat_acceptance_rate": st3["acceptance_rate"],
          "eager_run": eager_run,
          "verifier_only": {"first_run": plain_first,
                            "second_run": plain_second,
                            "repeat_run": plain_repeat},
          "tokens_per_s_repeat": {
              "speculative": repeat["tokens_per_s"],
              "verifier_only": plain_repeat["tokens_per_s"],
              "ratio": repeat["tokens_per_s"] / plain_repeat["tokens_per_s"]},
          "tokens_equal_verifier_only": True,
          "tokens_equal_eager": True,
          "float32_2_layers": {"tokens_equal_verifier_only": True,
                               "spec_cycles": st32["spec_cycles"],
                               "acceptance_rate": st32["acceptance_rate"]},
          "trace_counts": tc, "graphs": graphs,
          "launches": {"dequant_matmul_by_variant": b_by,
                       "dequant_matmul_by_variant_and_bits": want["split"],
                       "paged_attention": c_n},
          "launches_issued_by_wrappers": issued,
          "launches_measured_in_replays": replayed,
          "eager_launches_equal_captured": True,
          "drafter_admission_rows": rec["draft_admit"].log[:len(reqs)],
          "kv": kst, "peak_memory_gb": peak_gb})
    return (captured_launches["dequant_matmul.launches"], c_n,
            rec["draft_admit"].log[:len(reqs)])


# ---------------------------------------------------------------------------
# phase 9: native quantized serving checkpoints (quant.apply → save_serving →
# restore_serving → serve), live reload from a watched directory, the CLIs
# ---------------------------------------------------------------------------

def _leaves(tree, path=()):
    """``{"a/b/0": tensor}`` of a tree of dicts and lists."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_leaves(tree[k], path + (str(k),)))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_leaves(v, path + (str(i),)))
        return out
    return {"/".join(path): tree}


def _same_bytes(a, b):
    """Equal dtype, shape and bits (a bfloat16 tensor compared as int16)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype == torch.bfloat16:
        a, b = a.view(torch.int16), b.view(torch.int16)
    return torch.equal(a, b)


def _rows_differing(qt_tree, qdict_tree):
    """Rows of codes and of scales in which the ``quantize_tree`` tree
    (QuantizedTensor leaves) and the ``quant.apply`` tree (``w_q`` +
    ``w_scale``) of the same fp weights differ, over every linear."""
    from repro_torch.quant.qtypes import QuantizedTensor
    flat = _leaves(qdict_tree)
    out = {"linears": 0, "rows": 0, "code_rows_differing": 0,
           "scale_rows_differing": 0}
    for path, qt in _leaves(qt_tree).items():
        if not isinstance(qt, QuantizedTensor):
            continue
        base = path.rsplit("/", 1)[0]
        codes, scale = flat[base + "/w_q"], flat[base + "/w_scale"]
        out["linears"] += 1
        out["rows"] += codes.shape[0]
        out["code_rows_differing"] += int(
            (qt.data.reshape(codes.shape) != codes).any(dim=1).sum())
        out["scale_rows_differing"] += int(
            (qt.scale.reshape(-1) != scale.reshape(-1)).sum())
    return out


def _serve_paged(dev, model, tree, reqs):
    """Phase 6's serve configuration (captured) on a store built around
    ``tree``, one run of ``reqs``: tokens, launches (what the wrappers
    issued plus what the replays launched, read from the graphs), the
    kernel B and C launches the path implies, step ms, captures."""
    from repro_torch.kernels import dequant_matmul as dm
    from repro_torch.kernels import ops
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import paged_attention_quant as paq
    from repro_torch.kernels import squant_flip as sf
    from repro_torch.serving import ServeEngine, WeightStore

    eng = ServeEngine(model, None, paged_config(), device=dev,
                      store=WeightStore(serving_params=tree, device=dev))
    dec = eng._decode = _Counted(eng._decode)
    chk = eng._prefill_chunk = _Counted(
        eng._prefill_chunk, lambda a, o: int(a[1]["tokens"].numel()))
    _reset_launches(dm, pa, paq, sf)
    t0 = time.perf_counter()
    outs = eng.generate(reqs)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = ops.combine_launches(ops.launch_counts(),
                                    eng.replay_launches())
    layers = model.cfg.n_layers
    big = sum(1 for rows in chk.log if rows > 16)
    want = {"gemv": 0, "tiled": 0, "mma": 7 * layers * big,
            "tcgemv": 7 * layers * (dec.calls + chk.calls - big)}
    st = eng.stats()
    res = {"tokens": [o.tokens for o in outs], "run_s": run_s,
           "stage_ms": eng.store.current.staged_ms,
           "step_ms": st["scheduler"].step_ms,
           "decode_forwards": dec.calls, "chunk_forwards": chk.calls,
           "trace_counts": st["trace_counts"], "graphs": st["graphs"],
           "dequant_matmul": launches["dequant_matmul.launches"],
           "dequant_matmul_by_variant":
               launches["dequant_matmul.launches_by_variant"],
           "path_implies_by_variant": want,
           "paged_attention": launches["paged_attention.launches"],
           "path_implies_paged_attention": layers * dec.calls}
    if res["dequant_matmul_by_variant"] != want or not want["tcgemv"] \
            or res["paged_attention"] != layers * dec.calls:
        raise AssertionError(f"launches {res}: the path implies B {want} "
                             f"and C {layers * dec.calls}")
    if any(len(o.tokens) != r.max_new_tokens for o, r in zip(outs, reqs)):
        raise AssertionError("a completion is short")
    eng.close()
    del eng
    torch.cuda.empty_cache()
    return res


def drive_native_checkpoint(dev, seed, layers, phase6_b_launches=None):
    """9a: phase 6's fp tree quantized into the serving format by
    ``quant.apply`` on the card (kernel A, one launch a leaf), written as a
    native w8 checkpoint, the fp tree and the tree's device copy freed,
    restored onto the card with the serve config's expectations, and served
    in phase 6's configuration, captured: tokens bit-identical to the same
    engine on the never-saved tree, restored leaves byte-equal to the saved
    ones (the bfloat16 embedding included), kernel B launches by variant
    those of the never-saved run and (in total) of phase 6. Returns the
    kernel A launches of the quantization and the kernel B and C launches
    of the restored run."""
    import shutil
    import tempfile
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import get_config
    from repro_torch.core.pipeline import quantize_tree
    from repro_torch.kernels import dequant_matmul as dm
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import paged_attention_quant as paq
    from repro_torch.kernels import squant_flip as sf
    from repro_torch.models.model import build_model
    from repro_torch.quant import apply

    cfg = dataclasses.replace(get_config("granite-3-8b"), n_layers=layers)
    model = build_model(cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    params = model.init(gen, device=dev)
    reqs = chat_requests(seed, cfg.vocab)
    tree6, _ = quantize_tree(params, method="squant", bits=8, device=dev)
    # without this the earlier phases' cached blocks leave the allocator
    # freeing and retrying under this phase's ~49 GB, which the quantize
    # time would measure (scripts/quant_apply_time.py times it alone)
    torch.cuda.empty_cache()
    _reset_launches(dm, pa, paq, sf)
    tree, meta = apply.quantize_params_serving(params, 8, "squant")
    a_launches = {"squant_flip": sf.launches,
                  "squant_flip_by_route": dict(sf.launches_by_route),
                  "squant_scale": sf.scale_launches}
    linears = 7 * layers + (0 if cfg.tie_embeddings else 1)
    if sf.launches != linears or sf.scale_launches:
        raise AssertionError(f"kernel A launches {a_launches}: one a leaf "
                             f"({linears}) expected")
    rows = _rows_differing(tree6, tree)
    del params
    torch.cuda.empty_cache()

    served6 = _serve_paged(dev, model, tree6, reqs)     # phase 6's tokens
    del tree6
    torch.cuda.empty_cache()
    never_saved = _serve_paged(dev, model, tree, reqs)

    saved = {k: v.cpu() for k, v in _leaves(tree).items()}
    nbytes = {"codes": 0, "scales": 0, "other": 0}
    for k, v in saved.items():
        part = "codes" if k.endswith(("/w_q", "/w_q4")) else \
            "scales" if k.endswith("/w_scale") else "other"
        nbytes[part] += v.numel() * v.element_size()
    d = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        free = shutil.disk_usage(d).free
        if free < 1.1 * sum(nbytes.values()):
            raise AssertionError(f"{free} bytes free in {d}: the checkpoint "
                                 f"needs {sum(nbytes.values())}")
        ck = Checkpointer(d)                 # snapshot now, write on a thread
        t0 = time.perf_counter()
        ck.save_serving(1, tree, quant_meta=meta)
        d2h_ms = ck.timings["d2h_ms"]
        ck.wait()
        save_ms = (time.perf_counter() - t0) * 1e3
        write_ms = ck.timings["write_ms"]
        step_dir = os.path.join(d, "step_00000001")
        disk_bytes = sum(os.path.getsize(os.path.join(step_dir, f))
                         for f in os.listdir(step_dir))
        del tree
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        restored, rmeta, step = ck.restore_serving(
            expect={"quantize_weights": "squant", "weight_bits": 8},
            device=dev)
        torch.cuda.synchronize()
        restore_ms = (time.perf_counter() - t0) * 1e3
        read_ms, h2d_ms = ck.timings["read_ms"], ck.timings["h2d_ms"]
    finally:
        shutil.rmtree(d, ignore_errors=True)
    got = _leaves(restored)
    differing = sorted(set(saved) ^ set(got)) + [
        k for k in saved if k in got and not _same_bytes(got[k].cpu(),
                                                         saved[k])]
    if differing or step != 1 or rmeta["format"] != "quantized" or \
            any(t.device != dev for t in got.values()):
        raise AssertionError(f"restored leaves differ from the saved ones: "
                             f"{differing[:8]} (step {step}, "
                             f"{rmeta['format']})")
    emb = got["embedding/embedding"]
    emb_meta = {"dtype": str(emb.dtype).replace("torch.", ""),
                "shape": list(emb.shape)}
    del saved, got, emb
    served = _serve_paged(dev, model, restored, reqs)
    bad = [i for i, (a, b) in enumerate(zip(served["tokens"],
                                            never_saved["tokens"]))
           if a != b]
    if bad or len(served["tokens"]) != len(reqs):
        raise AssertionError(f"restored tree: tokens differ from the "
                             f"never-saved tree's for requests {bad}")
    if served["dequant_matmul_by_variant"] != \
            never_saved["dequant_matmul_by_variant"] or (
                phase6_b_launches is not None
                and served["dequant_matmul"] != phase6_b_launches):
        raise AssertionError(f"kernel B launches {served} vs never-saved "
                             f"{never_saved} and phase 6 "
                             f"{phase6_b_launches}")
    pairs = [(a, b) for x, y in zip(served["tokens"], served6["tokens"])
             for a, b in zip(x, y)]
    emit({"phase": "9a native w8 checkpoint: quant.apply, save_serving, "
                   "restore_serving, serve (continuous + paged + chunked, "
                   "captured)",
          "model": cfg.name, "layers": layers,
          "full_depth": layers == get_config("granite-3-8b").n_layers,
          "quantize_ms": meta["quantize_ms"], "launches_quantize": a_launches,
          "bytes_on_disk": disk_bytes, "bytes_by_part": nbytes,
          "embedding": emb_meta,
          "save_ms": save_ms, "save_d2h_ms": d2h_ms, "save_write_ms": write_ms,
          "restore_ms": restore_ms, "restore_read_ms": read_ms,
          "restore_h2d_ms": h2d_ms, "stage_ms": served["stage_ms"],
          "restored_byte_equal": True, "tokens_equal_never_saved": True,
          "step_ms": served["step_ms"],
          "step_ms_never_saved": never_saved["step_ms"],
          "step_ms_quantize_tree_tree": served6["step_ms"],
          "run_s": served["run_s"],
          "vs_quantize_tree_tree": rows,
          "greedy_agreement_with_phase6_tokens": {
              "equal_positions": sum(a == b for a, b in pairs),
              "positions": len(pairs),
              "requests_identical": sum(x == y for x, y in zip(
                  served["tokens"], served6["tokens"]))},
          "launches": {k: served[k] for k in (
              "dequant_matmul", "dequant_matmul_by_variant",
              "paged_attention")},
          "launches_phase6_dequant_matmul": phase6_b_launches,
          "trace_counts": served["trace_counts"], "graphs": served["graphs"],
          "tokens": served["tokens"]})
    del restored
    torch.cuda.empty_cache()
    return (a_launches["squant_flip"], served["dequant_matmul"],
            served["paged_attention"])


def _wait_until(cond, timeout, what):
    t_end = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > t_end:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.01)


def _overlaps(a, b):
    """Pairs of intervals ``(t0, t1, ...)`` of ``a`` and ``b`` that
    overlap in time."""
    return [(x, y) for x in a for y in b if x[0] < y[1] and y[0] < x[1]]


def drive_live_reload(dev, seed, layers=4):
    """9b: phase 6's engine (w8, paged continuous, chunked, captured) at
    full width and ``layers`` layers watches a fresh directory
    (``poll_s=0.05``) while a writer thread saves, with requests flowing:
    step 1 an fp ``save`` (another seed; quantized on the fly), step 2 a
    native w8 checkpoint of a third seed, a torn step 3 (no COMMITTED), step
    4 a w4-metadata checkpoint. Every completion is full length, versions
    never go backwards, the sources read ``ckpt:1`` then ``ckpt:2``, the
    only error is step 4's rejection, and the tokens after the last swap
    equal a fresh engine's on the restored step-2 tree. Records the reloads
    that ran while the scheduler's thread captured a new chunk width, each
    swap's stage ms (and restore + stage ms) and the recapture after it."""
    import shutil
    import tempfile
    import threading
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    from repro_torch.quant import apply
    from repro_torch.serving import ServeEngine, WeightStore

    cfg = dataclasses.replace(get_config("granite-3-8b"), n_layers=layers)
    model = build_model(cfg)

    def init(s):
        gen = torch.Generator(device=dev)
        gen.manual_seed(s)
        return model.init(gen, device=dev)

    eng = ServeEngine(model, init(seed), paged_config(), device=dev)
    fp1 = init(seed + 1)
    q2, m2 = apply.quantize_params_serving(init(seed + 2), 8, "squant")
    q4, m4 = apply.quantize_params_serving(init(seed + 3), 4, "squant")
    torch.cuda.empty_cache()

    captures, reloads, versions = [], [], []
    real_capture, real_poll = eng._capture, eng.store.poll_checkpoints

    def capture(fn, params, batch, caches, out, inputs):
        t0 = time.perf_counter()
        try:
            return real_capture(fn, params, batch, caches, out, inputs)
        finally:
            captures.append((t0, time.perf_counter(),
                             list(inputs[0].shape)))

    def poll(*a, **kw):
        t0 = time.perf_counter()
        step = real_poll(*a, **kw)
        if step is not None:                 # a restore and a stage ran
            reloads.append((t0, time.perf_counter(), step))
        return step

    def on_step(info):
        if not versions or versions[-1]["version"] != info["version"]:
            cur = eng.store.current
            versions.append({"version": info["version"],
                             "source": cur.source, "stage_ms": cur.staged_ms,
                             "t": time.perf_counter(),
                             "capture_ms": eng.capture_ms,
                             "captures": sum(eng.trace_counts.values())})
    eng._capture, eng.store.poll_checkpoints = capture, poll
    eng.on_step = on_step

    d = tempfile.mkdtemp(prefix="chip_smoke_watch_")
    side = tempfile.mkdtemp(prefix="chip_smoke_torn_")
    writes, writer_error = {}, []

    def writer():
        try:
            ck = Checkpointer(d, async_save=False)
            time.sleep(0.5)
            t0 = time.perf_counter()
            ck.save(1, fp1, {"step": 1})
            writes["1 fp save ms"] = (time.perf_counter() - t0) * 1e3
            _wait_until(lambda: eng.store.version >= 2, 300,
                        "step 1 swapped in")
            t0 = time.perf_counter()
            ck.save_serving(2, q2, quant_meta=m2)
            writes["2 w8 save ms"] = (time.perf_counter() - t0) * 1e3
            _wait_until(lambda: eng.store.version >= 3, 300,
                        "step 2 swapped in")
            # a torn step appears whole but without its COMMITTED marker
            Checkpointer(side, async_save=False).save_serving(
                3, q2, quant_meta=m2)
            os.remove(os.path.join(side, "step_00000003", "COMMITTED"))
            os.rename(os.path.join(side, "step_00000003"),
                      os.path.join(d, "step_00000003"))
            time.sleep(0.5)                     # several polls see it
            ck.save_serving(4, q4, quant_meta=m4)
            _wait_until(lambda: eng.store.errors, 300, "step 4 rejected")
        except BaseException as e:            # re-raised by the main thread
            writer_error.append(e)

    outs, k = [], 0
    try:
        eng.watch_checkpoints(d, poll_s=0.05)
        th = threading.Thread(target=writer, daemon=True)
        t_start = time.perf_counter()
        th.start()
        while th.is_alive() and time.perf_counter() - t_start < 600:
            reqs = chat_requests(seed + 100 + k, cfg.vocab, max_new=16)
            outs += list(zip(eng.generate(reqs), reqs))
            k += 1
        th.join(timeout=60)
        if th.is_alive() or writer_error:
            raise AssertionError(f"writer: {writer_error or 'still running'}")
        # after the last swap: fresh requests, then a fresh engine on the
        # restored step-2 tree
        final = chat_requests(seed + 99, cfg.vocab, max_new=16)
        live = [o.tokens for o in eng.generate(final)]
        st = eng.stats()
        tree2, _, _ = Checkpointer(d).restore_serving(
            2, expect={"quantize_weights": "squant", "weight_bits": 8},
            device=dev)
    finally:
        eng.close()
        shutil.rmtree(d, ignore_errors=True)
        shutil.rmtree(side, ignore_errors=True)
    fresh = ServeEngine(model, None, paged_config(), device=dev,
                        store=WeightStore(serving_params=tree2, device=dev))
    fresh_tokens = [o.tokens for o in fresh.generate(final)]
    fresh.close()
    del fresh, tree2, fp1, q2, q4, eng
    torch.cuda.empty_cache()

    w = st["weights"]
    seq = [v["version"] for v in versions]
    sources = [v["source"] for v in versions]
    short = [r.request_id for o, r in outs if len(o.tokens)
             != r.max_new_tokens]
    errors = w["errors"]
    landed = _overlaps(reloads, captures)
    problems = []
    if short:
        problems.append(f"short completions {short}")
    if seq != sorted(seq):
        problems.append(f"versions went backwards: {seq}")
    if sources != ["init", "ckpt:1", "ckpt:2"]:
        problems.append(f"sources {sources}")
    if len(errors) != 1 or "rejected" not in errors[0] \
            or "step 4" not in errors[0]:
        problems.append(f"errors {errors}")
    if live != fresh_tokens:
        problems.append("tokens after the last swap differ from a fresh "
                        "engine's on the restored step-2 tree")
    swaps = []
    for v, nxt in zip(versions, versions[1:] + [None]):
        after = nxt if nxt is not None else {
            "capture_ms": st["graphs"]["capture_ms"],
            "captures": sum(st["trace_counts"].values())}
        swaps.append({"version": v["version"], "source": v["source"],
                      "stage_ms": v["stage_ms"],
                      "restore_and_stage_ms": next(
                          ((t1 - t0) * 1e3 for t0, t1, step in reloads
                           if v["source"] == f"ckpt:{step}"), None),
                      "recaptures": after["captures"] - v["captures"],
                      "recapture_ms": after["capture_ms"] - v["capture_ms"]})
    emit({"phase": "9b live reload, granite-3-8b w8, continuous + paged + "
                   "chunked, captured",
          "layers": layers, "poll_s": 0.05, "requests": len(outs),
          "generate_calls": k + 1, "versions_seen": seq, "sources": sources,
          "errors": errors, "swaps": swaps, "writer": writes,
          "stages_while_capturing": {
              "count": len(landed),
              "note": "reloads (restore and stage of a checkpoint on "
                      "the watcher's thread) whose interval overlapped a "
                      "capture on the scheduler's thread" if landed
                      else "none did in this run",
              "widths": sorted({tuple(c[2]) for _, c in landed})},
          "captures": len(captures), "step_ms": st["scheduler"].step_ms,
          "drains": st["scheduler"].drains,
          "forced_swaps": st["scheduler"].forced_swaps,
          "tokens_equal_fresh_engine_step2": live == fresh_tokens})
    if problems:
        raise AssertionError("; ".join(problems))


def capture_sync_probe(dev):
    """What another thread's synchronization does to a CUDA-graph capture
    in progress (``thread_local`` mode, as the engine captures): for a
    synchronization of the other thread's own stream and of the whole
    device, whether the other thread's call raised, and whether the
    capture ended with a graph that replays right. Run it in a process of
    its own: a broken capture may leave the allocator in capture mode."""
    import threading
    out = {}
    for mode in ("stream_sync", "device_sync"):
        x = torch.ones(1 << 16, device=dev)
        began, done, other = threading.Event(), threading.Event(), {}

        def sync():
            began.wait(30)
            try:
                s = torch.cuda.Stream(dev)
                with torch.cuda.stream(s):       # no RNG: the capture
                    torch.ones(1 << 20, device=dev).sum()   # holds it
                if mode == "device_sync":
                    torch.cuda.synchronize(dev)
                else:
                    s.synchronize()
            except Exception as e:
                other["error"] = repr(e)
            done.set()

        th = threading.Thread(target=sync)
        th.start()
        side, g, res = torch.cuda.Stream(dev), torch.cuda.CUDAGraph(), {}
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            y = x * 2                                # warm-up
            try:
                g.capture_begin(capture_error_mode="thread_local")
                try:
                    y = x * 2
                    began.set()
                    done.wait(30)
                    y = y + 1
                finally:
                    g.capture_end()
                x.fill_(2.0)
                g.replay()
                side.synchronize()
                res["capture_ok"] = bool((y == 5).all())
            except Exception as e:
                res["capture_ok"], res["capture_error"] = False, repr(e)
        began.set()
        th.join(30)
        res["other_thread_error"] = other.get("error")
        out[mode] = res
    return out


def run_capture_sync_probe():
    """:func:`capture_sync_probe` in a process of its own; its result."""
    p = subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--capture-sync-probe"], capture_output=True,
                       text=True, timeout=300, cwd=ROOT)
    lines = p.stdout.strip().splitlines()
    if p.returncode != 0 or not lines:
        return {"returncode": p.returncode, "stderr": p.stderr[-2000:]}
    return json.loads(lines[-1])


def drive_clis(dev):
    """9c: the two CLIs as processes at their reduced config on the card:
    quantize writes a native w8 serving checkpoint, serve (continuous,
    paged) watches it and swaps it in (source ``ckpt:0``)."""
    import shutil
    import tempfile
    d = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src") + (
        os.pathsep + os.environ["PYTHONPATH"]
        if os.environ.get("PYTHONPATH") else ""))
    serving = os.path.join(d, "serving")
    cmds = {"quantize": ["-m", "repro_torch.launch.quantize", "--bits", "8",
                         "--out", os.path.join(d, "out"),
                         "--serving-ckpt", serving],
            "serve": ["-m", "repro_torch.launch.serve", "--quantize",
                      "squant", "--bits", "8", "--scheduler", "continuous",
                      "--kv-backend", "paged", "--reload-from", serving,
                      "--reload-poll", "0.01", "--rounds", "3",
                      "--max-new", "64", "--prompts", "hello world",
                      "the quick brown fox", "a", "SQuant on the fly"]}
    res, lines = {}, {}
    try:
        for name, args in cmds.items():
            t0 = time.perf_counter()
            p = subprocess.run([sys.executable] + args, capture_output=True,
                               text=True, timeout=300, cwd=ROOT, env=env)
            lines[name] = p.stdout.splitlines()
            res[name] = {"returncode": p.returncode,
                         "seconds": time.perf_counter() - t0,
                         "stdout_tail": p.stdout.strip().splitlines()[-6:],
                         "stderr_tail": p.stderr.strip().splitlines()[-6:]}
            if p.returncode != 0:
                break
    finally:
        shutil.rmtree(d, ignore_errors=True)
    swapped = [ln for ln in lines.get("serve", [])
               if "scheduler=continuous" in ln and "source ckpt:0" in ln]
    emit({"phase": "9c the quantize and serve CLIs (reduced config, on the "
                   "card)", "runs": res, "swapped_to_ckpt_0": bool(swapped)})
    if any(r["returncode"] != 0 for r in res.values()) or not swapped:
        raise AssertionError(f"CLIs: {res}")


# ---------------------------------------------------------------------------
# phase 10: a fine-grained mixture of experts (moonshot-v1-16b-a3b) on the
# paged continuous path
# ---------------------------------------------------------------------------

MOE_ARCH = "moonshot-v1-16b-a3b"


def moe_expert_shapes(cfg):
    """The expert banks of one MoE layer as (name, out, in) (kernel B's
    (M, N)): wi and wg d_model -> d_ff, wdown d_ff -> d_model."""
    return [("wi", cfg.d_ff, cfg.d_model), ("wg", cfg.d_ff, cfg.d_model),
            ("wdown", cfg.d_model, cfg.d_ff)]


def profile_moe_decode(dev, seed, eng, steps=4):
    """``--profile``: the captured paged decode step of phase 10's
    configuration on its tree, eight slots of its traffic admitted, traced
    (:func:`_profile_steps`), kernel B's device time split into expert and
    attention launches by grid (an expert launch's ``tcgemv`` grid is
    (ceil(out/128), splits) of its bank's shape)."""
    from repro_torch.kernels import dequant_matmul as dm
    from repro_torch.serving import ServeEngine, WeightStore
    cfg = eng.model.cfg
    sms, occ = dm.card_ctas_per_sm(8, eng.cfg.max_slots, dev.index)
    grids = {}
    for part, shapes in (("experts", [(m, n) for _, m, n in
                                      moe_expert_shapes(cfg)]),
                         ("attention", [(cfg.n_heads * cfg.head_dim,
                                         cfg.d_model),
                                        (cfg.n_kv_heads * cfg.head_dim,
                                         cfg.d_model),
                                        (cfg.d_model,
                                         cfg.n_heads * cfg.head_dim)])):
        for m, n in shapes:
            sp, _ = dm.split_plan(m, n, 128, sms, min(occ, dm.TC_CTAS_PER_SM))
            grids[(-(-m // dm.TC_ROWS), sp, 1)] = part
    if len(set(grids.values())) != 2:
        raise AssertionError(f"expert and attention grids coincide: {grids}")
    peng = ServeEngine(eng.model, None, paged_config(),
                       store=WeightStore(serving_params=eng.params,
                                         device=dev), device=dev)
    kv = peng.scheduler.kv
    slots = list(range(peng.cfg.max_slots))
    reqs = chat_requests(seed, cfg.vocab)[:len(slots)]
    kv.admit([(i, r) for i, r in enumerate(reqs)], slots, None,
             peng.params)

    def step():
        nxt = kv.logits.argmax(-1).to(torch.int32)
        nxt.cpu()                                        # the step's host sync
        kv.decode(peng.params, nxt, slots)

    _profile_steps(step, steps, f"10 profile of the captured MoE decode "
                   f"step, {cfg.name}", {
                       "layers": cfg.n_layers, "slots": len(slots),
                       "expert_grids": sorted([list(g), p]
                                              for g, p in grids.items())},
                   b_part=lambda grid: grids.get(grid, "unmatched"))
    peng.close()


def correlated_inputs(rng, samples, n, k):
    """ReLU-like activations whose E[xxᵀ] has the paper's structure
    (Appendix A.1): a channel-common floor, a per-kernel shared component
    and element noise with decaying within-kernel correlation (the recipe
    of ``tests/test_hessian.py``)."""
    import numpy as np
    common = rng.normal(size=(samples, 1, 1))
    kern = rng.normal(size=(samples, n, 1))
    elem = rng.normal(size=(samples, n, k + 4))
    smooth = np.array([0.3, 0.7, 1.0, 0.7, 0.3])
    sm = np.stack([elem[..., i:i + k] for i in range(5)], 0)
    elem = (sm * smooth[:, None, None, None]).sum(0) / np.sqrt(
        (smooth ** 2).sum())
    x = 0.3 * common + 0.8 * kern + 0.45 * elem + 0.5
    return np.maximum(x, 0).reshape(samples, n * k)


def hessian_on_card(dev, seed):
    """10d: the Hessian analysis and the baselines on the card, once, with
    ``tests/test_hessian.py``'s layer: (32, 144) weights, kernels of 9,
    4 bits, 4000 correlated activation samples from ``seed``. AP and
    AP-exact > 0.9 as that test holds them; the flip recorder's codes equal
    ``squant_codes``'; AdaRound's and RTN's output MSE on the samples."""
    import numpy as np

    from repro_torch.core import baselines, hessian
    from repro_torch.core.squant import squant_codes
    from repro_torch.quant.scales import max_scale

    rng = np.random.default_rng(seed)
    x = torch.from_numpy(correlated_inputs(rng, 4000, 16, 9)).to(dev)
    w = torch.from_numpy((rng.normal(size=(32, 144)) * 0.2).astype(
        np.float32)).to(dev)
    t0 = time.perf_counter()
    rep = hessian.approximation_precision(w, x, bits=4, group_size=9)
    ap_s = time.perf_counter() - t0
    s = max_scale(w, 4)
    codes, _, _ = squant_codes(w, s, bits=4, group_size=9, enable_k=True,
                               enable_c=True)
    rec, _, log = hessian._record_flips(
        (w.double() / s.double()).cpu().numpy(), 4, 9, True)
    recorder_equal = bool(np.array_equal(rec, codes.cpu().numpy()))
    xf = x.float()
    y = xf @ w.T
    t0 = time.perf_counter()
    ada = baselines.adaround(w, xf, bits=4)
    torch.cuda.synchronize()
    ada_s = time.perf_counter() - t0
    rtn = baselines.rtn(w, 4)
    mse = {k: float(torch.mean((xf @ q.dequantize().T - y) ** 2))
           for k, q in (("adaround", ada), ("rtn", rtn))}
    out = {"layer": [32, 144], "group_size": 9, "bits": 4, "samples": 4000,
           "flipped": rep.flipped, "ap": rep.ap, "ap_exact": rep.ap_exact,
           "ap_inorder": rep.ap_inorder, "by_stage": rep.by_stage,
           "recorder_codes_equal_squant_codes": recorder_equal,
           "flip_log_events": len(log), "output_mse": mse,
           "approximation_precision_s": ap_s, "adaround_s": ada_s,
           "device": str(ada.data.device)}
    if not (rep.flipped > 100 and rep.ap > 0.9 and rep.ap_exact > 0.9
            and recorder_equal and ada.data.is_cuda):
        raise AssertionError(f"the Hessian analysis on the card: {out}")
    return out


# 10c's floor for second turns, whose prefix reuse shifts their chunk
# boundaries off the oracle's: the reference engine's own lowest rate when
# chunk boundaries differ at 64 experts top-6 (0.75, chunk 1 against
# monolithic admission; FINE_GRAINED_REFERENCE_RATES in
# tests/test_torch_moe_serving.py). First turns chunk as the oracle does
# and owe equal tokens.
SHIFTED_CHUNK_FLOOR = 0.75


def agreement_by_turn(rep, reqs):
    """An agreement report split into first turns and second turns (a
    request whose prompt extends another's whole prompt): matched,
    compared, rate and the mismatched (request, position) pairs of each."""
    second = {r.request_id for r in reqs
              if any(len(o.prompt) < len(r.prompt)
                     and r.prompt[:len(o.prompt)] == o.prompt for o in reqs)}
    out = {}
    for name, ids in (("first", {r.request_id for r in reqs} - second),
                      ("second", second)):
        m = sum(rep.per_request.get(i, (0, 0))[0] for i in ids)
        n = sum(rep.per_request.get(i, (0, 0))[1] for i in ids)
        out[name] = {"requests": sorted(ids), "matched": m, "compared": n,
                     "rate": m / n if n else 1.0,
                     "mismatches": [list(p) for p in rep.mismatches
                                    if p[0] in ids]}
    return out


def drive_moe(dev, seed, layers, profile=False):
    """Phase 10: ``moonshot-v1-16b-a3b`` at full width (64 experts top-6,
    d_model 2048, d_ff 1408, vocab 163 840) and ``layers`` of its 48 layers
    on phase 6's path and traffic: (a) random weights, SQuant w8 of the
    whole tree (every expert bank on the native route), served captured,
    repeated and eager, tokens bit-identical and launches equal, kernel B's
    launches counted by weight shape and split into experts and attention
    by variant (every expert launch ``tcgemv``: capacity 8 at decode and at
    a 64-row chunk); (b) 2 layers in float32 through the kernels against
    the plain versions; (c) 2 layers in float32, teacher-forced agreement
    of the paged chunked engine against the one-slot contiguous oracle that
    admits in the same 64-token chunks: all of it the reference's ``moe``
    budget, first turns (chunked as the oracle chunks) equal tokens,
    second turns (their prefix reuse shifts their chunks)
    ``SHIFTED_CHUNK_FLOOR``; and, not gated, against the one-slot
    oracle with monolithic admission (capacity routing over a whole prompt
    drops other tokens than per chunk: at 64 experts top-6 the reference's
    own sweep falls below its 0.85 floor,
    ``tests/test_torch_moe_serving.py``); (d) the Hessian analysis and the
    baselines on the card.
    Returns kernel A's, B's and C's launches of (a), the context lengths
    of its fullest decode step and its line."""
    from repro_torch.configs import get_config
    from repro_torch.core.pipeline import quantize_tree
    from repro_torch.models.model import build_model
    from repro_torch.serving.equivalence import agreement_budget

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    full = get_config(MOE_ARCH)

    def before_close(eng):
        if profile:
            profile_moe_decode(dev, seed, eng)

    a_n, b_n, c_n, lengths, entry = drive_continuous(
        dev, seed, layers, f"10a fine-grained MoE, continuous + paged + "
        f"chunked, {MOE_ARCH} w8", arch=MOE_ARCH, agreement=False,
        capture_all_widths=False, before_close=before_close,
        reduced=None if layers == full.n_layers else
        {"n_layers": f"{full.n_layers} -> {layers}"})
    parts = entry["launches"]["dequant_matmul_by_part"]
    if set(parts["experts"]) != {"tcgemv"} or parts["experts"]["tcgemv"] \
            != 3 * full.moe.n_experts * layers * (
                entry["decode_forwards"] + entry["chunk_forwards"]):
        raise AssertionError(f"expert launches {parts['experts']}: every "
                             f"expert of every forward through tcgemv")
    if entry["quantize"]["stacked_buckets"]:
        raise AssertionError("an expert bucket took the stacked route")
    torch.cuda.empty_cache()

    # (b) and (c): two layers, float32 activations
    plain = paged_vs_plain(dev, seed, arch=MOE_ARCH)
    cfg = dataclasses.replace(full, n_layers=2, dtype="float32")
    model = build_model(cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    params = model.init(gen, device=dev)
    tree, _ = quantize_tree(params, method="squant", bits=8, device=dev)
    del params
    reqs = chat_requests(seed, cfg.vocab)
    budget = agreement_budget(paged_config(), cfg)
    # the oracle admits in the same 64-token chunks, so each chunk routes
    # with the same capacity: what is compared is the paged pool (block
    # tables, prefix reuse, copy-on-write) against the contiguous cache
    agree, oracle_s, _ = measure_agreement(
        dev, model, tree, reqs, False, torch.float32,
        prefill_chunk=paged_config().prefill_chunk)
    agree_mono, _, _ = measure_agreement(dev, model, tree, reqs, False,
                                         torch.float32)
    turns = agreement_by_turn(agree, reqs)
    del tree
    torch.cuda.empty_cache()
    m5 = hessian_on_card(dev, seed)
    line = {"phase": "10b-d fine-grained MoE at 2 layers (float32) and the "
                     "Hessian analysis on the card", "model": MOE_ARCH,
            "kernels_vs_plain": dict(plain, tolerance="1e-3 * max|logit| "
                                     "(phase 5's float32 tolerance)"),
            "agreement": {"against": "contiguous, one slot, admission in "
                          "the same 64-token chunks", "budget": budget,
                          "gated": "float32 activations, 2 layers; all "
                                   f">= {budget}, first turns equal "
                                   "tokens, second turns "
                                   f">= {SHIFTED_CHUNK_FLOOR}",
                          "rate": agree.rate, "matched": agree.matched,
                          "compared": agree.compared,
                          "oracle_run_s": oracle_s, "by_turn": turns,
                          "rate_against_monolithic_oracle_not_gated":
                              agree_mono.rate,
                          "matched_against_monolithic_oracle":
                              agree_mono.matched},
            "hessian": m5,
            "seconds": time.perf_counter() - t_phase}
    emit(line)
    if budget != 0.85 or agree.rate < budget \
            or turns["first"]["mismatches"] \
            or turns["second"]["rate"] < SHIFTED_CHUNK_FLOOR:
        raise AssertionError(f"MoE paged vs one-slot contiguous (chunked) "
                             f"agreement {agree.rate:.4f} (budget {budget}), "
                             f"by turn {turns}: first turns owe equal "
                             f"tokens, second turns {SHIFTED_CHUNK_FLOOR}")
    return a_n, b_n, c_n, lengths, entry


# ---------------------------------------------------------------------------
# optional: where a decode step's time goes (--profile)
# ---------------------------------------------------------------------------

def _device_events(prof):
    """The device activity of a ``torch.profiler`` run (kernels, copies,
    memsets) as (start us, duration us, name, grid) from its Chrome trace,
    in start order."""
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return sorted((float(e["ts"]), float(e.get("dur", 0.0)), e["name"],
                   tuple(e.get("args", {}).get("grid", ())))
                  for e in events
                  if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))


_B_KERNELS = ("tcgemv_kernel", "pf_kernel", "gemv_kernel", "tiled_kernel")


def _profile_steps(step, steps, phase, extra, b_part=None):
    """Trace ``steps`` calls of ``step()`` (after two warm ones) with
    ``torch.profiler`` and print device time by kernel (summed over
    kernels), the device's busy time (the union of the kernels' intervals)
    and its share of the untraced wall time, the number of device kernels
    per step, and the device time split into kernel C, kernel B,
    host-to-device copies and everything else. ``b_part(grid)`` names the
    part a kernel-B launch of that grid serves: kernel B's time is then
    split by part (a merge pass goes with the launch before it)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):                                   # warm
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    t1 = time.perf_counter()
    for _ in range(steps):                               # the same, untraced
        step()
    torch.cuda.synchronize()
    untraced_ms = (time.perf_counter() - t1) * 1e3
    split = {"paged_attention": 0.0, "host_to_device_copies": 0.0,
             "other": 0.0}
    by_name = {}
    # the union of the device intervals: a merge pass (kernels B and C)
    # launched as a programmatic dependent starts while the pass before it
    # runs, and the sum over kernels counts that overlap twice
    dev_us, busy_us, end, owner = 0.0, 0.0, None, "dequant_matmul"
    events = _device_events(prof)
    for ts, dur, name, grid in events:
        if end is None or ts > end:
            busy_us, end = busy_us + dur, ts + dur
        elif ts + dur > end:
            busy_us, end = busy_us + ts + dur - end, ts + dur
        dev_us += dur
        row = by_name.setdefault(name[:70], [0.0, 0])
        row[0] += dur
        row[1] += 1
        if "paged_decode_" in name:                  # split and merge pass
            key = "paged_attention"
        elif any(k in name for k in _B_KERNELS):
            owner = "dequant_matmul" if b_part is None else \
                f"dequant_matmul_{b_part(grid)}"
            key = owner
        elif "tcgemv_merge" in name:
            key = owner
        elif "HtoD" in name:
            key = "host_to_device_copies"
        else:
            key = "other"
        split[key] = split.get(key, 0.0) + dur
    rows = sorted(((us, n, c) for n, (us, c) in by_name.items()),
                  reverse=True)
    line = {"phase": phase, **extra,
            "steps": steps, "wall_ms_per_step_traced": wall_ms / steps,
            "wall_ms_per_step_untraced": untraced_ms / steps,
            "device_ms_per_step": dev_us / 1e3 / steps,
            "device_busy_ms_per_step": busy_us / 1e3 / steps,
            "device_busy_share_of_untraced_wall":
                busy_us / 1e3 / untraced_ms,
            "device_kernels_per_step": len(events) / steps,
            "device_ms_per_step_by_part": {k: v / 1e3 / steps
                                           for k, v in split.items()},
            "top_device_time": [{"name": n, "ms_per_step": us / 1e3 / steps,
                                 "calls_per_step": c / steps}
                                for us, n, c in rows[:12]]}
    emit(line)
    return line


def profile_decode(dev, seed, layers, batch=4, steps=4):
    """Where a decode step's time goes, round path and paged continuous
    path, and where an admission chunk forward's goes (``--profile``)."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    from repro_torch.serving import ServeConfig, ServeEngine, WeightStore

    cfg = dataclasses.replace(get_config("granite-3-8b"), n_layers=layers)
    model = build_model(cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    params = model.init(gen, device=dev)
    eng = ServeEngine(model, params, ServeConfig(
        max_batch=batch, max_len=256, quantize_weights="squant",
        weight_bits=8, dequantize_for_compute=False), device=dev)
    del params
    torch.cuda.empty_cache()
    prompt = torch.randint(0, cfg.vocab, (batch, 96), generator=gen, device=dev)
    state = {"cache": eng.model.init_cache(batch, 256, device=dev)}
    state["lg"], state["cache"] = eng.model.prefill(
        eng.params, {"tokens": prompt}, state["cache"])

    def round_step():
        nxt = state["lg"].argmax(-1)
        nxt.cpu()                                        # the step's host sync
        state["lg"], state["cache"] = eng.model.decode_step(
            eng.params, nxt[:, None], state["cache"])

    _profile_steps(round_step, steps, "profile of decode steps, round path",
                   {"layers": layers, "batch": batch})

    # the paged continuous path: 8 slots of phase 6's traffic admitted into
    # the block pool, then the scheduler's decode step (table push
    # included), captured, then eager (capture=False); then one
    # admission chunk of phase 6's configuration, 64 rows after the
    # 192-token shared prefix on the one-row side cache (the same positions
    # rewritten each call), through the engine's chunk entry point
    reqs = chat_requests(seed, cfg.vocab)[:8]
    prefix, chunk = 192, paged_config().prefill_chunk
    toks = torch.randint(0, cfg.vocab, (chunk,), generator=gen,
                         device=dev).cpu().numpy()
    for capture in (True, False):
        label = "captured" if capture else "eager"
        peng = ServeEngine(model, None, paged_config(),
                           store=WeightStore(serving_params=eng.params,
                                             device=dev), device=dev,
                           capture=capture)
        kv = peng.scheduler.kv
        kv.admit([(i, r) for i, r in enumerate(reqs)], list(range(8)), None,
                 peng.params)
        slots = list(range(8))

        def paged_step():
            nxt = kv.logits.argmax(-1).to(torch.int32)
            nxt.cpu()                                    # the step's host sync
            kv.decode(peng.params, nxt, slots)

        _profile_steps(paged_step, steps,
                       f"profile of decode steps, paged continuous path, "
                       f"{label}",
                       {"layers": layers, "batch": 8, "capture": capture,
                        "context_lengths": kv._lengths.tolist()})
        side = kv.side_cache(1)
        _, side = peng.model.prefill(peng.params, {"tokens": torch.tensor(
            [reqs[0].prompt[:prefix]], device=dev)}, side)

        def chunk_step():
            t, clock = kv.chunk_inputs(toks, prefix)
            lg, _ = peng._prefill_chunk(peng.params, {"tokens": t},
                                        dict(side, pos=clock))
            lg.cpu()                                     # the step's host sync

        _profile_steps(chunk_step, steps,
                       f"profile of an admission chunk forward, paged "
                       f"continuous config, {label}",
                       {"layers": layers, "chunk_rows": chunk,
                        "start_position": prefix, "capture": capture})
        emit({"phase": f"profiled paged engine, {label}",
              "trace_counts": dict(peng.trace_counts),
              "graphs": peng.stats()["graphs"]})
        peng.close()
        del peng, kv, side
        torch.cuda.empty_cache()
    eng.close()


def profile_quantize(dev, seed, layers):
    """Where one SQuant w8 quantization of the main path's tree spends its
    device time (``--profile``): the serving pipeline's quantize function
    traced as ``scripts/quantize_tree_ab.py`` traces it, after a warm call."""
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    from quantize_tree_ab import trace
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    from repro_torch.serving import ServeConfig
    from repro_torch.serving.weights import make_weight_pipeline

    cfg = dataclasses.replace(get_config("granite-3-8b"), n_layers=layers)
    model = build_model(cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    params = model.init(gen, device=dev)
    _, quantize_fn, _ = make_weight_pipeline(model, ServeConfig(
        quantize_weights="squant", weight_bits=8,
        dequantize_for_compute=False), device=dev)
    quantize_fn(params)
    torch.cuda.synchronize()
    emit({"phase": "profile of quantize_tree", "layers": layers,
          **trace(lambda: quantize_fn(params))})
    del params
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# optional: which kernel costs the paged path its agreement (--agreement-
# variants)
# ---------------------------------------------------------------------------

def agreement_variants(dev, seed, layers, layers7):
    """Teacher-forced greedy agreement of phase 6's paged engine against its
    one-slot contiguous oracle with bfloat16 activations, with one kernel at
    a time swapped for its plain version in both engines (kernel C, kernel
    B, both) and with float32 activations; then phase 7's int8 pool against
    the fp pool in bfloat16 and float32 at ``layers7`` and at 2 layers. Also
    the oracle's top-1 minus top-2 logit gap over the sampled positions."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models.model import build_model
    from repro_torch.serving import ServeEngine

    originals = {"pa": ops.paged_attention, "dm": ops.dequant_matmul}

    def plain(fn):
        def call(*a, **kw):
            kw["backend"] = "ref"
            return fn(*a, **kw)
        return call

    runs = [(layers, False, torch.bfloat16, "kernels"),
            (layers, False, torch.bfloat16, "C plain"),
            (layers, False, torch.bfloat16, "B plain"),
            (layers, False, torch.bfloat16, "B and C plain"),
            (layers, False, torch.float32, "kernels"),
            (layers7, True, torch.bfloat16, "kernels"),
            (layers7, True, torch.float32, "kernels"),
            (2, True, torch.bfloat16, "kernels"),
            (2, True, torch.float32, "kernels")]
    trees = {}
    out = []
    for depth, quant, dtype, swap in runs:
        if depth not in trees:
            trees.clear()
            torch.cuda.empty_cache()
            cfg = dataclasses.replace(get_config("granite-3-8b"),
                                      n_layers=depth)
            model = build_model(cfg)
            gen = torch.Generator(device=dev)
            gen.manual_seed(seed)
            params = model.init(gen, device=dev)
            trees[depth] = (model, ServeEngine(
                model, params, paged_config(), device=dev).params)
            del params
            torch.cuda.empty_cache()
        model, tree = trees[depth]
        ops.paged_attention = plain(originals["pa"]) \
            if "C plain" in swap or swap == "B and C plain" \
            else originals["pa"]
        ops.dequant_matmul = plain(originals["dm"]) \
            if swap in ("B plain", "B and C plain") else originals["dm"]
        reqs = chat_requests(seed, model.cfg.vocab)
        t0 = time.perf_counter()
        rep, _, _ = measure_agreement(dev, model, tree, reqs, quant, dtype)
        row = {"phase": "agreement variant", "layers": depth,
               "pool": "int8 vs fp paged" if quant
               else "paged vs one-slot contiguous",
               "activations": str(dtype).replace("torch.", ""),
               "swap": swap, "rate": rep.rate, "matched": rep.matched,
               "compared": rep.compared,
               "seconds": time.perf_counter() - t0}
        emit(row)
        out.append(row)
    ops.paged_attention, ops.dequant_matmul = originals["pa"], \
        originals["dm"]
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--layers", type=int, default=40,
                    help="depth of the w8 runs of phases 3 and 6 (40 = the "
                    "full model)")
    ap.add_argument("--layers4", type=int, default=4,
                    help="depth of the w4 main-path run")
    ap.add_argument("--layers7", type=int, default=4,
                    help="depth of the int8-KV continuous run")
    ap.add_argument("--layers8", type=int, default=40,
                    help="depth of the speculative run (w8 verifier, w4 "
                    "drafter)")
    ap.add_argument("--layers9", type=int, default=40,
                    help="depth of the native checkpoint run (9a)")
    ap.add_argument("--layers10", type=int, default=16,
                    help="depth of the MoE run (10a; 16 of moonshot's 48 "
                    "layers fit one 80 GB card in float32 before "
                    "quantization)")
    ap.add_argument("--capture-sync-probe", action="store_true",
                    help="only print what another thread's stream and "
                    "device synchronization do to a CUDA-graph capture "
                    "(phase 9b runs this in a process of its own)")
    ap.add_argument("--agreement-variants", action="store_true",
                    help="only build, then measure phase 6's and 7's "
                    "agreement with one kernel at a time swapped for its "
                    "plain version, and with float32 activations (and "
                    "--profile, if given); prints no ok line")
    ap.add_argument("--profile", action="store_true",
                    help="also trace a few decode steps and admission chunk "
                    "forwards (the paged ones captured and eager), a verify "
                    "forward and a draft chain, and one quantize_tree of "
                    "the tree with torch.profiler and print where their "
                    "time goes")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this script measures the port on a GPU and has no CPU "
              "mode", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    if args.capture_sync_probe:
        emit(capture_sync_probe(dev))
        return 0
    torch.backends.cuda.matmul.allow_tf32 = False     # float32 means float32
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    built = _build.build_all()
    emit({"phase": "1 card and build", "card": card, "python": sys.version.split()[0],
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "build_seconds": built, "nvcc_flags": " ".join(_build.NVCC_FLAGS)})

    if args.agreement_variants:
        agreement_variants(dev, args.seed, args.layers, args.layers7)
        if args.profile:
            profile_decode(dev, args.seed, args.layers)
        return 1

    lengths = [17, 96, 40, 64, 33, 128]       # two rounds of max_batch 4
    max_batch, max_new = 4, 16
    # The reduced-depth w4 run goes first: it also pays the one-time costs
    # (loading the kernels' libraries, cuBLAS and allocator start-up), so the
    # full-depth run's times are the path's own. Both run before phase 2,
    # which times kernel A at the bucket shapes the full-depth tree produced.
    memory = []
    drive(dev, args.seed, args.layers4, 4, lengths, max_batch, max_new,
          "4 main path, granite-3-8b w4")
    phase_memory("4", memory)
    a_n, b_n, buckets, s_n = drive(dev, args.seed, args.layers, 8, lengths,
                                  max_batch, max_new,
                                  "3 main path, granite-3-8b w8")
    phase_memory("3", memory)

    _, b6_n, c_n, path_lengths, _ = drive_continuous(
        dev, args.seed, args.layers,
        "6 main path, continuous + paged + chunked, granite-3-8b w8")
    phase_memory("6", memory)
    _, _, d_n, _, _ = drive_continuous(
        dev, args.seed, args.layers7,
        "7 int8 KV, continuous + paged + chunked, granite-3-8b w8",
        quantize_kv=True)
    phase_memory("7", memory)
    b8_n, c8_n, draft_rows = drive_speculative(dev, args.seed, args.layers8,
                                               profile=args.profile)
    phase_memory("8", memory)
    a9_n, b9_n, c9_n = drive_native_checkpoint(
        dev, args.seed, args.layers9,
        b6_n if args.layers9 == args.layers else None)
    phase_memory("9a", memory)
    t9 = time.perf_counter()
    drive_live_reload(dev, args.seed)
    phase_memory("9 live reload", memory)
    probe = run_capture_sync_probe()
    emit({"phase": "9b a synchronization in another thread during a "
                   "capture (thread_local), in a process of its own",
          "probe": probe, "seconds": time.perf_counter() - t9})
    if not probe.get("stream_sync", {}).get("capture_ok"):
        raise AssertionError(f"a stream synchronization in another thread "
                             f"broke a capture: {probe}")
    drive_clis(dev)
    a10_n, b10_n, c10_n, moe_lengths, moe_entry = drive_moe(
        dev, args.seed, args.layers10, profile=args.profile)
    phase_memory("10", memory)

    from repro_torch.configs import get_config
    moe_cfg = get_config(MOE_ARCH)
    e, layers10 = moe_cfg.moe.n_experts, args.layers10
    banks = moe_expert_shapes(moe_cfg)
    # phase 10's buckets: wi and wg, wdown (expert slices), attention
    moe_buckets = [(2 * layers10 * e, e, moe_cfg.d_model, moe_cfg.d_ff),
                   (layers10 * e, e, moe_cfg.d_ff, moe_cfg.d_model),
                   (4 * layers10, 1, moe_cfg.d_model, moe_cfg.d_model)]
    # the capacity of a monolithic admission of phase 10's longest prompt
    longest = max(moe_entry["prompt_lengths"])
    mono = math.ceil(longest * moe_cfg.moe.top_k
                     * moe_cfg.moe.capacity_factor / e)

    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    ka, ks = check_kernel_a(dev, gen, buckets, moe_buckets)
    # phase 6's decode batch (its slots) first, then the round path's; the
    # prefill rows: phase 6's admission chunk and the round path's prefills
    prefill_rows = [paged_config().prefill_chunk, 2 * 128, 4 * 96]
    kb = check_kernel_b(dev, gen, (paged_config().max_slots, max_batch),
                        prefill_rows, (min(draft_rows), max(draft_rows)),
                        experts={"n_experts": e, "banks": banks,
                                 "rows": [paged_config().max_slots, mono]})
    kc, kd = check_kernels_cd(dev, gen, path_lengths, moe_lengths)
    emit({"phase": "2 kernels vs plain versions", "squant_flip": {
        k: ka[k] for k in ("tie_rule", "max_abs_err", "tolerance")},
        "dequant_matmul": {k: kb[k] for k in ("comparisons", "max_rel_err",
                                              "tolerance")},
        "paged_attention": {k: kc[k] for k in (
            "max_abs_err", "max_abs_err_float32", "tolerance")},
        "paged_attention_quant": {k: kd[k] for k in (
            "max_abs_err", "max_abs_err_float32", "tolerance")}})
    phase_memory("2", memory)
    slice_vs_plain(dev, args.seed)
    phase_memory("5", memory)
    emit({"phase": "device memory allocated after each phase (GB; after "
                   "the phase returned, and after a garbage collection)",
          "phases": memory})
    if args.profile:
        profile_decode(dev, args.seed, args.layers)
        profile_quantize(dev, args.seed, args.layers)

    ka["launches"], kb["launches"], ks["launches"] = a_n, b_n, s_n
    kb["launches_phase6"], kb["launches_phase8"] = b6_n, b8_n
    kc["launches"], kd["launches"] = c_n, d_n
    kc["launches_phase8"] = c8_n
    ka["launches_phase9"] = a9_n
    kb["launches_phase9"], kc["launches_phase9"] = b9_n, c9_n
    ka["launches_phase10"], kb["launches_phase10"] = a10_n, b10_n
    kc["launches_phase10"] = c10_n
    ks["launches_phase10"] = moe_entry["quantize"]["launches"][
        "squant_scale"]
    kb["launches_phase10_by_part"] = moe_entry["launches"][
        "dequant_matmul_by_part"]
    emit({"seconds": time.perf_counter() - t_start})
    print(card, flush=True)
    emit({"kernels": [ka, kb, kc, kd, ks]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
