#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (written for an H100).

Run from the repository root with no arguments:

    python3 chip_smoke.py

It needs one CUDA device, ``nvcc`` and nothing from the network. It
1. prints the card's name and power limit, the torch/CUDA versions, and builds
   the three CUDA sources of ``src/repro_torch/kernels/csrc`` (in parallel);
2. holds each kernel against its plain PyTorch version on the card, at the
   shapes the main paths use plus a ragged one (kernels C and D also at one
   slot and at long contexts), and times kernel, plain version, the bound
   and one library call (B, C, D and their yardsticks with a cold L2);
3. drives the round-scheduler path at the full width of granite-3-8b: random
   weights from a seed, SQuant w8 quantization of the whole tree, six
   requests served real-quantized through ``ServeEngine`` (round scheduler,
   contiguous KV cache), with the kernels' launch counters read around it;
4. does the same with 4-bit weights at a reduced depth;
5. runs prefill + 8 decode steps at full width and 2 layers in float32 (and
   again in bfloat16, teacher-forced, with kernel B's launches by variant
   checked), and the paged continuous path at 2 layers, once through the
   kernels and once through their plain versions, and compares codes,
   logits and tokens;
6. drives this slice's main path at full width and full depth: SQuant w8,
   the continuous scheduler on the paged KV cache with chunked admission,
   twelve chat requests sharing a 192-token system prefix (prefix hits,
   copy-on-write, mid-flight admission, retirement), launch counters read
   around the run, the block pool checked after it, and teacher-forced
   greedy agreement against the contiguous continuous engine;
7. does the same traffic with the int8 KV pool at a reduced depth, held to
   the reference's ``int8_kv`` agreement budget against the fp paged pool.
The phases run in the order 1, 4, 3, 6, 7, 2, 5: the short w4 run pays the
one-time start-up costs, and phase 2 times the kernels at the shapes phases
3 and 6 produced. The last three lines are the card line, the ``kernels``
line and the ``ok`` line.
Every line it prints is one JSON object, apart from the card line. Any failed
phase raises: the script then exits non-zero and prints no final ``ok`` line.
Depth can be cut with ``--layers`` (phases 3 and 6), ``--layers4`` (phase 4)
and ``--layers7`` (phase 7); widths are never cut.
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

def check_kernel_a(dev, gen, tree_shapes):
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

    # timing at the (rows, N) of every launch quantize_tree makes on the tree
    shapes = []
    tot = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
    for (rows, n), count in sorted(tree_shapes.items()):
        w = torch.randn((rows, n), generator=gen, device=dev)
        s = compute_scale(w, 8, "max")
        kw = dict(bits=8, group_size=128)
        res = explain_code_differences(w, s, sf.squant_flip(w, s, **kw),
                                       sf.squant_flip_plain(w, s, **kw), **kw)
        for k in ties:
            ties[k] += res[k]
        if res["unexplained"]:
            raise AssertionError(f"kernel A differs from plain beyond the tie "
                                 f"rule at the main path's {(rows, n)}: {res}")
        ms = time_ms([lambda: sf.squant_flip(w, s, **kw)], 5)
        plain_ms = time_ms([lambda: sf.squant_flip_plain(w, s, **kw)], 1,
                           graph=False)
        nbytes = rows * n * 4 + rows * 4 + rows * n
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = A_OPS_PER_ELEMENT * rows * n / PEAK_FLOPS["float32"] * 1e3
        bound = max(t_bytes, t_ops)
        shapes.append({"rows": rows, "n": n, "launches_per_tree": count,
                       "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                       "bound_by": "bytes" if t_bytes >= t_ops else "operations"})
        tot["ms"] += count * ms
        tot["plain_ms"] += count * plain_ms
        tot["bound_ms"] += count * bound
        del w, s
        torch.cuda.empty_cache()
    entry = dict(KERNEL_A, max_abs_err=worst, tolerance="codes equal; rows that "
                 "differ must be explained by a float32 tie (1e-4) and keep "
                 "the paper's invariants", tie_rule=ties,
                 numbers_are="sums over every launch of one quantize_tree of "
                 "the main path's model", timing="ms: device time (CUDA graph "
                 "replay); plain_ms: eager calls", library_ms=None,
                 bound_by="bytes", shapes=shapes, **tot)
    return entry


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


def check_kernel_b(dev, gen, decode_batches, prefill_rows):
    """Kernel B against its plain version at the main paths' shapes and a
    ragged one, every variant and dtype; two launches bit-identical at the
    decode shapes; then times at the seven projections' shapes, bfloat16,
    int8, per-channel scales: the decode batches (the first, phase 6's, is
    the headline sum over one layer), the prefill rows, and 4-bit codes at
    the first decode batch. Kernel and ``torch.matmul`` yardstick alike are
    timed by CUDA-graph replay with a cold L2: the calls cycle through input
    sets whose reads exceed twice the L2."""
    from repro_torch.kernels import dequant_matmul as dm

    launches_before = dict(dm.launches_by_variant), dm.launches
    layer = [("wq", 4096, 4096), ("wk", 1024, 4096), ("wv", 1024, 4096),
             ("wo", 4096, 4096), ("wi", 12800, 4096), ("wg", 12800, 4096),
             ("wdown", 4096, 12800)]
    mn = sorted({(m, n) for _, m, n in layer})
    worst = {"float32": 0.0, "bfloat16": 0.0}
    worst_rel = {"float32": 0.0, "bfloat16": 0.0}
    n_cmp = 0
    for (m, n) in mn + [(100, 1000)]:
        for b in sorted({1, 8, 16, 512} | set(decode_batches)):
            for bits in (8, 4):
                for dt in (torch.float32, torch.bfloat16):
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
                        if b <= dm.GEMV_MAX_BATCH and not torch.equal(
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
        var, splits, _ = dm.launch_plan(x, cases[0][0], m, 1, 128, bits)
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
                "variant": var, "splits": splits, "input_sets": n_sets,
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
            shapes.append(timed(m, n, b, 8, torch.bfloat16))
        shapes.append(timed(m, n, head, 4, torch.bfloat16))
        torch.cuda.empty_cache()
    # comparisons and timings are not the path's launches
    dm.launches_by_variant, dm.launches = launches_before
    entry = dict(KERNEL_B, max_abs_err=worst["bfloat16"],
                 max_abs_err_float32=worst["float32"],
                 max_rel_err=worst_rel,
                 tolerance="float32: rtol 1e-4, atol 1e-4*max|ref| (sum order "
                 "over N up to 12800); bfloat16: rtol 2e-2, atol 2e-2*max|ref|;"
                 " two launches at batch <= 16: output bits equal",
                 comparisons=n_cmp,
                 numbers_are=f"sums over the seven projections of one layer in "
                 f"one decode step: batch {head}, bfloat16, int8 codes, "
                 f"per-channel scales",
                 timing="ms, library_ms: device time (CUDA graph replay) with "
                 "a cold L2: the calls cycle through input sets whose reads "
                 "exceed twice the L2; eager_call_ms: the wrapper called from "
                 "Python, host cost included; host_ms, library_host_ms: host "
                 "time to issue one call (perf_counter, no sync); plain_ms: "
                 "eager calls",
                 bound_share=tot["bound_ms"] / tot["ms"],
                 bound_by="bytes", shapes=shapes, **tot)
    return entry


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

    sf.launches = 0
    dm.launches = 0
    dm.launches_by_variant = dict.fromkeys(dm.VARIANTS, 0)
    eng = ServeEngine(model, params, ServeConfig(
        max_batch=max_batch, max_len=256, quantize_weights="squant",
        weight_bits=bits, dequantize_for_compute=False), device=dev)
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
    want_a = len(rep.buckets)
    want_b = 7 * layers * forwards
    if not all("g128" in b.key for b in rep.buckets):
        raise AssertionError("a bucket of the full-width tree is not grouped")
    if a_launches != want_a or a_launches == 0:
        raise AssertionError(f"kernel A launches {a_launches}, path implies {want_a}")
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
    tree_shapes = {}
    for b in rep.buckets:                   # "(M,N)xB dtype gG"
        mn, rest = b.key.split(")x")
        m, n = (int(v) for v in mn[1:].split(","))
        rows = m * int(rest.split(" ")[0])
        tree_shapes[(rows, n)] = tree_shapes.get((rows, n), 0) + 1
    emit({"phase": phase, "model": cfg.name, "layers": layers,
          "full_depth": layers == full.n_layers, "d_model": cfg.d_model,
          "d_ff": cfg.d_ff, "vocab": cfg.vocab, "weight_bits": bits,
          "activation_dtype": cfg.dtype, "dense_weight_dtype": "float32",
          "init_ms": init_ms, "quant_report": rep.summary(),
          "quantize_total_ms": rep.total_millis,
          "quantize_dispatch_ms": rep.dispatch_millis,
          "quantize_sync_ms": rep.sync_millis,
          "staged_ms": eng.store.current.staged_ms,
          "rounds": rounds, "tokens": [o.tokens for o in outs],
          "launches": {"squant_flip": a_launches, "dequant_matmul": b_launches,
                       "dequant_matmul_by_variant": dict(
                           dm.launches_by_variant)},
          "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9})
    eng.close()
    del eng, outs, cache, lg
    torch.cuda.empty_cache()
    return a_launches, b_launches, tree_shapes


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


def check_kernels_cd(dev, gen, path_lengths):
    """Kernels C and D against their plain versions at the main path's
    shape (B=8, H=32, KV=8, D=128, bs=16, nb=32, the per-slot lengths of a
    step of phase 6), at a ragged shape (rep=1, D=64, lengths {0, bs-1, bs,
    full}), at one slot (``single``: B=1, length 400, where the split
    matters most) and at long contexts (``long``: nb=256, lengths drawn
    from 1500-4095), in bfloat16 and float32, with tails at the trash block
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
            bound_by=head["bound_by"], shapes=shapes)
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

    def __call__(self, *args):
        self.calls += 1
        out = self.fn(*args)
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


def measure_agreement(dev, model, tree, reqs, quantize_kv, dtype):
    """Teacher-forced greedy agreement of the paged chunked engine (phase 6's
    serve config, ``quantize_kv`` as given) against its oracle on the same
    quantized tree, with activations in ``dtype``: the fp paged pool for an
    int8 pool, else the contiguous continuous engine without chunking and
    with ONE slot — a contiguous pool left-pads every prompt to the shared
    clock and the pad tokens are attended (the reference's semantics), so
    only a one-slot run sees the paged slots' context (positions 0..L-1).
    Returns the report and the oracle's seconds."""
    from repro_torch.models.model import build_model
    from repro_torch.serving import ServeEngine, WeightStore
    from repro_torch.serving.equivalence import (greedy_token_agreement,
                                                 oracle_tokens)

    name = str(dtype).replace("torch.", "")
    m = build_model(dataclasses.replace(model.cfg, dtype=name))
    store = WeightStore(serving_params=_retyped(tree, dtype), device=dev)
    ocfg = paged_config() if quantize_kv else paged_config(
        kv_backend="contiguous", prefill_chunk=0, max_slots=1)
    t0 = time.perf_counter()
    oracle = oracle_tokens(ServeEngine(m, None, ocfg, store=store,
                                       device=dev).generate(reqs))
    torch.cuda.synchronize()
    oracle_s = time.perf_counter() - t0
    rep = greedy_token_agreement(
        ServeEngine(m, None, paged_config(quantize_kv=quantize_kv),
                    store=store, device=dev), reqs, oracle)
    return rep, oracle_s


def drive_continuous(dev, seed, layers, phase, quantize_kv=False):
    """The continuous + paged + chunked path on granite-3-8b w8: one counted
    run through ``ServeEngine.generate`` (the main path), then the agreement
    check against its oracle engine, which shares the quantized tree."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import dequant_matmul as dm
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import paged_attention_quant as paq
    from repro_torch.kernels import squant_flip as sf
    from repro_torch.models.model import build_model
    from repro_torch.serving import ServeEngine
    from repro_torch.serving.equivalence import AGREEMENT_BUDGETS

    cfg = dataclasses.replace(get_config("granite-3-8b"), n_layers=layers)
    model = build_model(cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    params = model.init(gen, device=dev)
    reqs = chat_requests(seed, cfg.vocab)
    kernel_mod = paq if quantize_kv else pa

    sf.launches = dm.launches = pa.launches = paq.launches = 0
    eng = ServeEngine(model, params, paged_config(quantize_kv=quantize_kv),
                      device=dev)
    del params
    torch.cuda.empty_cache()
    a_launches = sf.launches
    kv = eng.scheduler.kv
    dec = eng._decode = _Counted(eng._decode,
                                 lambda a, o: kv._lengths.copy().tolist())
    chk = eng._prefill_chunk = _Counted(eng._prefill_chunk)
    pre = eng._prefill = _Counted(eng._prefill)
    torch.cuda.reset_peak_memory_stats()
    sf.launches = dm.launches = pa.launches = paq.launches = 0
    dm.launches_by_variant = dict.fromkeys(dm.VARIANTS, 0)
    t0 = time.perf_counter()
    outs = eng.generate(reqs)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    b_launches, k_launches = dm.launches, kernel_mod.launches
    b_by_variant = dict(dm.launches_by_variant)
    other = (pa if quantize_kv else paq).launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    st = eng.stats()["scheduler"]
    forwards = dec.calls + chk.calls + pre.calls
    if chk.calls != st.chunk_steps or pre.calls != 0:
        raise AssertionError(f"chunk forwards {chk.calls} vs stats "
                             f"{st.chunk_steps}, monolithic {pre.calls}")
    if b_launches != 7 * layers * forwards or b_launches == 0:
        raise AssertionError(f"kernel B launches {b_launches}, path implies "
                             f"{7 * layers * forwards}")
    # every decode linear (bfloat16, batch <= 16) goes through tcgemv: no
    # launch took gemv or tiled, and only the rule's batch <= 16 reaches
    # tcgemv or gemv (chunks of up to 16 rows count there too)
    if b_by_variant["gemv"] or b_by_variant["tiled"] or \
            b_by_variant["tcgemv"] < 7 * layers * dec.calls:
        raise AssertionError(f"kernel B by variant {b_by_variant}: not every "
                             f"one of the {7 * layers * dec.calls} decode "
                             f"linears went through tcgemv")
    if k_launches != layers * dec.calls or k_launches == 0 or other:
        raise AssertionError(f"{kernel_mod.__name__} launches {k_launches} "
                             f"(other paged kernel {other}), path implies "
                             f"{layers * dec.calls}")
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

    # agreement, measured with bfloat16 activations (the main path's) and
    # with float32 activations on the same quantized tree; the budget is
    # held in float32, where the random model's near-tied logits are not
    # flipped by bfloat16 rounding (PERF.md, ROADMAP "Faults")
    label = "int8 KV vs fp paged pool" if quantize_kv else \
        "paged vs contiguous (one slot)"
    budget = AGREEMENT_BUDGETS["int8_kv"] if quantize_kv else 0.98
    rep16, oracle_s = measure_agreement(dev, model, eng.params, reqs,
                                        quantize_kv, torch.bfloat16)
    rep, oracle32_s = measure_agreement(dev, model, eng.params, reqs,
                                        quantize_kv, torch.float32)
    entry = {"phase": phase, "model": cfg.name, "layers": layers,
             "full_depth": layers == get_config("granite-3-8b").n_layers,
             "weight_bits": 8, "quantize_kv": quantize_kv,
             "serve_config": {k: getattr(eng.cfg, k) for k in (
                 "scheduler", "kv_backend", "max_slots", "max_len",
                 "block_size", "prefill_chunk")},
             "requests": len(reqs),
             "prompt_lengths": [len(r.prompt) for r in reqs],
             "max_new_tokens": reqs[0].max_new_tokens,
             "run_s": run_s, "oracle_run_s_bfloat16": oracle_s,
             "oracle_run_s_float32": oracle32_s,
             "sampling_steps": st.steps, "decode_forwards": dec.calls,
             "chunk_forwards": chk.calls,
             "step_ms": st.step_ms,
             "prefill_ms_per_admission": [o.prefill_ms for o in outs],
             "kv": kst, "peak_memory_gb": peak_gb,
             "launches": {"squant_flip": a_launches,
                          "dequant_matmul": b_launches,
                          "dequant_matmul_by_variant": b_by_variant,
                          kernel_mod.__name__.split(".")[-1]: k_launches},
             "agreement": {"against": label, "budget": budget,
                           "gated": "float32 activations",
                           "rate": rep.rate, "matched": rep.matched,
                           "compared": rep.compared,
                           "rate_bfloat16": rep16.rate,
                           "matched_bfloat16": rep16.matched},
             "tokens": [o.tokens for o in outs]}
    emit(entry)
    if rep.rate < budget:
        raise AssertionError(f"{label}: teacher-forced greedy agreement "
                             f"{rep.rate:.4f} < {budget}")
    lengths = max(dec.log, key=sum)        # the step with the most context
    eng.close()
    del eng, outs
    torch.cuda.empty_cache()
    return a_launches, b_launches, k_launches, lengths


def paged_vs_plain(dev, seed):
    """The paged continuous path at 2 layers in float32, once through the
    kernels and once under ``force_backend("ref")``, on one quantized tree:
    greedy tokens equal, logits within 1e-3 of the largest."""
    from repro_torch.configs import get_config
    from repro_torch.core.pipeline import quantize_tree
    from repro_torch.kernels import ops
    from repro_torch.models.model import build_model
    from repro_torch.serving import ServeEngine, WeightStore

    cfg = dataclasses.replace(get_config("granite-3-8b"), n_layers=2,
                              dtype="float32")
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

        eng._decode = _Counted(eng._decode, keep)
        eng._prefill_chunk = _Counted(eng._prefill_chunk,
                                      lambda a, o: o[0].float().cpu())
        outs = eng.generate(reqs)
        return ([o.tokens for o in outs], torch.cat(eng._decode.log),
                torch.cat([x[None] for x in eng._prefill_chunk.log]))

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
# optional: where a decode step's time goes (--profile)
# ---------------------------------------------------------------------------

def _profile_steps(step, steps, phase, extra):
    """Trace ``steps`` calls of ``step()`` (after two warm ones) with
    ``torch.profiler`` and print device time by kernel (summed over
    kernels), the device's busy time (the union of the kernels' intervals)
    and its share of the untraced wall time, the number of device kernels
    per step, and the device time split into kernel C, kernel B,
    host-to-device copies and everything else."""
    from torch.autograd import DeviceType
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
    rows = []
    dev_us = 0.0
    n_kernels = 0
    split = {"paged_attention": 0.0, "dequant_matmul": 0.0,
             "host_to_device_copies": 0.0, "other": 0.0}
    for e in prof.key_averages():
        # device-side events only: the host-side op rows carry the time of
        # the kernels they launched as well and would count it twice
        if getattr(e, "device_type", None) != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", 0.0) or 0.0
        if us > 0:
            dev_us += us
            n_kernels += e.count
            rows.append((us, e.key[:70], e.count))
            k = e.key
            if "paged_decode_" in k:        # split pass and merge pass
                split["paged_attention"] += us
            elif any(n in k for n in ("tcgemv_", "gemv_kernel",
                                      "mma_kernel", "tiled_kernel")):
                split["dequant_matmul"] += us
            elif "HtoD" in k:
                split["host_to_device_copies"] += us
            else:
                split["other"] += us
    rows.sort(reverse=True)
    # the union of the device intervals: a merge pass (kernels B and C)
    # launched as a programmatic dependent starts while the pass before it
    # runs, and the sum over kernels counts that overlap twice
    busy_us, end = 0.0, None
    for t0_, t1_ in sorted(
            (e.time_range.start, e.time_range.end) for e in prof.events()
            if getattr(e, "device_type", None) == DeviceType.CUDA):
        if end is None or t0_ > end:
            busy_us += t1_ - t0_
            end = t1_
        elif t1_ > end:
            busy_us += t1_ - end
            end = t1_
    emit({"phase": phase, **extra,
          "steps": steps, "wall_ms_per_step_traced": wall_ms / steps,
          "wall_ms_per_step_untraced": untraced_ms / steps,
          "device_ms_per_step": dev_us / 1e3 / steps,
          "device_busy_ms_per_step": busy_us / 1e3 / steps,
          "device_busy_share_of_untraced_wall": busy_us / 1e3 / untraced_ms,
          "device_kernels_per_step": n_kernels / steps,
          "device_ms_per_step_by_part": {k: v / 1e3 / steps
                                         for k, v in split.items()},
          "top_device_time": [{"name": n, "ms_per_step": us / 1e3 / steps,
                               "calls_per_step": c / steps}
                              for us, n, c in rows[:12]]})


def profile_decode(dev, seed, layers, batch=4, steps=4):
    """Where a decode step's time goes, round path and paged continuous
    path (``--profile``)."""
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
    # the block pool, then the scheduler's decode step (table push included)
    peng = ServeEngine(model, None, paged_config(),
                       store=WeightStore(serving_params=eng.params,
                                         device=dev), device=dev)
    kv = peng.scheduler.kv
    reqs = chat_requests(seed, cfg.vocab)[:8]
    kv.admit([(i, r) for i, r in enumerate(reqs)], list(range(8)), None,
             peng.params)
    slots = list(range(8))

    def paged_step():
        nxt = kv.logits.argmax(-1).to(torch.int32)
        nxt.cpu()                                        # the step's host sync
        kv.decode(peng.params, nxt, slots)

    _profile_steps(paged_step, steps,
                   "profile of decode steps, paged continuous path",
                   {"layers": layers, "batch": 8,
                    "context_lengths": kv._lengths.tolist()})
    eng.close()
    peng.close()


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
        rep, _ = measure_agreement(dev, model, tree, reqs, quant, dtype)
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
    ap.add_argument("--agreement-variants", action="store_true",
                    help="only build, then measure phase 6's and 7's "
                    "agreement with one kernel at a time swapped for its "
                    "plain version, and with float32 activations (and "
                    "--profile, if given); prints no ok line")
    ap.add_argument("--profile", action="store_true",
                    help="also trace a few decode steps with torch.profiler "
                    "and print where their time goes")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this script measures the port on a GPU and has no CPU "
              "mode", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
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
    drive(dev, args.seed, args.layers4, 4, lengths, max_batch, max_new,
          "4 main path, granite-3-8b w4")
    a_n, b_n, tree_shapes = drive(dev, args.seed, args.layers, 8, lengths,
                                  max_batch, max_new,
                                  "3 main path, granite-3-8b w8")

    _, b6_n, c_n, path_lengths = drive_continuous(
        dev, args.seed, args.layers,
        "6 main path, continuous + paged + chunked, granite-3-8b w8")
    _, _, d_n, _ = drive_continuous(
        dev, args.seed, args.layers7,
        "7 int8 KV, continuous + paged + chunked, granite-3-8b w8",
        quantize_kv=True)

    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    ka = check_kernel_a(dev, gen, tree_shapes)
    # phase 6's decode batch (its slots) first, then the round path's; the
    # prefill rows: phase 6's admission chunk and the round path's prefills
    prefill_rows = [paged_config().prefill_chunk, 2 * 128, 4 * 96]
    kb = check_kernel_b(dev, gen, (paged_config().max_slots, max_batch),
                        prefill_rows)
    kc, kd = check_kernels_cd(dev, gen, path_lengths)
    emit({"phase": "2 kernels vs plain versions", "squant_flip": {
        k: ka[k] for k in ("tie_rule", "max_abs_err", "tolerance")},
        "dequant_matmul": {k: kb[k] for k in ("comparisons", "max_rel_err",
                                              "tolerance")},
        "paged_attention": {k: kc[k] for k in (
            "max_abs_err", "max_abs_err_float32", "tolerance")},
        "paged_attention_quant": {k: kd[k] for k in (
            "max_abs_err", "max_abs_err_float32", "tolerance")}})
    slice_vs_plain(dev, args.seed)
    if args.profile:
        profile_decode(dev, args.seed, args.layers)

    ka["launches"], kb["launches"] = a_n, b_n
    kb["launches_phase6"] = b6_n
    kc["launches"], kd["launches"] = c_n, d_n
    emit({"seconds": time.perf_counter() - t_start})
    print(card, flush=True)
    emit({"kernels": [ka, kb, kc, kd]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
