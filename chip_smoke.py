#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (written for an H100).

Run from the repository root with no arguments:

    python3 chip_smoke.py

It needs one CUDA device, ``nvcc`` and nothing from the network. It
1. prints the card's name and power limit, the torch/CUDA versions, and builds
   both CUDA kernels from ``src/repro_torch/kernels/csrc`` (in parallel);
2. holds each kernel against its plain PyTorch version on the card, at the
   shapes the main path uses plus a ragged one, and times kernel, plain
   version, the bound and (for the matmul) one library call;
3. drives the main path at the full width of granite-3-8b: random weights from
   a seed, SQuant w8 quantization of the whole tree, six requests served
   real-quantized through ``ServeEngine`` (round scheduler, contiguous KV
   cache), with the kernels' launch counters read around that run;
4. does the same with 4-bit weights at a reduced depth;
5. runs prefill + 8 decode steps at full width and 2 layers in float32 once
   through the kernels and once through their plain versions and compares
   codes, logits and greedy tokens.
The phases run in the order 1, 4, 3, 2, 5: the short w4 run pays the one-time
start-up costs, and phase 2 times kernel A at the bucket shapes phase 3's tree
produced. The last three lines are the card line, the ``kernels`` line and the
``ok`` line.
Every line it prints is one JSON object, apart from the card line. Any failed
phase raises: the script then exits non-zero and prints no final ``ok`` line.
Depth of phases 3 and 4 can be cut with ``--layers`` / ``--layers4``; widths
are never cut.
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

KERNEL_A = {"name": "squant_flip", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/squant_flip.cu",
            "replaces": "src/repro/kernels/squant_flip.py:66",
            "also_replaces": "src/repro/kernels/squant_flip.py:97"}
KERNEL_B = {"name": "dequant_matmul", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/dequant_matmul.cu",
            "replaces": "src/repro/kernels/dequant_matmul.py:35"}


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


def check_kernel_b(dev, gen, decode_batch, prefill_rows):
    from repro_torch.kernels import dequant_matmul as dm

    layer = [("wq", 4096, 4096), ("wk", 1024, 4096), ("wv", 1024, 4096),
             ("wo", 4096, 4096), ("wi", 12800, 4096), ("wg", 12800, 4096),
             ("wdown", 4096, 12800)]
    mn = sorted({(m, n) for _, m, n in layer})
    worst = {"float32": 0.0, "bfloat16": 0.0}
    worst_rel = {"float32": 0.0, "bfloat16": 0.0}
    n_cmp = 0
    for (m, n) in mn + [(100, 1000)]:
        for b in (1, decode_batch, 8, 512):
            for bits in (8, 4):
                for dt in (torch.float32, torch.bfloat16):
                    for per_group in (False, True):
                        if per_group and n % 128:
                            continue
                        if dt == torch.bfloat16 and per_group and bits == 4:
                            continue          # a subset at bf16
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
                        n_cmp += 1

    def timed(m, n, b, bits, dt):
        copies = max(1, min(8, int(1.5e8 // (m * n * (0.5 if bits <= 4 else 1)))))
        cases = _b_case(dev, gen, m, n, bits, False, copies)
        x = torch.randn((b, n), generator=gen, device=dev).to(dt)
        y = dm.dequant_matmul(x, *cases[0], bits=bits, group_size=128).float()
        r = dm.dequant_matmul_plain(x, *cases[0], bits=bits,
                                    group_size=128).float()
        tol = 1e-4 if dt == torch.float32 else 2e-2
        if not torch.allclose(y, r, rtol=tol,
                              atol=tol * max(float(r.abs().max()), 1.0)):
            raise AssertionError(f"kernel B != plain at the main path's "
                                 f"{(b, m, n, bits)}")
        iters = 40 if b <= 16 else 6
        calls = [(lambda d=d, s=s: dm.dequant_matmul(
            x, d, s, bits=bits, group_size=128)) for d, s in cases]
        ms = time_ms(calls, iters)
        wrapper_ms = time_ms(calls, iters, graph=False)
        plain_ms = time_ms([(lambda d=d, s=s: dm.dequant_matmul_plain(
            x, d, s, bits=bits, group_size=128)) for d, s in cases[:2]], 4,
            graph=False)
        # the library's call for the same function: one matmul on weights
        # dequantized beforehand (timed only; the port never calls it)
        deq = [(dm.unpack_int4(d) if bits <= 4 else d).to(dt) * s.to(dt)
               for d, s in cases[:4]]
        lib_ms = time_ms([(lambda w=w: torch.matmul(x, w.T)) for w in deq],
                         iters)
        name = str(dt).replace("torch.", "")
        esz = 2 if dt == torch.bfloat16 else 4
        nbytes = m * n * (0.5 if bits <= 4 else 1) + m * 4 + b * n * esz + b * m * esz
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = 2.0 * b * m * n / PEAK_FLOPS[name] * 1e3
        return {"m": m, "n": n, "batch": b, "bits": bits, "dtype": name,
                "ms": ms, "eager_call_ms": wrapper_ms, "plain_ms": plain_ms,
                "library_ms": lib_ms, "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations"}

    shapes = []
    tot = {"ms": 0.0, "eager_call_ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
           "library_ms": 0.0}
    per_mn = {}
    for (m, n) in mn:
        per_mn[(m, n)] = timed(m, n, decode_batch, 8, torch.bfloat16)
        shapes.append(per_mn[(m, n)])
    for _, m, n in layer:                 # one decode step of one layer
        for k in tot:
            tot[k] += per_mn[(m, n)][k]
    for (m, n) in mn:                     # the rest of the main path's shapes
        for b in sorted(set(prefill_rows) | {1, 8}):
            shapes.append(timed(m, n, b, 8, torch.bfloat16))
        shapes.append(timed(m, n, decode_batch, 4, torch.bfloat16))
    entry = dict(KERNEL_B, max_abs_err=worst["bfloat16"],
                 max_abs_err_float32=worst["float32"],
                 max_rel_err=worst_rel,
                 tolerance="float32: rtol 1e-4, atol 1e-4*max|ref| (sum order "
                 "over N up to 12800); bfloat16: rtol 2e-2, atol 2e-2*max|ref|",
                 comparisons=n_cmp,
                 numbers_are=f"sums over the seven projections of one layer in "
                 f"one decode step: batch {decode_batch}, bfloat16, int8 codes, "
                 f"per-channel scales",
                 timing="ms, library_ms: device time (CUDA graph replay); "
                 "eager_call_ms: the wrapper called from Python, host cost "
                 "included; plain_ms: eager calls",
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
          "launches": {"squant_flip": a_launches, "dequant_matmul": b_launches},
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
    emit({"phase": "5 slice vs plain versions", "layers": 2,
          "dtype": "float32", "codes_tie_rule": ties,
          "logits_max_abs_err": err, "logits_max_abs": mag,
          "tolerance": f"{tol} * max|logit|", "greedy_tokens_equal": True,
          "tokens": tk})


# ---------------------------------------------------------------------------
# optional: where a decode step's time goes (--profile)
# ---------------------------------------------------------------------------

def profile_decode(dev, seed, layers, batch=4, steps=4):
    """Trace a few decode steps of the w8 main path with ``torch.profiler``
    and print device time by kernel, the device's busy share of the wall
    time, and the number of device kernels per step."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    from repro_torch.serving import ServeConfig, ServeEngine

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
    cache = eng.model.init_cache(batch, 256, device=dev)
    lg, cache = eng.model.prefill(eng.params, {"tokens": prompt}, cache)
    for _ in range(2):                                   # warm
        lg, cache = eng.model.decode_step(eng.params, lg.argmax(-1)[:, None],
                                          cache)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            nxt = lg.argmax(-1)
            nxt.cpu()                                    # the step's host sync
            lg, cache = eng.model.decode_step(eng.params, nxt[:, None], cache)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    t1 = time.perf_counter()
    for _ in range(steps):                               # the same, untraced
        nxt = lg.argmax(-1)
        nxt.cpu()
        lg, cache = eng.model.decode_step(eng.params, nxt[:, None], cache)
    torch.cuda.synchronize()
    untraced_ms = (time.perf_counter() - t1) * 1e3
    rows = []
    dev_us = 0.0
    n_kernels = 0
    from torch.autograd import DeviceType
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
    rows.sort(reverse=True)
    emit({"phase": "profile of decode steps", "layers": layers, "batch": batch,
          "steps": steps, "wall_ms_per_step_traced": wall_ms / steps,
          "wall_ms_per_step_untraced": untraced_ms / steps,
          "device_ms_per_step": dev_us / 1e3 / steps,
          "device_busy_share_of_untraced_wall": dev_us / 1e3 / untraced_ms,
          "device_kernels_per_step": n_kernels / steps,
          "top_device_time": [{"name": n, "ms_per_step": us / 1e3 / steps,
                               "calls_per_step": c / steps}
                              for us, n, c in rows[:12]]})
    eng.close()


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--layers", type=int, default=40,
                    help="depth of the w8 main-path run (40 = the full model)")
    ap.add_argument("--layers4", type=int, default=4,
                    help="depth of the w4 main-path run")
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

    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    ka = check_kernel_a(dev, gen, tree_shapes)
    prefill_rows = [4 * 96, 2 * 128]
    kb = check_kernel_b(dev, gen, max_batch, prefill_rows)
    emit({"phase": "2 kernels vs plain versions", "squant_flip": {
        k: ka[k] for k in ("tie_rule", "max_abs_err", "tolerance")},
        "dequant_matmul": {k: kb[k] for k in ("comparisons", "max_rel_err",
                                              "tolerance")}})
    slice_vs_plain(dev, args.seed)
    if args.profile:
        profile_decode(dev, args.seed, args.layers)

    ka["launches"], kb["launches"] = a_n, b_n
    emit({"seconds": time.perf_counter() - t_start})
    print(card, flush=True)
    emit({"kernels": [ka, kb]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
