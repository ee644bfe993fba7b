#!/usr/bin/env python3
"""Time and trace SQuant w8 quantization of the whole granite-3-8b tree on a
GPU, for one or several copies of the port's package, each run in a process
of its own, in the order given.

Run from the repository root on a machine with one CUDA device and nvcc:

    python3 scripts/quantize_tree_ab.py                       # this checkout
    python3 scripts/quantize_tree_ab.py --src src --src OTHER/src \
        --order 1,0,0,1                                       # OTHER first

Each run builds the tree at full width (``--layers`` deep, random float32
weights from ``--seed``), quantizes it once to warm up (kernel build and
first launches), then ``--repeats`` times through the serving pipeline
(``serving.weights.make_weight_pipeline``, the path ``ServeEngine`` takes),
reading ``quantize_total_ms`` from the report, ``staged_ms`` (quantize plus
the device sync, host clock), kernel A's launches and the peak device memory
above the weights, then traces one more with ``torch.profiler`` and prints
device time by kernel and by part (kernel A, the scale pass, stack copies,
abs, amax, the rest) with the device's busy time (the union of kernel
intervals). One JSON line per run, then the card line.
"""
import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# kernel-name fragments -> part of the quantize pass they belong to
PARTS = (("kernel_a", ("squant_flip",)),
         ("scale_pass", ("squant_scale",)),
         ("stack_copy", ("CatArrayBatchedCopy",)),
         ("abs", ("AbsFunctor", "abs_kernel")),
         ("amax", ("reduce_kernel",)))


def part_of(name):
    for part, frags in PARTS:
        if any(f in name for f in frags):
            return part
    return "other"


def trace(fn):
    """Device time by kernel name and by part, device busy (union of kernel
    intervals) and the wall of one ``fn()`` call ending in a device sync."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        # one tiny kernel first: a trace has been seen to miss the first
        # kernel launched in its window
        torch.empty(1, device="cuda").zero_()
        fn()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    rows, by_part, n = [], {p: 0.0 for p, _ in PARTS}, 0
    by_part["other"] = 0.0
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", 0.0) or 0.0
        if us <= 0:
            continue
        rows.append((us, e.key[:90], e.count))
        by_part[part_of(e.key)] += us / 1e3
        n += e.count
    rows.sort(reverse=True)
    busy_us, end = 0.0, None
    for a, b in sorted((e.time_range.start, e.time_range.end)
                       for e in prof.events()
                       if getattr(e, "device_type", None) == DeviceType.CUDA):
        if end is None or a > end:
            busy_us, end = busy_us + b - a, b
        elif b > end:
            busy_us, end = busy_us + b - end, b
    return {"wall_ms_traced": wall_ms,
            "device_ms": sum(r[0] for r in rows) / 1e3,
            "device_busy_ms": busy_us / 1e3, "device_kernels": n,
            "device_ms_by_part": by_part,
            "top_device_time": [{"name": k, "ms": us / 1e3, "calls": c}
                                for us, k, c in rows[:16]]}


def child(src, layers, seed, repeats, do_trace):
    sys.path.insert(0, os.path.abspath(src))
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import squant_flip as sf
    from repro_torch.models.model import build_model
    from repro_torch.serving import ServeConfig
    from repro_torch.serving.weights import make_weight_pipeline

    dev = torch.device("cuda", 0)
    cfg = dataclasses.replace(get_config("granite-3-8b"), n_layers=layers)
    model = build_model(cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    params = model.init(gen, device=dev)
    torch.cuda.synchronize()
    _, quantize_fn, _ = make_weight_pipeline(model, ServeConfig(
        quantize_weights="squant", weight_bits=8,
        dequantize_for_compute=False), device=dev)

    def staged():
        t0 = time.perf_counter()
        tree, rep = quantize_fn(params)
        torch.cuda.synchronize()
        return tree, rep, (time.perf_counter() - t0) * 1e3

    tree, rep, warm_ms = staged()
    del tree
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    runs = []
    for _ in range(repeats):
        torch.cuda.reset_peak_memory_stats()
        n0 = sf.launches
        tree, rep, ms = staged()
        runs.append({"quantize_total_ms": rep.total_millis,
                     "dispatch_ms": rep.dispatch_millis,
                     "sync_ms": rep.sync_millis, "staged_ms": ms,
                     "kernel_a_launches": sf.launches - n0,
                     "bucket_ms": [b.dispatch_millis for b in rep.buckets],
                     "peak_gb_above_weights":
                         (torch.cuda.max_memory_allocated() - base) / 1e9})
        del tree
        torch.cuda.empty_cache()
    out = {"src": src, "layers": layers, "warm_staged_ms": warm_ms,
           "weights_gb": base / 1e9, "runs": runs,
           "buckets": [(b.key, getattr(b, "route", "stacked"))
                       for b in rep.buckets]}
    if do_trace:
        out["trace"] = trace(lambda: quantize_fn(params))
    print(json.dumps(out), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", action="append", default=None,
                    help="a package root holding repro_torch (repeatable; "
                    "default: this checkout's src)")
    ap.add_argument("--order", default=None,
                    help="comma-separated indices into --src, the runs in "
                    "turn (default: each once)")
    ap.add_argument("--layers", type=int, default=40)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--no-trace", action="store_true")
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child is not None:
        child(args.child, args.layers, args.seed, args.repeats,
              not args.no_trace)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("quantize_tree_ab: no CUDA device", file=sys.stderr)
        return 2
    srcs = args.src or [os.path.join(ROOT, "src")]
    order = [int(i) for i in args.order.split(",")] if args.order \
        else list(range(len(srcs)))
    for i in order:
        cmd = [sys.executable, os.path.abspath(__file__), "--child", srcs[i],
               "--layers", str(args.layers), "--seed", str(args.seed),
               "--repeats", str(args.repeats)]
        if args.no_trace:
            cmd.append("--no-trace")
        r = subprocess.run(cmd)
        if r.returncode != 0:
            return r.returncode
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
