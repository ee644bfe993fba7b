#!/usr/bin/env python3
"""Where ``quant.apply.quantize_params_serving``'s time goes on the card.

Builds granite-3-8b's fp tree (``--layers``, full width, random weights
from ``--seed``) on the CUDA device and quantizes it into the w8 serving
format three times: into an allocator whose cache holds no free blocks of
the codes' sizes (``torch.cuda.empty_cache()`` first), again after freeing
that tree (its blocks cached), and once more under ``torch.profiler``.
Prints one JSON object: the three wall times, and from the profile the
host time of the CUDA runtime calls and torch ops by name and the device
time of the kernels by name. Run from the repository root:

    python3 scripts/quant_apply_time.py [--layers 40]
"""
import argparse
import dataclasses
import json
import os
import sys
import time

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))


def main():
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    from repro_torch.quant import apply

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=40)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    cfg = dataclasses.replace(get_config("granite-3-8b"),
                              n_layers=args.layers)
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    params = build_model(cfg).init(gen, device=dev)
    warm = {"p": {"w": params["stack"]["list"][0]["b0"]["attn"]["wq"]["w"]}}
    apply.quantize_params_serving(warm, 8)          # loads the kernel
    out = {"device": torch.cuda.get_device_name(0), "layers": args.layers}

    def timed():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tree, meta = apply.quantize_params_serving(params, 8)
        return tree, (time.perf_counter() - t0) * 1e3, meta["quantize_ms"]

    torch.cuda.empty_cache()
    tree, out["empty_cache_ms"], _ = timed()
    del tree                                   # its blocks stay cached
    tree, out["cached_blocks_ms"], _ = timed()
    del tree
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        tree, out["profiled_ms"], _ = timed()
    host, device = {}, {}
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            device[ev.key] = ev.device_time_total / 1e3
        else:
            host[ev.key] = ev.self_cpu_time_total / 1e3
    out["host_ms_top"] = dict(sorted(host.items(), key=lambda kv: -kv[1])[:12])
    out["device_ms_top"] = dict(sorted(device.items(),
                                       key=lambda kv: -kv[1])[:8])
    out["device_ms_total"] = sum(device.values())
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
