#!/usr/bin/env python3
"""Cold-L2 device times of kernel B's bfloat16 variants at the shapes of
granite-3-8b's linears on one GPU, beside ``torch.matmul`` on weights
dequantized to bfloat16 beforehand (``--float32``: its float32 instances
at seamless-m4t-medium's shapes, below):

* the decode variant ``tcgemv`` at batch 4, 8, 16 (int8) and 8 (int4),
  under split plans aimed at 1 or 2 CTAs per SM, and the CUDA-core ``gemv``;
* the prefill variant ``mma`` at 17, 32, 43, 64, 128, 256 and 384 rows
  (int8; int4 at 64 and 384), under the wrapper's plan (2 CTAs per SM),
  the same aimed at 1 CTA per SM, half the wrapper's splits, and no split
  of K.

The 16-row ``tcgemv`` rows beside the 17-row ``mma`` rows say where the
batch limit between the two (``GEMV_MAX_BATCH``) belongs. Each plan is
passed to the wrapper as its ``plan`` argument. Timing is
``chip_smoke.py``'s: CUDA-graph replay, cycling through input sets whose
reads exceed twice the 50 MB L2.

``--float32``: float32 x at seamless-m4t-medium's (1024, 1024), (4096,
1024) and (1024, 4096) (int8): ``tcgemv32`` at 8 rows under the split
plans aimed at 1 and 2 CTAs per SM, no split, and the CUDA-core ``gemv``;
``mma32`` at 17, 64, 512 and 2 048 rows under the wrapper's plan, 2 and 4
splits, no split, and the CUDA-core ``tiled``; beside ``torch.matmul`` in
float32 (TF32 off) on weights dequantized to float32, and the bound of
three bf16 passes at 989 TFLOP/s.

Run from the repository root on a machine with one CUDA device and nvcc:

    python3 scripts/dequant_matmul_sweep.py [--quick] [--prefill-only]
        [--float32]

``--quick`` times only the wrapper's own plans; ``--prefill-only`` skips
the decode rows. Prints one JSON object per (shape, batch, bits, plan), then
the card line.
"""
import argparse
import json
import math
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import chip_smoke as cs  # noqa: E402

SHAPES = [(1024, 4096), (4096, 4096), (12800, 4096), (4096, 12800)]
CTAS_PER_SM = [1, 2]
DECODE = ((8, (4, 8, 16)), (4, (8,)))
PREFILL = ((8, (17, 32, 43, 64, 128, 256, 384)), (4, (64, 384)))
F32_SHAPES = [(1024, 1024), (4096, 1024), (1024, 4096)]
F32_DECODE = ((8, (8,)),)
F32_PREFILL = ((8, (17, 64, 512, 2048)),)


def plans_for(dm, m, n, b, bits, cpsms, prefill, f32=False):
    """(label, plan) pairs to time at one shape."""
    sfx = "32" if f32 else ""
    units = n // dm.PF_UNIT
    if not prefill:
        sms, occ = dm.card_ctas_per_sm(bits, b, 0, f32)
        out = [(cpsm, ("tcgemv" + sfx, *dm.split_plan(m, n, 128, sms,
                                                      min(occ, cpsm))))
               for cpsm in cpsms]
        if f32:
            out.append(("no split", ("tcgemv32", 1, units)))
        return out + [("gemv", ("gemv", 1, n // 128))]
    sms, occ = dm.card_pf_ctas_per_sm(bits, b, 1, 0, f32)
    out = [(cpsm, ("mma" + sfx, *dm.prefill_plan(b, m, n, None, sms,
                                                 min(occ, cpsm), f32)))
           for cpsm in cpsms]
    if f32:
        for s in (2, 4):
            if units >= 2 * s:
                out.append((f"{s} splits", ("mma32", s, -(-units // s))))
        out.append(("no split", ("mma32", 1, units)))
        return out + [("tiled", ("tiled", 1, units))]
    if len(cpsms) > 1:
        s, p = out[-1][1][1:]
        units = n // dm.PF_UNIT
        if s > 1:
            p2 = -(-units // max(1, s // 2))
            out.append(("half the splits", ("mma", -(-units // p2), p2)))
        out.append(("no split", ("mma", 1, units)))
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--prefill-only", action="store_true")
    ap.add_argument("--float32", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("dequant_matmul_sweep: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import dequant_matmul as dm

    torch.backends.cuda.matmul.allow_tf32 = False     # float32 means float32
    f32 = args.float32
    dt = torch.float32 if f32 else torch.bfloat16
    esz, tol = (4, 1e-4) if f32 else (2, 2e-2)
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    groups = [(False, F32_DECODE if f32 else DECODE),
              (True, F32_PREFILL if f32 else PREFILL)]
    if args.prefill_only:
        groups = groups[1:]
    for (m, n) in (F32_SHAPES if f32 else SHAPES):
        for prefill, per_bits in groups:
            cpsms = [dm.PF_CTAS_PER_SM if prefill else dm.TC_CTAS_PER_SM] \
                if args.quick else CTAS_PER_SM
            for bits, batches in per_bits:
                wbytes = m * n // (2 if bits <= 4 else 1)
                n_sets = max(2, min(64, math.ceil(cs.L2_COLD_BYTES / wbytes)))
                sets = cs._b_case(dev, gen, m, n, bits, False, n_sets)
                n_lib = max(2, math.ceil(cs.L2_COLD_BYTES / (esz * m * n)))
                deq = [((dm.unpack_int4(d) if bits <= 4 else d).to(dt)
                        * s.to(dt)) for d, s in
                       (sets[i % len(sets)] for i in range(n_lib))]
                for b in batches:
                    x = torch.randn((b, n), generator=gen, device=dev).to(dt)
                    want = dm.dequant_matmul_plain(x, *sets[0], bits=bits,
                                                   group_size=128).float()
                    iters = max(40 if b <= 64 else 12, 2 * n_sets)
                    lib_ms = cs.time_ms([(lambda w=w: torch.matmul(x, w.T))
                                         for w in deq], max(iters, 2 * n_lib))
                    nbytes = wbytes + m * 4 + b * n * esz + b * m * esz
                    t_bytes = nbytes / cs.HBM_BYTES_PER_S * 1e3
                    # float32: three bf16 passes on the tensor cores
                    t_ops = (3 if f32 else 1) * 2.0 * b * m * n \
                        / cs.PEAK_FLOPS["bfloat16"] * 1e3
                    bound = max(t_bytes, t_ops)
                    for label, plan in plans_for(dm, m, n, b, bits, cpsms,
                                                 prefill, f32):
                        y = dm.dequant_matmul(x, *sets[0], bits=bits,
                                              group_size=128,
                                              plan=plan).float()
                        err = float((y - want).abs().max())
                        ok = bool(torch.allclose(y, want, rtol=tol,
                                                 atol=tol))
                        ms = cs.time_ms([(lambda d=d, s=s: dm.dequant_matmul(
                            x, d, s, bits=bits, group_size=128, plan=plan))
                            for d, s in sets], iters)
                        print(json.dumps({
                            "m": m, "n": n, "batch": b, "bits": bits,
                            "dtype": str(dt).replace("torch.", ""),
                            "variant": plan[0], "label": label,
                            "plan": plan, "input_sets": n_sets, "ms": ms,
                            "library_ms": lib_ms, "bound_ms": bound,
                            "bound_by": "bytes" if t_bytes >= t_ops
                            else "operations",
                            "bound_share": bound / ms,
                            "max_abs_err": err, "close_to_plain": ok}),
                            flush=True)
                del sets, deq
                torch.cuda.empty_cache()
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
