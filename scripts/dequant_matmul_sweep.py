#!/usr/bin/env python3
"""Cold-L2 device times of kernel B's decode variants (``tcgemv`` under
split plans aimed at 1 or 2 CTAs per SM, and the CUDA-core ``gemv``) at the
decode shapes of granite-3-8b on one GPU, beside ``torch.matmul`` on weights
dequantized to bfloat16 beforehand. Each plan is passed to the wrapper as
its ``plan`` argument. Timing is ``chip_smoke.py``'s: CUDA-graph replay,
cycling through input sets whose reads exceed twice the 50 MB L2.

Run from the repository root on a machine with one CUDA device and nvcc:

    python3 scripts/dequant_matmul_sweep.py [--quick]

``--quick`` times only the wrapper's own plan. Prints one JSON object per
(shape, batch, bits, plan), then the card line.
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


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("dequant_matmul_sweep: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import dequant_matmul as dm

    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    cpsms = [dm.TC_CTAS_PER_SM] if args.quick else CTAS_PER_SM
    for (m, n) in SHAPES:
        for bits, batches in ((8, (4, 8, 16)), (4, (8,))):
            wbytes = m * n // (2 if bits <= 4 else 1)
            n_sets = max(2, min(64, math.ceil(cs.L2_COLD_BYTES / wbytes)))
            sets = cs._b_case(dev, gen, m, n, bits, False, n_sets)
            n_lib = max(2, math.ceil(cs.L2_COLD_BYTES / (2 * m * n)))
            deq = [((dm.unpack_int4(d) if bits <= 4 else d).to(torch.bfloat16)
                    * s.to(torch.bfloat16)) for d, s in
                   (sets[i % len(sets)] for i in range(n_lib))]
            for b in batches:
                x = torch.randn((b, n), generator=gen, device=dev).to(
                    torch.bfloat16)
                want = dm.dequant_matmul_plain(x, *sets[0], bits=bits,
                                               group_size=128).float()
                iters = max(40, 2 * n_sets)
                lib_ms = cs.time_ms([(lambda w=w: torch.matmul(x, w.T))
                                     for w in deq], max(40, 2 * n_lib))
                nbytes = wbytes + m * 4 + b * n * 2 + b * m * 2
                bound = nbytes / cs.HBM_BYTES_PER_S * 1e3
                sms, occ = dm.card_ctas_per_sm(bits, b, 0)
                plans = [(cpsm, ("tcgemv", *dm.split_plan(
                    m, n, 128, sms, min(occ, cpsm)))) for cpsm in cpsms]
                plans.append((None, ("gemv", 1, n // 128)))
                for cpsm, plan in plans:
                    y = dm.dequant_matmul(x, *sets[0], bits=bits,
                                          group_size=128, plan=plan).float()
                    err = float((y - want).abs().max())
                    ok = bool(torch.allclose(y, want, rtol=2e-2, atol=2e-2))
                    ms = cs.time_ms([(lambda d=d, s=s: dm.dequant_matmul(
                        x, d, s, bits=bits, group_size=128, plan=plan))
                        for d, s in sets], iters)
                    print(json.dumps({
                        "m": m, "n": n, "batch": b, "bits": bits,
                        "variant": plan[0], "ctas_per_sm": cpsm,
                        "plan": plan, "input_sets": n_sets, "ms": ms,
                        "library_ms": lib_ms, "bound_ms": bound,
                        "bound_share": bound / ms,
                        "max_abs_err": err, "close_to_plain": ok}),
                        flush=True)
            del sets, deq
            torch.cuda.empty_cache()
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
