#!/usr/bin/env python3
"""Cold-L2 device times of the port's paged decode attention kernels (C:
model-dtype pool, D: int8 pool) on one GPU, under variants of their launch:
the split plan's CTAs per SM (the kernel instance's occupancy as the card
reports it, which the wrappers use, or a fixed number) and its
``MIN_SPLIT_POSITIONS``. Timing is ``chip_smoke.py``'s:
CUDA-graph replay, cycling through input sets whose reads exceed twice the
50 MB L2; SDPA on pre-gathered K/V is timed the same way beside them.

Run from the repository root on a machine with one CUDA device and nvcc:

    python3 scripts/paged_attention_sweep.py

Prints one JSON object per (case, kernel, variant), then the card line.
"""
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

# (CTAs per SM, None: the card's occupancy; MIN_SPLIT_POSITIONS)
VARIANTS = [(None, 32), (1, 32), (2, 32), (4, 32), (8, 32), (None, 16),
            (None, 64)]


def main():
    if not torch.cuda.is_available():
        print("paged_attention_sweep: no CUDA device", file=sys.stderr)
        return 2
    import torch.nn.functional as F

    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import paged_attention_quant as paq

    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    draw = lambda lo, hi, n: torch.randint(  # noqa: E731
        lo, hi, (n,), generator=gen, device=dev).tolist()
    cases = [("path", dict(b=8, kv=8, rep=4, d=128, bs=16, nb=32,
                           lengths=draw(200, 360, 8))),
             ("single", dict(b=1, kv=8, rep=4, d=128, bs=16, nb=32,
                             lengths=[400])),
             ("long", dict(b=8, kv=8, rep=4, d=128, bs=16, nb=256,
                           lengths=draw(1500, 4096, 8)))]
    occupancy_of = pa.card_ctas_per_sm
    min_default = pa.MIN_SPLIT_POSITIONS
    for tag, c in cases:
        for quant in (False, True):
            kern = paq.paged_attention_quant if quant else pa.paged_attention
            plain = paq.paged_attention_quant_plain if quant \
                else pa.paged_attention_plain
            nbytes, _ = cs._paged_bytes_ops(c, quant, 2)
            n_sets = max(2, min(128, math.ceil(cs.L2_COLD_BYTES / nbytes)))
            sets = [cs._paged_inputs(dev, gen, c["b"], c["kv"], c["rep"],
                                     c["d"], c["bs"], c["nb"], c["lengths"],
                                     torch.bfloat16, quant)
                    for _ in range(n_sets)]
            scale = c["d"] ** -0.5
            want = plain(*sets[0], scale=scale).float()
            lib = [cs._sdpa_inputs(a, c, quant, torch.bfloat16)
                   for a in sets]
            lib_ms = cs.time_ms([lambda x=x: F.scaled_dot_product_attention(
                x[0], x[1], x[2], attn_mask=x[3], scale=scale,
                enable_gqa=True) for x in lib], 200)
            del lib
            sms, occ = occupancy_of(quant, True, c["rep"], c["d"], dev.index)
            for ctas, min_pos in VARIANTS:
                n = occ if ctas is None else ctas
                pa.card_ctas_per_sm = lambda *a, n=n: (sms, n)
                pa.MIN_SPLIT_POSITIONS = min_pos
                got = kern(*sets[0], scale=scale).float()
                err = float((got - want).abs().max())
                if not torch.allclose(got, want, rtol=2e-2, atol=2e-2):
                    raise AssertionError(f"{tag} quant={quant} {n} "
                                         f"{min_pos}: err {err}")
                ms = cs.time_ms([lambda a=a: kern(*a, scale=scale)
                                 for a in sets], 200)
                bound = nbytes / cs.HBM_BYTES_PER_S * 1e3
                print(json.dumps({
                    "case": tag, "kernel": "D" if quant else "C",
                    "dtype": "bfloat16", "lengths": c["lengths"],
                    "ctas_per_sm": n, "occupancy": occ,
                    "min_split_positions": min_pos,
                    "split_plan": pa.split_plan(c["b"], c["kv"], c["nb"],
                                                c["bs"], sms, n),
                    "input_sets": n_sets, "ms": ms, "bound_ms": bound,
                    "bound_share": bound / ms, "library_ms": lib_ms,
                    "max_abs_err": err}), flush=True)
            pa.card_ctas_per_sm = occupancy_of
            pa.MIN_SPLIT_POSITIONS = min_default
            del sets
            torch.cuda.empty_cache()
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
