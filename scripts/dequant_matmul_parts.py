#!/usr/bin/env python3
"""Where kernel B's prefill variant (``pf_kernel``, id ``mma``) spends its
time: cold-L2 device times of the kernel as built, and of copies of
``csrc/dequant_matmul.cu`` with the code widening, the wgmma products, or
both switched off (the copies differ from the source only in a guard
around one call each; their outputs are wrong and not checked, the full
build's is). "neither" is the TMA data movement, the mbarrier ring, the
epilogue and the merge pass alone.

Run from the repository root on a machine with one CUDA device and nvcc:

    python3 scripts/dequant_matmul_parts.py

Builds the four copies under ``build/`` in parallel, then prints one JSON
object per (shape, rows, plan) at the main path's prefill shapes and the
wrapper's plans, then the card line.
"""
import ctypes
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

WIDEN = "    pf_widen<PACKED>(gbase + (cs0 - base) + s * CB,"
MMA = "        wgmma_128(acc[i], pf_desc("
PARTS = {"full": (False, False), "no_widening": (True, False),
         "no_products": (False, True), "neither": (True, True)}
SHAPES = [(1024, 4096), (4096, 4096), (12800, 4096), (4096, 12800)]


def build(name, off_widen, off_mma):
    from repro_torch.kernels import _build
    src = open(os.path.join(_build.CSRC, "dequant_matmul.cu")).read()
    for anchor in (WIDEN, MMA):
        if src.count(anchor) != 1:
            raise RuntimeError(f"anchor not found once in the source: "
                               f"{anchor.strip()}")
    if off_widen:
        src = src.replace(WIDEN, "    if (false) " + WIDEN.lstrip())
    if off_mma:
        src = src.replace(MMA, "        if (false) " + MMA.lstrip())
    d = os.path.join(_build.build_dir(), "parts")
    os.makedirs(d, exist_ok=True)
    cu, so = os.path.join(d, f"{name}.cu"), os.path.join(d, f"lib{name}.so")
    with open(cu, "w") as f:
        f.write(src)
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", so, cu]
    return so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)


def main():
    if not torch.cuda.is_available():
        print("dequant_matmul_parts: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import dequant_matmul as dm

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    procs = {k: build(k, *v) for k, v in PARTS.items()}
    fns = {}
    for k, (so, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {k}:\n{log}")
        fn = ctypes.CDLL(so).dequant_matmul_launch
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 10 + \
            [ctypes.c_void_p]
        fns[k] = fn
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    for m, n in SHAPES:
        n_sets = max(2, min(64, math.ceil(cs.L2_COLD_BYTES / (m * n))))
        sets = cs._b_case(dev, gen, m, n, 8, False, n_sets)
        for b in (64, 256, 384):
            x = torch.randn((b, n), generator=gen, device=dev).to(
                torch.bfloat16)
            sms, occ = dm.card_pf_ctas_per_sm(8, b, 1, 0)
            splits, ups = dm.prefill_plan(b, m, n, None, sms,
                                          min(occ, dm.PF_CTAS_PER_SM))
            y = torch.empty((b, m), dtype=torch.bfloat16, device=dev)
            part = torch.empty((splits, b, m), dtype=torch.float32,
                               device=dev)
            want = dm.dequant_matmul_plain(x, *sets[0], bits=8,
                                           group_size=128).float()
            row = {"m": m, "n": n, "batch": b, "plan": [splits, ups]}
            for k, fn in fns.items():
                def call(d, s, fn=fn):
                    err = fn(x.data_ptr(), d.data_ptr(), s.data_ptr(),
                             y.data_ptr(), part.data_ptr(), b, m, n, 1, 128,
                             0, 1, dm.VARIANTS.index("mma"), splits, ups,
                             torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f"{k}: cuda error {err}")
                if k == "full":
                    call(*sets[0])
                    row["full_close_to_plain"] = bool(torch.allclose(
                        y.float(), want, rtol=2e-2, atol=2e-2))
                row[k + "_ms"] = cs.time_ms(
                    [(lambda d=d, s=s: call(d, s)) for d, s in sets],
                    max(40 if b <= 64 else 12, 2 * n_sets))
            print(json.dumps(row), flush=True)
        del sets
        torch.cuda.empty_cache()
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
