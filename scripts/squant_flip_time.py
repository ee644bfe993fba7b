#!/usr/bin/env python3
"""Device time of kernel A on (in, out) leaves where they are stored, and of
its scale pass, at the buckets of granite-3-8b's full-depth tree (40
layers: (4096, 1024) x 80, (4096, 4096) x 80, (12800, 4096) x 40,
(4096, 12800) x 80), beside the bytes bound; the first leaf of each bucket
held against the plain version (codes within the tie rule, scales bit for
bit).

Run from the repository root on a machine with one CUDA device and nvcc:

    python3 scripts/squant_flip_time.py [--layers 40] [--iters 3]

Prints one JSON object per bucket, the totals per tree, then the card line.
"""
import argparse
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import chip_smoke as cs  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=40)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--stages", action="store_true",
                    help="also time the E and E&K configurations of the "
                    "flip (what the K rounds and the C stage cost)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("squant_flip_time: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.core.dispatch import _scales
    from repro_torch.kernels import squant_flip as sf
    from repro_torch.kernels.ref import explain_code_differences

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    n = args.layers
    buckets = [(2 * n, 4096, 1024), (2 * n, 4096, 4096), (n, 12800, 4096),
               (2 * n, 4096, 12800)]
    kw = dict(bits=8, group_size=128)
    tot = {"ms": 0.0, "bound_ms": 0.0, "scale_ms": 0.0, "scale_bound_ms": 0.0}
    for nb, kin, nch in buckets:
        leaves = [torch.randn((kin, nch), generator=gen, device=dev)
                  for _ in range(nb)]
        s = sf.squant_scales(leaves, 8)
        got = sf.squant_flip_leaves(leaves, s, **kw)
        want = sf.squant_flip_leaves_plain(leaves[:1], s[:1], **kw)[0]
        ties = explain_code_differences(leaves[0].T, s[0][:, None], got[0],
                                        want, **kw)
        if ties["unexplained"] or not torch.equal(
                s[0], _scales(leaves[0].T[None], 8, "max")[0, :, 0]):
            raise AssertionError(f"kernel A or its scales disagree at "
                                 f"{(nb, kin, nch)}: {ties}")
        del got, want
        ms = cs.time_ms([lambda: sf.squant_flip_leaves(leaves, s, **kw)],
                        args.iters)
        s_ms = cs.time_ms([lambda: sf.squant_scales(leaves, 8)], args.iters)
        stages = {}
        if args.stages:
            for tag, ek, ec in (("E", False, False), ("EK", True, False)):
                stages[tag] = cs.time_ms([lambda: sf.squant_flip_leaves(
                    leaves, s, bits=8, group_size=128, enable_k=ek,
                    enable_c=ec)], args.iters)
        bound = nb * (kin * nch * 5 + nch * 4) / cs.HBM_BYTES_PER_S * 1e3
        s_bound = nb * (kin * nch * 4 + nch * 4) / cs.HBM_BYTES_PER_S * 1e3
        cs.emit({"leaves": nb, "in": kin, "out": nch, "ms": ms,
                 "bound_ms": bound, "bound_share": bound / ms,
                 "scale_ms": s_ms, "scale_bound_ms": s_bound,
                 "scale_bound_share": s_bound / s_ms, "tie_rule": ties,
                 **({"ms_by_stages": dict(stages, EKC=ms)} if stages else {})})
        tot["ms"] += ms
        tot["bound_ms"] += bound
        tot["scale_ms"] += s_ms
        tot["scale_bound_ms"] += s_bound
        del leaves, s
        torch.cuda.empty_cache()
    cs.emit({"per_tree": tot, "bound_share": tot["bound_ms"] / tot["ms"],
             "layers": n})
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
