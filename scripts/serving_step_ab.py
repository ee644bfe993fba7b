#!/usr/bin/env python3
"""Profile the paged serving step of one or several copies of the port's
package on a GPU, each run in a process of its own, in the order given: the
scheduler's decode step at 8 slots and one 64-row admission chunk forward,
at the full width of granite-3-8b (``--layers`` deep, SQuant w8, random
weights from ``--seed``), in ``chip_smoke.py``'s paged configuration and
traffic.

Run from the repository root on a machine with one CUDA device and nvcc:

    python3 scripts/serving_step_ab.py                        # this checkout
    python3 scripts/serving_step_ab.py --src src --src OTHER/src \
        --order 1,0,0,1                                       # OTHER first

A package whose ``ServeEngine`` takes ``capture`` is run captured and then
eagerly (``capture=False``); an older one only as it runs. Each step is
issued as the scheduler issues it: the decode through
``PagedKVCache.decode`` (host tables pushed every step), the chunk with its
tokens copied from the host, then a host sync. For each, one JSON line from
``chip_smoke._profile_steps``: untraced wall per step, device busy time
(the union of kernel intervals) and device time by part. Then the card
line.
"""
import argparse
import dataclasses
import inspect
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def child(src, layers, seed, steps):
    sys.path.insert(0, ROOT)
    import chip_smoke as cs          # helpers; imports no repro_torch yet
    sys.path.insert(0, os.path.abspath(src))
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.models.model import build_model
    from repro_torch.serving import ServeEngine, WeightStore

    _build.build_all()
    dev = torch.device("cuda", 0)
    cfg = dataclasses.replace(get_config("granite-3-8b"), n_layers=layers)
    model = build_model(cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    params = model.init(gen, device=dev)
    can_capture = "capture" in inspect.signature(ServeEngine).parameters
    modes = (True, False) if can_capture else (None,)
    reqs = cs.chat_requests(seed, cfg.vocab)[:8]
    prefix, chunk = 192, cs.paged_config().prefill_chunk
    toks = np.random.default_rng(seed).integers(0, cfg.vocab, size=chunk)
    tree = None
    for capture in modes:
        kw = {} if capture is None else {"capture": capture}
        if tree is None:
            eng = ServeEngine(model, params, cs.paged_config(), device=dev,
                              **kw)
            tree = eng.params
            del params
        else:
            eng = ServeEngine(model, None, cs.paged_config(),
                              store=WeightStore(serving_params=tree,
                                                device=dev),
                              device=dev, **kw)
        label = {None: "as it runs", True: "captured",
                 False: "eager"}[capture]
        kv = eng.scheduler.kv
        kv.admit([(i, r) for i, r in enumerate(reqs)], list(range(8)), None,
                 eng.params)
        slots = list(range(8))

        def decode_step():
            nxt = kv.logits.argmax(-1).to(torch.int32)
            nxt.cpu()                                # the step's host sync
            kv.decode(eng.params, nxt, slots)

        extra = {"src": src, "mode": label, "layers": layers}
        cs._profile_steps(decode_step, steps,
                          "paged decode step, 8 slots",
                          dict(extra, context_lengths=kv._lengths.tolist()))
        side = kv.side_cache(1)
        _, side = eng.model.prefill(eng.params, {"tokens": torch.tensor(
            [reqs[0].prompt[:prefix]], device=dev)}, side)

        if hasattr(kv, "chunk_inputs"):
            def chunk_step():
                t, clock = kv.chunk_inputs(toks, prefix)
                lg, _ = eng._prefill_chunk(eng.params, {"tokens": t},
                                           dict(side, pos=clock))
                lg.cpu()                             # the step's host sync
        else:
            def chunk_step():
                t = torch.from_numpy(toks[None].copy()).to(dev)
                lg, _ = eng._prefill_chunk(eng.params, {"tokens": t},
                                           dict(side, pos=prefix))
                lg.cpu()                             # the step's host sync

        cs._profile_steps(chunk_step, steps,
                          f"admission chunk forward, {chunk} rows",
                          dict(extra, start_position=prefix))
        eng.close()
        del eng, kv, side
        torch.cuda.empty_cache()


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
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child is not None:
        child(args.child, args.layers, args.seed, args.steps)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("serving_step_ab: no CUDA device", file=sys.stderr)
        return 2
    srcs = args.src or [os.path.join(ROOT, "src")]
    order = [int(i) for i in args.order.split(",")] if args.order \
        else list(range(len(srcs)))
    for i in order:
        r = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--child", srcs[i], "--layers", str(args.layers),
                            "--seed", str(args.seed),
                            "--steps", str(args.steps)])
        if r.returncode != 0:
            return r.returncode
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
