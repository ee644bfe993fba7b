"""Data-free quantization CLI: checkpoint in, SQuant-ed checkpoint out.

The black-box post-processing deployment mode the paper argues for: no data,
no back-prop, well under a second per network on the card.

Example (on the card; ``--device cpu`` runs the plain versions on the host):
    python -m repro_torch.launch.quantize --arch granite-3-8b --reduced \\
        --method squant --bits 4 --out /tmp/granite_w4 \\
        --serving-ckpt /tmp/granite_w4_serving

``--serving-ckpt DIR`` also writes a native quantized serving checkpoint
(``w_q``/``w_q4`` + ``w_scale`` tree, int4 kept packed on disk, quant
metadata in ``index.json``) that ``repro_torch.launch.serve --reload-from
DIR`` hot-loads without re-quantizing, and that the reference package reads.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import tempfile

import torch

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs import get_config, list_archs
from repro_torch.core.dispatch import BACKENDS
from repro_torch.core.pipeline import quantize_tree
from repro_torch.models.model import build_model


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-8b", choices=list_archs())
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint dir (default: fresh init)")
    ap.add_argument("--method", default="squant",
                    choices=["rtn", "squant", "squant_e", "squant_ek",
                             "squant_ec"])
    ap.add_argument("--bits", type=int, default=4)
    ap.add_argument("--group-size", type=int, default=128)
    ap.add_argument("--backend", default="auto", choices=list(BACKENDS),
                    help="kernel backend: auto (CUDA tensor → the kernel, "
                         "CPU tensor → the plain version), ref (the plain "
                         "version on any device), cuda (the kernel)")
    ap.add_argument("--serial", action="store_true",
                    help="per-layer loop with one device sync per layer "
                         "(baseline for the batched pipeline)")
    ap.add_argument("--mesh", default="off",
                    help="sharded quantization; only 'off' is ported")
    ap.add_argument("--device", default="cuda",
                    help="where the weights live and quantization runs "
                         "('cuda' = the current CUDA device, or 'cpu')")
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "repro_torch_quantized"))
    ap.add_argument("--serving-ckpt", default=None, metavar="DIR",
                    help="additionally write a *native* quantized serving "
                         "checkpoint (w_q/w_q4+w_scale qdict tree, int4 "
                         "kept packed on disk, quant metadata in "
                         "index.json) that repro_torch.launch.serve "
                         "--reload-from hot-loads without re-quantizing")
    ap.add_argument("--serving-step", type=int, default=0,
                    help="step number for --serving-ckpt (watchers reload "
                         "steps in increasing order)")
    args = ap.parse_args(argv)
    if args.mesh != "off":
        raise NotImplementedError("not ported yet: sharded quantization "
                                  "(--mesh, M7)")

    device = torch.device(args.device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    cfg = get_config(args.arch, reduced=args.reduced)
    if args.reduced:
        # the serve CLI's reduced model (its byte tokenizer needs ids up to
        # 258), so a --serving-ckpt written here reloads there
        cfg = dataclasses.replace(cfg, dtype="float32",
                                  vocab=max(cfg.vocab, 260))
    model = build_model(cfg)
    if args.ckpt:
        params, _, step = Checkpointer(args.ckpt).restore_latest(
            device=device)
        print(f"[quantize] loaded step {step} from {args.ckpt}")
    else:
        gen = torch.Generator(device=device)
        gen.manual_seed(0)
        params = model.init(gen, device=device)

    qtree, report = quantize_tree(params, method=args.method, bits=args.bits,
                                  group_size=args.group_size,
                                  dequantize=True, backend=args.backend,
                                  batched=not args.serial, device=device)
    print(f"[quantize] {report.summary()}")
    os.makedirs(args.out, exist_ok=True)
    Checkpointer(args.out, async_save=False).save(0, qtree, {"step": 0})
    with open(os.path.join(args.out, "quant_report.json"), "w") as f:
        json.dump({"method": args.method, "bits": args.bits,
                   "backend": report.backend,
                   "batched": not args.serial,
                   "total_ms": report.total_millis,
                   "dispatch_ms": report.dispatch_millis,
                   "sync_ms": report.sync_millis,
                   "mesh_axis": report.mesh_axis,
                   "mesh_size": report.mesh_size,
                   "shards": [{"device": s.device, "rows": s.rows,
                               "pad_rows": s.pad_rows}
                              for s in report.shards],
                   "buckets": [{"key": b.key, "layers": b.num_layers,
                                "ms": b.dispatch_millis}
                               for b in report.buckets],
                   "layers": [{"path": l.path, "shape": list(l.shape),
                               "ms": l.millis, "bucket": l.bucket}
                              for l in report.layers]},
                  f, indent=1)
    print(f"[quantize] wrote {args.out}")

    if args.serving_ckpt:
        # the serving checkpoint needs the qdict layout (stack dims kept,
        # plain arrays), which only the serving-format quantizer emits — a
        # separate pass from the pipeline run above, so its metadata
        # records this pass's own timing
        from repro_torch.quant.apply import quantize_params_serving
        qserve, meta = quantize_params_serving(params, args.bits,
                                               method=args.method,
                                               group_size=args.group_size)
        Checkpointer(args.serving_ckpt, async_save=False).save_serving(
            args.serving_step, qserve, quant_meta=meta)
        print(f"[quantize] wrote serving checkpoint step "
              f"{args.serving_step} → {args.serving_ckpt} "
              f"({meta['leaf_format']})")


if __name__ == "__main__":
    main()
