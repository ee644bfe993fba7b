"""Training CLI: a config trained on synthetic data (Markov or uniform
tokens) with the full fault-tolerance path (checkpoint/restart, preemption,
straggler monitor). Runs on the current CUDA device; ``--device cpu`` runs
on the host. ``--reduced`` configs (the default) train in float32.

Examples:
    python -m repro_torch.launch.train --arch granite-3-8b --reduced \
        --steps 200 --ckpt-dir ckpt
    python -m repro_torch.launch.train --steps 6 --device cpu --ckpt-dir ckpt

``--production`` builds the production mesh (16×16, or 2×16×16 with
``--pod-compress``) over the ranks of the process group, so it raises below
256 (512) ranks, as the reference's does; on it the parameters and AdamW
moments are sharded with the framework rules
(``distributed.sharding.fsdp_place``): tensor-parallel over the 16-way
'model' axis (heads and FFN widths 16 does not divide on replica
groups) and FSDP (ZeRO-3) over 'data', and the step raises
``NotImplementedError`` for a config ``check_tensor_parallel`` refuses.
``--pod-compress`` without it trains plainly (the step has no 'pod' axis
to compress over).
"""
from __future__ import annotations

import argparse
import dataclasses

import torch

from repro_torch.configs import get_config, list_archs
from repro_torch.data.synthetic import markov_batches, synthetic_batches
from repro_torch.models.model import build_model
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.training.train_loop import (Trainer, TrainerConfig,
                                             make_train_step)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-8b", choices=list_archs())
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--data", default="markov", choices=["markov", "random"])
    ap.add_argument("--ckpt-dir", default="repro_train_ckpt")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--pod-compress", action="store_true")
    ap.add_argument("--production", action="store_true",
                    help="build the production mesh (needs >= 256 ranks)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the current CUDA device)")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    mesh = None
    if args.production:
        from repro_torch.launch.mesh import make_production_mesh
        mesh = make_production_mesh(multi_pod=args.pod_compress,
                                    device=device)
    cfg = get_config(args.arch, reduced=args.reduced)
    if args.reduced:
        cfg = dataclasses.replace(cfg, dtype="float32")
    model = build_model(cfg)
    gen = torch.Generator(device=device).manual_seed(0)
    params = model.init(gen, device=device)

    ocfg = AdamWConfig(lr=args.lr, warmup_steps=min(20, args.steps // 5),
                       decay_steps=args.steps)
    step = make_train_step(model, ocfg, microbatches=args.microbatches,
                           pod_compress=args.pod_compress, mesh=mesh)
    if mesh is not None:
        from repro_torch.distributed.sharding import fsdp_place
        params = fsdp_place(params, mesh, cfg=cfg)
    trainer = Trainer(model, ocfg,
                      TrainerConfig(total_steps=args.steps,
                                    checkpoint_every=args.ckpt_every,
                                    checkpoint_dir=args.ckpt_dir),
                      train_step=step, device=device)
    gen_fn = markov_batches if args.data == "markov" else synthetic_batches
    extra = {}
    if cfg.is_encdec:
        extra = {"encdec_dim": cfg.d_model, "enc_ratio": cfg.enc_ratio}
    params, opt, info = trainer.run(
        params, gen_fn(args.batch, args.seq, cfg.vocab, seed=0, **extra))
    hist = info["history"]
    if hist:
        print(f"[train] done: loss {hist[0]:.4f} → {hist[-1]:.4f} "
              f"({len(hist)} steps, {len(info['stragglers'])} stragglers)",
              flush=True)
    else:
        print("[train] done: nothing left to run", flush=True)


if __name__ == "__main__":
    main()
