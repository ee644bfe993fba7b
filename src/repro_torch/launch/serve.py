"""Serving CLI: on-the-fly data-free quantization + batched generation,
with optional zero-downtime weight reloads from a checkpoint directory.
Runs on the current CUDA device; ``--device cpu`` runs every kernel's plain
version on the host.

Example:
    python -m repro_torch.launch.serve --arch granite-3-8b --reduced \
        --quantize squant --bits 8 --prompts "hello" "world"

Hot reload: watch a checkpoint dir (the trainer's, or one written by
``repro_torch.launch.quantize --serving-ckpt``, or by the reference
package) and swap new COMMITTED steps in between decode rounds — fp steps
are re-quantized on the fly (sub-second, data-free: the point of SQuant),
quantized steps load natively:

    python -m repro_torch.launch.serve --quantize squant --bits 8 \
        --reload-from /tmp/ckpts --reload-poll 0.5 --rounds 20

Continuous batching (``--scheduler continuous``): a fixed pool of
``--max-slots`` decode slots over one persistent KV cache — short requests
retire immediately and queued ones refill mid-stream, and a staged reload
drains admission and swaps at a step boundary (force-swap after
``--swap-deadline-ms`` instead of waiting for the longest request):

    python -m repro_torch.launch.serve --scheduler continuous --max-slots 8 \
        --quantize squant --bits 8 --reload-from /tmp/ckpts

Paged KV cache (``--kv-backend paged``): block-pool KV with per-slot block
tables, shared-prefix reuse and copy-on-write — many requests carrying the
same system prompt prefill it once:

    python -m repro_torch.launch.serve --scheduler continuous --max-slots 8 \
        --kv-backend paged --block-size 16 --prompts "hi" "hi there"

Paged composes with chunked admission (``--prefill-chunk``): each pending
prefills its own unshared suffix a bounded chunk per step at its own
position (no shared clock, so any chunk size works mid-flight), keeping
resident decode tails flat while long shared-prefix prompts admit:

    python -m repro_torch.launch.serve --scheduler continuous --max-slots 8 \
        --kv-backend paged --block-size 16 --prefill-chunk 16

Quantized KV (``--quant-kv``) composes with both: the paged pool stores
int8 codes plus per-(position, head) scales (~0.27x fp32 bytes/position at
full widths) and decode runs the fused dequant-attention kernel. Tokens
are tolerance-equivalent, not bit-identical — pass ``--verify-agreement``
to measure teacher-forced greedy agreement against an fp-KV oracle engine
(the per-config budget is 0.98, see ``repro_torch.serving.equivalence``):

    python -m repro_torch.launch.serve --scheduler continuous --max-slots 8 \
        --kv-backend paged --quant-kv --prefill-chunk 16 --verify-agreement

Self-speculative decoding (``--speculative``): a ``--draft-bits``
quantization of the SAME checkpoint autoregressively proposes
``--draft-k``-token runs per slot, the serving tree verifies all
positions in one batched forward, and the longest matching prefix is
accepted. Greedy acceptance keeps tokens bit-identical to verifier-only
decode; the run ends with the draft acceptance printout. Requires the
paged backend and greedy sampling (not --quant-kv):

    python -m repro_torch.launch.serve --scheduler continuous --max-slots 8 \
        --kv-backend paged --quantize squant --bits 8 \
        --speculative --draft-bits 4 --draft-k 4
"""
from __future__ import annotations

import argparse
import dataclasses

import torch

from repro_torch.configs import get_config, list_archs
from repro_torch.data.tokenizer import ByteTokenizer
from repro_torch.models.model import build_model
from repro_torch.serving.engine import Request, ServeConfig, ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-8b", choices=list_archs())
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--quantize", default=None,
                    choices=[None, "rtn", "squant", "squant_e", "squant_ek",
                             "squant_ec"])
    ap.add_argument("--bits", type=int, default=8)
    ap.add_argument("--quant-kv", action="store_true",
                    help="int8 KV cache with per-(position, head) scales; "
                         "composes with --kv-backend paged (fused dequant "
                         "decode kernel) and --prefill-chunk")
    ap.add_argument("--verify-agreement", action="store_true",
                    help="continuous + --quant-kv: after serving, replay "
                         "the prompts teacher-forced against an fp-KV "
                         "oracle engine and report greedy-token agreement "
                         "(budget 0.98 at production widths)")
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--scheduler", default="round",
                    choices=["round", "continuous"],
                    help="round: static batches, swap between rounds; "
                         "continuous: slot pool with per-request "
                         "admission/retirement and reload-aware drain")
    ap.add_argument("--max-slots", type=int, default=0,
                    help="continuous decode-slot pool size (0: --batch)")
    ap.add_argument("--swap-deadline-ms", type=float, default=250.0,
                    help="continuous: max ms to drain in-flight slots "
                         "before a staged reload is force-swapped "
                         "(negative: drain fully, never force)")
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="continuous: consume admission prefills at most "
                         "this many prompt positions per engine step while "
                         "resident slots keep decoding, bounding the "
                         "step-time spike a long-prompt admission causes "
                         "(0: monolithic prefill; composes with "
                         "--kv-backend paged)")
    ap.add_argument("--kv-backend", default="contiguous",
                    choices=["contiguous", "paged"],
                    help="KV-cache layout: contiguous (one cache row per "
                         "slot) or paged (continuous only: block pool + "
                         "per-slot block tables with shared-prefix reuse "
                         "and copy-on-write — repeated system prompts "
                         "prefill once)")
    ap.add_argument("--block-size", type=int, default=16,
                    help="paged: positions per KV block (must divide "
                         "max_len)")
    ap.add_argument("--kv-blocks", type=int, default=0,
                    help="paged: physical blocks in the pool incl. the "
                         "trash block (0: full capacity, no admission "
                         "backpressure)")
    ap.add_argument("--speculative", action="store_true",
                    help="self-speculative decoding (paged + continuous + "
                         "greedy): a --draft-bits quantization of the same "
                         "checkpoint drafts --draft-k-token runs, the "
                         "serving tree verifies them in one batched "
                         "forward; tokens stay bit-identical to "
                         "verifier-only decode")
    ap.add_argument("--draft-bits", type=int, default=4,
                    help="speculative: bit-width of the drafter "
                         "quantization (the verifier serves at --bits)")
    ap.add_argument("--draft-k", type=int, default=4,
                    help="speculative: draft tokens proposed per verify "
                         "cycle")
    ap.add_argument("--prompts", nargs="*", default=["hello world"])
    ap.add_argument("--reload-from", default=None, metavar="CKPT_DIR",
                    help="watch this checkpoint dir and hot-swap new "
                         "COMMITTED steps at decode-round boundaries")
    ap.add_argument("--reload-poll", type=float, default=1.0,
                    help="watcher poll interval in seconds")
    ap.add_argument("--rounds", type=int, default=1,
                    help="generation passes over the prompts (use >1 with "
                         "--reload-from to observe live swaps)")
    ap.add_argument("--device", default="cuda",
                    help="where weights, caches and the model live "
                         "('cuda' = the current CUDA device, or 'cpu')")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, reduced=args.reduced)
    cfg = dataclasses.replace(cfg, dtype="float32",
                              vocab=max(cfg.vocab, 260))
    model = build_model(cfg)
    device = torch.device(args.device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    params = model.init(gen, device=device)
    tok = ByteTokenizer()
    deadline = None if args.swap_deadline_ms < 0 else args.swap_deadline_ms
    eng = ServeEngine(model, params,
                      ServeConfig(max_batch=args.batch, max_len=256,
                                  quantize_weights=args.quantize,
                                  weight_bits=args.bits,
                                  quantize_kv=args.quant_kv,
                                  scheduler=args.scheduler,
                                  max_slots=args.max_slots,
                                  swap_deadline_ms=deadline,
                                  prefill_chunk=args.prefill_chunk,
                                  kv_backend=args.kv_backend,
                                  block_size=args.block_size,
                                  kv_blocks=args.kv_blocks,
                                  speculative=args.speculative,
                                  draft_bits=args.draft_bits,
                                  draft_k=args.draft_k),
                      device=device)
    if eng.quant_report:
        print("[serve]", eng.quant_report.summary())
    if args.reload_from:
        eng.watch_checkpoints(args.reload_from, poll_s=args.reload_poll)
        print(f"[serve] watching {args.reload_from} "
              f"(poll {args.reload_poll}s)")
    reqs = [Request(prompt=tok.encode(p), max_new_tokens=args.max_new,
                    request_id=i) for i, p in enumerate(args.prompts)]
    for rnd in range(args.rounds):
        for c in eng.generate(reqs):
            print(f"[serve] round {rnd} req {c.request_id} "
                  f"v{c.weights_version}: {c.tokens} "
                  f"(prefill {c.prefill_ms:.1f} ms, decode "
                  f"{c.decode_ms:.1f} ms, swap {c.swap_ms:.2f} ms)")
    stats = eng.stats()
    w = stats["weights"]
    sch = stats["scheduler"]
    print(f"[serve] scheduler={sch['kind']} steps={sch['steps']}, "
          f"weights v{w['version']} (source {w['source']}, "
          f"{w['swaps']} swaps, {w['versions_built']} versions built)")
    if sch["kind"] == "continuous":
        print(f"[serve] slots={sch['max_slots']} admitted={sch['admitted']} "
              f"waves={sch['waves']} drains={sch['drains']} "
              f"forced_swaps={sch['forced_swaps']} "
              f"mean_occupancy={sch['mean_occupancy']:.2f}")
        if sch["step_ms"]:
            print(f"[serve] step-time p50/p95/p99 = "
                  f"{sch['step_ms']['p50']:.1f}/{sch['step_ms']['p95']:.1f}/"
                  f"{sch['step_ms']['p99']:.1f} ms "
                  f"(prefill_chunk={sch['prefill_chunk']}, "
                  f"{sch['chunk_steps']} chunk forwards, "
                  f"{sch['pendings_abandoned']} abandoned)")
        kv = sch["kv"]
        if kv.get("backend") == "paged":
            print(f"[serve] paged kv: {kv['blocks_total']} blocks x "
                  f"{kv['block_size']} (peak {kv['peak_blocks_active']} "
                  f"active), prefix hits={kv['prefix_hits']} "
                  f"({kv['prefix_tokens_reused']} tokens reused), "
                  f"cow={kv['cow_copies']} evictions={kv['evictions']}")
            print(f"[serve] kv pool: "
                  f"{'int8+scales' if kv['quantize_kv'] else 'fp'} "
                  f"{kv['pool_bytes'] / 1e6:.2f} MB "
                  f"({kv['bytes_per_position']} B/position)")
        if sch["speculative"]:
            al = sch["accepted_len"]
            print(f"[serve] speculative: {sch['spec_cycles']} verify "
                  f"cycles, {sch['draft_tokens_accepted']}/"
                  f"{sch['draft_tokens_proposed']} drafts accepted "
                  f"(rate {sch['acceptance_rate']:.2f}), accepted-len "
                  f"p50/p95 = {al.get('p50', 0.0):.1f}/"
                  f"{al.get('p95', 0.0):.1f} tokens/cycle")
    if args.verify_agreement:
        if args.scheduler != "continuous" or not args.quant_kv:
            print("[serve] --verify-agreement needs --scheduler continuous "
                  "and --quant-kv; skipping")
        else:
            from repro_torch.serving.equivalence import (agreement_budget,
                                                   greedy_token_agreement,
                                                   oracle_tokens)
            oracle_eng = ServeEngine(
                model, params,
                dataclasses.replace(eng.cfg, quantize_kv=False),
                device=device)
            oracle = oracle_tokens(oracle_eng.generate(reqs))
            oracle_eng.close()
            rep = greedy_token_agreement(eng, reqs, oracle)
            budget = agreement_budget(eng.cfg, eng.model.cfg)
            print(f"[serve] greedy agreement vs fp-KV oracle: "
                  f"{rep.rate:.4f} ({rep.matched}/{rep.compared} tokens, "
                  f"budget {budget:.2f} at production widths)")
    for err in w["errors"]:
        print(f"[serve] reload error: {err}")
    eng.close()


if __name__ == "__main__":
    main()
