#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (written for an H100).

Run from the repository root with no arguments:

    python3 chip_smoke.py

It needs one CUDA device, ``nvcc`` and nothing from the network. It
1. prints the card's name and power limit, the torch/CUDA versions, and builds
   the three CUDA sources of ``src/repro_torch/kernels/csrc`` (in parallel);
2. holds each kernel against its plain PyTorch version on the card, at the
   shapes the main paths use plus ragged ones (kernel A on (in, out) leaves
   as stored, at each bucket's real leaf count and shape, with its scale
   pass held bit for bit against ``core.dispatch._scales``; kernel B also at
   17, 43 and 64 prefill rows, two launches bit-identical; kernels C and D
   also at one slot and at long contexts), and times kernel, plain version,
   the bound and one library call (B, C, D and their yardsticks with a cold
   L2; B summed over one layer at the decode batch and at each prefill row
   count); also at phase 10's shapes: kernel A on its expert buckets read
   in place, kernel B at its expert banks' shapes (2048 -> 1408, 1408 ->
   2048) at 8 rows (``tcgemv``) and at a monolithic admission's capacity
   (``mma``), summed over one layer's 192 expert launches beside the
   reference's form (each bank dequantized, one batched matmul), kernel C
   at 16/16 heads (rep 1); and at phase 11's shapes, compared only: kernel
   A on the trained trees' buckets at 8 and 4 bits, kernel B at every
   launch shape phase 11's serving made (read from its plan cache: rows,
   weight shape, bits, dtype, pointer alignment), kernel C at 12/4 heads
   of 64 (rep 3) with the lengths of one of 11b's decode steps;
3. drives the round-scheduler path at the full width of granite-3-8b: random
   weights from a seed, SQuant w8 quantization of the whole tree (one
   kernel-A launch and one scale pass per bucket, every bucket read where it
   is stored; the quantize breakdown and its peak memory printed), six
   requests served real-quantized through ``ServeEngine`` (round scheduler,
   contiguous KV cache), with the kernels' launch counters read around it;
4. does the same with 4-bit weights at a reduced depth;
5. runs prefill + 8 decode steps at full width and 2 layers in float32 (and
   again in bfloat16, teacher-forced, with kernel B's launches by variant
   checked), and the paged continuous path at 2 layers in float32 and, with
   32-row admission chunks, in bfloat16 (teacher-forced, launches by
   variant checked), once through the kernels and once through their plain
   versions, and compares codes, logits and tokens;
6. drives this slice's main path at full width and full depth: SQuant w8,
   the continuous scheduler on the paged KV cache with chunked admission,
   its decode step and each chunk width captured as CUDA graphs (one
   capture each, counted in ``trace_counts``), twelve chat requests sharing
   a 192-token system prefix (prefix hits, copy-on-write, mid-flight
   admission, retirement), launch counters read around the run, the block
   pool checked after it; the same requests twice more on that engine (no
   capture for a shape seen before), a fresh set of requests (new widths
   captured while requests wait), and once on the same configuration run
   eagerly (``capture=False``): greedy tokens bit-identical, and launch
   counts equal, the captured run's read as what the wrappers issued plus
   what each graph launches in a replay, read by kernel name from its nodes
   through the driver, times its replays; then every chunk width captured
   (the cost of capturing them all up front); then teacher-forced greedy
   agreement against the contiguous continuous engine (in bfloat16 also
   the float32 oracle's top-2 logit margin at every disagreement);
7. does the same traffic with the int8 KV pool at a reduced depth, with the
   same captured-vs-eager checks, held to the reference's ``int8_kv``
   agreement budget against the fp paged pool;
8. serves phase 6's traffic and configuration with self-speculative
   decoding at full width and 12 of granite's 40 layers (``--layers8``;
   40 until phase 15 came, cut to keep the script inside its time limit on
   a slow host): the w4 tree of the same fp weights
   drafts four tokens a cycle, the w8 tree verifies them in one forward
   (its verify forward and the draft chain captured as CUDA graphs, one per
   width); a first run (launches held to the eager run's and to what the
   path implies), a second, a repeat that captures nothing, an eager run
   and the verifier-only engine: tokens of every request bit-identical to
   verifier-only decode (also in float32 at 2 layers), acceptance,
   tokens per second against the verifier alone in the same call;
9. native quantized serving checkpoints: (a) phase 6's fp tree (at 12 of
   its 40 layers, ``--layers9``; 40 until phase 15 came) quantized
   into the ``w_q`` + ``w_scale`` serving format by ``quant.apply`` on the
   card (kernel A, one launch a leaf), saved as a native w8 checkpoint
   (``checkpoint.Checkpointer.save_serving``) in a temporary directory,
   the device copies freed, restored onto the card and served in phase 6's
   configuration, captured: tokens bit-identical to the never-saved tree,
   leaves byte-equal, kernel B launches those of phase 6 (at a depth other
   than phase 6's, those of phase 6's tree served at this depth); quantize,
   save,
   restore and stage times; (b) live reload at 4 layers: the engine watches
   a directory while a writer saves an fp step, a native w8 step, a torn
   step and a w4 step, requests flowing: every completion full length,
   sources ``ckpt:1`` then ``ckpt:2``, the w4 step rejected, the torn one
   unseen, tokens after the last swap those of a fresh engine on the
   restored tree; what a device-wide synchronization does to another
   thread's capture, in a process of its own; (c) the quantize and serve
   CLIs as processes (serve swaps in the quantize CLI's checkpoint);
10. a fine-grained mixture of experts, ``moonshot-v1-16b-a3b`` (64
   experts top-6) at full width and 4 of its 48 layers (the cut is listed
   in the phase's line: 48 layers of float32 weights do not fit one card;
   16 did until phase 15 came and 8 until phases 15e-f came, cut to keep
   the script inside its time limit):
   (a) SQuant w8 of the whole tree, every expert bank quantized where it is
   stored (native route, nothing stacked), phase 6's serve configuration
   and traffic, captured, repeated and eager (tokens bit-identical,
   launches equal; kernel B's launches split into experts and attention by
   variant, every expert launch ``tcgemv``); (b) 2 layers in float32
   through the kernels against the plain versions; (c) 2 layers in float32,
   teacher-forced agreement against a one-slot contiguous oracle that
   admits in the same 64-token chunks, held to the reference's ``moe``
   budget (0.85), and, printed beside it, against the monolithic one; (d)
   the Hessian analysis
   (approximation precision) and the AdaRound and RTN baselines on one
   layer on the card;
11. training on the card (``training/``, ``LM.train_loss``, the synthetic
   data): (a) granite-3-8b as published (bf16 embedding, float32 dense
   kernels, remat) at full width and 8 of its 40 layers, ten steps of
   ``make_train_step`` on ``markov_batches(4, 512, 49155, seed)``: a
   finite loss that falls, ``microbatches=2`` equal to one pass within the
   bfloat16 tolerance, step ms, tokens/s, the forward+backward and
   optimizer split by CUDA events, peak memory and the model FLOP
   utilization; (b) the reference example's ``--size 100m`` model trained
   by the ``Trainer`` (preempted at mid-run, resumed from its checkpoint)
   on Markov batches made on a thread, held-out xent below 0.8 ln(vocab),
   then SQuant w8 of the trained tree (kernel A) served on phase 6's path
   (kernels B and C), agreement against the one-slot oracle in float32
   (gated at 0.98) and bfloat16 (printed, with the float32 top-2 margins),
   self-speculation (w4 drafts) with tokens equal to verifier-only, and
   the training CLI as a process, then 11b's step with remat on and off
   (step ms, the split, peak memory, device busy and kernels a step by
   ``torch.profiler``); (c) moonshot-v1-16b-a3b at full width
   and 2 layers, ten steps with its MoE aux loss, then moonshot's routing
   at (b)'s width trained on (b)'s batches: 10c's agreement gates and
   speculation on the MoE stack, tokens equal to verifier-only;
12. MLA and the sliding-window ring on the contiguous continuous path (the
   reference gates the paged backend off both) and the round scheduler:
   (a) ``minicpm3-4b`` at full width and depth (62 layers), SQuant w8 by
   kernel A, served in bfloat16 with phase 6's chat requests twice (8
   slots, 64-token chunks; tokens equal run to run) and on the round
   scheduler with phase 3's requests, kernel B's launches by variant and
   weight shape held to what the forwards imply (the ``kv_up``
   re-expansion of every slot's cache at each decode step), one decode
   step traced (the re-expansion against the rest), the weight-absorbed
   decode timed beside it; (b) ``mixtral-8x7b`` at full width and 4 of its
   32 layers (listed in the line; 6 until phase 15 came), expert banks quantized in place, 12
   requests of 4160-4480 prompt tokens that wrap the 4096-slot ring, four
   admitted mid-flight, served twice, launches held to the path's; (c)
   both at 2 layers in float32: codes and a prefill plus 8 decode steps
   through the kernels against the plain versions, and teacher-forced
   agreement of the 8-slot chunked engine (MLA against the one-slot
   monolithic oracle, >= 0.98; mixtral against the one-slot oracle
   admitting in the same chunks, >= the reference's sliding_window x moe
   budget). Phase 2 then also holds kernel A at 12a's and 12b's buckets
   and kernel B at every launch shape they made, and times ``kv_down``,
   the ``kv_up`` re-expansion and a mixtral layer's experts at decode;
13. the recurrent mixers on the contiguous continuous path and the round
   scheduler: (a) ``rwkv6-1.6b`` at full width and depth (24 layers),
   SQuant w8 (kernel A on every grouped bucket; the decay LoRA's
   64-input up-projection whole-row on the plain version and the bf16
   head on the stacked route, both named in the line), served in bfloat16
   with phase 6's chat requests twice (tokens equal run to run) and on the
   round scheduler with phase 3's, kernel B's launches by weight shape
   held to what the forwards imply, one decode step traced (the WKV
   recurrence, the mixer's other ops and kernel B by part); (b)
   ``jamba-1.5-large-398b`` at full width and one period of its block
   pattern (8 of 72 layers, listed in the line; 16 experts top-2 on every
   other layer), its ~180 GB float32 period made on the card one leaf at
   a time and quantized as it is made (kernel A's launches equal to what
   the per-leaf calls imply, peak memory printed), served as (a) is, one
   decode step traced (mamba's mixer ops, experts, other kernel B,
   other); (c) both at full width and 2 layers in float32 (jamba's mixer
   isolated beside one attention layer): codes and a prefill plus 8
   decode steps through the kernels against the plain versions, and
   teacher-forced agreement of the 8-slot chunked engine against the
   one-slot monolithic oracle on prompts of one length, gated at the
   reference's budgets, with the same traffic at the reduced width beside
   the reference engine's pinned reading. Phase 2 also holds kernel A at
   13a's and 13b's buckets and kernel B at every launch shape they made
   (rwkv's ``w_lora_b`` at K = 64 among them), and times the decay LoRA,
   jamba's ``in_proj`` at 8 and 512 rows and jamba's layer of 48 expert
   launches at decode;
14. the encoder-decoder on the round scheduler (the reference gates the
   continuous one off it): (a) ``seamless-m4t-medium`` at full width and
   depth (12 encoder + 12 decoder layers), SQuant w8 (kernel A on three
   native buckets, the bf16 head's 256 206 rows on the stacked route),
   served in bfloat16 with one round of eight 256-token requests over the
   scheduler's float32 zero frames (the decoder runs float32 from layer
   0's cross-attention on, so kernel B takes its float32 instances
   ``tcgemv32`` / ``mma32`` there), kernel B's launches by weight shape
   held to what the forwards imply (121 a decode step: ``tcgemv`` 5,
   ``tcgemv32`` 92, ``mma32`` 24; a prefill's 193: ``mma`` 5, ``mma32``
   188, the encoder's 72 among them; never ``gemv`` or ``tiled``),
   one decode step traced (kernel B by part and variant, attention, the
   rest), the continuous scheduler refused with the reference's message;
   (b) the same tree against the plain versions: every leaf's codes (the
   head too), and a prefill plus 4 decode steps over random float32 and
   bfloat16 frames, logits and encoder output within 2e-2 of the largest,
   in the reference's dtypes; (c) 2 + 2 layers in float32: teacher-forced
   agreement of the kernel path with the plain path, gated at 0.95; (d)
   ten training steps at full width and depth on Markov batches with
   float32 frames (8 x 512 tokens, 128 frames a row): a loss that falls,
   step ms, the forward+backward / optimizer split, tokens/s, ``mfu`` and
   peak memory, then the trained tree quantized and served one round.
   Phase 2 also holds kernel A at 14a's buckets and kernel B at every
   launch shape 14a-d made, and times kernel B with float32 activations
   at 14a's shapes three ways in one call: the float32 instance
   (``tcgemv32`` at 8 rows, ``mma32`` at 512 and 2 048), the CUDA-core
   variant it replaced (``gemv`` / ``tiled`` by an explicit plan) and
   ``torch.matmul`` in float32 (TF32 off) on pre-dequantized weights,
   beside the bound of three bf16 passes at 989 TFLOP/s.
15. the distributed layer on the card (``distributed/``, ``launch/mesh``,
   ``runtime/elastic``, ``training/grad_compression``): (a) a real one-rank
   NCCL mesh through the real code path, granite-3-8b at full width and
   ``--layers15`` layers (default 8): ``quantize_tree(mesh=
   make_quantize_mesh())`` bit-equal to ``mesh=None`` (one kernel-A launch
   and one scale pass a bucket, one synchronization), ``save_serving``
   then ``restore_serving(mesh=)`` byte-equal, a round served on the
   restored placed tree with tokens equal to the unplaced tree's and
   kernel B's launches those the round implies; (b) four ranks sharing the
   card over gloo (``run_local(world=4, backend="gloo")``), each quantizing
   its row slab of granite at full width and 2 layers through kernel A:
   gathered codes and scales bit-equal to rank 0's ``mesh=None`` run,
   ``QuantReport.shards`` equal to ``shard_rows``; the tree saved from the
   4-rank mesh and restored onto ``make_elastic_mesh(2)`` (ranks 0 and 1),
   leaves equal; (c) the int8 ring over 100 M
   floats a rank on the four ranks: identical on every rank, relative
   error below 0.03 against the float32 sum, ms per hop (host-staged gloo
   on one card, not an interconnect number); (d) pod-compressed training
   of the ``--size 100m`` model, 2 pods x 2 data ranks, 30 steps on Markov
   batches over its first 512 token ids (the width kept) beside the plain
   one-rank step on the same global batches, held
   to the reference's learning contract, the step split into grads,
   in-pod all-reduce, compress, ring and update; (e) tensor-parallel
   serving over 'model' on the four ranks (mesh (data 1, model 4)):
   granite at full width and 4 layers in float32, SQuant w8 quantized on
   the ranks' row slabs (kernel A), gathered and cut into each rank's
   shards (``sharding.tp_local``), a prefill of 8 x 256 tokens and 16
   greedy decode steps under ``activate_mesh``: kernel B's launches by
   local weight shape 7 x L x forwards on every rank, the logits within
   1e-4 of the one-rank forward's largest |logit|, at 2 layers
   free-running tokens equal to it (w8, and int4 with one scale a
   128-group: the row-parallel leaves' per-group scales cut at the
   shard's groups, 2e-2), bfloat16 reported; (f) tensor-parallel training
   on (data 2, model 2), granite at full width and 2 layers in float32, 5
   steps beside the plain one-rank step trained in the script's process:
   losses and grad norms within 1e-4 relative, every rank's parameter
   shards within the port's train-step tolerance of the one-rank
   parameters' slices, the step split into grads, the collectives over
   'model', the data all-reduce, the norm and the update; (g-n) MoE, MLA,
   the ring, mamba and rwkv the same way (their functions' docstrings);
   (o) sixteen ranks on (data 1, model 16): granite, minitron, minicpm3
   and mixtral-8x7b (its 8 experts on the 'expert_ff' fallback: every
   expert's 896 of 14 336 FFN columns a rank) at full width and one
   layer, served against one rank, and granite's and mixtral's train
   steps; (p-q) seamless-m4t-medium at full width and 2 + 2 layers on
   (data 1, model 4), its encoder and cross-attention on 4 of 16 heads a
   rank, served over random frames and trained against one rank.
The phases run in the order 1, 4, 3, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15,
2, 5: the short w4 run pays the one-time start-up costs, and phase 2 times
the kernels at the shapes phases 3, 6, 8 and 10 produced and compares
them at phase 11's, 12's, 13's, 14's and 15e's (whose local weight shapes
it also times at 8 rows). The last three lines are the
card line, the ``kernels`` line and the ``ok`` line.
Every line it prints is one JSON object, apart from the card line. Any failed
phase raises: the script then exits non-zero and prints no final ``ok`` line.
Depth can be cut with ``--layers`` (phases 3 and 6), ``--layers4`` (phase 4),
``--layers7`` (phase 7), ``--layers8`` (phase 8), ``--layers9`` (phase
9a), ``--layers10`` (phase 10a), ``--layers11`` (phase 11a),
``--layers12`` (phase 12b), ``--layers13`` (phase 13a) and ``--layers15``
(phase 15a), and the trained models' steps with ``--train-steps``;
widths are never cut.
"""
import argparse
import collections
import dataclasses
import json
import math
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}   # CUDA cores / tensor cores
A_OPS_PER_ELEMENT = 6          # divide, round, two clamps, subtract, add to the sum
L2_COLD_BYTES = 2 * 50e6       # twice the H100's 50 MB L2: cycling input sets
                               # whose reads exceed it times cold launches

KERNEL_A = {"name": "squant_flip", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/squant_flip.cu",
            "replaces": "src/repro/kernels/squant_flip.py:66",
            "also_replaces": "src/repro/kernels/squant_flip.py:97"}
KERNEL_B = {"name": "dequant_matmul", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/dequant_matmul.cu",
            "replaces": "src/repro/kernels/dequant_matmul.py:35"}
KERNEL_C = {"name": "paged_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
            "replaces": "src/repro/kernels/paged_attention.py:79"}
KERNEL_SCALE = {"name": "squant_scale", "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/squant_flip.cu",
                "replaces": "src/repro/core/dispatch.py:60",
                "note": "the bucket scales kernel A divides by; the reference "
                        "computes them with jnp ops (no Pallas kernel)"}
KERNEL_D = {"name": "paged_attention_quant", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
            "replaces": "src/repro/kernels/paged_attention_quant.py:88"}


def emit(obj):
    print(json.dumps(obj), flush=True)


def time_ms(fns, iters, graph=True):
    """Mean milliseconds of one call, cycling through ``fns`` (several
    closures over different buffers, so a small operand is not served from
    the L2 cache by the previous iteration), between two CUDA events.

    ``graph=True`` records the calls into a CUDA graph and times its replay:
    that is the device's time, free of the host's cost of issuing each call
    (tens of microseconds in Python, more than a small kernel runs).
    ``graph=False`` times the calls as a program makes them."""
    for f in fns:
        f()
    torch.cuda.synchronize()
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for i in range(iters):
                fns[i % len(fns)]()
        g.replay()
        torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    if graph:
        g.replay()
    else:
        for i in range(iters):
            fns[i % len(fns)]()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def host_ms(fns, iters):
    """Mean host milliseconds to issue one call from Python, until the call
    returns (not until its kernels end): what an eager decode step pays per
    call. Few enough calls that the launch queue never fills."""
    for f in fns:
        f()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(iters):
        fns[i % len(fns)]()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t * 1e3 / iters


# ---------------------------------------------------------------------------
# phase 2a: kernel A against its plain version
# ---------------------------------------------------------------------------

def check_kernel_a(dev, gen, buckets, moe_buckets=(), trees=None):
    """Kernel A against its plain version (exact and random inputs, heavy
    clipping), then the native-layout launches at each bucket of the main
    path's tree (``buckets``: (leaves, in, out)) and of phase 10's
    (``moe_buckets``: (leaves, experts, in, out), an expert bucket's
    leaves the expert slices of its banks, read where they are stored):
    every leaf against the plain versions, the scale pass and the flip
    timed against their bytes bound. ``trees`` ({phase: {"bits": (...),
    "timed": bool, "parts": {part: buckets in ``moe_buckets``' form}}}):
    the trees later phases quantized, each bucket at each of ``bits``
    against the plain versions (:func:`_a_bucket_vs_plain`), and where
    ``timed`` the flip and the scale pass timed beside their bytes bound;
    reported under ``trees_compared`` by phase and part."""
    from repro_torch.kernels import squant_flip as sf
    from repro_torch.kernels.ref import explain_code_differences
    from repro_torch.quant.scales import compute_scale

    stages = {"E": (False, False), "EK": (True, False), "EKC": (True, True)}
    cmp_shapes = [(4096, 4096, 128), (12800, 4096, 128), (4096, 12800, 128),
                  (37, 1000, 128)]
    worst = 0
    ties = {"rows": 0, "rows_differing": 0, "unexplained": 0}
    for (m, n, g) in cmp_shapes:
        for bits in (4, 8):
            for tag, (ek, ec) in stages.items():
                kw = dict(bits=bits, group_size=g, enable_k=ek, enable_c=ec)
                # (i) exact inputs: weights on a binary grid, power-of-two
                # scale -> every sum is exact in float32 in any order
                w = torch.randint(-400, 401, (m, n), generator=gen,
                                  device=dev).float() / 64.0
                s = torch.full((m, 1), 2.0 ** (-1 if bits == 8 else 0),
                               device=dev)
                got = sf.squant_flip(w, s, **kw)
                want = sf.squant_flip_plain(w, s, **kw)
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    raise AssertionError(f"kernel A != plain on exact inputs "
                                         f"{(m, n, g, bits, tag)}")
                # (ii) random normal weights through compute_scale
                w = torch.randn((m, n), generator=gen, device=dev)
                s = compute_scale(w, bits, "max")
                got = sf.squant_flip(w, s, **kw)
                want = sf.squant_flip_plain(w, s, **kw)
                res = explain_code_differences(w, s, got, want, **kw)
                worst = max(worst, int((got.int() - want.int()).abs().max()))
                for k in ties:
                    ties[k] += res[k]
                if res["unexplained"]:
                    raise AssertionError(f"kernel A differs from plain beyond "
                                         f"the tie rule at "
                                         f"{(m, n, g, bits, tag)}: {res}")
                del w, s, got, want
    # heavy clipping: codes pile up at +-qmax, eligibility needs the grid test
    w = torch.randn((64, 1024), generator=gen, device=dev) * 4.0
    w = torch.round(w * 16) / 16
    s = torch.full((64, 1), 0.5, device=dev)
    for bits in (4, 8):
        if not torch.equal(sf.squant_flip(w, s, bits=bits, group_size=128),
                           sf.squant_flip_plain(w, s, bits=bits,
                                                group_size=128)):
            raise AssertionError("kernel A != plain under heavy clipping")

    # the native-layout launches at each bucket's real B x (in, out) of the
    # main path's tree: random leaves, the scale pass and the flip timed,
    # every leaf held against the plain versions
    from repro_torch.core.dispatch import _scales
    a0 = dict(sf.launches_by_route)
    shapes, scale_rows = [], []
    tot = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
    stot = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0}
    kw = dict(bits=8, group_size=128)
    moe_tot = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "scale_ms": 0.0,
               "scale_bound_ms": 0.0}
    moe_rows = []
    for i, (nb, experts, kin, nch) in enumerate(
            [(nb, 1, kin, nch) for nb, kin, nch in buckets]
            + list(moe_buckets)):
        is_moe = i >= len(buckets)
        # an expert bucket: nb / experts banks (experts, in, out), each
        # expert's slice one (in, out) leaf
        leaves = [sl for _ in range(nb // experts)
                  for sl in torch.randn((experts, kin, nch), generator=gen,
                                        device=dev).unbind(0)]
        # exact inputs on the first leaf's shape: codes equal
        gw = torch.randint(-400, 401, (kin, nch), generator=gen,
                           device=dev).float() / 64.0
        gs = torch.full((1, nch), 0.5, device=dev)
        if not torch.equal(sf.squant_flip_leaves([gw], gs, **kw),
                           sf.squant_flip_leaves_plain([gw], gs, **kw)):
            raise AssertionError(f"kernel A (native) != plain on exact inputs "
                                 f"at {(kin, nch)}")
        del gw
        s = sf.squant_scales(leaves, 8)
        for b, leaf in enumerate(leaves):
            if not torch.equal(s[b], _scales(leaf.T[None], 8, "max")[0, :, 0]):
                raise AssertionError(f"scale pass != _scales at {(kin, nch)}")
        s_ms = time_ms([lambda: sf.squant_scales(leaves, 8)], 3)
        s_plain = time_ms([lambda: sf.squant_scales_plain(leaves, 8)], 1,
                          graph=False)
        lib_ms = time_ms([lambda: [torch.linalg.vector_norm(
            leaf, float("inf"), dim=0) for leaf in leaves]], 1, graph=False)
        s_bytes = nb * (kin * nch * 4 + nch * 4)
        s_bound = s_bytes / HBM_BYTES_PER_S * 1e3
        srow = {"leaves": nb, "in": kin, "out": nch, "ms": s_ms,
                "bound_ms": s_bound, "bound_share": s_bound / s_ms,
                "plain_ms": s_plain, "library_ms": lib_ms}
        if is_moe:
            moe_tot["scale_ms"] += s_ms
            moe_tot["scale_bound_ms"] += s_bound
        else:
            scale_rows.append(srow)
            stot["ms"] += s_ms
            stot["plain_ms"] += s_plain
            stot["bound_ms"] += s_bound
            stot["library_ms"] += lib_ms

        got = sf.squant_flip_leaves(leaves, s, **kw)
        again = sf.squant_flip_leaves(leaves, s, **kw)
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise AssertionError(f"kernel A (native) launches differ at "
                                 f"{(nb, kin, nch)}")
        del again
        plain_ms = 0.0
        for b, leaf in enumerate(leaves):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            want = sf.squant_flip_leaves_plain([leaf], s[b:b + 1], **kw)[0]
            e1.record()
            torch.cuda.synchronize()
            plain_ms += e0.elapsed_time(e1)
            res = explain_code_differences(leaf.T, s[b][:, None], got[b],
                                           want, **kw)
            worst = max(worst, int((got[b].int() - want.int()).abs().max()))
            for k in ties:
                ties[k] += res[k]
            if res["unexplained"]:
                raise AssertionError(f"kernel A (native) differs from plain "
                                     f"beyond the tie rule at "
                                     f"{(nb, kin, nch)}: {res}")
            del want
        ms = time_ms([lambda: sf.squant_flip_leaves(leaves, s, **kw)], 3)
        nbytes = nb * (kin * nch * 5 + nch * 4)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = A_OPS_PER_ELEMENT * nb * kin * nch / PEAK_FLOPS["float32"] * 1e3
        bound = max(t_bytes, t_ops)
        row = {"leaves": nb, "in": kin, "out": nch,
               "route": sf.route(nch, True), "ms": ms,
               "plain_ms": plain_ms, "bound_ms": bound,
               "bound_share": bound / ms,
               "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
        if is_moe:
            row.update(experts=experts, banks=nb // experts,
                       launches=-(-nb // sf.MAX_LEAVES), scale_ms=s_ms,
                       scale_bound_ms=s_bound)
            moe_rows.append(row)
            for k in ("ms", "plain_ms", "bound_ms"):
                moe_tot[k] += row[k]
        else:
            shapes.append(row)
            for k in tot:
                tot[k] += row[k]
        del leaves, s, got
        torch.cuda.empty_cache()
    trees_compared = {}
    for phase, spec in (trees or {}).items():
        trees_compared[phase] = {}
        for part, bks in spec["parts"].items():
            rows = []
            for nb, experts, kin, nch in bks:
                for bits in spec["bits"]:
                    t = {} if spec["timed"] else None
                    w = _a_bucket_vs_plain(dev, gen, nb, experts, kin, nch,
                                           bits, ties, t)
                    worst = max(worst, w)
                    row = {"leaves": nb, "experts": experts, "in": kin,
                           "out": nch, "bits": bits,
                           "route": sf.route(nch, True),
                           "max_abs_code_diff": w}
                    if t is not None:
                        t_bytes = nb * (kin * nch * 5 + nch * 4) \
                            / HBM_BYTES_PER_S * 1e3
                        t_ops = A_OPS_PER_ELEMENT * nb * kin * nch \
                            / PEAK_FLOPS["float32"] * 1e3
                        bound = max(t_bytes, t_ops)
                        row.update(t, launches=-(-nb // sf.MAX_LEAVES),
                                   bound_ms=bound, bound_share=bound / t["ms"],
                                   bound_by="bytes" if t_bytes >= t_ops
                                   else "operations",
                                   scale_bound_ms=nb * (kin * nch + nch) * 4
                                   / HBM_BYTES_PER_S * 1e3)
                    rows.append(row)
                    torch.cuda.empty_cache()
            out = {"buckets": rows}
            if spec["timed"]:
                out.update({k: sum(r[k] for r in rows) for k in (
                    "ms", "plain_ms", "bound_ms", "scale_ms",
                    "scale_bound_ms")})
                out["bound_share"] = out["bound_ms"] / out["ms"]
            trees_compared[phase][part] = out
    routes = {k: sf.launches_by_route[k] - a0[k] for k in a0}
    if routes["cp16"] == 0:
        raise AssertionError(f"no native launch took the 16-byte route: "
                             f"{routes}")
    entry = dict(KERNEL_A, max_abs_err=worst, tolerance="codes equal; rows that "
                 "differ must be explained by a float32 tie (1e-4) and keep "
                 "the paper's invariants", tie_rule=ties,
                 numbers_are="sums over the launches of one quantize_tree of "
                 "the main path's model (one per bucket)", timing="ms: device "
                 "time (CUDA graph replay); plain_ms: eager calls, leaf by "
                 "leaf", library_ms=None, bound_by="bytes", shapes=shapes,
                 bound_share=tot["bound_ms"] / tot["ms"], **tot)
    if moe_rows:
        entry["moe_tree"] = dict(
            moe_tot, model=MOE_ARCH, buckets=moe_rows,
            bound_share=moe_tot["bound_ms"] / moe_tot["ms"],
            numbers_are="sums over the launches of one quantize_tree of "
            "phase 10's tree: the expert buckets read in place (the flip "
            "takes up to MAX_LEAVES slices a launch) and the attention "
            "bucket")
    entry["trees_compared"] = trees_compared
    scale = dict(KERNEL_SCALE, max_abs_err=0.0, tolerance="bit-identical to "
                 "core.dispatch._scales on every leaf", bound_by="bytes",
                 numbers_are="sums over the launches of one quantize_tree of "
                 "the main path's model (one per bucket)", timing="ms: device "
                 "time (CUDA graph replay); plain_ms and library_ms: eager "
                 "calls", library="torch.linalg.vector_norm(leaf, inf, "
                 "dim=0), one call a leaf", bound_share=stot["bound_ms"] /
                 stot["ms"], shapes=scale_rows, **stot)
    return entry, scale


def _a_bucket_vs_plain(dev, gen, nb, experts, kin, nch, bits, ties,
                       times=None):
    """Kernel A's native launch at one bucket (``nb`` random (in, out)
    leaves, ``experts`` slices of a bank each) against its plain versions:
    codes equal on exact inputs, the scale pass bit-identical to
    ``_scales``, every leaf's codes equal up to the tie rule (``ties``
    accumulates). ``times`` (a dict) receives the flip's and the scale
    pass's device ms (CUDA graph replay) and the plain version's, leaf by
    leaf. Returns the largest code difference."""
    from repro_torch.core.dispatch import _scales
    from repro_torch.kernels import squant_flip as sf
    from repro_torch.kernels.ref import explain_code_differences
    kw = dict(bits=bits, group_size=128)
    gw = torch.randint(-400, 401, (kin, nch), generator=gen,
                       device=dev).float() / 64.0
    gs = torch.full((1, nch), 2.0 ** (-1 if bits == 8 else 0), device=dev)
    if not torch.equal(sf.squant_flip_leaves([gw], gs, **kw),
                       sf.squant_flip_leaves_plain([gw], gs, **kw)):
        raise AssertionError(f"kernel A (native) != plain on exact inputs "
                             f"at {(kin, nch, bits)}")
    del gw
    leaves = [sl for _ in range(nb // experts)
              for sl in torch.randn((experts, kin, nch), generator=gen,
                                    device=dev).unbind(0)]
    s = sf.squant_scales(leaves, bits)
    got = sf.squant_flip_leaves(leaves, s, **kw)
    worst, plain_ms = 0, 0.0
    for b, leaf in enumerate(leaves):
        if not torch.equal(s[b], _scales(leaf.T[None], bits, "max")[0, :, 0]):
            raise AssertionError(f"scale pass != _scales at "
                                 f"{(kin, nch, bits)}")
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        want = sf.squant_flip_leaves_plain([leaf], s[b:b + 1], **kw)[0]
        e1.record()
        torch.cuda.synchronize()
        plain_ms += e0.elapsed_time(e1)
        res = explain_code_differences(leaf.T, s[b][:, None], got[b], want,
                                       **kw)
        worst = max(worst, int((got[b].int() - want.int()).abs().max()))
        for k in ties:
            ties[k] += res[k]
        if res["unexplained"]:
            raise AssertionError(f"kernel A (native) differs from plain "
                                 f"beyond the tie rule at "
                                 f"{(nb, kin, nch, bits)}: {res}")
        del want
    if times is not None:
        times.update(
            ms=time_ms([lambda: sf.squant_flip_leaves(leaves, s, **kw)], 3),
            scale_ms=time_ms([lambda: sf.squant_scales(leaves, bits)], 3),
            plain_ms=plain_ms)
    return worst


def _a_buckets(qrep):
    """(leaves, experts, in, out) of each bucket of a ``quantize_tree``
    report (``check_kernel_a``'s ``moe_buckets`` form): a 2-D (in, out)
    leaf is one leaf, an (E, in, out) bank E expert slices."""
    by = {}
    for lr in qrep.layers:
        e, kin, nch = (1,) * (3 - len(lr.shape)) + tuple(lr.shape)
        n = by.get(lr.bucket, (0,))[0]
        by[lr.bucket] = (n + e, e, kin, nch)
    return list(by.values())


# ---------------------------------------------------------------------------
# phase 2b: kernel B against its plain version
# ---------------------------------------------------------------------------

def _b_case(dev, gen, m, n, bits, per_group, copies=1):
    from repro_torch.quant.qtypes import pack_int4
    qmax = 2 ** (bits - 1) - 1
    out = []
    for _ in range(copies):
        codes = torch.randint(-qmax, qmax + 1, (m, n), generator=gen,
                              device=dev, dtype=torch.int8)
        data = pack_int4(codes) if bits <= 4 else codes
        # scales of the size SQuant gives weights of std 1/sqrt(N)
        sc = (torch.rand((m, n // 128 if per_group else 1), generator=gen,
                         device=dev) + 0.5) * (3.0 / math.sqrt(n) / qmax)
        out.append((data, sc))
    return out


def check_kernel_b(dev, gen, decode_batches, prefill_rows, draft_rows=(),
                   experts=None, plans=None, phase12=None, phase13=None,
                   phase14=None, phase15=None, phase15ij=None,
                   phase15lm=None, phase15o=None):
    """Kernel B against its plain version at the main paths' shapes, a
    ragged N and a ragged M, every variant and dtype (also at the prefill
    instances' 17, 43 and 64 rows: a chunk tail, a ragged chunk, a whole
    chunk; float32 there takes ``mma32``'s one-m-tile plan); two launches
    bit-identical at every comparison; then times
    at the seven projections' shapes, bfloat16, int8, per-channel scales:
    the decode batches (the first, phase 6's, is the headline sum over one
    layer), the prefill rows (each summed over one layer too), 4-bit
    codes at the first decode batch, and 4-bit codes on the ``mma``
    variant at phase 8's drafter admission prefills (``draft_rows``, at
    (4096, 4096) and (12800, 4096)). Kernel and ``torch.matmul`` yardstick
    alike are timed by CUDA-graph replay with a cold L2: the calls cycle
    through input sets whose reads exceed twice the L2. ``experts`` (phase
    10's: ``n_experts``, ``banks`` as (name, out, in), ``rows``): kernel B
    at each expert bank's shape and each capacity in ``rows``, against the
    plain version, summed over one layer's launches (one per expert and
    bank) beside their bound, and beside the reference's form of the same
    products: each bank dequantized and one batched ``torch.matmul``.
    ``plans`` ({phase: {part: ``dm.cached_plans()`` of its run}}): every
    launch shape the later phases' paths made, compared (not timed) by
    :func:`_b_plan_vs_plain` and reported under
    ``launch_shapes_compared`` by phase and part. ``phase12``: ``timed``
    ((label, M, N, rows) cells timed like the main path's) and ``experts``
    (mixtral's layer at decode, in ``experts``' form); ``phase13`` the same
    for phase 13 (rwkv's decay LoRA at K = 64, jamba's ``in_proj`` and
    jamba's layer of 48 expert launches at decode); ``phase14`` (label, M,
    N, rows) cells timed with float32 activations
    (:func:`kernel_b_phase14_times`); ``phase15`` (label, M, N, rows): 15e's
    local weight shapes, timed so in float32 and in bfloat16;
    ``phase15ij``, ``phase15lm`` and ``phase15o`` (label, M, N, rows):
    15i-j's, 15l-m's and 15o's local shapes, timed so in float32 (their
    paths' dtype)."""
    from repro_torch.kernels import dequant_matmul as dm
    from repro_torch.kernels import ops

    launches_before = ops.launch_counts()
    layer = [("wq", 4096, 4096), ("wk", 1024, 4096), ("wv", 1024, 4096),
             ("wo", 4096, 4096), ("wi", 12800, 4096), ("wg", 12800, 4096),
             ("wdown", 4096, 12800)]
    mn = sorted({(m, n) for _, m, n in layer})
    worst = {"float32": 0.0, "bfloat16": 0.0}
    worst_rel = {"float32": 0.0, "bfloat16": 0.0}
    n_cmp = 0
    for (m, n) in mn + [(100, 1000), (1000, 4096)]:
        for b in sorted({1, 8, 16, 17, 43, 64, 512} | set(decode_batches)):
            for bits in (8, 4):
                for dt in (torch.float32, torch.bfloat16):
                    for per_group in (False, True):
                        if per_group and n % 128:
                            continue
                        (data, sc), = _b_case(dev, gen, m, n, bits, per_group)
                        x = torch.randn((b, n), generator=gen,
                                        device=dev).to(dt)
                        gs = 128 if n % 128 == 0 else n
                        y = dm.dequant_matmul(x, data, sc, bits=bits,
                                              group_size=gs).float()
                        r = dm.dequant_matmul_plain(x, data, sc, bits=bits,
                                                    group_size=gs).float()
                        torch.cuda.synchronize()
                        # float32: 1e-4 relative plus 1e-4 of the output's
                        # magnitude (the float32 sum over N = 4096..12800
                        # terms is taken in another order than the plain
                        # version's matmul); bfloat16: 2e-2 both, one
                        # rounding of the output
                        tol = 1e-4 if dt == torch.float32 else 2e-2
                        scale_ = max(float(r.abs().max()), 1.0)
                        err = float((y - r).abs().max())
                        name = str(dt).replace("torch.", "")
                        worst[name] = max(worst[name], err)
                        worst_rel[name] = max(worst_rel[name], err / scale_)
                        if not torch.allclose(y, r, rtol=tol, atol=tol * scale_):
                            raise AssertionError(
                                f"kernel B != plain at {(b, m, n, bits, name, per_group)}"
                                f": max abs err {err}, max |ref| {scale_}")
                        if not torch.equal(
                                y, dm.dequant_matmul(x, data, sc, bits=bits,
                                                     group_size=gs).float()):
                            raise AssertionError(
                                f"kernel B: two launches differ at "
                                f"{(b, m, n, bits, name, per_group)}")
                        n_cmp += 1

    compared = {}
    for phase, parts in (plans or {}).items():
        compared[phase] = {}
        for part, pl in parts.items():
            errs = [_b_plan_vs_plain(dev, gen, p) for p in pl]
            for p, (err, rel) in zip(pl, errs):
                worst[p["dtype"]] = max(worst[p["dtype"]], err)
                worst_rel[p["dtype"]] = max(worst_rel[p["dtype"]], rel)
            n_cmp += len(pl)
            compared[phase][part] = {
                "launch_shapes": len(pl),
                "by_variant_bits_dtype": dict(collections.Counter(
                    f"{p['variant']} int{p['bits']} {p['dtype']}"
                    for p in pl)),
                "weight_shapes": sorted({f"{p['m']}x{p['n']}" for p in pl}),
                "rows": sorted({p["b"] for p in pl}),
                "max_rel_err": max((r for _, r in errs), default=0.0)}
            torch.cuda.empty_cache()

    def timed(m, n, b, bits, dt):
        return _b_timed(dev, gen, m, n, b, bits, dt)

    shapes = []
    tot = {"ms": 0.0, "eager_call_ms": 0.0, "host_ms": 0.0, "plain_ms": 0.0,
           "bound_ms": 0.0, "library_ms": 0.0, "library_host_ms": 0.0}
    head = decode_batches[0]
    per_mn = {}
    for (m, n) in mn:
        per_mn[(m, n)] = timed(m, n, head, 8, torch.bfloat16)
        shapes.append(per_mn[(m, n)])
        torch.cuda.empty_cache()
    for _, m, n in layer:                 # one decode step of one layer
        for k in tot:
            tot[k] += per_mn[(m, n)][k]
    for (m, n) in mn:                     # the rest of the main paths' shapes
        for b in list(decode_batches[1:]) + list(prefill_rows):
            per_mn[(b, m, n)] = timed(m, n, b, 8, torch.bfloat16)
            shapes.append(per_mn[(b, m, n)])
        shapes.append(timed(m, n, head, 4, torch.bfloat16))
        torch.cuda.empty_cache()
    # kernel B int4 on the mma variant at the drafter's admission prefill
    # rows (phase 8): compared with the plain version and timed
    draft_prefill = []
    for b in draft_rows:
        for (m, n) in ((4096, 4096), (12800, 4096)):
            row = timed(m, n, b, 4, torch.bfloat16)
            if row["variant"] != "mma":
                raise AssertionError(f"int4 at {b} rows took {row}")
            draft_prefill.append(row)
        torch.cuda.empty_cache()
    # one layer's seven projections at each prefill row count (an admission
    # chunk of phase 6, the round path's prefills)
    prefill_layers = {}
    for b in prefill_rows:
        rows = [per_mn[(b, m, n)] for _, m, n in layer]
        lt = {k: sum(r[k] for r in rows) for k in (
            "ms", "library_ms", "bound_ms", "plain_ms")}
        prefill_layers[str(b)] = dict(
            lt, bound_share=lt["bound_ms"] / lt["ms"],
            library_bound_share=lt["bound_ms"] / lt["library_ms"],
            faster_than_library_each=all(r["ms"] < r["library_ms"]
                                         for r in rows),
            variant=sorted({r["variant"] for r in rows}),
            splits={f"({r['m']},{r['n']})": r["splits"] for r in rows})
    expert_layer = None if experts is None else \
        _expert_layer_times(dev, gen, experts)
    phase12_timed = None if phase12 is None else \
        kernel_b_phase12_times(dev, gen, phase12)
    phase13_timed = None if phase13 is None else \
        kernel_b_phase13_times(dev, gen, phase13)
    phase14_timed = None if phase14 is None else \
        kernel_b_phase14_times(dev, gen, phase14)
    phase15_timed = None if phase15 is None else {
        "float32": kernel_b_phase14_times(dev, gen, phase15)["cells"],
        "bfloat16": [dict(_b_timed(dev, gen, m, n, b, 8, torch.bfloat16),
                          label=label) for label, m, n, b in phase15]}
    phase15ij_timed = None if phase15ij is None else \
        kernel_b_phase14_times(dev, gen, phase15ij)["cells"]
    # 15l-m's cells without the older variant beside them (time)
    phase15lm_timed = None if phase15lm is None else \
        kernel_b_phase14_times(dev, gen, phase15lm, old=False)["cells"]
    phase15o_timed = None if phase15o is None else \
        kernel_b_phase14_times(dev, gen, phase15o, old=False)["cells"]
    # comparisons and timings are not the path's launches
    ops.set_launch_counts(launches_before)
    entry = dict(KERNEL_B, variants=list(dm.VARIANTS),
                 float32_instances={
                     "tcgemv32": "tcgemv_kernel<NT, PACKED, true>: float32 "
                                 "x at B <= 16, replaces gemv there",
                     "mma32": "pf_kernel<1, PACKED, GROUPED, true>: "
                              "float32 x above 16 rows, replaces tiled "
                              "there"},
                 experts=expert_layer, max_abs_err=worst["bfloat16"],
                 max_abs_err_float32=worst["float32"],
                 max_rel_err=worst_rel,
                 tolerance="float32: rtol 1e-4, atol 1e-4*max|ref| (sum order "
                 "over N up to 12800); bfloat16: rtol 2e-2, atol 2e-2*max|ref|;"
                 " two launches: output bits equal",
                 comparisons=n_cmp,
                 numbers_are=f"sums over the seven projections of one layer in "
                 f"one decode step: batch {head}, bfloat16, int8 codes, "
                 f"per-channel scales; prefill_layers: the same sums at each "
                 f"prefill row count",
                 timing="ms, library_ms: device time (CUDA graph replay) with "
                 "a cold L2: the calls cycle through input sets whose reads "
                 "exceed twice the L2; eager_call_ms: the wrapper called from "
                 "Python, host cost included; host_ms, library_host_ms: host "
                 "time to issue one call (perf_counter, no sync); plain_ms: "
                 "eager calls",
                 bound_share=tot["bound_ms"] / tot["ms"],
                 bound_by="bytes", prefill_layers=prefill_layers,
                 draft_prefill_int4=draft_prefill,
                 launch_shapes_compared=compared,
                 phase12=phase12_timed, phase13=phase13_timed,
                 phase14=phase14_timed, phase15=phase15_timed,
                 phase15ij=phase15ij_timed, phase15lm=phase15lm_timed,
                 phase15o=phase15o_timed,
                 shapes=shapes, **tot)
    return entry


def _b_timed(dev, gen, m, n, b, bits, dt, also=None):
    """Kernel B at one cell (``b`` rows of ``dt`` on an (M, N) weight,
    ``bits``, per-channel scales) against its plain version, and timed:
    device ms by CUDA-graph replay with a cold L2 (the calls cycle through
    input sets whose reads exceed twice the L2), the wrapper's eager call,
    the host's cost of issuing it, the plain version, the library's
    ``torch.matmul`` on pre-dequantized weights and the bound. ``also``
    ({name: plan}): other plans (``dequant_matmul(plan=)``) timed the same
    way on the same inputs, each held to the plain version too, reported
    as ``<name>_ms``."""
    from repro_torch.kernels import dequant_matmul as dm
    wbytes = m * n // (2 if bits <= 4 else 1)
    n_sets = max(2, min(64, math.ceil(L2_COLD_BYTES / wbytes)))
    cases = _b_case(dev, gen, m, n, bits, False, n_sets)
    gs = 128 if n % 128 == 0 else n          # ops.dequant_matmul's group
    x = torch.randn((b, n), generator=gen, device=dev).to(dt)
    y = dm.dequant_matmul(x, *cases[0], bits=bits, group_size=gs).float()
    r = dm.dequant_matmul_plain(x, *cases[0], bits=bits,
                                group_size=gs).float()
    tol = 1e-4 if dt == torch.float32 else 2e-2
    if not torch.allclose(y, r, rtol=tol,
                          atol=tol * max(float(r.abs().max()), 1.0)):
        raise AssertionError(f"kernel B != plain at the main path's "
                             f"{(b, m, n, bits)}")
    var, splits, ups = dm.launch_plan(x, cases[0][0], m, 1, gs, bits)
    iters = max(40 if b <= 16 else 6, 2 * n_sets)
    calls = [(lambda d=d, s=s: dm.dequant_matmul(
        x, d, s, bits=bits, group_size=gs)) for d, s in cases]
    ms = time_ms(calls, iters)
    also_ms = {}
    for name, plan in (also or {}).items():
        ya = dm.dequant_matmul(x, *cases[0], bits=bits, group_size=gs,
                               plan=plan).float()
        if not torch.allclose(ya, r, rtol=tol,
                              atol=tol * max(float(r.abs().max()), 1.0)):
            raise AssertionError(f"kernel B's {plan} != plain at "
                                 f"{(b, m, n, bits)}")
        also_ms[f"{name}_ms"] = time_ms(
            [(lambda d=d, s=s, p=plan: dm.dequant_matmul(
                x, d, s, bits=bits, group_size=gs, plan=p))
             for d, s in cases], iters)
    wrapper_ms = time_ms(calls, iters, graph=False)
    call_host_ms = host_ms(calls, iters)
    plain_ms = time_ms([(lambda d=d, s=s: dm.dequant_matmul_plain(
        x, d, s, bits=bits, group_size=gs)) for d, s in cases[:2]], 4,
        graph=False)
    # the library's call for the same function: one matmul on weights
    # dequantized beforehand (timed only; the port never calls it), on
    # enough copies that its reads too exceed twice the L2
    esz = 2 if dt == torch.bfloat16 else 4
    n_lib = max(2, math.ceil(L2_COLD_BYTES / (m * n * esz)))
    deq = [(dm.unpack_int4(d) if bits <= 4 else d).to(dt) * s.to(dt)
           for d, s in (cases[i % n_sets] for i in range(n_lib))]
    lib_calls = [(lambda w=w: torch.matmul(x, w.T)) for w in deq]
    lib_ms = time_ms(lib_calls, max(iters, 2 * n_lib))
    lib_host_ms = host_ms(lib_calls, max(iters, 2 * n_lib))
    del deq, cases
    name = str(dt).replace("torch.", "")
    nbytes = wbytes + m * 4 + b * n * esz + b * m * esz
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2.0 * b * m * n / PEAK_FLOPS[name] * 1e3
    bound = max(t_bytes, t_ops)
    return {"m": m, "n": n, "batch": b, "bits": bits, "dtype": name,
            "variant": var, "splits": splits, "units_per_split": ups,
            "input_sets": n_sets,
            "library_input_sets": n_lib,
            "ms": ms, **also_ms, "eager_call_ms": wrapper_ms,
            "host_ms": call_host_ms, "plain_ms": plain_ms,
            "library_ms": lib_ms, "library_host_ms": lib_host_ms,
            "bound_ms": bound,
            "bound_share": bound / ms,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def _expert_layer_times(dev, gen, experts):
    """One MoE layer's expert launches (``experts``: ``n_experts``,
    ``banks`` as (name, out, in), ``rows``: capacities) timed by
    :func:`_b_timed`, summed over the layer's launches (one per expert and
    bank), beside their bound and the reference's form (each bank
    dequantized, one batched ``torch.matmul``)."""
    out = {}
    e = experts["n_experts"]
    for c in experts["rows"]:
        per = {}
        for _, m, n in experts["banks"]:
            if (m, n) not in per:
                per[(m, n)] = _b_timed(dev, gen, m, n, c, 8, torch.bfloat16)
                torch.cuda.empty_cache()
        lt = {k: e * sum(per[(m, n)][k] for _, m, n in experts["banks"])
              for k in ("ms", "library_ms", "bound_ms", "plain_ms")}
        yard = sum(_bank_matmul_ms(dev, gen, e, m, n, c)
                   for _, m, n in experts["banks"])
        out[str(c)] = dict(
            lt, launches=e * len(experts["banks"]),
            bound_share=lt["bound_ms"] / lt["ms"],
            dequant_bank_matmul_ms=yard,
            variant=sorted({r["variant"] for r in per.values()}),
            per_launch=list(per.values()))
        if out[str(c)]["variant"] != [_variant(c)]:
            raise AssertionError(f"expert launches at {c} rows took "
                                 f"{out[str(c)]['variant']}")
    return out


def kernel_b_phase12_times(dev, gen, phase12):
    """Phase 12's kernel-B cells (``timed``: (label, M, N, rows)) and
    mixtral's layer of expert launches at decode (``experts``), timed as
    the main path's cells are."""
    out = {"cells": [dict(_b_timed(dev, gen, m, n, b, 8, torch.bfloat16),
                          label=label)
                     for label, m, n, b in phase12["timed"]],
           "experts": _expert_layer_times(dev, gen, phase12["experts"])}
    torch.cuda.empty_cache()
    return out


def _at_offset(t, offset):
    """A copy of ``t`` whose data pointer lies ``offset`` bytes past a
    16-byte boundary."""
    esz = t.element_size()
    buf = torch.empty(t.numel() + 16 // esz, dtype=t.dtype, device=t.device)
    if buf.data_ptr() % 16 or offset % esz:
        raise AssertionError(f"cannot place {t.dtype} at offset {offset}")
    out = buf[offset // esz:offset // esz + t.numel()].view(t.shape)
    out.copy_(t)
    return out


def _b_plan_vs_plain(dev, gen, p):
    """Kernel B against its plain version at one launch shape a path made
    (a ``dm.cached_plans()`` entry): the same rows, weight shape, bits,
    scale columns, group, activation dtype and pointer offsets, so the
    launch takes the path's variant and split (checked); random codes and
    scales of SQuant's size; the shape sweep's tolerances; two launches
    bit-identical. Returns (max abs error, that over max |ref|)."""
    from repro_torch.kernels import dequant_matmul as dm
    from repro_torch.quant.qtypes import pack_int4
    b, m, n, bits, gsz = p["b"], p["m"], p["n"], p["bits"], p["group_size"]
    dt = torch.bfloat16 if p["dtype"] == "bfloat16" else torch.float32
    qmax = 2 ** (bits - 1) - 1
    codes = torch.randint(-qmax, qmax + 1, (m, n), generator=gen, device=dev,
                          dtype=torch.int8)
    codes = _at_offset(pack_int4(codes) if bits <= 4 else codes,
                       p["codes_align"])
    sc = (torch.rand((m, p["scols"]), generator=gen, device=dev) + 0.5) \
        * (3.0 / math.sqrt(n) / qmax)
    x = _at_offset(torch.randn((b, n), generator=gen, device=dev).to(dt),
                   p["x_align"])
    plan = dm.launch_plan(x, codes, m, p["scols"], gsz, bits)
    if plan != (p["variant"], p["splits"], p["per_split"]):
        raise AssertionError(f"kernel B at the path's shape {p} planned "
                             f"{plan}")
    y = dm.dequant_matmul(x, codes, sc, bits=bits, group_size=gsz).float()
    r = dm.dequant_matmul_plain(x, codes, sc, bits=bits,
                                group_size=gsz).float()
    torch.cuda.synchronize()
    tol = 1e-4 if dt == torch.float32 else 2e-2
    scale_ = max(float(r.abs().max()), 1.0)
    err = float((y - r).abs().max())
    if not torch.allclose(y, r, rtol=tol, atol=tol * scale_):
        raise AssertionError(f"kernel B != plain at the path's shape {p}: "
                             f"max abs err {err}, max |ref| {scale_}")
    if not torch.equal(y, dm.dequant_matmul(x, codes, sc, bits=bits,
                                            group_size=gsz).float()):
        raise AssertionError(f"kernel B: two launches differ at {p}")
    return err, err / scale_


def _bank_matmul_ms(dev, gen, e, m, n, c):
    """Device ms of the plain version of one expert bank's product on the
    card, the reference's form: the ``(e*m, n)`` int8 bank dequantized to
    bfloat16 and one batched ``torch.matmul`` on ``(e, c, n)`` rows
    (``ops.expert_matmul`` under ``force_backend("ref")``), two banks
    cycled (each ``e*m*n`` bytes, past the L2)."""
    from repro_torch.kernels import ops
    from repro_torch.quant.qtypes import QuantizedTensor
    banks = [{"w": QuantizedTensor(data=d, scale=sc, bits=8,
                                   shape=(e * m, n))}
             for d, sc in _b_case(dev, gen, e * m, n, 8, False, 2)]
    x = torch.randn((e, c, n), generator=gen, device=dev).to(torch.bfloat16)
    with ops.force_backend("ref"):
        ms = time_ms([(lambda b=b: ops.expert_matmul(x, b)) for b in banks],
                     4)
    del banks
    torch.cuda.empty_cache()
    return ms


# ---------------------------------------------------------------------------
# phases 3 and 4: the main path
# ---------------------------------------------------------------------------

# phases 3/4's round-scheduler traffic, also 12a's: (prompt lengths,
# max_batch, max_new, max_len)
ROUND_TRAFFIC = ([17, 96, 40, 64, 33, 128], 4, 16, 256)


def make_requests(seed, vocab, lengths, max_new):
    import numpy as np
    from repro_torch.serving import Request
    rng = np.random.default_rng(seed)
    return [Request(rng.integers(0, vocab, size=n).tolist(), max_new,
                    request_id=i) for i, n in enumerate(lengths)]


def drive(dev, seed, layers, bits, lengths, max_batch, max_new, phase):
    from repro_torch.configs import get_config
    from repro_torch.kernels import dequant_matmul as dm
    from repro_torch.kernels import squant_flip as sf
    from repro_torch.models.model import build_model
    from repro_torch.serving import ServeConfig, ServeEngine

    full = get_config("granite-3-8b")
    cfg = dataclasses.replace(full, n_layers=layers)
    model = build_model(cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    t0 = time.perf_counter()
    params = model.init(gen, device=dev)
    torch.cuda.synchronize()
    init_ms = (time.perf_counter() - t0) * 1e3

    sf.launches = sf.scale_launches = 0
    sf.launches_by_route = dict.fromkeys(sf.ROUTES, 0)
    dm.launches = 0
    dm.launches_by_variant = dict.fromkeys(dm.VARIANTS, 0)
    weights_bytes = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    eng = ServeEngine(model, params, ServeConfig(
        max_batch=max_batch, max_len=256, quantize_weights="squant",
        weight_bits=bits, dequantize_for_compute=False), device=dev)
    quant_peak_gb = (torch.cuda.max_memory_allocated() - weights_bytes) / 1e9
    scale_launches = sf.scale_launches
    a_routes = dict(sf.launches_by_route)
    del params
    torch.cuda.empty_cache()
    rep = eng.quant_report
    reqs = make_requests(seed, cfg.vocab, lengths, max_new)
    outs = eng.generate(reqs)
    torch.cuda.synchronize()
    a_launches, b_launches = sf.launches, dm.launches     # read right after

    st = eng.stats()
    forwards = 0
    rounds = []
    for i, rl in enumerate(st["round_log"]):
        chunk = lengths[i * max_batch:(i + 1) * max_batch]
        # no EOS: a round samples max_new times and, like the reference
        # scheduler, runs a decode forward after every sample
        steps = max_new
        forwards += 1 + steps               # 1 prefill + max_new decodes
        rounds.append({"requests": rl["requests"], "prompt_len": max(chunk),
                       "prefill_ms": rl["prefill_ms"],
                       "decode_ms": rl["decode_ms"],
                       "ms_per_decode_step": rl["decode_ms"] / steps})
    if st["scheduler"].steps != len(rounds) * max_new:
        raise AssertionError(f"sampling steps {st['scheduler'].steps} != "
                             f"{len(rounds) * max_new}")
    # one kernel-A launch and one scale pass per bucket, every bucket read
    # where it is stored (the native route): nothing stacked
    want_a = len(rep.buckets)
    want_b = 7 * layers * forwards
    if not all("g128" in b.key for b in rep.buckets):
        raise AssertionError("a bucket of the full-width tree is not grouped")
    if not all(b.route == "native" for b in rep.buckets):
        raise AssertionError(f"a bucket took the stacked route: "
                             f"{[(b.key, b.route) for b in rep.buckets]}")
    if a_launches != want_a or a_launches == 0 or scale_launches != want_a:
        raise AssertionError(f"kernel A launches {a_launches} (scale pass "
                             f"{scale_launches}), path implies {want_a}")
    if b_launches != want_b or b_launches == 0:
        raise AssertionError(f"kernel B launches {b_launches}, path implies {want_b}")
    for o, r in zip(outs, reqs):
        if len(o.tokens) != r.max_new_tokens or \
                not all(0 <= t < cfg.vocab for t in o.tokens):
            raise AssertionError(f"request {r.request_id}: bad tokens {o.tokens}")
    # the served tree gives finite logits of the right shape
    cache = eng.model.init_cache(1, 64, device=dev)
    lg, _ = eng.model.prefill(eng.params, {"tokens": torch.tensor(
        [reqs[0].prompt[:16]], device=dev)}, cache)
    if tuple(lg.shape) != (1, cfg.vocab) or not bool(torch.isfinite(lg).all()):
        raise AssertionError("logits of the served tree are not finite")
    buckets = []                            # (leaves, in, out)
    for b in rep.buckets:                   # "(M,N)xB dtype gG", M = out
        mn, rest = b.key.split(")x")
        m, n = (int(v) for v in mn[1:].split(","))
        buckets.append((int(rest.split(" ")[0]), n, m))
    emit({"phase": phase, "model": cfg.name, "layers": layers,
          "full_depth": layers == full.n_layers, "d_model": cfg.d_model,
          "d_ff": cfg.d_ff, "vocab": cfg.vocab, "weight_bits": bits,
          "activation_dtype": cfg.dtype, "dense_weight_dtype": "float32",
          "init_ms": init_ms, "quant_report": rep.summary(),
          "quantize_total_ms": rep.total_millis,
          "quantize_dispatch_ms": rep.dispatch_millis,
          "quantize_sync_ms": rep.sync_millis,
          "staged_ms": eng.store.current.staged_ms,
          "quantize_buckets": [{"key": b.key, "route": b.route,
                                "dispatch_ms": b.dispatch_millis}
                               for b in rep.buckets],
          "quantize_peak_gb_above_weights": quant_peak_gb,
          "rounds": rounds, "tokens": [o.tokens for o in outs],
          "launches": {"squant_flip": a_launches,
                       "squant_flip_by_route": a_routes,
                       "squant_scale": scale_launches,
                       "dequant_matmul": b_launches,
                       "dequant_matmul_by_variant": dict(
                           dm.launches_by_variant)},
          "mma_plans": dm.cached_plans("mma"),
          "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9})
    eng.close()
    del eng, outs, cache, lg
    torch.cuda.empty_cache()
    return a_launches, b_launches, buckets, scale_launches


# ---------------------------------------------------------------------------
# phase 5: the slice through its kernels against the slice through the plain
# versions
# ---------------------------------------------------------------------------

def slice_vs_plain(dev, seed):
    from repro_torch.configs import get_config
    from repro_torch.core.pipeline import quantize_tree
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import explain_code_differences
    from repro_torch.models.model import build_model

    cfg = dataclasses.replace(get_config("granite-3-8b"), n_layers=2,
                              dtype="float32")
    model = build_model(cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    params = model.init(gen, device=dev)
    tree_k, _ = quantize_tree(params, method="squant", bits=8, device=dev)
    with ops.force_backend("ref"):
        tree_p, _ = quantize_tree(params, method="squant", bits=8, device=dev)
    ties = {"rows": 0, "rows_differing": 0, "unexplained": 0}
    for li in range(2):
        for grp in ("attn", "ffn"):
            for name, leaf in params["stack"]["list"][li]["b0"][grp].items():
                qk = tree_k["stack"]["list"][li]["b0"][grp][name]["w"]
                qp = tree_p["stack"]["list"][li]["b0"][grp][name]["w"]
                if not torch.equal(qk.scale, qp.scale):
                    raise AssertionError("scales differ between backends")
                res = explain_code_differences(
                    leaf["w"].T, qp.scale, qk.data, qp.data, bits=8,
                    group_size=128)
                for k in ties:
                    ties[k] += res[k]
    if ties["unexplained"]:
        raise AssertionError(f"codes differ beyond the tie rule: {ties}")
    del params
    torch.cuda.empty_cache()

    prompt = torch.randint(0, cfg.vocab, (2, 24), generator=gen, device=dev)

    def run(tree):
        cache = model.init_cache(2, 64, device=dev)
        lg, cache = model.prefill(tree, {"tokens": prompt}, cache)
        logits, toks = [lg], []
        for _ in range(8):
            nxt = lg.argmax(-1)
            toks.append(nxt.tolist())
            lg, cache = model.decode_step(tree, nxt[:, None], cache)
            logits.append(lg)
        return torch.stack(logits), toks

    c0 = ops.launch_counts()
    lk, tk = run(tree_k)
    by = _b_by_variant(ops.launches_between(c0, ops.launch_counts()))
    with ops.force_backend("ref"):
        lp, tp = run(tree_p)
    torch.cuda.synchronize()
    err = float((lk - lp).abs().max())
    mag = float(lp.abs().max())
    tol = 1e-3          # of the largest logit: float32 sum order, two layers
    if tk != tp:
        raise AssertionError(f"greedy tokens differ: {tk} vs {tp}")
    if err > tol * mag:
        raise AssertionError(f"logits differ by {err} (max |logit| {mag})")
    bf16 = bf16_slice_vs_plain(dev, model, tree_k, prompt)
    bf16["paged_chunked"] = bf16_paged_vs_plain(dev, seed, model, tree_k)
    paged = paged_vs_plain(dev, seed)
    emit({"phase": "5 slice vs plain versions", "layers": 2,
          "dtype": "float32", "codes_tie_rule": ties,
          "dequant_matmul_by_variant": by,
          "logits_max_abs_err": err, "logits_max_abs": mag,
          "tolerance": f"{tol} * max|logit|", "greedy_tokens_equal": True,
          "tokens": tk, "bfloat16": bf16, **paged})


def bf16_slice_vs_plain(dev, model, tree, prompt, steps=8):
    """The round path's prefill and decode steps with bfloat16 activations
    (the main path's dtype, where the decode linears take ``tcgemv``) on
    phase 5's quantized tree, through the kernels and under
    ``force_backend("ref")``, both fed the plain run's greedy tokens so they
    see one context: logits within 2e-2 of the largest (a bf16 rounding of
    every linear's output, taken after float32 sums in another order), and
    the kernels' launches by variant: every decode linear on ``tcgemv``,
    every prefill linear (2 x 24 rows) on ``mma``."""
    from repro_torch.kernels import dequant_matmul as dm
    from repro_torch.kernels import ops
    from repro_torch.models.model import build_model

    m16 = build_model(dataclasses.replace(model.cfg, dtype="bfloat16"))
    tree = _retyped(tree, torch.bfloat16)

    def run(feed=None):
        cache = m16.init_cache(prompt.shape[0], 64, device=dev)
        lg, cache = m16.prefill(tree, {"tokens": prompt}, cache)
        logits, fed = [lg], []
        for i in range(steps):
            nxt = lg.argmax(-1) if feed is None else feed[i]
            fed.append(nxt)
            lg, cache = m16.decode_step(tree, nxt[:, None], cache)
            logits.append(lg)
        return torch.stack(logits).float(), fed

    with ops.force_backend("ref"):
        lp, fed = run()
    dm.launches_by_variant = dict.fromkeys(dm.VARIANTS, 0)
    lk, _ = run(fed)
    torch.cuda.synchronize()
    by = dict(dm.launches_by_variant)
    linears = 7 * model.cfg.n_layers
    want = _variants(tcgemv=linears * steps, mma=linears)
    if by != want:
        raise AssertionError(f"bf16 slice: kernel B launches by variant {by}, "
                             f"path implies {want}")
    if lk.shape != lp.shape or not bool(torch.isfinite(lk).all()):
        raise AssertionError(f"bf16 slice: logits {tuple(lk.shape)} not "
                             f"finite or not of shape {tuple(lp.shape)}")
    err = float((lk - lp).abs().max())
    mag = float(lp.abs().max())
    tol = 2e-2
    if err > tol * mag:
        raise AssertionError(f"bf16 slice: logits differ by {err} (max "
                             f"|logit| {mag})")
    same = float((lk.argmax(-1) == lp.argmax(-1)).float().mean())
    return {"logits_max_abs_err": err, "logits_max_abs": mag,
            "tolerance": f"{tol} * max|logit|", "launches_by_variant": by,
            "greedy_argmax_agreement": same}


def bf16_paged_vs_plain(dev, seed, model, tree, chunk=32):
    """The paged continuous path with chunked admission (chunks of
    ``chunk`` > 16 rows, so chunk forwards take kernel B's ``mma``) in
    bfloat16 on phase 5's quantized tree: once under
    ``force_backend("ref")``, then through the kernels with the
    scheduler's token override feeding the plain run's tokens, so both see
    one context. Logits of every chunk forward and of the live rows of
    every decode forward within 2e-2 of the largest, and kernel B's
    launches by variant exactly the path's: ``mma`` 7 x L per chunk forward
    of more than 16 rows, ``tcgemv`` 7 x L per other forward, no ``gemv``
    or ``tiled``."""
    from repro_torch.kernels import ops
    from repro_torch.models.model import build_model
    from repro_torch.serving import ServeEngine, WeightStore
    from repro_torch.serving.equivalence import (greedy_token_agreement,
                                                 oracle_tokens)

    m16 = build_model(dataclasses.replace(model.cfg, dtype="bfloat16"))
    tree16 = _retyped(tree, torch.bfloat16)
    reqs = chat_requests(seed, model.cfg.vocab, max_new=8, prefix=32)[:6]

    def run(oracle=None):
        eng = ServeEngine(m16, None, paged_config(
            max_slots=4, max_len=256, prefill_chunk=chunk),
            store=WeightStore(serving_params=tree16, device=dev), device=dev)
        sch = eng.scheduler

        def keep(a, o):
            # live slots only: retired rows read the trash block
            rows = [i for i, s in enumerate(sch.slots) if s is not None]
            return o[0][rows].float().cpu()

        dec = eng._decode = _Counted(eng._decode, keep)
        chk = eng._prefill_chunk = _Counted(
            eng._prefill_chunk, lambda a, o: (int(a[1]["tokens"].numel()),
                                              o[0].float().cpu()))
        c0 = ops.launch_counts()
        if oracle is None:
            toks = oracle_tokens(eng.generate(reqs))
        else:
            toks = greedy_token_agreement(eng, reqs, oracle)
        torch.cuda.synchronize()
        # what the wrappers issued plus what the replays launched (read
        # from the graphs' kernel nodes)
        launched = ops.combine_launches(
            ops.launches_between(c0, ops.launch_counts()),
            eng.replay_launches())
        eng.close()
        return (toks, torch.cat(dec.log), [r for r, _ in chk.log],
                torch.cat([lg[None] for _, lg in chk.log]), dec.calls,
                launched["dequant_matmul.launches_by_variant"])

    with ops.force_backend("ref"):
        oracle, dp, rows_p, cp, _, _ = run()
    rep, dk, rows_k, ck, n_dec, by = run(oracle)
    linears = 7 * model.cfg.n_layers
    big = sum(1 for r in rows_k if r > 16)
    want = _variants(mma=linears * big,
                     tcgemv=linears * (n_dec + len(rows_k) - big))
    if rows_k != rows_p or dk.shape != dp.shape or big == 0:
        raise AssertionError(f"bf16 paged: the runs differ in shape (chunk "
                             f"rows {rows_k} vs {rows_p}, decode logits "
                             f"{tuple(dk.shape)} vs {tuple(dp.shape)})")
    if by != want:
        raise AssertionError(f"bf16 paged: kernel B launches by variant "
                             f"{by}, path implies {want}")
    if not (bool(torch.isfinite(dk).all()) and bool(torch.isfinite(ck).all())):
        raise AssertionError("bf16 paged: logits not finite")
    err = max(float((dk - dp).abs().max()), float((ck - cp).abs().max()))
    mag = max(float(dp.abs().max()), float(cp.abs().max()))
    tol = 2e-2
    if err > tol * mag:
        raise AssertionError(f"bf16 paged: logits differ by {err} (max "
                             f"|logit| {mag})")
    return {"logits_max_abs_err": err, "logits_max_abs": mag,
            "tolerance": f"{tol} * max|logit|", "prefill_chunk": chunk,
            "chunk_rows": rows_k, "decode_forwards": n_dec,
            "launches_by_variant": by,
            "greedy_argmax_agreement": rep.rate}


# ---------------------------------------------------------------------------
# phase 2c: kernels C and D against their plain versions
# ---------------------------------------------------------------------------

def _paged_inputs(dev, gen, b, kv, rep, d, bs, nb, lengths, dtype, quant,
                  poison=True):
    """Pools with spare blocks (trash block 0 included), distinct blocks per
    slot, table tails past a slot's length pointing at the trash block, and
    every position no slot reads unmasked poisoned with +1e6 (codes +127 and
    scales 1e6 for the int8 pool)."""
    from repro_torch.models.attention import _quant_tok
    n = b * nb + 2
    perm = torch.randperm(n - 1, generator=gen, device=dev)[:b * nb] + 1
    bt = perm.reshape(b, nb).to(torch.int32)
    live = torch.zeros(n, bs, dtype=torch.bool, device=dev)
    for i, L in enumerate(lengths):
        used = min(nb, L // bs + 1)
        bt[i, used:] = 0
        cols = torch.arange(used * bs, device=dev)
        cols = cols[cols <= L]
        live[bt[i, (cols // bs)].long(), cols % bs] = True
    q = torch.randn(b, kv * rep, d, generator=gen, device=dev).to(dtype)
    dead = ~live
    if quant:
        kq, ks = _quant_tok(torch.randn(n, bs, kv, d, generator=gen,
                                        device=dev))
        vq, vs = _quant_tok(torch.randn(n, bs, kv, d, generator=gen,
                                        device=dev))
        if poison:
            kq[dead], vq[dead], ks[dead], vs[dead] = 127, 127, 1e6, 1e6
        pools = [kq, vq, ks, vs]
    else:
        k = torch.randn(n, bs, kv, d, generator=gen, device=dev)
        v = torch.randn(n, bs, kv, d, generator=gen, device=dev)
        if poison:
            k[dead] += 1e6
            v[dead] += 1e6
        pools = [k.to(dtype), v.to(dtype)]
    return [q] + pools + [bt, torch.tensor(lengths, dtype=torch.int32,
                                           device=dev)]


def _paged_bytes_ops(c, quant, esz):
    """Bytes the kernel must move (K/V rows and scales of positions <=
    lengths once, q and the output once) and its flops."""
    b, h, d = c["b"], c["kv"] * c["rep"], c["d"]
    rows = sum(L + 1 for L in c["lengths"]) * c["kv"]
    per_row = 2 * d + 8 if quant else 2 * d * esz
    return (rows * per_row + 2 * b * h * d * esz,
            4.0 * sum(L + 1 for L in c["lengths"]) * h * d)


def _sdpa_inputs(args, c, quant, dt):
    """q and the slots' K/V gathered to a contiguous (B, KV, T, D) form (and
    dequantized, for the int8 pool), with the length mask: the library
    yardstick's operands, built outside its time."""
    q, pools, bt, ln = args[0], args[1:-2], args[-2], args[-1]
    b_, _, d_ = q.shape
    t = c["nb"] * c["bs"]
    kc = pools[0][bt.long()].reshape(b_, t, c["kv"], d_)
    vc = pools[1][bt.long()].reshape(b_, t, c["kv"], d_)
    if quant:
        kc = (kc.float() * pools[2][bt.long()].reshape(
            b_, t, c["kv"], 1)).to(dt)
        vc = (vc.float() * pools[3][bt.long()].reshape(
            b_, t, c["kv"], 1)).to(dt)
    mask = (torch.arange(t, device=q.device)[None, :]
            <= ln[:, None])[:, None, None, :]
    return (q[:, :, None, :], kc.transpose(1, 2).contiguous(),
            vc.transpose(1, 2).contiguous(), mask)


def check_kernels_cd(dev, gen, path_lengths, moe_lengths=None, trained=None):
    """Kernels C and D against their plain versions at the main path's
    shape (B=8, H=32, KV=8, D=128, bs=16, nb=32, the per-slot lengths of a
    step of phase 6), at a ragged shape (rep=1, D=64, lengths {0, bs-1, bs,
    full}), at one slot (``single``: B=1, length 400, where the split
    matters most) and at long contexts (``long``: nb=256, lengths drawn
    from 1500-4095), and at phase 10's shape when ``moe_lengths`` is given
    (``moe``: B=8, H=KV=16, rep=1, D=128, the per-slot lengths of a step of
    phase 10), in bfloat16 and float32, with tails at the trash block
    and masked positions poisoned; ``trained`` (a case dict: phase 11b's
    shape, H=12, KV=4, rep=3, D=64, and the lengths of one of its decode
    steps) adds case ``trained``. Times by CUDA-graph replay with a cold
    L2: the timed calls cycle through enough independent input sets that
    the bytes they read exceed twice the 50 MB L2 (at most 128 sets, so the
    tiny ragged case stays warm), for the kernel and for the library
    yardstick alike (``scaled_dot_product_attention`` on K/V already
    gathered to contiguous form and, for D, already dequantized: the
    gather and the dequantization are not in its time)."""
    import torch.nn.functional as F

    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import paged_attention_quant as paq

    long_lengths = torch.randint(1500, 4096, (8,), generator=gen,
                                 device=dev).tolist()
    cases = [("path", dict(b=8, kv=8, rep=4, d=128, bs=16, nb=32,
                           lengths=list(path_lengths))),
             ("ragged", dict(b=4, kv=2, rep=1, d=64, bs=16, nb=4,
                             lengths=[0, 15, 16, 63])),
             ("single", dict(b=1, kv=8, rep=4, d=128, bs=16, nb=32,
                             lengths=[400])),
             ("long", dict(b=8, kv=8, rep=4, d=128, bs=16, nb=256,
                           lengths=long_lengths))]
    if moe_lengths is not None:
        cases.append(("moe", dict(b=8, kv=16, rep=1, d=128, bs=16, nb=32,
                                  lengths=list(moe_lengths))))
    if trained is not None:
        cases.append(("trained", trained))
    entries = {}
    for quant in (False, True):
        mod = paq if quant else pa
        kern = paq.paged_attention_quant if quant else pa.paged_attention
        plain = paq.paged_attention_quant_plain if quant \
            else pa.paged_attention_plain
        shapes, worst = [], {"float32": 0.0, "bfloat16": 0.0}
        launches_before = mod.launches
        for tag, c in cases:
            for dt in (torch.bfloat16, torch.float32):
                name = str(dt).replace("torch.", "")
                esz = 2 if dt == torch.bfloat16 else 4
                nbytes, ops_ = _paged_bytes_ops(c, quant, esz)
                n_sets = max(2, min(128, math.ceil(L2_COLD_BYTES / nbytes)))
                sets = [_paged_inputs(dev, gen, c["b"], c["kv"], c["rep"],
                                      c["d"], c["bs"], c["nb"], c["lengths"],
                                      dt, quant) for _ in range(n_sets)]
                args = sets[0]
                scale = c["d"] ** -0.5
                got = kern(*args, scale=scale).float()
                want = plain(*args, scale=scale).float()
                torch.cuda.synchronize()
                # float32: both sum in float32 in another order; bfloat16:
                # the plain version rounds its products to bfloat16
                tol = 2e-5 if dt == torch.float32 else 2e-2
                err = float((got - want).abs().max())
                worst[name] = max(worst[name], err)
                if not bool(torch.isfinite(got).all()) or \
                        not torch.allclose(got, want, rtol=tol, atol=tol):
                    raise AssertionError(f"{mod.__name__} != plain at {tag} "
                                         f"{name}: max abs err {err}")
                # the same draw without poison gives the same output bits
                g2 = torch.Generator(device=dev)
                g2.manual_seed(1234)
                clean = _paged_inputs(dev, g2, c["b"], c["kv"], c["rep"],
                                      c["d"], c["bs"], c["nb"], c["lengths"],
                                      dt, quant, poison=False)
                g2.manual_seed(1234)
                dirty = _paged_inputs(dev, g2, c["b"], c["kv"], c["rep"],
                                      c["d"], c["bs"], c["nb"], c["lengths"],
                                      dt, quant, poison=True)
                if not torch.equal(kern(*clean, scale=scale),
                                   kern(*dirty, scale=scale)):
                    raise AssertionError(f"{mod.__name__}: poisoned masked "
                                         f"positions changed the output "
                                         f"({tag} {name})")
                del clean, dirty, got, want
                ms = time_ms([lambda a=a: kern(*a, scale=scale)
                              for a in sets], 200)
                plain_ms = time_ms([lambda: plain(*args, scale=scale)], 5,
                                   graph=False)
                lib = [_sdpa_inputs(a, c, quant, dt) for a in sets]
                lib_ms = time_ms([lambda x=x: F.scaled_dot_product_attention(
                    x[0], x[1], x[2], attn_mask=x[3], scale=scale,
                    enable_gqa=True) for x in lib], 200)
                t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
                t_ops = ops_ / PEAK_FLOPS["float32"] * 1e3
                bound = max(t_bytes, t_ops)
                sms, ctas = pa.card_ctas_per_sm(
                    quant, dt == torch.bfloat16, c["rep"], c["d"], dev.index)
                shapes.append({"case": tag, "dtype": name, "batch": c["b"],
                               "heads": c["kv"] * c["rep"],
                               "kv_heads": c["kv"], "head_dim": c["d"],
                               "block_size": c["bs"],
                               "blocks_per_slot": c["nb"],
                               "lengths": c["lengths"],
                               "ctas_per_sm": ctas,
                               "split_plan": pa.split_plan(
                                   c["b"], c["kv"], c["nb"], c["bs"], sms,
                                   ctas),
                               "input_sets": n_sets,
                               "l2_cold": n_sets * nbytes >= L2_COLD_BYTES,
                               "max_abs_err": err,
                               "ms": ms, "plain_ms": plain_ms,
                               "library_ms": lib_ms, "bound_ms": bound,
                               "bound_share": bound / ms,
                               "bound_by": "bytes" if t_bytes >= t_ops
                               else "operations"})
                del sets, args, lib
                torch.cuda.empty_cache()
        mod.launches = launches_before     # comparisons do not count
        head = shapes[0]                   # the path's shape in bfloat16
        entries[quant] = dict(
            KERNEL_D if quant else KERNEL_C,
            max_abs_err=worst["bfloat16"],
            max_abs_err_float32=worst["float32"],
            tolerance="float32: rtol=atol=2e-5; bfloat16: rtol=atol=2e-2 "
            "(the plain version rounds its products to bfloat16); poisoned "
            "masked positions: output bits equal",
            numbers_are="one call (split pass + merge pass) at the main "
            "path's shape (B=8, H=32, KV=8, D=128, bs=16, nb=32, bfloat16, "
            "lengths of a phase-6 decode step)",
            timing="ms, library_ms: device time (CUDA graph replay) with a "
            "cold L2: the calls cycle through input sets whose reads exceed "
            "twice the L2; plain_ms: eager calls; library_ms is "
            "scaled_dot_product_attention(enable_gqa=True) on K/V gathered "
            "beforehand" + (" and dequantized beforehand" if quant else "")
            + ": the gather" + (" and the dequantization are" if quant
                                 else " is") + " not in its time",
            ms=head["ms"], plain_ms=head["plain_ms"],
            library_ms=head["library_ms"], bound_ms=head["bound_ms"],
            bound_share=head["bound_share"],
            bound_by=head["bound_by"], shapes=shapes,
            **{case: next(({k: r[k] for k in (
                "ms", "plain_ms", "library_ms", "bound_ms", "bound_share",
                "split_plan", "ctas_per_sm", "max_abs_err")}
                for r in shapes if r["case"] == case
                and r["dtype"] == "bfloat16"), None)
               for case in ("moe", "trained")})
    return entries[False], entries[True]


# ---------------------------------------------------------------------------
# phases 6 and 7: continuous scheduler + paged KV cache + chunked admission
# ---------------------------------------------------------------------------

def chat_requests(seed, vocab, max_new=32, prefix=192, bs=16):
    """Twelve chat requests: a shared 192-token system prefix (12 full
    blocks) and a user suffix of 8-160 tokens each for requests 0-7;
    requests 8-11 are second turns of requests 4-7 (their whole prompt plus
    8-40 new tokens), admitted while those are still decoding, so they share
    their full blocks and the partial tail block (copy-on-write)."""
    import numpy as np
    from repro_torch.serving import Request
    rng = np.random.default_rng(seed)
    system = rng.integers(0, vocab, size=prefix).tolist()
    prompts = []
    for i in range(8):
        n = int(rng.integers(8, 161))
        if i >= 4 and (prefix + n) % bs == 0:
            n += 1                        # keep a partial tail to share
        prompts.append(system + rng.integers(0, vocab, size=n).tolist())
    for i in range(4):
        n = int(rng.integers(8, 41))
        prompts.append(prompts[4 + i] + rng.integers(0, vocab,
                                                     size=n).tolist())
    return [Request(p, max_new, request_id=i) for i, p in enumerate(prompts)]


class _Counted:
    """Wraps an engine entry point: counts its calls, and optionally keeps
    what ``record(args, out)`` returns for each."""

    def __init__(self, fn, record=None):
        self.fn, self.record, self.calls, self.log = fn, record, 0, []

    def __call__(self, *args, **kw):
        self.calls += 1
        out = self.fn(*args, **kw)
        if self.record is not None:
            self.log.append(self.record(args, out))
        return out


def paged_config(**over):
    from repro_torch.serving import ServeConfig
    kw = dict(scheduler="continuous", kv_backend="paged", max_slots=8,
              max_len=512, block_size=16, prefill_chunk=64,
              quantize_weights="squant", weight_bits=8,
              dequantize_for_compute=False)
    kw.update(over)
    return ServeConfig(**kw)


def _retyped(tree, dtype):
    """The serving tree with its model-dtype leaves (the embedding, an
    untied fp head) cast to ``dtype``; quantized linears and float32 norms
    are shared as they are."""
    out = dict(tree)
    out["embedding"] = {"embedding": tree["embedding"]["embedding"].to(dtype)}
    head = tree.get("lm_head", {}).get("w")
    if isinstance(head, torch.Tensor):
        out["lm_head"] = {"w": head.to(dtype)}
    return out


def measure_agreement(dev, model, tree, reqs, quantize_kv, dtype,
                      **oracle_over):
    """Teacher-forced greedy agreement of the paged chunked engine (phase 6's
    serve config, ``quantize_kv`` as given) against its oracle on the same
    quantized tree, with activations in ``dtype``: the fp paged pool for an
    int8 pool, else the contiguous continuous engine without chunking and
    with ONE slot — a contiguous pool left-pads every prompt to the shared
    clock and the pad tokens are attended (the reference's semantics), so
    only a one-slot run sees the paged slots' context (positions 0..L-1).
    ``oracle_over`` changes the oracle's serve config. Returns the report
    and the oracle's seconds."""
    from repro_torch.models.model import build_model
    from repro_torch.serving import ServeEngine, WeightStore
    from repro_torch.serving.equivalence import (greedy_token_agreement,
                                                 oracle_tokens)

    name = str(dtype).replace("torch.", "")
    m = build_model(dataclasses.replace(model.cfg, dtype=name))
    store = WeightStore(serving_params=_retyped(tree, dtype), device=dev)
    ocfg = paged_config(**oracle_over) if quantize_kv else paged_config(
        **dict(dict(kv_backend="contiguous", prefill_chunk=0, max_slots=1),
               **oracle_over))
    t0 = time.perf_counter()
    eng = ServeEngine(m, None, ocfg, store=store, device=dev)
    oracle = oracle_tokens(eng.generate(reqs))
    torch.cuda.synchronize()
    oracle_s = time.perf_counter() - t0
    eng.close()
    eng = ServeEngine(m, None, paged_config(quantize_kv=quantize_kv),
                      store=store, device=dev)
    rep = greedy_token_agreement(eng, reqs, oracle)
    eng.close()
    return rep, oracle_s, oracle


def oracle_margins(dev, model, tree, reqs, forced):
    """The float32 one-slot contiguous oracle (measure_agreement's) teacher-
    forced on ``forced`` ({request id: tokens}): its top-1 minus top-2 logit
    at every sampled position, {(request id, position): margin}."""
    from repro_torch.models.model import build_model
    from repro_torch.serving import ServeEngine, WeightStore
    from repro_torch.serving import scheduler as sched

    m = build_model(dataclasses.replace(model.cfg, dtype="float32"))
    store = WeightStore(serving_params=_retyped(tree, torch.float32),
                        device=dev)
    eng = ServeEngine(m, None, paged_config(
        kv_backend="contiguous", prefill_chunk=0, max_slots=1), store=store,
        device=dev)
    margins, where = [], []
    real = sched.sample

    def sample(logits, *a, **kw):              # one slot: one row a step
        top = logits.float().topk(2, dim=-1).values[0]
        margins.append(float(top[0] - top[1]))
        return real(logits, *a, **kw)

    def override(rid, t, proposed):
        where.append((rid, t))
        toks = forced.get(rid)
        return None if toks is None or t >= len(toks) else int(toks[t])

    sched.sample = sample
    eng.scheduler.token_override = override
    try:
        eng.generate(reqs)
    finally:
        sched.sample = real
    if len(where) != len(margins):
        raise AssertionError(f"{len(margins)} sampling steps, {len(where)} "
                             "sampled positions: not one slot")
    eng.close()
    return dict(zip(where, margins))


def _percentiles(xs):
    """p50/p95/p99 of ``xs``, as ``ContinuousScheduler.stats`` gives them."""
    import numpy as np
    return {f"p{q}": float(np.percentile(np.asarray(xs, np.float64), q))
            for q in (50, 95, 99)} if xs else {}


def _quantiles(xs):
    import numpy as np
    if not xs:
        return None
    q = np.quantile(np.asarray(xs, np.float64), [0.0, 0.1, 0.5, 0.9, 1.0])
    return dict(zip(("min", "p10", "p50", "p90", "max"), q.tolist()))


def _tree_bytes(tree):
    """Bytes of the tensors of a parameter tree (nested dicts and lists; a
    quantized leaf's codes and scales)."""
    from repro_torch.quant.qtypes import QuantizedTensor
    if torch.is_tensor(tree):
        return tree.numel() * tree.element_size()
    if isinstance(tree, QuantizedTensor):
        return _tree_bytes(tree.data) + _tree_bytes(tree.scale)
    items = tree.values() if isinstance(tree, dict) else \
        tree if isinstance(tree, (list, tuple)) else ()
    return sum(_tree_bytes(t) for t in items)


TRAIN_STEPS_BEFORE = 600   # 11b's and 11c (ii)'s steps before 15l-n came


def _steps_cut(steps):
    """The ``reduced`` entry of 11b's and 11c (ii)'s lines: None at the
    steps they ran before the cut, else the cut and why it was made."""
    if steps == TRAIN_STEPS_BEFORE:
        return None
    return {"train_steps": f"{TRAIN_STEPS_BEFORE} -> {steps} (cut to 300 "
                           f"when phases 15l-n came, to 200 when 15o came, "
                           f"to keep the script inside its time limit)"}


def _depth_cut(layers, full=40):
    """The ``reduced`` entry of a granite phase's line: None at full depth,
    else the cut and why it was made."""
    if layers == full:
        return None
    return {"n_layers": f"{full} -> {layers} (phases 8 and 9a were cut "
                        f"to 12 when phase 15 came, to 6 when phases 15l-n "
                        f"came and to 4 when 15o (vi)-(vii) and 15p-q came, "
                        f"to keep the script within its time limit)"}


_PHASE_CLOCK = [time.perf_counter()]   # when the last phase_memory ran


def phase_memory(label, log):
    """Device memory still allocated after a phase, as it returns, after a
    garbage collection and after PyTorch's cuBLAS workspaces are freed,
    into ``log``, with the package's and this script's objects that only
    the collection freed (a reference cycle held them) and the device
    bytes of the tensors among them. Fails if anything is left after
    that: every phase closes what it made."""
    import gc
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    gc.set_debug(gc.DEBUG_SAVEALL)
    try:
        gc.collect()
        cyclic, cuda_bytes = {}, 0
        for o in gc.garbage:
            mod = getattr(type(o), "__module__", "") or ""
            if mod.startswith("repro_torch") or mod == __name__:
                name = f"{mod}.{type(o).__qualname__}"
                cyclic[name] = cyclic.get(name, 0) + 1
            elif torch.is_tensor(o) and o.is_cuda:
                cuda_bytes += o.numel() * o.element_size()
    finally:
        gc.set_debug(0)
        gc.garbage.clear()
    gc.collect()
    after_gc = torch.cuda.memory_allocated()
    # PyTorch keeps a cuBLAS workspace for every stream a matmul ran on
    # (each engine's capture stream, each store's staging stream)
    torch._C._cuda_clearCublasWorkspaces()
    torch.cuda.empty_cache()
    left = torch.cuda.memory_allocated()
    now = time.perf_counter()
    since, _PHASE_CLOCK[0] = now - _PHASE_CLOCK[0], now
    log.append({"after": label, "seconds_since_previous_entry": since,
                "allocated_gb": held / 1e9,
                "allocated_gb_after_gc": after_gc / 1e9,
                "allocated_gb_after_cublas_workspaces": left / 1e9,
                "cyclic_objects": cyclic,
                "cyclic_cuda_tensor_gb": cuda_bytes / 1e9})
    if left:
        raise AssertionError(f"phase {label} left {left} bytes allocated "
                             f"on the device: {log[-1]}")


def _reset_launches(dm, pa, paq, sf):
    sf.launches = sf.scale_launches = dm.launches = pa.launches = \
        paq.launches = 0
    sf.launches_by_route = dict.fromkeys(sf.ROUTES, 0)
    dm.launches_by_variant = dict.fromkeys(dm.VARIANTS, 0)
    dm.launches_by_shape = {}


def _variant(rows, n=128):
    """Kernel B's variant for bfloat16 activations of ``rows`` rows on the
    path's aligned shapes, with ``n`` input columns
    (``dequant_matmul.variant``: above 16 rows an N that is not a multiple
    of 128 takes ``tiled``)."""
    if rows <= 16:
        return "tcgemv"
    return "mma" if n % 128 == 0 else "tiled"


def kernel_b_forward(cfg, layers, rows, dropless):
    """Kernel B launches by variant that one forward of ``rows`` tokens
    makes, split by part: ``attention`` (wq, wk, wv, wo of every layer) and
    ``ffn`` (wi, wg, wdown of a dense layer) or ``experts`` (the same three
    banks, one launch per expert on its capacity's rows: ``rows`` when
    ``dropless``, else the GShard capacity rounded up)."""
    from repro_torch.models.transformer import layer_plan
    plan = layer_plan(cfg) * (layers // len(layer_plan(cfg)))
    out = {"attention": {}, "ffn": {}, "experts": {}}

    def add(part, var, n):
        out[part][var] = out[part].get(var, 0) + n

    for _, moe in plan:
        add("attention", _variant(rows), 4)
        if not moe:
            add("ffn", _variant(rows), 3)
            continue
        e, k = cfg.moe.n_experts, cfg.moe.top_k
        cap = rows if dropless else min(rows, max(1, math.ceil(
            rows * k * cfg.moe.capacity_factor / e)))
        add("experts", _variant(cap), 3 * e)
    return {k: v for k, v in out.items() if v}


def kernel_b_parts(cfg, by_shape):
    """Kernel B's measured launches (``launches_by_shape``: by variant and
    weight (M, N), as the wrapper counts them and a graph's nodes hold
    them) by part, as :func:`kernel_b_forward` splits them: a shape of
    wq/wk/wv/wo is ``attention``, one of wi/wg/wdown ``experts`` in an MoE
    stack, else ``ffn``."""
    from repro_torch.models.transformer import layer_plan
    moe = [m for _, m in layer_plan(cfg)]
    if any(moe) and not all(moe):
        raise ValueError("dense and MoE layers share the FFN's shapes")
    q, kv = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
    part = {(q, cfg.d_model): "attention", (kv, cfg.d_model): "attention",
            (cfg.d_model, q): "attention"}
    for mn in ((cfg.d_ff, cfg.d_model), (cfg.d_model, cfg.d_ff)):
        if mn in part:
            raise ValueError(f"an FFN shape {mn} is an attention shape")
        part[mn] = "experts" if all(moe) else "ffn"
    out = {}
    for key, n in by_shape.items():
        if not n:
            continue
        var, shape = key.split()
        mn = tuple(int(v) for v in shape.split("x"))
        if mn not in part:
            raise AssertionError(f"kernel B launched at {mn}, no linear's "
                                 f"shape of {cfg.name}")
        by = out.setdefault(part[mn], {})
        by[var] = by.get(var, 0) + n
    return out


def _add_counts(a, b, times=1):
    out = {k: dict(v) for k, v in a.items()}
    for part, by in b.items():
        for var, n in by.items():
            out.setdefault(part, {})
            out[part][var] = out[part].get(var, 0) + times * n
    return out


def drive_continuous(dev, seed, layers, phase, quantize_kv=False,
                     arch="granite-3-8b", agreement=True,
                     capture_all_widths=True, reduced=None, before_close=None):
    """The continuous + paged + chunked path on granite-3-8b w8: one counted
    run through ``ServeEngine.generate`` (the main path, its decode step and
    chunk widths captured as CUDA graphs), two repeats of the same requests
    on that engine (captures only for chunk widths the first run did not
    have, none in the third), a fresh request set, the same configuration
    run eagerly (``capture=False``) on the same tree and requests (tokens
    bit-identical, launch counts equal: the main run's replays measured by
    ``ServeEngine.replay_launches``), every chunk width captured
    (``all_widths``), then the agreement check against its oracle engine,
    which shares the quantized tree (``agreement``). ``arch`` names the
    model, ``reduced`` the depth cut listed in the phase's line;
    ``before_close(engine)`` runs before the engine closes. Returns
    kernel A's, kernel B's and kernel C's (or D's) launches, the context
    lengths of the step with the most context, and the phase's line."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import dequant_matmul as dm
    from repro_torch.kernels import ops
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import paged_attention_quant as paq
    from repro_torch.kernels import squant_flip as sf
    from repro_torch.models.model import build_model
    from repro_torch.serving import ServeEngine, WeightStore
    from repro_torch.serving.equivalence import AGREEMENT_BUDGETS

    full = get_config(arch)
    cfg = dataclasses.replace(full, n_layers=layers)
    model = build_model(cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    t0 = time.perf_counter()
    params = model.init(gen, device=dev)
    torch.cuda.synchronize()
    init_ms = (time.perf_counter() - t0) * 1e3
    reqs = chat_requests(seed, cfg.vocab)
    kernel_mod = paq if quantize_kv else pa

    _reset_launches(dm, pa, paq, sf)
    weights_bytes = _tree_bytes(params)
    allocated = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    eng = ServeEngine(model, params, paged_config(quantize_kv=quantize_kv),
                      device=dev)
    quant_peak_gb = (torch.cuda.max_memory_allocated() - allocated) / 1e9
    del params
    torch.cuda.empty_cache()
    a_launches = sf.launches
    qrep = eng.quant_report
    quantize = {"report": qrep.summary(), "total_ms": qrep.total_millis,
                "dispatch_ms": qrep.dispatch_millis,
                "sync_ms": qrep.sync_millis,
                "staged_ms": eng.store.current.staged_ms,
                "buckets": [{"key": b.key, "route": b.route,
                             "dispatch_ms": b.dispatch_millis}
                            for b in qrep.buckets],
                "stacked_buckets": sum(b.route == "stacked"
                                       for b in qrep.buckets),
                "launches": {"squant_flip": a_launches,
                             "squant_flip_by_route": dict(
                                 sf.launches_by_route),
                             "squant_scale": sf.scale_launches},
                "peak_gb_above_weights": quant_peak_gb,
                "weights_gb": weights_bytes / 1e9,
                "allocated_gb_before": allocated / 1e9, "init_ms": init_ms}
    if quantize["stacked_buckets"] or not all("g128" in b.key
                                              for b in qrep.buckets):
        raise AssertionError(f"a bucket took the stacked route or is not "
                             f"grouped: {quantize['buckets']}")
    kv = eng.scheduler.kv
    dec = eng._decode = _Counted(eng._decode,
                                 lambda a, o: kv._lengths.copy().tolist())
    chk = eng._prefill_chunk = _Counted(
        eng._prefill_chunk, lambda a, o: int(a[1]["tokens"].numel()))
    pre = eng._prefill = _Counted(eng._prefill)
    torch.cuda.reset_peak_memory_stats()
    _reset_launches(dm, pa, paq, sf)
    t0 = time.perf_counter()
    outs = eng.generate(reqs)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    # the main run's launches: what the wrappers issued (eager warm-ups,
    # everything not replayed) plus what its replays launched, measured:
    # each graph's kernel nodes read from the driver, counted by name, held
    # to its capture's tally, times its replays
    issued = ops.launch_counts()
    replayed = eng.replay_launches()
    replays = {f"{name}{list(key)}": g.replays
               for name, gs in eng._graphs.items() for key, g in gs.items()}
    captured_launches = ops.combine_launches(issued, replayed)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    st = eng.stats()["scheduler"]
    graphs = eng.stats()["graphs"]
    tc = dict(eng.trace_counts)
    widths = sorted(set(chk.log))
    if tc != {"prefill": 0, "prefill_chunk": len(widths), "decode": 1,
              "admit": 0}:
        raise AssertionError(f"captures {tc}: expected one decode capture "
                             f"and one per chunk width {widths}")
    if chk.calls != st.chunk_steps or pre.calls != 0:
        raise AssertionError(f"chunk forwards {chk.calls} vs stats "
                             f"{st.chunk_steps}, monolithic {pre.calls}")
    # what the main run's launches must be: kernel B on every linear of
    # every forward (an MoE layer: once per expert and bank), through
    # tcgemv up to 16 rows (bfloat16), mma above, never gemv or tiled; C
    # (or D) once per layer and decode
    big = sum(1 for rows in chk.log if rows > 16)
    b_parts = _add_counts({}, kernel_b_forward(cfg, layers,
                                               eng.cfg.max_slots, True),
                          dec.calls)
    for rows in chk.log:
        b_parts = _add_counts(b_parts, kernel_b_forward(cfg, layers, rows,
                                                        False))
    want_by = _variants()
    for by in b_parts.values():
        for var, n in by.items():
            want_by[var] += n
    want_b, want_k = sum(want_by.values()), layers * dec.calls
    b_launches = captured_launches["dequant_matmul.launches"]
    b_by_variant = captured_launches["dequant_matmul.launches_by_variant"]
    k_launches = captured_launches[
        f"{kernel_mod.__name__.split('.')[-1]}.launches"]
    other = captured_launches[
        f"{(pa if quantize_kv else paq).__name__.split('.')[-1]}.launches"]
    if b_launches != want_b or b_launches == 0:
        raise AssertionError(f"kernel B launches {b_launches}, path implies "
                             f"{want_b}")
    if b_by_variant != want_by:
        raise AssertionError(f"kernel B by variant {b_by_variant}, path "
                             f"implies {want_by}")
    # the same launches by part, as counted: the wrappers' and the graph
    # nodes' (M, N) of every launch
    b_parts_measured = kernel_b_parts(
        cfg, captured_launches["dequant_matmul.launches_by_shape"])
    if b_parts_measured != {p: {v: n for v, n in by.items() if n}
                            for p, by in b_parts.items()}:
        raise AssertionError(f"kernel B by part {b_parts_measured}, path "
                             f"implies {b_parts}")
    if k_launches != want_k or k_launches == 0 or other:
        raise AssertionError(f"{kernel_mod.__name__} launches {k_launches} "
                             f"(other paged kernel {other}), path implies "
                             f"{want_k}")
    kv.check_invariants()
    kst = st.kv
    if kst["blocks_active"] or kst["blocks_reserved"]:
        raise AssertionError(f"blocks not returned after the run: {kst}")
    if not (kst["prefix_hits"] and kst["cow_copies"]):
        raise AssertionError(f"no prefix hit or no copy-on-write: {kst}")
    if st.admitted != len(reqs) or st.waves != 1 or st.pendings_started < 2:
        raise AssertionError(f"expected one fresh wave and mid-flight "
                             f"admissions: {st}")
    for o, r in zip(outs, reqs):
        if len(o.tokens) != r.max_new_tokens or \
                not all(0 <= t < cfg.vocab for t in o.tokens):
            raise AssertionError(f"request {r.request_id}: bad tokens")

    # the main run's forwards, before the repeats add to the counts
    n_dec, n_chk, dec_log = dec.calls, chk.calls, list(dec.log)
    # the same requests again: the prefix registry now shortens every
    # suffix, so the second run may use widths the first did not (one
    # capture each); the third repeats the second's shapes exactly
    repeats = []
    for _ in range(2):
        n0 = len(chk.log)
        before = dict(eng.trace_counts)
        steps0 = list(eng.scheduler.step_ms_log)
        t0 = time.perf_counter()
        eng.generate(reqs)
        torch.cuda.synchronize()
        steps = list(eng.scheduler.step_ms_log)[len(steps0):]
        widths_all = sorted(set(chk.log))
        new_widths = sorted(set(chk.log[n0:]) - set(chk.log[:n0]))
        repeats.append({"run_s": time.perf_counter() - t0,
                        "step_ms": _percentiles(steps),
                        "chunk_widths": sorted(set(chk.log[n0:])),
                        "new_captures": {k: eng.trace_counts[k] - before[k]
                                         for k in before}})
        if eng.trace_counts != dict(tc, prefill_chunk=len(widths_all)) \
                or repeats[-1]["new_captures"]["prefill_chunk"] \
                != len(new_widths):
            raise AssertionError(f"repeated run: captures "
                                 f"{eng.trace_counts}, chunk widths so far "
                                 f"{widths_all}")
    if any(repeats[-1]["new_captures"].values()):
        raise AssertionError(f"a run repeating the last one's shapes "
                             f"captured again: {repeats[-1]}")
    kv.check_invariants()
    # fresh traffic after those: another system prefix and other suffix
    # lengths, so new chunk widths are captured while requests wait
    fresh = chat_requests(seed + 1, cfg.vocab)
    before, ms0 = dict(eng.trace_counts), eng.capture_ms
    steps0 = list(eng.scheduler.step_ms_log)
    t0 = time.perf_counter()
    fresh_outs = eng.generate(fresh)
    torch.cuda.synchronize()
    fresh_run = {"run_s": time.perf_counter() - t0,
                 "step_ms": _percentiles(
                     list(eng.scheduler.step_ms_log)[len(steps0):]),
                 "prefill_ms_per_admission": _percentiles(
                     [o.prefill_ms for o in fresh_outs]),
                 "new_captures": {k: eng.trace_counts[k] - before[k]
                                  for k in before},
                 "capture_ms": eng.capture_ms - ms0}
    kv.check_invariants()

    # the same configuration eagerly, on the same tree and requests
    eager = ServeEngine(model, None, paged_config(quantize_kv=quantize_kv),
                        store=WeightStore(serving_params=eng.params,
                                          device=dev),
                        device=dev, capture=False)
    _reset_launches(dm, pa, paq, sf)
    t0 = time.perf_counter()
    eager_outs = eager.generate(reqs)
    torch.cuda.synchronize()
    eager_run_s = time.perf_counter() - t0
    eager_launches = ops.launch_counts()
    est = eager.stats()
    eager.close()
    del eager
    torch.cuda.empty_cache()
    differing = [r.request_id for o, e, r in zip(outs, eager_outs, reqs)
                 if o.tokens != e.tokens]
    if differing:
        raise AssertionError(f"captured tokens differ from the eager path's "
                             f"for requests {differing}")
    if est["trace_counts"] != dict.fromkeys(tc, 0):
        raise AssertionError(f"eager engine captured: {est['trace_counts']}")

    if eager_launches != captured_launches:
        raise AssertionError(f"launches captured {captured_launches} vs "
                             f"eager {eager_launches}")

    # the cost of capturing every chunk width up front: each width of 1 to
    # prefill_chunk not captured yet, driven once on the one-row side cache
    all_widths = None
    if capture_all_widths:
        side = kv.side_cache(1)
        rng = torch.Generator().manual_seed(seed)
        n0, ms0 = eng.trace_counts["prefill_chunk"], eng.capture_ms
        for n in range(1, eng.cfg.prefill_chunk + 1):
            t, clock = kv.chunk_inputs(torch.randint(
                0, cfg.vocab, (n,), generator=rng).numpy(), 0)
            chk.fn(eng.params, {"tokens": t}, dict(side, pos=clock))
        torch.cuda.synchronize()
        all_widths = {"widths": eng.cfg.prefill_chunk,
                      "captured_now": eng.trace_counts["prefill_chunk"] - n0,
                      "capture_ms_now": eng.capture_ms - ms0,
                      "graphs": eng.stats()["graphs"]}
        if eng.trace_counts["prefill_chunk"] != eng.cfg.prefill_chunk:
            raise AssertionError(f"captures {eng.trace_counts} after "
                                 f"driving every width 1.."
                                 f"{eng.cfg.prefill_chunk}")

    # agreement, measured with bfloat16 activations (the main path's) and
    # with float32 activations on the same quantized tree; the budget is
    # held in float32, where the random model's near-tied logits are not
    # flipped by bfloat16 rounding (PERF.md, ROADMAP "Faults")
    label = "int8 KV vs fp paged pool" if quantize_kv else \
        "paged vs contiguous (one slot)"
    budget = AGREEMENT_BUDGETS["int8_kv"] if quantize_kv else 0.98
    rep = rep16 = oracle_s = oracle32_s = near_ties = None
    if agreement:
        rep16, oracle_s, oracle16 = measure_agreement(
            dev, model, eng.params, reqs, quantize_kv, torch.bfloat16)
        rep, oracle32_s, _ = measure_agreement(dev, model, eng.params, reqs,
                                               quantize_kv, torch.float32)
    if agreement and not quantize_kv:
        # where the bf16 token differs from the bf16 oracle's: the float32
        # oracle's top-2 logit margin on the same (teacher-forced) context,
        # beside the margins at every compared position
        margin = oracle_margins(dev, model, eng.params, reqs, oracle16)
        missed = [margin[p] for p in rep16.mismatches if p in margin]
        near_ties = {"disagreements": len(rep16.mismatches),
                     "with_margin": len(missed),
                     "margin_at_disagreements": _quantiles(missed),
                     "margins_sorted": sorted(missed),
                     "margin_at_all_positions": _quantiles(
                         list(margin.values())),
                     "positions": len(margin)}
    entry = {"phase": phase, "model": cfg.name, "layers": layers,
             "full_depth": layers == full.n_layers, "reduced": reduced,
             "d_model": cfg.d_model, "d_ff": cfg.d_ff, "vocab": cfg.vocab,
             "moe": dataclasses.asdict(cfg.moe) if cfg.moe else None,
             "weight_bits": 8, "quantize_kv": quantize_kv,
             "quantize": quantize,
             "serve_config": {k: getattr(eng.cfg, k) for k in (
                 "scheduler", "kv_backend", "max_slots", "max_len",
                 "block_size", "prefill_chunk")},
             "requests": len(reqs),
             "prompt_lengths": [len(r.prompt) for r in reqs],
             "max_new_tokens": reqs[0].max_new_tokens,
             "run_s": run_s, "oracle_run_s_bfloat16": oracle_s,
             "oracle_run_s_float32": oracle32_s,
             "sampling_steps": st.steps, "decode_forwards": n_dec,
             "chunk_forwards": n_chk,
             "chunk_forwards_over_16_rows": big,
             "step_ms": st.step_ms,
             "trace_counts": tc, "chunk_widths": widths,
             "graphs": graphs,
             "repeat_runs_note": "the same requests again; the third run "
                                 "has every width it uses already captured",
             "repeat_runs": repeats,
             "fresh_run": fresh_run, "all_widths_captured": all_widths,
             "eager": {"run_s": eager_run_s,
                       "step_ms": est["scheduler"].step_ms,
                       "launches": eager_launches,
                       "tokens_equal_captured": True},
             "prefill_ms_per_admission": [o.prefill_ms for o in outs],
             "kv": kst, "peak_memory_gb": peak_gb,
             "launches": {"squant_flip": a_launches,
                          "dequant_matmul": b_launches,
                          "dequant_matmul_by_variant": b_by_variant,
                          "dequant_matmul_by_part": b_parts_measured,
                          "dequant_matmul_by_shape": {
                              k: v for k, v in captured_launches[
                                  "dequant_matmul.launches_by_shape"].items()
                              if v},
                          kernel_mod.__name__.split(".")[-1]: k_launches},
             "launches_issued_by_wrappers": issued,
             "launches_measured_in_replays": replayed,
             "replays": replays,
             "mma_plans": dm.cached_plans("mma"),
             "agreement": None if not agreement else {
                 "against": label, "budget": budget,
                 "gated": "float32 activations",
                 "rate": rep.rate, "matched": rep.matched,
                 "compared": rep.compared,
                 "rate_bfloat16": rep16.rate,
                 "matched_bfloat16": rep16.matched,
                 "bfloat16_disagreements_float32_margin": near_ties},
             "tokens": [o.tokens for o in outs]}
    emit(entry)
    if agreement and rep.rate < budget:
        raise AssertionError(f"{label}: teacher-forced greedy agreement "
                             f"{rep.rate:.4f} < {budget}")
    lengths = max(dec_log, key=sum)        # the step with the most context
    if before_close is not None:
        before_close(eng)
    eng.close()
    del eng, outs
    torch.cuda.empty_cache()
    return a_launches, b_launches, k_launches, lengths, entry


def paged_vs_plain(dev, seed, arch="granite-3-8b"):
    """The paged continuous path at 2 layers in float32, once through the
    kernels and once under ``force_backend("ref")``, on one quantized tree:
    greedy tokens equal, logits within 1e-3 of the largest."""
    from repro_torch.configs import get_config
    from repro_torch.core.pipeline import quantize_tree
    from repro_torch.kernels import ops
    from repro_torch.models.model import build_model
    from repro_torch.serving import ServeEngine, WeightStore

    cfg = dataclasses.replace(get_config(arch), n_layers=2, dtype="float32")
    model = build_model(cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    params = model.init(gen, device=dev)
    tree, _ = quantize_tree(params, method="squant", bits=8, device=dev)
    del params
    reqs = chat_requests(seed, cfg.vocab, max_new=8, prefix=32)[:6]

    def run():
        eng = ServeEngine(model, None, paged_config(
            max_slots=4, max_len=256, prefill_chunk=16),
            store=WeightStore(serving_params=tree, device=dev), device=dev)
        sch = eng.scheduler

        def keep(a, o):
            # only the rows of live slots: retired rows read the trash
            # block, whose content depends on the order of racing writes
            rows = [i for i, s in enumerate(sch.slots) if s is not None]
            return o[0][rows].float().cpu()

        dec = eng._decode = _Counted(eng._decode, keep)
        chk = eng._prefill_chunk = _Counted(eng._prefill_chunk,
                                            lambda a, o: o[0].float().cpu())
        c0 = ops.launch_counts()
        outs = eng.generate(reqs)
        # what the wrappers issued plus what the replays launched
        launched = ops.combine_launches(
            ops.launches_between(c0, ops.launch_counts()),
            eng.replay_launches())
        eng.close()
        return ([o.tokens for o in outs], torch.cat(dec.log),
                torch.cat([x[None] for x in chk.log]),
                _b_by_variant(launched))

    tk, dk, ck, by = run()
    with ops.force_backend("ref"):
        tp, dp, cp, _ = run()
    err = max(float((dk - dp).abs().max()), float((ck - cp).abs().max()))
    mag = max(float(dp.abs().max()), float(cp.abs().max()))
    tol = 1e-3          # of the largest logit: float32 sum order, two layers
    if tk != tp:
        raise AssertionError(f"paged path: greedy tokens differ: {tk} vs {tp}")
    if err > tol * mag:
        raise AssertionError(f"paged path: logits differ by {err} (max "
                             f"|logit| {mag})")
    return {"paged_logits_max_abs_err": err, "paged_logits_max_abs": mag,
            "paged_greedy_tokens_equal": True,
            "paged_decode_forwards": int(dk.shape[0]),
            "paged_dequant_matmul_by_variant": by}


# ---------------------------------------------------------------------------
# phase 8: self-speculative decoding (w4 drafts, w8 verifier) on the paged
# continuous path
# ---------------------------------------------------------------------------

def _tokens_per_s(outs, run_s):
    return sum(len(o.tokens) for o in outs) / run_s


def _spec_path_launches(layers, chunk_rows, verify_s, chain_s, draft_rows):
    """What a speculative run's launches must be: kernel B seven times per
    layer and forward: the verify forward once per position (its B rows,
    ``tcgemv`` int8), the draft chain once per feed (``tcgemv`` int4), the
    chunk forwards as phase 6 (``mma`` above 16 rows), the drafter's
    admission prefill (``mma`` int4 above 16 rows); kernel C once per layer
    and verify position. No decode step runs."""
    big = sum(1 for r in chunk_rows if r > 16)
    draft_big = sum(1 for r in draft_rows if r > 16)
    tc8 = 7 * layers * (sum(verify_s) + len(chunk_rows) - big)
    tc4 = 7 * layers * (sum(chain_s) + len(draft_rows) - draft_big)
    mma8, mma4 = 7 * layers * big, 7 * layers * draft_big
    return {"by_variant": _variants(tcgemv=tc8 + tc4, mma=mma8 + mma4),
            "split": {"tcgemv_int8": tc8, "tcgemv_int4": tc4,
                      "mma_int8": mma8, "mma_int4": mma4},
            "paged_attention": layers * sum(verify_s)}


def _instrument_spec(eng):
    """Counters on a speculative engine's entry points: verify widths,
    chain widths, chunk widths, drafter admission rows, decode calls,
    cycle wall ms and each capture's ms by graph."""
    kv, spec = eng.scheduler.kv, eng.scheduler.spec
    rec = {"verify": _Counted(kv._verify, lambda a, o: int(a[1].shape[1])),
           "chain": _Counted(spec._chain, lambda a, o: int(a[1].shape[1])),
           "chunk": _Counted(eng._prefill_chunk,
                             lambda a, o: int(a[1]["tokens"].numel())),
           "draft_admit": _Counted(spec.admit_slot,
                                   lambda a, o: len(a[1])),
           "decode": _Counted(eng._decode), "cycle_ms": [],
           "capture_ms": []}
    kv._verify, spec._chain = rec["verify"], rec["chain"]
    eng._prefill_chunk, eng._decode = rec["chunk"], rec["decode"]
    spec.admit_slot = rec["draft_admit"]
    run_cycle, capture = spec.run_cycle, eng._capture

    def cycle(*a):
        t0 = time.perf_counter()
        out = run_cycle(*a)                  # ends in the cycle's host sync
        rec["cycle_ms"].append((time.perf_counter() - t0) * 1e3)
        return out

    def captured(fn, params, batch, caches, out, inputs):
        t0 = time.perf_counter()
        res = capture(fn, params, batch, caches, out, inputs)
        rec["capture_ms"].append(
            {"graph": getattr(fn, "__name__", type(fn).__name__),
             "tokens": list(inputs[0].shape),
             "ms": (time.perf_counter() - t0) * 1e3})
        return res
    spec.run_cycle, eng._capture = cycle, captured
    return rec


def _run_counted(eng, reqs, rec=None):
    """One counted run: outputs, seconds, this run's step ms, cycle ms and
    capture log (from ``rec``'s logs), new captures."""
    before = dict(eng.trace_counts)
    steps0 = len(eng.scheduler.step_ms_log)
    n = {k: len(v.log) if isinstance(v, _Counted) else len(v)
         for k, v in (rec or {}).items()}
    t0 = time.perf_counter()
    outs = eng.generate(reqs)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    run = {"run_s": run_s, "tokens_per_s": _tokens_per_s(outs, run_s),
           "step_ms": _percentiles(list(eng.scheduler.step_ms_log)[steps0:]),
           "new_captures": {k: eng.trace_counts[k] - before.get(k, 0)
                            for k in eng.trace_counts}}
    if rec:
        log = {k: (v.log if isinstance(v, _Counted) else v)[n[k]:]
               for k, v in rec.items()}
        run.update(cycle_ms=_percentiles(log["cycle_ms"]),
                   captures=log["capture_ms"],
                   verify_widths=sorted(set(log["verify"])),
                   chain_widths=sorted(set(log["chain"])))
    return outs, run


def drive_speculative(dev, seed, layers, profile=False):
    """Self-speculative decoding on phase 6's paged chunked configuration,
    granite-3-8b full width at ``layers`` layers, bfloat16: the w8 tree
    verifies what the w4 tree of the same fp weights drafts (``draft_k`` 4).
    A captured first run (the main path, launches counted), a second run
    (prefix hits give new chunk widths), a repeat that captures nothing,
    the same configuration eagerly (``capture=False``) and the
    verifier-only engine (phase 6's configuration) on the same trees and
    requests: tokens bit-identical everywhere, launches of the captured run
    equal to the eager run's and to what the path implies. Then the same
    pair in float32 at 2 layers. Returns the main run's kernel B and C
    launches and the drafter's admission prefill row counts."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import dequant_matmul as dm
    from repro_torch.kernels import ops
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import paged_attention_quant as paq
    from repro_torch.kernels import squant_flip as sf
    from repro_torch.models.model import build_model
    from repro_torch.serving import ServeEngine, WeightStore

    spec_kw = dict(speculative=True, draft_bits=4, draft_k=4)
    cfg = dataclasses.replace(get_config("granite-3-8b"), n_layers=layers)
    model = build_model(cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    params = model.init(gen, device=dev)
    reqs = chat_requests(seed, cfg.vocab)

    _reset_launches(dm, pa, paq, sf)
    t0 = time.perf_counter()
    eng = ServeEngine(model, params, paged_config(**spec_kw), device=dev)
    torch.cuda.synchronize()
    stage_ms = (time.perf_counter() - t0) * 1e3
    a_launches, a_scale = sf.launches, sf.scale_launches
    del params
    torch.cuda.empty_cache()
    tree, draft = eng.params, eng.store.current.draft_params

    def shared_store():
        # both trees of the pair, shared (no second quantization)
        return WeightStore(lambda _: (tree, None), fp_params=tree,
                           draft_quantize_fn=lambda _: draft, device=dev)

    rec = _instrument_spec(eng)
    torch.cuda.reset_peak_memory_stats()
    _reset_launches(dm, pa, paq, sf)
    outs, first = _run_counted(eng, reqs, rec)
    issued = ops.launch_counts()
    replayed = eng.replay_launches()
    captured_launches = ops.combine_launches(issued, replayed)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    st = eng.scheduler.stats()
    kv = eng.scheduler.kv
    kv.check_invariants()
    kst = st.kv
    if kst["blocks_active"] or kst["blocks_reserved"]:
        raise AssertionError(f"blocks not returned after the run: {kst}")
    want = _spec_path_launches(layers, rec["chunk"].log, rec["verify"].log,
                               rec["chain"].log, rec["draft_admit"].log)
    b_by = captured_launches["dequant_matmul.launches_by_variant"]
    c_n = captured_launches["paged_attention.launches"]
    if rec["decode"].calls or b_by != want["by_variant"] \
            or c_n != want["paged_attention"] \
            or captured_launches["paged_attention_quant.launches"]:
        raise AssertionError(f"launches {captured_launches}, decode calls "
                             f"{rec['decode'].calls}; the path implies "
                             f"{want}")
    tc = dict(eng.trace_counts)
    if tc["verify"] != len(first["verify_widths"]) \
            or tc["draft_chain"] != len(first["chain_widths"]) \
            or tc["decode"] or tc["prefill"] or tc["admit"] \
            or tc["spec_carry"] or tc["draft_prefill"] or tc["draft_admit"]:
        raise AssertionError(f"captures {tc}: expected one verify graph per "
                             f"S {first['verify_widths']} and one chain "
                             f"graph per k_eff {first['chain_widths']}")
    if not st.draft_tokens_accepted > 0:
        raise AssertionError(f"no draft token accepted: {st}")
    for o, r in zip(outs, reqs):
        if len(o.tokens) != r.max_new_tokens or \
                not all(0 <= t < cfg.vocab for t in o.tokens):
            raise AssertionError(f"request {r.request_id}: bad tokens")
    spec_stats = {k: st[k] for k in (
        "spec_cycles", "draft_tokens_proposed", "draft_tokens_accepted",
        "acceptance_rate", "accepted_len", "steps", "chunk_steps")}
    tokens_total = sum(len(o.tokens) for o in outs)
    # a slot's sampling steps per token it emitted (verifier-only: 1)
    steps_per_token = sum(o.steps for o in outs) / tokens_total

    # the second run meets the widths the prefix hits give; the third
    # repeats its shapes and must capture nothing
    _, second = _run_counted(eng, reqs, rec)
    outs3, repeat = _run_counted(eng, reqs, rec)
    if any(repeat["new_captures"].values()):
        raise AssertionError(f"the repeat captured: {repeat}")
    st3 = eng.scheduler.stats()
    graphs = eng.stats()["graphs"]

    # --profile: one verify forward and one draft chain, replayed at the
    # positions of eight admitted slots of the same traffic
    if profile:
        spec = eng.scheduler.spec
        slots = list(range(8))
        kv.admit([(i, r) for i, r in enumerate(reqs[:8])], slots, None,
                 tree)
        for i, r in zip(slots, reqs):
            spec.admit_slot.fn(i, r.prompt, draft)
            kv.ensure_rows(i, int(kv._lengths[i]), 5)
        kv._push_positions()
        t0_tok = kv.logits.argmax(-1).to(torch.int32)
        run = spec.propose(draft, t0_tok, 4)
        extra = {"layers": layers, "slots": 8, "draft_k": 4,
                 "context_lengths": kv._lengths.tolist()}

        def verify_step():
            (_, verdict), _ = kv._verify.fn(tree, run, kv._cache)
            verdict.cpu()

        def chain_step():
            spec._chain.fn(draft, run, spec._draft_cache)
            run.cpu()

        _profile_steps(verify_step, 4, "8 profile of a verify forward "
                       "(S = 5), captured", extra)
        _profile_steps(chain_step, 4, "8 profile of a draft chain (k = 4, "
                       "5 feeds of the w4 tree), captured", extra)
        for i in slots:
            kv.retire(i)
            spec.retire_slot(i)
        kv.check_invariants()

    # the same configuration eagerly, on the same pair and requests
    eager = ServeEngine(model, None, paged_config(**spec_kw),
                        store=shared_store(), device=dev, capture=False)
    _reset_launches(dm, pa, paq, sf)
    eager_outs, eager_run = _run_counted(eager, reqs)
    eager_launches = ops.launch_counts()
    est = eager.stats()
    eager.close()
    del eager
    if est["trace_counts"] != dict.fromkeys(tc, 0):
        raise AssertionError(f"eager engine captured: {est['trace_counts']}")
    if eager_launches != captured_launches:
        raise AssertionError(f"launches captured {captured_launches} vs "
                             f"eager {eager_launches}")

    # the verifier alone (phase 6's configuration), on the same w8 tree:
    # first run, second, and the repeat timed against the speculative one
    plain = ServeEngine(model, None, paged_config(),
                        store=WeightStore(serving_params=tree, device=dev),
                        device=dev)
    plain_outs, plain_first = _run_counted(plain, reqs)
    _, plain_second = _run_counted(plain, reqs)
    plain_outs3, plain_repeat = _run_counted(plain, reqs)
    plain_repeat["steps_per_token"] = sum(o.steps for o in plain_outs3) / \
        sum(len(o.tokens) for o in plain_outs3)
    plain.close()
    del plain
    torch.cuda.empty_cache()
    for label, got in (("captured", outs), ("eager", eager_outs),
                       ("repeat", outs3)):
        ref = plain_outs3 if label == "repeat" else plain_outs
        differing = [r.request_id for o, p, r in zip(got, ref, reqs)
                     if o.tokens != p.tokens]
        if differing:
            raise AssertionError(f"speculative ({label}) tokens differ from "
                                 f"verifier-only decode for requests "
                                 f"{differing}")

    eng.close()
    del eng, tree, draft, outs, outs3, eager_outs, plain_outs, plain_outs3
    torch.cuda.empty_cache()

    # float32 at 2 layers: speculative tokens == verifier-only tokens
    f32 = build_model(dataclasses.replace(cfg, n_layers=2, dtype="float32"))
    gen.manual_seed(seed)
    p32 = f32.init(gen, device=dev)
    s32 = ServeEngine(f32, p32, paged_config(**spec_kw), device=dev)
    v32 = ServeEngine(f32, None, paged_config(),
                      store=WeightStore(serving_params=s32.params,
                                        device=dev), device=dev)
    del p32
    o32, v32o = s32.generate(reqs), v32.generate(reqs)
    st32 = s32.scheduler.stats()
    differing32 = [r.request_id for a, b, r in zip(o32, v32o, reqs)
                   if a.tokens != b.tokens]
    s32.close()
    v32.close()
    del s32, v32
    torch.cuda.empty_cache()
    if differing32:
        raise AssertionError(f"float32, 2 layers: speculative tokens differ "
                             f"from verifier-only for requests {differing32}")

    emit({"phase": "8 speculative decoding, continuous + paged + chunked, "
          "granite-3-8b w8 verifier, w4 drafter", "model": cfg.name,
          "layers": layers,
          "full_depth": layers == get_config("granite-3-8b").n_layers,
          "reduced": _depth_cut(layers),
          "serve_config": {k: getattr(paged_config(**spec_kw), k) for k in (
              "scheduler", "kv_backend", "max_slots", "max_len",
              "block_size", "prefill_chunk", "speculative", "draft_bits",
              "draft_k", "weight_bits")},
          "requests": len(reqs), "max_new_tokens": reqs[0].max_new_tokens,
          "stage_ms_w8_and_w4": stage_ms,
          "squant_flip_launches_stage": a_launches,
          "squant_scale_launches_stage": a_scale,
          "speculative": spec_stats,
          "steps_per_token": steps_per_token,
          "cycles_per_token": spec_stats["spec_cycles"] / tokens_total,
          "first_run": first, "second_run": second, "repeat_run": repeat,
          "repeat_acceptance_rate": st3["acceptance_rate"],
          "eager_run": eager_run,
          "verifier_only": {"first_run": plain_first,
                            "second_run": plain_second,
                            "repeat_run": plain_repeat},
          "tokens_per_s_repeat": {
              "speculative": repeat["tokens_per_s"],
              "verifier_only": plain_repeat["tokens_per_s"],
              "ratio": repeat["tokens_per_s"] / plain_repeat["tokens_per_s"]},
          "tokens_equal_verifier_only": True,
          "tokens_equal_eager": True,
          "float32_2_layers": {"tokens_equal_verifier_only": True,
                               "spec_cycles": st32["spec_cycles"],
                               "acceptance_rate": st32["acceptance_rate"]},
          "trace_counts": tc, "graphs": graphs,
          "launches": {"dequant_matmul_by_variant": b_by,
                       "dequant_matmul_by_variant_and_bits": want["split"],
                       "paged_attention": c_n},
          "launches_issued_by_wrappers": issued,
          "launches_measured_in_replays": replayed,
          "eager_launches_equal_captured": True,
          "drafter_admission_rows": rec["draft_admit"].log[:len(reqs)],
          "kv": kst, "peak_memory_gb": peak_gb})
    return (captured_launches["dequant_matmul.launches"], c_n,
            rec["draft_admit"].log[:len(reqs)])


# ---------------------------------------------------------------------------
# phase 9: native quantized serving checkpoints (quant.apply → save_serving →
# restore_serving → serve), live reload from a watched directory, the CLIs
# ---------------------------------------------------------------------------

def _leaves(tree, path=()):
    """``{"a/b/0": tensor}`` of a tree of dicts and lists."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_leaves(tree[k], path + (str(k),)))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_leaves(v, path + (str(i),)))
        return out
    return {"/".join(path): tree}


def _same_bytes(a, b):
    """Equal dtype, shape and bits (a bfloat16 tensor compared as int16)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype == torch.bfloat16:
        a, b = a.view(torch.int16), b.view(torch.int16)
    return torch.equal(a, b)


def _rows_differing(qt_tree, qdict_tree):
    """Rows of codes and of scales in which the ``quantize_tree`` tree
    (QuantizedTensor leaves) and the ``quant.apply`` tree (``w_q`` +
    ``w_scale``) of the same fp weights differ, over every linear."""
    from repro_torch.quant.qtypes import QuantizedTensor
    flat = _leaves(qdict_tree)
    out = {"linears": 0, "rows": 0, "code_rows_differing": 0,
           "scale_rows_differing": 0}
    for path, qt in _leaves(qt_tree).items():
        if not isinstance(qt, QuantizedTensor):
            continue
        base = path.rsplit("/", 1)[0]
        codes, scale = flat[base + "/w_q"], flat[base + "/w_scale"]
        out["linears"] += 1
        out["rows"] += codes.shape[0]
        out["code_rows_differing"] += int(
            (qt.data.reshape(codes.shape) != codes).any(dim=1).sum())
        out["scale_rows_differing"] += int(
            (qt.scale.reshape(-1) != scale.reshape(-1)).sum())
    return out


def _serve_paged(dev, model, tree, reqs):
    """Phase 6's serve configuration (captured) on a store built around
    ``tree``, one run of ``reqs``: tokens, launches (what the wrappers
    issued plus what the replays launched, read from the graphs), the
    kernel B and C launches the path implies, step ms, captures."""
    from repro_torch.kernels import dequant_matmul as dm
    from repro_torch.kernels import ops
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import paged_attention_quant as paq
    from repro_torch.kernels import squant_flip as sf
    from repro_torch.serving import ServeEngine, WeightStore

    eng = ServeEngine(model, None, paged_config(), device=dev,
                      store=WeightStore(serving_params=tree, device=dev))
    kv = eng.scheduler.kv
    dec = eng._decode = _Counted(eng._decode,
                                 lambda a, o: kv._lengths.copy().tolist())
    chk = eng._prefill_chunk = _Counted(
        eng._prefill_chunk, lambda a, o: int(a[1]["tokens"].numel()))
    _reset_launches(dm, pa, paq, sf)
    t0 = time.perf_counter()
    outs = eng.generate(reqs)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = ops.combine_launches(ops.launch_counts(),
                                    eng.replay_launches())
    layers = model.cfg.n_layers
    big = sum(1 for rows in chk.log if rows > 16)
    want = _variants(mma=7 * layers * big,
                     tcgemv=7 * layers * (dec.calls + chk.calls - big))
    st = eng.stats()
    res = {"tokens": [o.tokens for o in outs], "run_s": run_s,
           "stage_ms": eng.store.current.staged_ms,
           "step_ms": st["scheduler"].step_ms,
           "decode_forwards": dec.calls, "chunk_forwards": chk.calls,
           "trace_counts": st["trace_counts"], "graphs": st["graphs"],
           "dequant_matmul": launches["dequant_matmul.launches"],
           "dequant_matmul_by_variant":
               launches["dequant_matmul.launches_by_variant"],
           "path_implies_by_variant": want,
           "paged_attention": launches["paged_attention.launches"],
           "path_implies_paged_attention": layers * dec.calls,
           # the step with the most context
           "decode_lengths": max(dec.log, key=sum)}
    if res["dequant_matmul_by_variant"] != want or not want["tcgemv"] \
            or res["paged_attention"] != layers * dec.calls:
        raise AssertionError(f"launches {res}: the path implies B {want} "
                             f"and C {layers * dec.calls}")
    if any(len(o.tokens) != r.max_new_tokens for o, r in zip(outs, reqs)):
        raise AssertionError("a completion is short")
    eng.close()
    del eng
    torch.cuda.empty_cache()
    return res


def drive_native_checkpoint(dev, seed, layers, phase6_b_launches=None):
    """9a: phase 6's fp tree quantized into the serving format by
    ``quant.apply`` on the card (kernel A, one launch a leaf), written as a
    native w8 checkpoint, the fp tree and the tree's device copy freed,
    restored onto the card with the serve config's expectations, and served
    in phase 6's configuration, captured: tokens bit-identical to the same
    engine on the never-saved tree, restored leaves byte-equal to the saved
    ones (the bfloat16 embedding included), kernel B launches by variant
    those of the never-saved run and (in total) of phase 6 where it ran at
    ``layers``, else of phase 6's tree served at ``layers``. Returns the
    kernel A launches of the quantization and the kernel B and C launches
    of the restored run."""
    import shutil
    import tempfile
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import get_config
    from repro_torch.core.pipeline import quantize_tree
    from repro_torch.kernels import dequant_matmul as dm
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import paged_attention_quant as paq
    from repro_torch.kernels import squant_flip as sf
    from repro_torch.models.model import build_model
    from repro_torch.quant import apply

    cfg = dataclasses.replace(get_config("granite-3-8b"), n_layers=layers)
    model = build_model(cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    params = model.init(gen, device=dev)
    reqs = chat_requests(seed, cfg.vocab)
    tree6, _ = quantize_tree(params, method="squant", bits=8, device=dev)
    # without this the earlier phases' cached blocks leave the allocator
    # freeing and retrying under this phase's ~49 GB, which the quantize
    # time would measure (scripts/quant_apply_time.py times it alone)
    torch.cuda.empty_cache()
    _reset_launches(dm, pa, paq, sf)
    tree, meta = apply.quantize_params_serving(params, 8, "squant")
    a_launches = {"squant_flip": sf.launches,
                  "squant_flip_by_route": dict(sf.launches_by_route),
                  "squant_scale": sf.scale_launches}
    linears = 7 * layers + (0 if cfg.tie_embeddings else 1)
    if sf.launches != linears or sf.scale_launches:
        raise AssertionError(f"kernel A launches {a_launches}: one a leaf "
                             f"({linears}) expected")
    rows = _rows_differing(tree6, tree)
    del params
    torch.cuda.empty_cache()

    served6 = _serve_paged(dev, model, tree6, reqs)     # phase 6's tokens
    del tree6
    torch.cuda.empty_cache()
    never_saved = _serve_paged(dev, model, tree, reqs)

    saved = {k: v.cpu() for k, v in _leaves(tree).items()}
    nbytes = {"codes": 0, "scales": 0, "other": 0}
    for k, v in saved.items():
        part = "codes" if k.endswith(("/w_q", "/w_q4")) else \
            "scales" if k.endswith("/w_scale") else "other"
        nbytes[part] += v.numel() * v.element_size()
    d = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        free = shutil.disk_usage(d).free
        if free < 1.1 * sum(nbytes.values()):
            raise AssertionError(f"{free} bytes free in {d}: the checkpoint "
                                 f"needs {sum(nbytes.values())}")
        ck = Checkpointer(d)                 # snapshot now, write on a thread
        t0 = time.perf_counter()
        ck.save_serving(1, tree, quant_meta=meta)
        d2h_ms = ck.timings["d2h_ms"]
        ck.wait()
        save_ms = (time.perf_counter() - t0) * 1e3
        write_ms = ck.timings["write_ms"]
        step_dir = os.path.join(d, "step_00000001")
        disk_bytes = sum(os.path.getsize(os.path.join(step_dir, f))
                         for f in os.listdir(step_dir))
        del tree
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        restored, rmeta, step = ck.restore_serving(
            expect={"quantize_weights": "squant", "weight_bits": 8},
            device=dev)
        torch.cuda.synchronize()
        restore_ms = (time.perf_counter() - t0) * 1e3
        read_ms, h2d_ms = ck.timings["read_ms"], ck.timings["h2d_ms"]
    finally:
        shutil.rmtree(d, ignore_errors=True)
    got = _leaves(restored)
    differing = sorted(set(saved) ^ set(got)) + [
        k for k in saved if k in got and not _same_bytes(got[k].cpu(),
                                                         saved[k])]
    if differing or step != 1 or rmeta["format"] != "quantized" or \
            any(t.device != dev for t in got.values()):
        raise AssertionError(f"restored leaves differ from the saved ones: "
                             f"{differing[:8]} (step {step}, "
                             f"{rmeta['format']})")
    emb = got["embedding/embedding"]
    emb_meta = {"dtype": str(emb.dtype).replace("torch.", ""),
                "shape": list(emb.shape)}
    del saved, got, emb
    served = _serve_paged(dev, model, restored, reqs)
    bad = [i for i, (a, b) in enumerate(zip(served["tokens"],
                                            never_saved["tokens"]))
           if a != b]
    if bad or len(served["tokens"]) != len(reqs):
        raise AssertionError(f"restored tree: tokens differ from the "
                             f"never-saved tree's for requests {bad}")
    # phase 6's count where it ran at this depth, else that of phase 6's
    # tree (quantize_tree) served the same way at this depth
    b_ref = served6["dequant_matmul"] if phase6_b_launches is None \
        else phase6_b_launches
    if served["dequant_matmul_by_variant"] != \
            never_saved["dequant_matmul_by_variant"] or \
            served["dequant_matmul"] != b_ref:
        raise AssertionError(f"kernel B launches {served} vs never-saved "
                             f"{never_saved} and phase 6's tree {b_ref}")
    pairs = [(a, b) for x, y in zip(served["tokens"], served6["tokens"])
             for a, b in zip(x, y)]
    emit({"phase": "9a native w8 checkpoint: quant.apply, save_serving, "
                   "restore_serving, serve (continuous + paged + chunked, "
                   "captured)",
          "model": cfg.name, "layers": layers,
          "full_depth": layers == get_config("granite-3-8b").n_layers,
          "reduced": _depth_cut(layers),
          "quantize_ms": meta["quantize_ms"], "launches_quantize": a_launches,
          "bytes_on_disk": disk_bytes, "bytes_by_part": nbytes,
          "embedding": emb_meta,
          "save_ms": save_ms, "save_d2h_ms": d2h_ms, "save_write_ms": write_ms,
          "restore_ms": restore_ms, "restore_read_ms": read_ms,
          "restore_h2d_ms": h2d_ms, "stage_ms": served["stage_ms"],
          "restored_byte_equal": True, "tokens_equal_never_saved": True,
          "step_ms": served["step_ms"],
          "step_ms_never_saved": never_saved["step_ms"],
          "step_ms_quantize_tree_tree": served6["step_ms"],
          "run_s": served["run_s"],
          "vs_quantize_tree_tree": rows,
          "greedy_agreement_with_phase6_tokens": {
              "equal_positions": sum(a == b for a, b in pairs),
              "positions": len(pairs),
              "requests_identical": sum(x == y for x, y in zip(
                  served["tokens"], served6["tokens"]))},
          "launches": {k: served[k] for k in (
              "dequant_matmul", "dequant_matmul_by_variant",
              "paged_attention")},
          "launches_phase6_dequant_matmul": phase6_b_launches,
          "launches_dequant_matmul_held_equal_to": {
              "count": b_ref,
              "of": "phase 6" if phase6_b_launches is not None else
                    "phase 6's quantize_tree tree served at this depth"},
          "trace_counts": served["trace_counts"], "graphs": served["graphs"],
          "tokens": served["tokens"]})
    del restored
    torch.cuda.empty_cache()
    return (a_launches["squant_flip"], served["dequant_matmul"],
            served["paged_attention"])


def _wait_until(cond, timeout, what):
    t_end = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > t_end:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.01)


def _overlaps(a, b):
    """Pairs of intervals ``(t0, t1, ...)`` of ``a`` and ``b`` that
    overlap in time."""
    return [(x, y) for x in a for y in b if x[0] < y[1] and y[0] < x[1]]


def drive_live_reload(dev, seed, layers=4):
    """9b: phase 6's engine (w8, paged continuous, chunked, captured) at
    full width and ``layers`` layers watches a fresh directory
    (``poll_s=0.05``) while a writer thread saves, with requests flowing:
    step 1 an fp ``save`` (another seed; quantized on the fly), step 2 a
    native w8 checkpoint of a third seed, a torn step 3 (no COMMITTED), step
    4 a w4-metadata checkpoint. Every completion is full length, versions
    never go backwards, the sources read ``ckpt:1`` then ``ckpt:2``, the
    only error is step 4's rejection, and the tokens after the last swap
    equal a fresh engine's on the restored step-2 tree. Records the reloads
    that ran while the scheduler's thread captured a new chunk width, each
    swap's stage ms (and restore + stage ms) and the recapture after it."""
    import shutil
    import tempfile
    import threading
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    from repro_torch.quant import apply
    from repro_torch.serving import ServeEngine, WeightStore

    cfg = dataclasses.replace(get_config("granite-3-8b"), n_layers=layers)
    model = build_model(cfg)

    def init(s):
        gen = torch.Generator(device=dev)
        gen.manual_seed(s)
        return model.init(gen, device=dev)

    eng = ServeEngine(model, init(seed), paged_config(), device=dev)
    fp1 = init(seed + 1)
    q2, m2 = apply.quantize_params_serving(init(seed + 2), 8, "squant")
    q4, m4 = apply.quantize_params_serving(init(seed + 3), 4, "squant")
    torch.cuda.empty_cache()

    captures, reloads, versions = [], [], []
    real_capture, real_poll = eng._capture, eng.store.poll_checkpoints

    def capture(fn, params, batch, caches, out, inputs):
        t0 = time.perf_counter()
        try:
            return real_capture(fn, params, batch, caches, out, inputs)
        finally:
            captures.append((t0, time.perf_counter(),
                             list(inputs[0].shape)))

    def poll(*a, **kw):
        t0 = time.perf_counter()
        step = real_poll(*a, **kw)
        if step is not None:                 # a restore and a stage ran
            reloads.append((t0, time.perf_counter(), step))
        return step

    def on_step(info):
        if not versions or versions[-1]["version"] != info["version"]:
            cur = eng.store.current
            versions.append({"version": info["version"],
                             "source": cur.source, "stage_ms": cur.staged_ms,
                             "t": time.perf_counter(),
                             "capture_ms": eng.capture_ms,
                             "captures": sum(eng.trace_counts.values())})
    eng._capture, eng.store.poll_checkpoints = capture, poll
    eng.on_step = on_step

    d = tempfile.mkdtemp(prefix="chip_smoke_watch_")
    side = tempfile.mkdtemp(prefix="chip_smoke_torn_")
    writes, writer_error = {}, []

    def writer():
        try:
            ck = Checkpointer(d, async_save=False)
            time.sleep(0.5)
            t0 = time.perf_counter()
            ck.save(1, fp1, {"step": 1})
            writes["1 fp save ms"] = (time.perf_counter() - t0) * 1e3
            _wait_until(lambda: eng.store.version >= 2, 300,
                        "step 1 swapped in")
            t0 = time.perf_counter()
            ck.save_serving(2, q2, quant_meta=m2)
            writes["2 w8 save ms"] = (time.perf_counter() - t0) * 1e3
            _wait_until(lambda: eng.store.version >= 3, 300,
                        "step 2 swapped in")
            # a torn step appears whole but without its COMMITTED marker
            Checkpointer(side, async_save=False).save_serving(
                3, q2, quant_meta=m2)
            os.remove(os.path.join(side, "step_00000003", "COMMITTED"))
            os.rename(os.path.join(side, "step_00000003"),
                      os.path.join(d, "step_00000003"))
            time.sleep(0.5)                     # several polls see it
            ck.save_serving(4, q4, quant_meta=m4)
            _wait_until(lambda: eng.store.errors, 300, "step 4 rejected")
        except BaseException as e:            # re-raised by the main thread
            writer_error.append(e)

    outs, k = [], 0
    try:
        eng.watch_checkpoints(d, poll_s=0.05)
        th = threading.Thread(target=writer, daemon=True)
        t_start = time.perf_counter()
        th.start()
        while th.is_alive() and time.perf_counter() - t_start < 600:
            reqs = chat_requests(seed + 100 + k, cfg.vocab, max_new=16)
            outs += list(zip(eng.generate(reqs), reqs))
            k += 1
        th.join(timeout=60)
        if th.is_alive() or writer_error:
            raise AssertionError(f"writer: {writer_error or 'still running'}")
        # after the last swap: fresh requests, then a fresh engine on the
        # restored step-2 tree
        final = chat_requests(seed + 99, cfg.vocab, max_new=16)
        live = [o.tokens for o in eng.generate(final)]
        st = eng.stats()
        tree2, _, _ = Checkpointer(d).restore_serving(
            2, expect={"quantize_weights": "squant", "weight_bits": 8},
            device=dev)
    finally:
        eng.close()
        shutil.rmtree(d, ignore_errors=True)
        shutil.rmtree(side, ignore_errors=True)
    fresh = ServeEngine(model, None, paged_config(), device=dev,
                        store=WeightStore(serving_params=tree2, device=dev))
    fresh_tokens = [o.tokens for o in fresh.generate(final)]
    fresh.close()
    del fresh, tree2, fp1, q2, q4, eng
    torch.cuda.empty_cache()

    w = st["weights"]
    seq = [v["version"] for v in versions]
    sources = [v["source"] for v in versions]
    short = [r.request_id for o, r in outs if len(o.tokens)
             != r.max_new_tokens]
    errors = w["errors"]
    landed = _overlaps(reloads, captures)
    problems = []
    if short:
        problems.append(f"short completions {short}")
    if seq != sorted(seq):
        problems.append(f"versions went backwards: {seq}")
    if sources != ["init", "ckpt:1", "ckpt:2"]:
        problems.append(f"sources {sources}")
    if len(errors) != 1 or "rejected" not in errors[0] \
            or "step 4" not in errors[0]:
        problems.append(f"errors {errors}")
    if live != fresh_tokens:
        problems.append("tokens after the last swap differ from a fresh "
                        "engine's on the restored step-2 tree")
    swaps = []
    for v, nxt in zip(versions, versions[1:] + [None]):
        after = nxt if nxt is not None else {
            "capture_ms": st["graphs"]["capture_ms"],
            "captures": sum(st["trace_counts"].values())}
        swaps.append({"version": v["version"], "source": v["source"],
                      "stage_ms": v["stage_ms"],
                      "restore_and_stage_ms": next(
                          ((t1 - t0) * 1e3 for t0, t1, step in reloads
                           if v["source"] == f"ckpt:{step}"), None),
                      "recaptures": after["captures"] - v["captures"],
                      "recapture_ms": after["capture_ms"] - v["capture_ms"]})
    emit({"phase": "9b live reload, granite-3-8b w8, continuous + paged + "
                   "chunked, captured",
          "layers": layers, "poll_s": 0.05, "requests": len(outs),
          "generate_calls": k + 1, "versions_seen": seq, "sources": sources,
          "errors": errors, "swaps": swaps, "writer": writes,
          "stages_while_capturing": {
              "count": len(landed),
              "note": "reloads (restore and stage of a checkpoint on "
                      "the watcher's thread) whose interval overlapped a "
                      "capture on the scheduler's thread" if landed
                      else "none did in this run",
              "widths": sorted({tuple(c[2]) for _, c in landed})},
          "captures": len(captures), "step_ms": st["scheduler"].step_ms,
          "drains": st["scheduler"].drains,
          "forced_swaps": st["scheduler"].forced_swaps,
          "tokens_equal_fresh_engine_step2": live == fresh_tokens})
    if problems:
        raise AssertionError("; ".join(problems))


def capture_sync_probe(dev):
    """What another thread's synchronization does to a CUDA-graph capture
    in progress (``thread_local`` mode, as the engine captures): for a
    synchronization of the other thread's own stream and of the whole
    device, whether the other thread's call raised, and whether the
    capture ended with a graph that replays right. Run it in a process of
    its own: a broken capture may leave the allocator in capture mode."""
    import threading
    out = {}
    for mode in ("stream_sync", "device_sync"):
        x = torch.ones(1 << 16, device=dev)
        began, done, other = threading.Event(), threading.Event(), {}

        def sync():
            began.wait(30)
            try:
                s = torch.cuda.Stream(dev)
                with torch.cuda.stream(s):       # no RNG: the capture
                    torch.ones(1 << 20, device=dev).sum()   # holds it
                if mode == "device_sync":
                    torch.cuda.synchronize(dev)
                else:
                    s.synchronize()
            except Exception as e:
                other["error"] = repr(e)
            done.set()

        th = threading.Thread(target=sync)
        th.start()
        side, g, res = torch.cuda.Stream(dev), torch.cuda.CUDAGraph(), {}
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            y = x * 2                                # warm-up
            try:
                g.capture_begin(capture_error_mode="thread_local")
                try:
                    y = x * 2
                    began.set()
                    done.wait(30)
                    y = y + 1
                finally:
                    g.capture_end()
                x.fill_(2.0)
                g.replay()
                side.synchronize()
                res["capture_ok"] = bool((y == 5).all())
            except Exception as e:
                res["capture_ok"], res["capture_error"] = False, repr(e)
        began.set()
        th.join(30)
        res["other_thread_error"] = other.get("error")
        out[mode] = res
    return out


def run_capture_sync_probe():
    """:func:`capture_sync_probe` in a process of its own; its result."""
    p = subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--capture-sync-probe"], capture_output=True,
                       text=True, timeout=300, cwd=ROOT)
    lines = p.stdout.strip().splitlines()
    if p.returncode != 0 or not lines:
        return {"returncode": p.returncode, "stderr": p.stderr[-2000:]}
    return json.loads(lines[-1])


def drive_clis(dev):
    """9c: the two CLIs as processes at their reduced config on the card:
    quantize writes a native w8 serving checkpoint, serve (continuous,
    paged) watches it and swaps it in (source ``ckpt:0``)."""
    import shutil
    import tempfile
    d = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src") + (
        os.pathsep + os.environ["PYTHONPATH"]
        if os.environ.get("PYTHONPATH") else ""))
    serving = os.path.join(d, "serving")
    cmds = {"quantize": ["-m", "repro_torch.launch.quantize", "--bits", "8",
                         "--out", os.path.join(d, "out"),
                         "--serving-ckpt", serving],
            "serve": ["-m", "repro_torch.launch.serve", "--quantize",
                      "squant", "--bits", "8", "--scheduler", "continuous",
                      "--kv-backend", "paged", "--reload-from", serving,
                      "--reload-poll", "0.01", "--rounds", "3",
                      "--max-new", "64", "--prompts", "hello world",
                      "the quick brown fox", "a", "SQuant on the fly"]}
    res, lines = {}, {}
    try:
        for name, args in cmds.items():
            t0 = time.perf_counter()
            p = subprocess.run([sys.executable] + args, capture_output=True,
                               text=True, timeout=300, cwd=ROOT, env=env)
            lines[name] = p.stdout.splitlines()
            res[name] = {"returncode": p.returncode,
                         "seconds": time.perf_counter() - t0,
                         "stdout_tail": p.stdout.strip().splitlines()[-6:],
                         "stderr_tail": p.stderr.strip().splitlines()[-6:]}
            if p.returncode != 0:
                break
    finally:
        shutil.rmtree(d, ignore_errors=True)
    swapped = [ln for ln in lines.get("serve", [])
               if "scheduler=continuous" in ln and "source ckpt:0" in ln]
    emit({"phase": "9c the quantize and serve CLIs (reduced config, on the "
                   "card)", "runs": res, "swapped_to_ckpt_0": bool(swapped)})
    if any(r["returncode"] != 0 for r in res.values()) or not swapped:
        raise AssertionError(f"CLIs: {res}")


# ---------------------------------------------------------------------------
# phase 10: a fine-grained mixture of experts (moonshot-v1-16b-a3b) on the
# paged continuous path
# ---------------------------------------------------------------------------

MOE_ARCH = "moonshot-v1-16b-a3b"


def moe_expert_shapes(cfg):
    """The expert banks of one MoE layer as (name, out, in) (kernel B's
    (M, N)): wi and wg d_model -> d_ff, wdown d_ff -> d_model."""
    return [("wi", cfg.d_ff, cfg.d_model), ("wg", cfg.d_ff, cfg.d_model),
            ("wdown", cfg.d_model, cfg.d_ff)]


def profile_moe_decode(dev, seed, eng, steps=4):
    """``--profile``: the captured paged decode step of phase 10's
    configuration on its tree, eight slots of its traffic admitted, traced
    (:func:`_profile_steps`), kernel B's device time split into expert and
    attention launches by grid (an expert launch's ``tcgemv`` grid is
    (ceil(out/128), splits) of its bank's shape)."""
    from repro_torch.kernels import dequant_matmul as dm
    from repro_torch.serving import ServeEngine, WeightStore
    cfg = eng.model.cfg
    sms, occ = dm.card_ctas_per_sm(8, eng.cfg.max_slots, dev.index)
    grids = {}
    for part, shapes in (("experts", [(m, n) for _, m, n in
                                      moe_expert_shapes(cfg)]),
                         ("attention", [(cfg.n_heads * cfg.head_dim,
                                         cfg.d_model),
                                        (cfg.n_kv_heads * cfg.head_dim,
                                         cfg.d_model),
                                        (cfg.d_model,
                                         cfg.n_heads * cfg.head_dim)])):
        for m, n in shapes:
            sp, _ = dm.split_plan(m, n, 128, sms, min(occ, dm.TC_CTAS_PER_SM))
            grids[(-(-m // dm.TC_ROWS), sp, 1)] = part
    if len(set(grids.values())) != 2:
        raise AssertionError(f"expert and attention grids coincide: {grids}")
    peng = ServeEngine(eng.model, None, paged_config(),
                       store=WeightStore(serving_params=eng.params,
                                         device=dev), device=dev)
    kv = peng.scheduler.kv
    slots = list(range(peng.cfg.max_slots))
    reqs = chat_requests(seed, cfg.vocab)[:len(slots)]
    kv.admit([(i, r) for i, r in enumerate(reqs)], slots, None,
             peng.params)

    def step():
        nxt = kv.logits.argmax(-1).to(torch.int32)
        nxt.cpu()                                        # the step's host sync
        kv.decode(peng.params, nxt, slots)

    _profile_steps(step, steps, f"10 profile of the captured MoE decode "
                   f"step, {cfg.name}", {
                       "layers": cfg.n_layers, "slots": len(slots),
                       "expert_grids": sorted([list(g), p]
                                              for g, p in grids.items())},
                   b_part=lambda grid, name: grids.get(grid, "unmatched"))
    peng.close()


def correlated_inputs(rng, samples, n, k):
    """ReLU-like activations whose E[xxᵀ] has the paper's structure
    (Appendix A.1): a channel-common floor, a per-kernel shared component
    and element noise with decaying within-kernel correlation (the recipe
    of ``tests/test_hessian.py``)."""
    import numpy as np
    common = rng.normal(size=(samples, 1, 1))
    kern = rng.normal(size=(samples, n, 1))
    elem = rng.normal(size=(samples, n, k + 4))
    smooth = np.array([0.3, 0.7, 1.0, 0.7, 0.3])
    sm = np.stack([elem[..., i:i + k] for i in range(5)], 0)
    elem = (sm * smooth[:, None, None, None]).sum(0) / np.sqrt(
        (smooth ** 2).sum())
    x = 0.3 * common + 0.8 * kern + 0.45 * elem + 0.5
    return np.maximum(x, 0).reshape(samples, n * k)


def hessian_on_card(dev, seed):
    """10d: the Hessian analysis and the baselines on the card, once, with
    ``tests/test_hessian.py``'s layer: (32, 144) weights, kernels of 9,
    4 bits, 4000 correlated activation samples from ``seed``. AP and
    AP-exact > 0.9 as that test holds them; the flip recorder's codes equal
    ``squant_codes``'; AdaRound's and RTN's output MSE on the samples."""
    import numpy as np

    from repro_torch.core import baselines, hessian
    from repro_torch.core.squant import squant_codes
    from repro_torch.quant.scales import max_scale

    rng = np.random.default_rng(seed)
    x = torch.from_numpy(correlated_inputs(rng, 4000, 16, 9)).to(dev)
    w = torch.from_numpy((rng.normal(size=(32, 144)) * 0.2).astype(
        np.float32)).to(dev)
    t0 = time.perf_counter()
    rep = hessian.approximation_precision(w, x, bits=4, group_size=9)
    ap_s = time.perf_counter() - t0
    s = max_scale(w, 4)
    codes, _, _ = squant_codes(w, s, bits=4, group_size=9, enable_k=True,
                               enable_c=True)
    rec, _, log = hessian._record_flips(
        (w.double() / s.double()).cpu().numpy(), 4, 9, True)
    recorder_equal = bool(np.array_equal(rec, codes.cpu().numpy()))
    xf = x.float()
    y = xf @ w.T
    t0 = time.perf_counter()
    ada = baselines.adaround(w, xf, bits=4)
    torch.cuda.synchronize()
    ada_s = time.perf_counter() - t0
    rtn = baselines.rtn(w, 4)
    mse = {k: float(torch.mean((xf @ q.dequantize().T - y) ** 2))
           for k, q in (("adaround", ada), ("rtn", rtn))}
    out = {"layer": [32, 144], "group_size": 9, "bits": 4, "samples": 4000,
           "flipped": rep.flipped, "ap": rep.ap, "ap_exact": rep.ap_exact,
           "ap_inorder": rep.ap_inorder, "by_stage": rep.by_stage,
           "recorder_codes_equal_squant_codes": recorder_equal,
           "flip_log_events": len(log), "output_mse": mse,
           "approximation_precision_s": ap_s, "adaround_s": ada_s,
           "device": str(ada.data.device)}
    if not (rep.flipped > 100 and rep.ap > 0.9 and rep.ap_exact > 0.9
            and recorder_equal and ada.data.is_cuda):
        raise AssertionError(f"the Hessian analysis on the card: {out}")
    return out


# 10c's floor for second turns, whose prefix reuse shifts their chunk
# boundaries off the oracle's: the reference engine's own lowest rate when
# chunk boundaries differ at 64 experts top-6 (0.75, chunk 1 against
# monolithic admission; FINE_GRAINED_REFERENCE_RATES in
# tests/test_torch_moe_serving.py). First turns chunk as the oracle does
# and owe equal tokens.
SHIFTED_CHUNK_FLOOR = 0.75


def agreement_by_turn(rep, reqs):
    """An agreement report split into first turns and second turns (a
    request whose prompt extends another's whole prompt): matched,
    compared, rate and the mismatched (request, position) pairs of each."""
    second = {r.request_id for r in reqs
              if any(len(o.prompt) < len(r.prompt)
                     and r.prompt[:len(o.prompt)] == o.prompt for o in reqs)}
    out = {}
    for name, ids in (("first", {r.request_id for r in reqs} - second),
                      ("second", second)):
        m = sum(rep.per_request.get(i, (0, 0))[0] for i in ids)
        n = sum(rep.per_request.get(i, (0, 0))[1] for i in ids)
        out[name] = {"requests": sorted(ids), "matched": m, "compared": n,
                     "rate": m / n if n else 1.0,
                     "mismatches": [list(p) for p in rep.mismatches
                                    if p[0] in ids]}
    return out


def drive_moe(dev, seed, layers, profile=False):
    """Phase 10: ``moonshot-v1-16b-a3b`` at full width (64 experts top-6,
    d_model 2048, d_ff 1408, vocab 163 840) and ``layers`` of its 48 layers
    on phase 6's path and traffic: (a) random weights, SQuant w8 of the
    whole tree (every expert bank on the native route), served captured,
    repeated and eager, tokens bit-identical and launches equal, kernel B's
    launches counted by weight shape and split into experts and attention
    by variant (every expert launch ``tcgemv``: capacity 8 at decode and at
    a 64-row chunk); (b) 2 layers in float32 through the kernels against
    the plain versions; (c) 2 layers in float32, teacher-forced agreement
    of the paged chunked engine against the one-slot contiguous oracle that
    admits in the same 64-token chunks: all of it the reference's ``moe``
    budget, first turns (chunked as the oracle chunks) equal tokens,
    second turns (their prefix reuse shifts their chunks)
    ``SHIFTED_CHUNK_FLOOR``; and, not gated, against the one-slot
    oracle with monolithic admission (capacity routing over a whole prompt
    drops other tokens than per chunk: at 64 experts top-6 the reference's
    own sweep falls below its 0.85 floor,
    ``tests/test_torch_moe_serving.py``); (d) the Hessian analysis and the
    baselines on the card.
    Returns kernel A's, B's and C's launches of (a), the context lengths
    of its fullest decode step and its line."""
    from repro_torch.configs import get_config
    from repro_torch.core.pipeline import quantize_tree
    from repro_torch.models.model import build_model
    from repro_torch.serving.equivalence import agreement_budget

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    full = get_config(MOE_ARCH)

    def before_close(eng):
        if profile:
            profile_moe_decode(dev, seed, eng)

    a_n, b_n, c_n, lengths, entry = drive_continuous(
        dev, seed, layers, f"10a fine-grained MoE, continuous + paged + "
        f"chunked, {MOE_ARCH} w8", arch=MOE_ARCH, agreement=False,
        capture_all_widths=False, before_close=before_close,
        reduced=None if layers == full.n_layers else
        {"n_layers": f"{full.n_layers} -> {layers}"})
    parts = entry["launches"]["dequant_matmul_by_part"]
    if set(parts["experts"]) != {"tcgemv"} or parts["experts"]["tcgemv"] \
            != 3 * full.moe.n_experts * layers * (
                entry["decode_forwards"] + entry["chunk_forwards"]):
        raise AssertionError(f"expert launches {parts['experts']}: every "
                             f"expert of every forward through tcgemv")
    if entry["quantize"]["stacked_buckets"]:
        raise AssertionError("an expert bucket took the stacked route")
    torch.cuda.empty_cache()

    # (b) and (c): two layers, float32 activations
    plain = paged_vs_plain(dev, seed, arch=MOE_ARCH)
    cfg = dataclasses.replace(full, n_layers=2, dtype="float32")
    model = build_model(cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    params = model.init(gen, device=dev)
    tree, _ = quantize_tree(params, method="squant", bits=8, device=dev)
    del params
    reqs = chat_requests(seed, cfg.vocab)
    budget = agreement_budget(paged_config(), cfg)
    # the oracle admits in the same 64-token chunks, so each chunk routes
    # with the same capacity: what is compared is the paged pool (block
    # tables, prefix reuse, copy-on-write) against the contiguous cache
    agree, oracle_s, _ = measure_agreement(
        dev, model, tree, reqs, False, torch.float32,
        prefill_chunk=paged_config().prefill_chunk)
    agree_mono, _, _ = measure_agreement(dev, model, tree, reqs, False,
                                         torch.float32)
    turns = agreement_by_turn(agree, reqs)
    del tree
    torch.cuda.empty_cache()
    m5 = hessian_on_card(dev, seed)
    line = {"phase": "10b-d fine-grained MoE at 2 layers (float32) and the "
                     "Hessian analysis on the card", "model": MOE_ARCH,
            "kernels_vs_plain": dict(plain, tolerance="1e-3 * max|logit| "
                                     "(phase 5's float32 tolerance)"),
            "agreement": {"against": "contiguous, one slot, admission in "
                          "the same 64-token chunks", "budget": budget,
                          "gated": "float32 activations, 2 layers; all "
                                   f">= {budget}, first turns equal "
                                   "tokens, second turns "
                                   f">= {SHIFTED_CHUNK_FLOOR}",
                          "rate": agree.rate, "matched": agree.matched,
                          "compared": agree.compared,
                          "oracle_run_s": oracle_s, "by_turn": turns,
                          "rate_against_monolithic_oracle_not_gated":
                              agree_mono.rate,
                          "matched_against_monolithic_oracle":
                              agree_mono.matched},
            "hessian": m5,
            "seconds": time.perf_counter() - t_phase}
    emit(line)
    if budget != 0.85 or agree.rate < budget \
            or turns["first"]["mismatches"] \
            or turns["second"]["rate"] < SHIFTED_CHUNK_FLOOR:
        raise AssertionError(f"MoE paged vs one-slot contiguous (chunked) "
                             f"agreement {agree.rate:.4f} (budget {budget}), "
                             f"by turn {turns}: first turns owe equal "
                             f"tokens, second turns {SHIFTED_CHUNK_FLOOR}")
    return a_n, b_n, c_n, lengths, entry


# ---------------------------------------------------------------------------
# phase 11: training on the card (the trainer, AdamW, the synthetic data,
# LM.train_loss), then trained models quantized and served
# ---------------------------------------------------------------------------

TRAIN_SIZE_100M = dict(n_layers=12, d_model=768, n_heads=12, n_kv_heads=4,
                       head_dim=64, d_ff=2048, vocab=32_000, dtype="float32")
# 11c (ii): moonshot's routing at 11b's width; the experts' d_ff keeps
# moonshot's d_ff / d_model (1408 / 2048) rounded to a multiple of 128
MOE_AT_100M_WIDTH = dict(n_layers=2, d_model=768, n_heads=12, n_kv_heads=4,
                         head_dim=64, d_ff=512, vocab=32_000, dtype="float32")


class _StepSplit:
    """CUDA events around the optimizer update inside ``make_train_step``'s
    step (``train_loop.adamw_update`` wrapped while the context is open):
    with an event recorded before each step, forward + backward is step
    start → update start and the optimizer is the update."""

    def __init__(self):
        from repro_torch.training import train_loop
        self.mod, self.real = train_loop, train_loop.adamw_update
        self.starts, self.marks = [], []

    def start(self):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        self.starts.append(e)

    def __enter__(self):
        def timed(*a, **kw):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = self.real(*a, **kw)
            e1.record()
            self.marks.append((e0, e1))
            return out
        self.mod.adamw_update = timed
        return self

    def __exit__(self, *exc):
        self.mod.adamw_update = self.real

    def split_ms(self):
        torch.cuda.synchronize()
        return ([s.elapsed_time(e0) for s, (e0, _) in
                 zip(self.starts, self.marks)],
                [e0.elapsed_time(e1) for e0, e1 in self.marks])


def _numel(tree):
    from repro_torch.training.optimizer import tree_leaves
    return sum(t.numel() for t in tree_leaves(tree))


def _flop_params(cfg, params):
    """6·N's N for a causal LM step: the non-embedding parameters plus the
    tied logits product (d_model x vocab)."""
    emb = params["embedding"]["embedding"].numel()
    return _numel(params) - emb + (emb if cfg.tie_embeddings else 0)


def _grads_rel_diff(a, b):
    """||a - b|| / ||a|| over every leaf of two gradient trees (float32)."""
    from repro_torch.training.optimizer import tree_leaves
    num = den = 0.0
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        x, y = x.float(), y.float()
        num += float(torch.sum((x - y) ** 2))
        den += float(torch.sum(x * x))
    return math.sqrt(num / den)


def _train_steps(step, params, opt, batches):
    """Drive ``step`` over ``batches`` (tensors on the card): losses, MoE
    aux values, step ms (host clock, the loss read back each step), and
    the forward+backward / optimizer split by CUDA events."""
    losses, aux, step_ms = [], [], []
    with _StepSplit() as sp:
        for b in batches:
            torch.cuda.synchronize()
            sp.start()
            t0 = time.perf_counter()
            params, opt, met = step(params, opt, b)
            losses.append(float(met["loss"]))
            step_ms.append((time.perf_counter() - t0) * 1e3)
            aux.append(float(met["moe_aux"]))
    fb, op = sp.split_ms()
    return params, opt, {"losses": losses, "moe_aux": aux,
                         "step_ms": step_ms, "forward_backward_ms": fb,
                         "optimizer_ms": op}


def train_full_width(dev, seed, layers, card, *, lr, arch="granite-3-8b",
                     seq=512, micro_check=True):
    """11a / 11c (i): ``arch`` as published (embedding in the config's
    dtype, dense kernels float32, so activations take the embedding's
    dtype; remat on) at ``layers`` of its layers, ten steps of
    ``make_train_step`` on ``markov_batches(4, seq, vocab, seed)``, no
    checkpoint. Gates: a finite loss that falls from step 1 to step 10
    (and, for an MoE stack, a finite aux loss > 0); with ``micro_check``,
    ``microbatches=2`` equal to ``microbatches=1`` on one batch within the
    bfloat16 tolerance 2e-2."""
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import markov_batches
    from repro_torch.models.model import build_model
    from repro_torch.training import train_loop as tl
    from repro_torch.training.optimizer import AdamWConfig, adamw_init

    t_phase = time.perf_counter()
    batch, steps = 4, 10
    full = get_config(arch)
    cfg = dataclasses.replace(full, n_layers=layers)
    if not cfg.remat:
        raise AssertionError(f"{arch}: remat is off")
    model = build_model(cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    torch.cuda.synchronize()
    allocated0 = torch.cuda.memory_allocated()
    params = model.init(gen, device=dev)
    n_params, n_flop = _numel(params), _flop_params(cfg, params)
    per_layer = _numel(params["stack"]) / layers
    n_full = n_params + per_layer * (full.n_layers - layers)
    t0 = time.perf_counter()
    host = [b for b, _ in zip(markov_batches(batch, seq, cfg.vocab, seed),
                              range(steps + 1))]
    data_s = time.perf_counter() - t0
    batches = [tl.to_device(b, dev) for b in host]
    # the training CLI's optimizer for ``steps`` steps
    ocfg = AdamWConfig(lr=lr, warmup_steps=min(20, steps // 5),
                       decay_steps=steps)
    step = tl.make_train_step(model, ocfg)
    opt = adamw_init(params)
    torch.cuda.synchronize()
    state_gb = (torch.cuda.memory_allocated() - allocated0) / 1e9
    torch.cuda.reset_peak_memory_stats()
    params, opt, run = _train_steps(step, params, opt, batches[:steps])
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = run["losses"]
    p50 = _percentiles(run["step_ms"][2:])["p50"]       # steps 3 on
    tokens = batch * seq
    fb, op = run["forward_backward_ms"][2:], run["optimizer_ms"][2:]
    fb_p50, op_p50 = _percentiles(fb)["p50"], _percentiles(op)["p50"]
    del opt
    torch.cuda.empty_cache()

    micro = None
    if micro_check:
        # on a batch not trained on, from the trained params: the grads of
        # microbatches=2 (two sequential halves, float32 sums) against one
        # pass, then one make_train_step step each from a fresh state
        b = batches[steps]
        l1, _, g1 = tl._accumulate_grads(model.train_loss, params, b, 1)
        l2, _, g2 = tl._accumulate_grads(model.train_loss, params, b, 2)
        rel = _grads_rel_diff(g1, g2)
        del g1, g2
        torch.cuda.empty_cache()
        mets = {}
        for mb in (1, 2):
            _, _, m = tl.make_train_step(model, ocfg, microbatches=mb)(
                params, adamw_init(params), b)
            mets[mb] = {k: float(v) for k, v in m.items()}
            torch.cuda.empty_cache()
        micro = {"grads_rel_l2_diff": rel,
                 "loss_microbatches_1": float(l1),
                 "loss_microbatches_2": float(l2),
                 "train_step_metrics": mets, "tolerance": 2e-2}
    del params, batches
    torch.cuda.empty_cache()

    line = {"phase": f"11{'a' if cfg.moe is None else 'c (i)'} training at "
                     f"full width, {arch}",
            "card": card, "model": cfg.name, "layers": layers,
            "reduced": {"n_layers": f"{full.n_layers} -> {layers}"},
            "reduced_because": (
                "float32 weights, grads and AdamW moments cost 16 B a "
                f"parameter: {n_full / 1e9:.2f} G parameters at "
                f"{full.n_layers} layers are {16 * n_full / 1e9:.0f} GB, at "
                f"{layers} {16 * n_params / 1e9:.1f} GB"),
            "d_model": cfg.d_model, "d_ff": cfg.d_ff, "vocab": cfg.vocab,
            "moe": dataclasses.asdict(cfg.moe) if cfg.moe else None,
            "dtype": {"embedding": cfg.dtype, "dense_kernels": "float32",
                      "activations": cfg.dtype},
            "remat": cfg.remat,
            "tf32": bool(torch.backends.cuda.matmul.allow_tf32),
            "params": n_params, "state_gb": state_gb,
            "data": f"markov_batches({batch}, {seq}, {cfg.vocab}, {seed})",
            "data_host_s": data_s, "optimizer": dataclasses.asdict(ocfg),
            "steps": steps, "losses": losses, "moe_aux": run["moe_aux"],
            "step_ms": run["step_ms"], "step_ms_p50_steps_3_on": p50,
            "tokens_per_step": tokens, "tokens_per_s": tokens / (p50 / 1e3),
            "forward_backward_ms": run["forward_backward_ms"],
            "optimizer_ms": run["optimizer_ms"],
            "forward_backward_ms_p50": fb_p50, "optimizer_ms_p50": op_p50,
            "optimizer_share": op_p50 / (fb_p50 + op_p50),
            "peak_memory_gb": peak_gb,
            "mfu": 6 * n_flop * tokens / (p50 / 1e3)
            / PEAK_FLOPS["bfloat16"],
            "mfu_formula": "6 * (non-embedding params + d_model * vocab, the "
                           "tied logits product) * tokens / step s / 989 "
                           "TFLOP/s (H100 SXM dense bf16 peak, "
                           "hopper-kernels guide)",
            "flop_params": n_flop, "microbatches": micro,
            "seconds": time.perf_counter() - t_phase}
    emit(line)
    bad = [x for x in losses + run["moe_aux"] if not math.isfinite(x)]
    if bad or not losses[-1] < losses[0]:
        raise AssertionError(f"{arch}: losses {losses} (aux "
                             f"{run['moe_aux']}) not finite or not falling")
    if cfg.moe is not None and not min(run["moe_aux"]) > 0:
        raise AssertionError(f"{arch}: MoE aux loss {run['moe_aux']}")
    if micro is not None and (
            micro["grads_rel_l2_diff"] > 2e-2
            or abs(micro["loss_microbatches_2"] - micro["loss_microbatches_1"])
            > 2e-2 * abs(micro["loss_microbatches_1"])
            or abs(mets[2]["loss"] - mets[1]["loss"])
            > 2e-2 * abs(mets[1]["loss"])
            or abs(mets[2]["grad_norm"] - mets[1]["grad_norm"])
            > 2e-2 * mets[1]["grad_norm"]):
        raise AssertionError(f"{arch}: microbatches=2 differs from "
                             f"microbatches=1: {micro}")
    return line


class _BatchFeed:
    """Numpy batches made on a thread into a queue, so the card does not
    wait for the host: the trainer's ``data_iter``. Keeps every batch it
    made (``made``) and each one's host ms; ``wait_ms`` is what the
    consumer waited in ``next``."""

    def __init__(self, gen, n):
        import queue
        import threading
        self.q, self.made, self.host_ms, self.wait_ms = \
            queue.Queue(maxsize=64), [], [], []
        self.error = None

        def work():
            try:
                for _ in range(n):
                    t0 = time.perf_counter()
                    b = next(gen)
                    self.host_ms.append((time.perf_counter() - t0) * 1e3)
                    self.made.append(b)
                    self.q.put(b)
            except Exception as e:              # raised by the consumer
                self.error = e
                self.q.put(None)
        self.thread = threading.Thread(target=work, daemon=True)
        self.thread.start()

    def __iter__(self):
        return self

    def __next__(self):
        t0 = time.perf_counter()
        b = self.q.get()
        self.wait_ms.append((time.perf_counter() - t0) * 1e3)
        if b is None:
            raise RuntimeError(f"batch thread failed: {self.error!r}")
        return b

    def close(self):
        self.thread.join()


class _LoggedMonitor:
    """A ``StepMonitor`` that also keeps every step's seconds."""

    def __init__(self, factor):
        from repro_torch.runtime.monitor import StepMonitor
        self.inner, self.log = StepMonitor(factor), []

    def record(self, dt):
        self.log.append(dt)
        return self.inner.record(dt)

    def __getattr__(self, name):
        return getattr(self.inner, name)


def train_with_trainer(dev, model, params, feed, steps, seed_dir):
    """The port's ``Trainer`` on ``feed`` for ``steps`` steps with the
    reference example's optimizer (``AdamWConfig(lr=3e-3, warmup_steps=20,
    decay_steps=steps)``): preempted at mid-run (its checkpoint committed
    into a temporary directory), then a second ``Trainer`` on that
    directory resumes and finishes. The trainers' lines are captured, not
    printed. Returns the trained params and the run's record."""
    import contextlib
    import io
    import shutil
    import tempfile
    from repro_torch.training.optimizer import AdamWConfig
    from repro_torch.training.train_loop import Trainer, TrainerConfig

    d = tempfile.mkdtemp(prefix=seed_dir)
    ocfg = AdamWConfig(lr=3e-3, warmup_steps=20, decay_steps=steps)
    tcfg = TrainerConfig(total_steps=steps, checkpoint_every=steps,
                         checkpoint_dir=d, log_every=max(1, steps // 6))
    mid = steps // 2
    out = io.StringIO()
    mons = [_LoggedMonitor(tcfg.straggler_factor) for _ in range(2)]
    try:
        with contextlib.redirect_stdout(out):
            first = Trainer(model, ocfg, tcfg, monitor=mons[0], device=dev)

            def hook(step, p, m):
                if step + 1 == mid:
                    first._preempted = True       # as a SIGTERM would
            t0 = time.perf_counter()
            _, _, info1 = first.run(params, feed, step_hook=hook)
            first_s = time.perf_counter() - t0
            from repro_torch.checkpoint import Checkpointer
            committed = Checkpointer(d).list_steps()
            second = Trainer(model, ocfg, tcfg, monitor=mons[1], device=dev)
            t0 = time.perf_counter()
            params, _, info2 = second.run(params, feed)
            second_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(d, ignore_errors=True)
    lines = out.getvalue().splitlines()
    resumed = [ln for ln in lines if "resumed from step" in ln]
    hist = info1["history"] + info2["history"]
    step_s = mons[0].log + mons[1].log
    rec = {"optimizer": dataclasses.asdict(ocfg), "steps": steps,
           "preempted_at": mid, "committed_after_preemption": committed,
           "resumed": resumed, "losses_first_last_5": [hist[:5], hist[-5:]],
           "loss_mean_first_5": sum(hist[:5]) / 5,
           "loss_mean_last_5": sum(hist[-5:]) / 5,
           "step_ms": _percentiles([s * 1e3 for s in step_s]),
           "run_s": [first_s, second_s], "stragglers": [
               info1["stragglers"], info2["stragglers"]],
           "trainer_lines": lines[:3] + lines[-3:]}
    if committed != [mid] or resumed != [f"[trainer] resumed from step "
                                         f"{mid}"] \
            or len(hist) != steps:
        raise AssertionError(f"preemption / resume: {rec}")
    if not all(math.isfinite(x) for x in hist):
        raise AssertionError(f"a non-finite loss: {rec}")
    return params, rec


def heldout_xent(model, params, vocab, dev):
    """The reference example's held-out split: 4 ``markov_batches(16, 64,
    vocab, seed=7, start=100_000)``, mean xent."""
    from repro_torch.data.synthetic import markov_batches
    from repro_torch.training.train_loop import to_device
    xs = []
    with torch.no_grad():
        for b, _ in zip(markov_batches(16, 64, vocab, seed=7, start=100_000),
                        range(4)):
            xs.append(float(model.train_loss(params, to_device(b, dev))[1]
                            ["xent"]))
    return sum(xs) / len(xs)


def speculate_vs_verifier(dev, model16, fp16, reqs):
    """Self-speculation on phase 6's configuration with the w4 tree of the
    fp tree ``fp16`` drafting (``draft_k`` 4) and its w8 tree verifying,
    captured, against the verifier-only engine on the same w8 tree: a first
    run each (counted), a repeat each timed in this call. Tokens must be
    bit-identical. Returns the record, with the speculative first run's
    kernel B launches by variant and the split by bits the path implies."""
    from repro_torch.kernels import dequant_matmul as dm
    from repro_torch.kernels import ops
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import paged_attention_quant as paq
    from repro_torch.kernels import squant_flip as sf
    from repro_torch.serving import ServeEngine, WeightStore

    _reset_launches(dm, pa, paq, sf)
    t0 = time.perf_counter()
    eng = ServeEngine(model16, fp16, paged_config(
        speculative=True, draft_bits=4, draft_k=4), device=dev)
    torch.cuda.synchronize()
    stage_ms = (time.perf_counter() - t0) * 1e3
    a_n, s_n = sf.launches, sf.scale_launches
    rec = _instrument_spec(eng)
    _reset_launches(dm, pa, paq, sf)
    outs, first = _run_counted(eng, reqs, rec)
    launches = ops.combine_launches(ops.launch_counts(),
                                    eng.replay_launches())
    st = eng.scheduler.stats()
    want = _spec_path_launches(model16.cfg.n_layers, rec["chunk"].log,
                               rec["verify"].log, rec["chain"].log,
                               rec["draft_admit"].log)
    _, repeat = _run_counted(eng, reqs, rec)
    plain = ServeEngine(model16, None, paged_config(), device=dev,
                        store=WeightStore(serving_params=eng.params,
                                          device=dev))
    plain_outs, plain_first = _run_counted(plain, reqs)
    _, plain_repeat = _run_counted(plain, reqs)
    plain.close()
    differing = [r.request_id for o, p, r in zip(outs, plain_outs, reqs)
                 if o.tokens != p.tokens]
    spec = {k: st[k] for k in ("spec_cycles", "draft_tokens_proposed",
                               "draft_tokens_accepted", "acceptance_rate",
                               "accepted_len")}
    res = {"stage_ms_w8_and_w4": stage_ms, "squant_flip_launches_stage": a_n,
           "squant_scale_launches_stage": s_n,
           "speculative": spec, "first_run": first, "repeat_run": repeat,
           "verifier_only": {"first_run": plain_first,
                             "repeat_run": plain_repeat},
           "tokens_per_s_repeat": {
               "speculative": repeat["tokens_per_s"],
               "verifier_only": plain_repeat["tokens_per_s"],
               "ratio": repeat["tokens_per_s"]
               / plain_repeat["tokens_per_s"]},
           "launches": {
               "dequant_matmul_by_variant":
                   launches["dequant_matmul.launches_by_variant"],
               "paged_attention": launches["paged_attention.launches"]},
           "tokens_equal_verifier_only": not differing}
    if model16.cfg.moe is None:      # (an MoE layer's launches: per expert)
        res["launches"]["dequant_matmul_by_variant_and_bits"] = \
            want["split"]
        if launches["dequant_matmul.launches_by_variant"] \
                != want["by_variant"] \
                or launches["paged_attention.launches"] \
                != want["paged_attention"]:
            raise AssertionError(f"speculative launches {launches}; the "
                                 f"path implies {want}")
    eng.close()
    del eng, plain
    torch.cuda.empty_cache()
    if differing:
        raise AssertionError(f"speculative tokens differ from verifier-only "
                             f"decode for requests {differing}: {res}")
    return res


class _CliRun:
    """``python <args> --ckpt-dir <a temporary directory>`` started on
    entering, collected by :meth:`collect`; killed, and its directory
    removed, on leaving (also when the caller fails first)."""

    def __init__(self, args, prefix):
        import tempfile
        self.dir = tempfile.mkdtemp(prefix=prefix)
        self.ckpt = os.path.join(self.dir, "ckpt")
        self.args = [sys.executable] + args + ["--ckpt-dir", self.ckpt]

    def __enter__(self):
        env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src") + (
            os.pathsep + os.environ["PYTHONPATH"]
            if os.environ.get("PYTHONPATH") else ""))
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(self.args, stdout=subprocess.PIPE,
                                     stderr=subprocess.PIPE, text=True,
                                     cwd=ROOT, env=env)
        return self

    def collect(self, timeout):
        from repro_torch.checkpoint import Checkpointer
        out, err = self.proc.communicate(timeout=timeout)
        ok = self.proc.returncode == 0
        return {"returncode": self.proc.returncode,
                "seconds_beside_this_process":
                    time.perf_counter() - self.t0,
                "stdout_tail": out.strip().splitlines()[-3:],
                "stderr_tail": err.strip().splitlines()[-3:],
                "checkpoints": Checkpointer(self.ckpt).list_steps()
                if ok else None}

    def __exit__(self, *exc):
        import shutil
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.communicate()
        shutil.rmtree(self.dir, ignore_errors=True)


def train_and_serve(dev, seed, steps, card):
    """11b: the reference example's ``--size 100m`` model (granite family,
    12 layers, d_model 768, 12/4 heads of 64, d_ff 2048, vocab 32 000,
    float32) trained by the port's ``Trainer`` (preempted at mid-run and
    resumed) on ``markov_batches(16, 64, 32000, seed=7)`` made on a thread;
    held-out xent gated below 0.8 ln(vocab); then SQuant w8 of the trained
    tree (kernel A) served on phase 6's configuration and chat traffic,
    captured (bfloat16 activations, kernels B and C counted), agreement
    against the one-slot contiguous oracle in float32 (gated at 0.98) and
    bfloat16 (printed, with the float32 oracle's top-2 margins), and
    self-speculation (w4 drafts of the same fp tree, w8 verifier) against
    verifier-only decode (tokens gated equal); the training CLI once as a
    process, beside this one's training. Returns the line, the batches
    made (for 11c), the launch counts and the shapes phase 2 compares:
    kernel A's buckets and kernel C's case (a decode step's lengths)."""
    from repro_torch.configs import get_config
    from repro_torch.core.pipeline import quantize_tree
    from repro_torch.data.synthetic import markov_batches
    from repro_torch.kernels import squant_flip as sf
    from repro_torch.models.model import build_model

    t_phase = time.perf_counter()
    # the training CLI once, as a process on the card, while this one trains
    with _CliRun(["-m", "repro_torch.launch.train", "--arch", "granite-3-8b",
                  "--reduced", "--steps", "6"], "chip_smoke_train_cli_") \
            as cli_run:
        cfg = dataclasses.replace(get_config("granite-3-8b", reduced=True),
                                  **TRAIN_SIZE_100M)
        model = build_model(cfg)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        params = model.init(gen, device=dev)
        n_params = _numel(params)
        feed = _BatchFeed(markov_batches(16, 64, cfg.vocab, seed=7), steps)
        params, train = train_with_trainer(dev, model, params, feed, steps,
                                           "chip_smoke_train_")
        feed.close()
        train["data"] = "markov_batches(16, 64, 32000, seed=7), on a thread"
        train["host_ms_per_batch"] = _percentiles(feed.host_ms)
        train["trainer_wait_ms_per_batch"] = _percentiles(feed.wait_ms)
        xent = heldout_xent(model, params, cfg.vocab, dev)
        limit = 0.8 * math.log(cfg.vocab)

        # SQuant w8 of the trained tree, served (bfloat16 activations)
        reqs = chat_requests(seed, cfg.vocab)
        _reset_launches(*_kernel_modules())
        t0 = time.perf_counter()
        tree, qrep = quantize_tree(params, method="squant", bits=8,
                                   device=dev)
        torch.cuda.synchronize()
        quantize = {"total_ms": (time.perf_counter() - t0) * 1e3,
                    "report": qrep.summary(), "squant_flip": sf.launches,
                    "squant_scale": sf.scale_launches}
        m16 = build_model(dataclasses.replace(cfg, dtype="bfloat16"))
        served = _serve_paged(dev, m16, _retyped(tree, torch.bfloat16),
                              reqs)
        rep32, _, _ = measure_agreement(dev, model, tree, reqs, False,
                                        torch.float32)
        rep16, _, oracle16 = measure_agreement(dev, model, tree, reqs, False,
                                               torch.bfloat16)
        margin = oracle_margins(dev, model, tree, reqs, oracle16)
        missed = [margin[p] for p in rep16.mismatches if p in margin]
        del tree
        torch.cuda.empty_cache()
        spec = speculate_vs_verifier(dev, m16,
                                     _retyped(params, torch.bfloat16), reqs)
        cli = cli_run.collect(timeout=300)

    del params
    torch.cuda.empty_cache()
    line = {"phase": "11b a trained dense model (the reference example's "
                     "--size 100m), quantized and served", "card": card,
            "model": cfg.name, "shape": {k: getattr(cfg, k) for k in (
                "n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim",
                "d_ff", "vocab", "dtype")}, "params": n_params,
            "train": train, "reduced": _steps_cut(steps),
            "heldout_xent": xent, "heldout_limit": limit,
            "heldout": "4 x markov_batches(16, 64, 32000, seed=7, "
                       "start=100_000)",
            "quantize": quantize, "serve_bfloat16": served,
            "agreement": {"against": "paged vs contiguous (one slot)",
                          "budget": 0.98, "gated": "float32 activations",
                          "rate": rep32.rate, "matched": rep32.matched,
                          "compared": rep32.compared,
                          "rate_bfloat16": rep16.rate,
                          "matched_bfloat16": rep16.matched,
                          "bfloat16_disagreements_float32_margin": {
                              "disagreements": len(rep16.mismatches),
                              "margin_at_disagreements": _quantiles(missed),
                              "margins_sorted": sorted(missed),
                              "margin_at_all_positions": _quantiles(
                                  list(margin.values())),
                              "positions": len(margin)}},
            "speculative": spec, "train_cli": cli,
            "seconds": time.perf_counter() - t_phase}
    emit(line)
    if not xent < limit:
        raise AssertionError(f"held-out xent {xent:.4f} >= {limit:.4f}")
    if rep32.rate < 0.98:
        raise AssertionError(f"trained model: float32 agreement "
                             f"{rep32.rate:.4f} < 0.98")
    if cli["returncode"] != 0 or not any(
            "[train] done: loss" in ln for ln in cli["stdout_tail"]) \
            or cli["checkpoints"] != [6]:
        raise AssertionError(f"the training CLI: {cli}")
    pc = paged_config()
    shapes = {"a": _a_buckets(qrep), "c": dict(
        b=pc.max_slots, kv=cfg.n_kv_heads, rep=cfg.n_heads // cfg.n_kv_heads,
        d=cfg.head_dim, bs=pc.block_size, nb=pc.max_len // pc.block_size,
        lengths=served["decode_lengths"])}
    return line, feed.made, _phase11_launches(
        quantize["squant_flip"], quantize["squant_scale"], spec,
        serve_b=served["dequant_matmul_by_variant"],
        serve_c=served["paged_attention"]), shapes


def _kernel_modules():
    from repro_torch.kernels import dequant_matmul as dm
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import paged_attention_quant as paq
    from repro_torch.kernels import squant_flip as sf
    return dm, pa, paq, sf


def train_moe_and_serve(dev, seed, batches, card):
    """11c (ii): moonshot's routing (64 experts, top-6, capacity 1.25) at
    11b's width, trained by the ``Trainer`` on 11b's batches and steps;
    then SQuant w8, 10c's agreement against the one-slot contiguous oracle
    admitting in the same 64-token chunks (float32, 10c's gates), and
    self-speculation on the MoE stack (bfloat16, w4 drafts, w8 verifier):
    tokens equal to verifier-only (gated), acceptance. Returns the line,
    the launch counts and kernel A's buckets (for phase 2)."""
    from repro_torch.configs import get_config
    from repro_torch.core.pipeline import quantize_tree
    from repro_torch.kernels import squant_flip as sf
    from repro_torch.models.model import build_model
    from repro_torch.serving.equivalence import agreement_budget

    t_phase = time.perf_counter()
    base = get_config(MOE_ARCH)
    cfg = dataclasses.replace(base, name=f"{base.name}-at-100m-width",
                              **MOE_AT_100M_WIDTH)
    if (cfg.moe.n_experts, cfg.moe.top_k, cfg.moe.capacity_factor) \
            != (64, 6, 1.25):
        raise AssertionError(f"{MOE_ARCH}'s routing is {cfg.moe}")
    model = build_model(cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    params = model.init(gen, device=dev)
    n_params = _numel(params)
    params, train = train_with_trainer(dev, model, params, iter(batches),
                                       len(batches), "chip_smoke_moe_")
    train["data"] = "11b's batches"
    train["reduced"] = _steps_cut(len(batches))
    xent = heldout_xent(model, params, cfg.vocab, dev)

    reqs = chat_requests(seed, cfg.vocab)
    _reset_launches(*_kernel_modules())
    tree, qrep = quantize_tree(params, method="squant", bits=8, device=dev)
    torch.cuda.synchronize()
    a_n, s_n = sf.launches, sf.scale_launches
    budget = agreement_budget(paged_config(), cfg)
    agree, oracle_s, _ = measure_agreement(
        dev, model, tree, reqs, False, torch.float32,
        prefill_chunk=paged_config().prefill_chunk)
    turns = agreement_by_turn(agree, reqs)
    del tree
    torch.cuda.empty_cache()
    m16 = build_model(dataclasses.replace(cfg, dtype="bfloat16"))
    spec = speculate_vs_verifier(dev, m16, _retyped(params, torch.bfloat16),
                                 reqs)
    del params
    torch.cuda.empty_cache()
    line = {"phase": "11c (ii) a trained MoE (moonshot's routing at 11b's "
                     "width), quantized and served", "card": card,
            "model": cfg.name, "shape": {k: getattr(cfg, k) for k in (
                "n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim",
                "d_ff", "vocab", "dtype")},
            "moe": dataclasses.asdict(cfg.moe), "params": n_params,
            "train": train, "heldout_xent": xent,
            "quantize": {"report": qrep.summary(), "squant_flip": a_n},
            "agreement": {"against": "contiguous, one slot, admission in "
                          "the same 64-token chunks", "budget": budget,
                          "gated": "float32 activations; all "
                                   f">= {budget}, first turns equal "
                                   "tokens, second turns "
                                   f">= {SHIFTED_CHUNK_FLOOR}",
                          "rate": agree.rate, "matched": agree.matched,
                          "compared": agree.compared,
                          "oracle_run_s": oracle_s, "by_turn": turns},
            "speculative": spec,
            "seconds": time.perf_counter() - t_phase}
    emit(line)
    if budget != 0.85 or agree.rate < budget \
            or turns["first"]["mismatches"] \
            or turns["second"]["rate"] < SHIFTED_CHUNK_FLOOR:
        raise AssertionError(f"trained MoE agreement {agree.rate:.4f} "
                             f"(budget {budget}), by turn {turns}")
    if not spec["speculative"]["draft_tokens_accepted"] > 0:
        raise AssertionError(f"MoE speculation accepted nothing: {spec}")
    return line, _phase11_launches(a_n, s_n, spec), _a_buckets(qrep)


def _phase11_launches(a_n, s_n, spec, serve_b=None, serve_c=0):
    """A part's launches for the ``kernels`` line: kernel A and the scale
    pass (a ``quantize_tree`` and the speculative engine's w8 + w4 stage),
    kernel B by variant (the served run's, the speculative run's, and,
    where the path gives it, the latter by bits), kernel C."""
    b = {"speculative": {k: v for k, v in spec["launches"].items()
                         if k.startswith("dequant_matmul")}}
    if serve_b is not None:
        b["serve"] = serve_b
    return {"squant_flip": a_n + spec["squant_flip_launches_stage"],
            "squant_scale": s_n + spec["squant_scale_launches_stage"],
            "dequant_matmul": b,
            "paged_attention": serve_c + spec["launches"]["paged_attention"]}


def drive_training(dev, seed, layers11, train_steps, card, memory):
    """Phase 11: 11a, 11b (and its step with remat on and off), 11c; each
    part's memory gated like a phase's. Returns each kernel's launches by
    part ({kernel: {part: ...}}) and the shapes phase 2 compares at:
    kernel A's buckets and kernel B's launch shapes by part, kernel C's
    case."""
    from repro_torch.kernels import dequant_matmul as dm
    t0 = time.perf_counter()
    # the learning rates at which ten steps lower the loss on the card
    # (PERF.md §6: granite also falls at 1e-3, with a bump; moonshot stays
    # flat at 3e-4)
    train_full_width(dev, seed, layers11, card, lr=3e-4)
    phase_memory("11a", memory)
    # kernel B's plan cache doubles as the record of the launch shapes a
    # part made: emptied before it, read after it
    dm._plans.clear()
    _, batches, l11b, s11b = train_and_serve(dev, seed, train_steps, card)
    b11b = dm.cached_plans()
    phase_memory("11b", memory)
    remat_on_off(dev, seed, card)
    phase_memory("11b remat", memory)
    train_full_width(dev, seed, 2, card, arch=MOE_ARCH, seq=256,
                     micro_check=False, lr=1e-3)
    phase_memory("11c (i)", memory)
    dm._plans.clear()
    _, l11c, a11c = train_moe_and_serve(dev, seed, batches, card)
    b11c = dm.cached_plans()
    del batches
    phase_memory("11c (ii)", memory)
    emit({"phase": "11 seconds", "card": card,
          "seconds": time.perf_counter() - t0})
    shapes = {"a": {"11b": s11b["a"], "11c (ii)": a11c},
              "b": {"11b": b11b, "11c (ii)": b11c}, "c": s11b["c"]}
    return {k: {"11b": l11b[k], "11c (ii)": l11c[k]} for k in l11b}, shapes


def remat_on_off(dev, seed, card, steps=12):
    """11b's training step (the ``--size 100m`` model, ``make_train_step``
    with the example's optimizer, ``markov_batches(16, 64, 32000,
    seed=7)``) with remat on (the config's default) and off: step ms (host
    clock, the loss read back each step; steps 4 on), forward+backward and
    optimizer ms by CUDA events, peak memory (``_train_steps``), then where
    the device time goes over three more steps (``_profile_steps``)."""
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import markov_batches
    from repro_torch.models.model import build_model
    from repro_torch.training import train_loop as tl
    from repro_torch.training.optimizer import AdamWConfig, adamw_init

    for remat in (True, False):
        cfg = dataclasses.replace(get_config("granite-3-8b", reduced=True),
                                  remat=remat, **TRAIN_SIZE_100M)
        model = build_model(cfg)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        params = model.init(gen, device=dev)
        opt = adamw_init(params)
        batches = [tl.to_device(b, dev) for b, _ in zip(
            markov_batches(16, 64, cfg.vocab, seed=7), range(steps))]
        step = tl.make_train_step(model, AdamWConfig(
            lr=3e-3, warmup_steps=20, decay_steps=600))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        params, opt, run = _train_steps(step, params, opt, batches)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        state = [params, opt]

        def one():
            state[0], state[1], met = step(state[0], state[1], batches[0])
            float(met["loss"])
        del params, opt
        _profile_steps(one, 3, f"11b train step, remat "
                               f"{'on' if remat else 'off'}", {
            "card": card, "model": "examples/train_then_quantize.py "
                                   "--size 100m", "remat": remat,
            "tokens_per_step": 16 * 64,
            "step_ms_p50_steps_4_on": _percentiles(run["step_ms"][3:])["p50"],
            "forward_backward_ms_p50":
                _percentiles(run["forward_backward_ms"][3:])["p50"],
            "optimizer_ms_p50": _percentiles(run["optimizer_ms"][3:])["p50"],
            "peak_memory_gb": peak_gb})
        del state, batches, one
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# optional: where a decode step's time goes (--profile)
# ---------------------------------------------------------------------------

def _device_events(prof):
    """The device activity of a ``torch.profiler`` run (kernels, copies,
    memsets) as (start us, duration us, name, grid) from its Chrome trace,
    in start order."""
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return sorted((float(e["ts"]), float(e.get("dur", 0.0)), e["name"],
                   tuple(e.get("args", {}).get("grid", ())))
                  for e in events
                  if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))


_B_KERNELS = ("tcgemv_kernel", "pf_kernel", "gemv_kernel", "tiled_kernel")


def _profile_steps(step, steps, phase, extra, b_part=None, gap_part=None):
    """Trace ``steps`` calls of ``step()`` (after two warm ones) with
    ``torch.profiler`` and print device time by kernel (summed over
    kernels), the device's busy time (the union of the kernels' intervals)
    and its share of the untraced wall time, the number of device kernels
    per step, and the device time split into kernel C, kernel B,
    host-to-device copies and everything else. ``b_part(grid, name)``
    names the part a kernel-B launch of that grid and kernel name serves:
    kernel B's time is then split by part (a merge pass goes with the
    launch before it). ``gap_part(part)`` names the part the other device
    kernels serve that run after a kernel-B launch of ``part`` (before the
    first: ``None``) and before the next one."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):                                   # warm
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    t1 = time.perf_counter()
    for _ in range(steps):                               # the same, untraced
        step()
    torch.cuda.synchronize()
    untraced_ms = (time.perf_counter() - t1) * 1e3
    split = {"paged_attention": 0.0, "host_to_device_copies": 0.0,
             "other": 0.0}
    by_name = {}
    # the union of the device intervals: a merge pass (kernels B and C)
    # launched as a programmatic dependent starts while the pass before it
    # runs, and the sum over kernels counts that overlap twice
    dev_us, busy_us, end, owner = 0.0, 0.0, None, "dequant_matmul"
    events = _device_events(prof)
    for ts, dur, name, grid in events:
        if end is None or ts > end:
            busy_us, end = busy_us + dur, ts + dur
        elif ts + dur > end:
            busy_us, end = busy_us + ts + dur - end, ts + dur
        dev_us += dur
        row = by_name.setdefault(name[:70], [0.0, 0])
        row[0] += dur
        row[1] += 1
        if "paged_decode_" in name:                  # split and merge pass
            key = "paged_attention"
        elif any(k in name for k in _B_KERNELS):
            owner = "dequant_matmul" if b_part is None else \
                f"dequant_matmul_{b_part(grid, name)}"
            key = owner
        elif "tcgemv_merge" in name:
            key = owner
        elif "HtoD" in name:
            key = "host_to_device_copies"
        elif gap_part is not None:
            key = gap_part(None if owner == "dequant_matmul"
                           else owner[len("dequant_matmul_"):])
        else:
            key = "other"
        split[key] = split.get(key, 0.0) + dur
    rows = sorted(((us, n, c) for n, (us, c) in by_name.items()),
                  reverse=True)
    line = {"phase": phase, **extra,
            "steps": steps, "wall_ms_per_step_traced": wall_ms / steps,
            "wall_ms_per_step_untraced": untraced_ms / steps,
            "device_ms_per_step": dev_us / 1e3 / steps,
            "device_busy_ms_per_step": busy_us / 1e3 / steps,
            "device_busy_share_of_untraced_wall":
                busy_us / 1e3 / untraced_ms,
            "device_kernels_per_step": len(events) / steps,
            "device_ms_per_step_by_part": {k: v / 1e3 / steps
                                           for k, v in split.items()},
            "top_device_time": [{"name": n, "ms_per_step": us / 1e3 / steps,
                                 "calls_per_step": c / steps}
                                for us, n, c in rows[:12]]}
    emit(line)
    return line


def profile_decode(dev, seed, layers, batch=4, steps=4):
    """Where a decode step's time goes, round path and paged continuous
    path, and where an admission chunk forward's goes (``--profile``)."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    from repro_torch.serving import ServeConfig, ServeEngine, WeightStore

    cfg = dataclasses.replace(get_config("granite-3-8b"), n_layers=layers)
    model = build_model(cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    params = model.init(gen, device=dev)
    eng = ServeEngine(model, params, ServeConfig(
        max_batch=batch, max_len=256, quantize_weights="squant",
        weight_bits=8, dequantize_for_compute=False), device=dev)
    del params
    torch.cuda.empty_cache()
    prompt = torch.randint(0, cfg.vocab, (batch, 96), generator=gen, device=dev)
    state = {"cache": eng.model.init_cache(batch, 256, device=dev)}
    state["lg"], state["cache"] = eng.model.prefill(
        eng.params, {"tokens": prompt}, state["cache"])

    def round_step():
        nxt = state["lg"].argmax(-1)
        nxt.cpu()                                        # the step's host sync
        state["lg"], state["cache"] = eng.model.decode_step(
            eng.params, nxt[:, None], state["cache"])

    _profile_steps(round_step, steps, "profile of decode steps, round path",
                   {"layers": layers, "batch": batch})

    # the paged continuous path: 8 slots of phase 6's traffic admitted into
    # the block pool, then the scheduler's decode step (table push
    # included), captured, then eager (capture=False); then one
    # admission chunk of phase 6's configuration, 64 rows after the
    # 192-token shared prefix on the one-row side cache (the same positions
    # rewritten each call), through the engine's chunk entry point
    reqs = chat_requests(seed, cfg.vocab)[:8]
    prefix, chunk = 192, paged_config().prefill_chunk
    toks = torch.randint(0, cfg.vocab, (chunk,), generator=gen,
                         device=dev).cpu().numpy()
    for capture in (True, False):
        label = "captured" if capture else "eager"
        peng = ServeEngine(model, None, paged_config(),
                           store=WeightStore(serving_params=eng.params,
                                             device=dev), device=dev,
                           capture=capture)
        kv = peng.scheduler.kv
        kv.admit([(i, r) for i, r in enumerate(reqs)], list(range(8)), None,
                 peng.params)
        slots = list(range(8))

        def paged_step():
            nxt = kv.logits.argmax(-1).to(torch.int32)
            nxt.cpu()                                    # the step's host sync
            kv.decode(peng.params, nxt, slots)

        _profile_steps(paged_step, steps,
                       f"profile of decode steps, paged continuous path, "
                       f"{label}",
                       {"layers": layers, "batch": 8, "capture": capture,
                        "context_lengths": kv._lengths.tolist()})
        side = kv.side_cache(1)
        _, side = peng.model.prefill(peng.params, {"tokens": torch.tensor(
            [reqs[0].prompt[:prefix]], device=dev)}, side)

        def chunk_step():
            t, clock = kv.chunk_inputs(toks, prefix)
            lg, _ = peng._prefill_chunk(peng.params, {"tokens": t},
                                        dict(side, pos=clock))
            lg.cpu()                                     # the step's host sync

        _profile_steps(chunk_step, steps,
                       f"profile of an admission chunk forward, paged "
                       f"continuous config, {label}",
                       {"layers": layers, "chunk_rows": chunk,
                        "start_position": prefix, "capture": capture})
        emit({"phase": f"profiled paged engine, {label}",
              "trace_counts": dict(peng.trace_counts),
              "graphs": peng.stats()["graphs"]})
        peng.close()
        del peng, kv, side
        torch.cuda.empty_cache()
    eng.close()


def profile_quantize(dev, seed, layers):
    """Where one SQuant w8 quantization of the main path's tree spends its
    device time (``--profile``): the serving pipeline's quantize function
    traced as ``scripts/quantize_tree_ab.py`` traces it, after a warm call."""
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    from quantize_tree_ab import trace
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    from repro_torch.serving import ServeConfig
    from repro_torch.serving.weights import make_weight_pipeline

    cfg = dataclasses.replace(get_config("granite-3-8b"), n_layers=layers)
    model = build_model(cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    params = model.init(gen, device=dev)
    _, quantize_fn, _ = make_weight_pipeline(model, ServeConfig(
        quantize_weights="squant", weight_bits=8,
        dequantize_for_compute=False), device=dev)
    quantize_fn(params)
    torch.cuda.synchronize()
    emit({"phase": "profile of quantize_tree", "layers": layers,
          **trace(lambda: quantize_fn(params))})
    del params
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# optional: which kernel costs the paged path its agreement (--agreement-
# variants)
# ---------------------------------------------------------------------------

def agreement_variants(dev, seed, layers, layers7):
    """Teacher-forced greedy agreement of phase 6's paged engine against its
    one-slot contiguous oracle with bfloat16 activations, with one kernel at
    a time swapped for its plain version in both engines (kernel C, kernel
    B, both) and with float32 activations; then phase 7's int8 pool against
    the fp pool in bfloat16 and float32 at ``layers7`` and at 2 layers. Also
    the oracle's top-1 minus top-2 logit gap over the sampled positions."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models.model import build_model
    from repro_torch.serving import ServeEngine

    originals = {"pa": ops.paged_attention, "dm": ops.dequant_matmul}

    def plain(fn):
        def call(*a, **kw):
            kw["backend"] = "ref"
            return fn(*a, **kw)
        return call

    runs = [(layers, False, torch.bfloat16, "kernels"),
            (layers, False, torch.bfloat16, "C plain"),
            (layers, False, torch.bfloat16, "B plain"),
            (layers, False, torch.bfloat16, "B and C plain"),
            (layers, False, torch.float32, "kernels"),
            (layers7, True, torch.bfloat16, "kernels"),
            (layers7, True, torch.float32, "kernels"),
            (2, True, torch.bfloat16, "kernels"),
            (2, True, torch.float32, "kernels")]
    trees = {}
    out = []
    for depth, quant, dtype, swap in runs:
        if depth not in trees:
            trees.clear()
            torch.cuda.empty_cache()
            cfg = dataclasses.replace(get_config("granite-3-8b"),
                                      n_layers=depth)
            model = build_model(cfg)
            gen = torch.Generator(device=dev)
            gen.manual_seed(seed)
            params = model.init(gen, device=dev)
            trees[depth] = (model, ServeEngine(
                model, params, paged_config(), device=dev).params)
            del params
            torch.cuda.empty_cache()
        model, tree = trees[depth]
        ops.paged_attention = plain(originals["pa"]) \
            if "C plain" in swap or swap == "B and C plain" \
            else originals["pa"]
        ops.dequant_matmul = plain(originals["dm"]) \
            if swap in ("B plain", "B and C plain") else originals["dm"]
        reqs = chat_requests(seed, model.cfg.vocab)
        t0 = time.perf_counter()
        rep, _, _ = measure_agreement(dev, model, tree, reqs, quant, dtype)
        row = {"phase": "agreement variant", "layers": depth,
               "pool": "int8 vs fp paged" if quant
               else "paged vs one-slot contiguous",
               "activations": str(dtype).replace("torch.", ""),
               "swap": swap, "rate": rep.rate, "matched": rep.matched,
               "compared": rep.compared,
               "seconds": time.perf_counter() - t0}
        emit(row)
        out.append(row)
    ops.paged_attention, ops.dequant_matmul = originals["pa"], \
        originals["dm"]
    return out


# ---------------------------------------------------------------------------
# phase 12: MLA (minicpm3-4b) and the sliding-window ring (mixtral-8x7b) on
# the contiguous continuous path and the round scheduler
# ---------------------------------------------------------------------------

MLA_ARCH = "minicpm3-4b"
SWA_ARCH = "mixtral-8x7b"
# 12b's traffic: prompts past mixtral's 4096-token window, so every
# admission and every decode step wraps the ring. The ring holds
# min(max_len, window) slots whatever max_len is; max_len leaves room for a
# mid-flight admission's committed clock (a 64-token chunk a step catching
# up with a clock past 4400 commits ~70 positions ahead of it)
SWA_PROMPTS = (4160, 4480)
SWA_MAX_LEN = 4736
SWA_NEW, SWA_SHORT_NEW = 48, 16
# 12c's published-capacity traffic at the reduced width, where
# tests/test_torch_mla_window_models.py reads the reference engine on the
# same weights: mixtral's routing as published (8 experts, top 2, capacity
# factor 1.25) at the reduced width, 2 layers, float32, a 64-token window;
# four prompts of 64 + 337 tokens (12c's excess over the window at seed 0)
# and SWA_NEW new tokens each; the 8-slot engine against the one-slot
# oracle, both admitting in 64-token chunks. SWA_REFERENCE_MATCHED is the
# reference engine's teacher-forced matches there, of 4 x SWA_NEW.
SWA_REFERENCE_WINDOW, SWA_REFERENCE_PROMPT = 64, 64 + 337
SWA_REFERENCE_MATCHED = 112


def contiguous_config(**over):
    """Phase 6's serve configuration on the contiguous KV cache (the
    reference gates the paged backend off MLA and sliding-window caches)."""
    return paged_config(**dict(dict(kv_backend="contiguous"), **over))


def swa_requests(seed, vocab, n=12, short=4):
    """12b's traffic: ``n`` requests of 4160-4480 random prompt tokens from
    ``seed``, 48 new tokens each except the first ``short`` (16). Those
    retire while the rest of the first wave decodes, so the last four are
    admitted into their slots mid-flight: the contiguous pool shares one
    clock, and a wave whose requests all ask for the same number of tokens
    retires on one step, after which the next admission is a fresh wave."""
    import numpy as np
    from repro_torch.serving import Request
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        plen = int(rng.integers(SWA_PROMPTS[0], SWA_PROMPTS[1] + 1))
        out.append(Request(rng.integers(0, vocab, size=plen).tolist(),
                           SWA_SHORT_NEW if i < short else SWA_NEW,
                           request_id=i))
    return out


def _block_linears(cfg, kind, moe, rows, exp_rows, dropless):
    """Kernel B's launches of one block of ``kind`` in call order, as
    (part, rows, M, N): rwkv's time mix (the decay LoRA, then r, k, v, g,
    then the output) and channel mix (k, r, v); mamba's four projections;
    MLA's five projections (its ``kv_up`` on ``exp_rows``, the re-expanded
    cache) or GQA's four; then the SwiGLU FFN's three, or, in an MoE layer,
    its three banks once per expert on the capacity's rows (``rows`` when
    ``dropless``)."""
    d = cfg.d_model
    if kind == "rwkv":
        lora, f = 64, cfg.d_ff
        return ([("decay_lora", rows, lora, d), ("decay_lora", rows, d, lora)]
                + [("time_mix_rkvg", rows, d, d)] * 4
                + [("time_mix_out", rows, d, d), ("channel_mix", rows, f, d),
                   ("channel_mix", rows, d, d), ("channel_mix", rows, d, f)])
    if kind == "m":
        m = cfg.mamba
        di, r = m.expand * d, m.dt_rank or max(1, d // 16)
        per = [("mamba_in_proj", rows, 2 * di, d),
               ("mamba_x_dt_proj", rows, r + 2 * m.d_state, di),
               ("mamba_x_dt_proj", rows, di, r),
               ("mamba_out_proj", rows, d, di)]
    elif cfg.mla is not None:
        m, h = cfg.mla, cfg.n_heads
        per = [("attention", rows, m.q_lora, d),
               ("attention", rows, h * (m.nope_dim + m.rope_dim), m.q_lora),
               ("attention", rows, m.kv_lora + m.rope_dim, d),
               ("attention", exp_rows, h * (m.nope_dim + m.v_dim), m.kv_lora),
               ("attention", rows, d, h * m.v_dim)]
    else:
        q, kv = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
        per = [("attention", rows, q, d), ("attention", rows, kv, d),
               ("attention", rows, kv, d), ("attention", rows, d, q)]
    ffn = [(cfg.d_ff, d), (cfg.d_ff, d), (d, cfg.d_ff)]
    if moe:
        e, k = cfg.moe.n_experts, cfg.moe.top_k
        cap = rows if dropless else min(rows, max(1, math.ceil(
            rows * k * cfg.moe.capacity_factor / e)))
        per += [("experts", cap, mm, nn) for mm, nn in ffn for _ in range(e)]
    else:
        per += [("ffn", rows, mm, nn) for mm, nn in ffn]
    return per


def _forward_linears(cfg, layers, rows, exp_rows, dropless):
    """Kernel B's launches of one forward of ``rows`` tokens through
    ``layers`` layers (whole periods of ``layer_plan``) in call order, as
    :func:`_block_linears` gives them, and the untied ``lm_head``'s."""
    from repro_torch.models.transformer import layer_plan
    plan = layer_plan(cfg)
    out = []
    for kind, moe in plan * (layers // len(plan)):
        out += _block_linears(cfg, kind, moe, rows, exp_rows, dropless)
    if not cfg.tie_embeddings:
        out.append(("lm_head", rows, cfg.vocab, cfg.d_model))
    return out


def _b_forward_shapes(cfg, layers, rows, exp_rows, dropless):
    """Kernel B's launches, by ``dequant_matmul.shape_key`` (variant and
    weight (M, N)), of one forward of ``rows`` tokens through ``layers``
    layers in bfloat16 (:func:`_forward_linears`)."""
    from repro_torch.kernels.dequant_matmul import shape_key
    out = collections.Counter()
    for _, r, mm, nn in _forward_linears(cfg, layers, rows, exp_rows,
                                         dropless):
        out[shape_key(_variant(r, nn), mm, nn)] += 1
    return out


def _log_forwards(eng, chunk_ms):
    """Wrap the engine's decode, chunk and monolithic prefill entry points:
    each call appends (kind, batch rows, tokens a row) to the returned
    list, and each chunk forward its host ms to ``chunk_ms`` (synchronized
    at its end, as the scheduler synchronizes after every chunk)."""
    log = []

    def wrap(fn, kind):
        def call(params, batch, caches, *a, **kw):
            toks = batch["tokens"] if isinstance(batch, dict) else batch
            log.append((kind,) + tuple(toks.shape))
            if kind != "chunk":
                return fn(params, batch, caches, *a, **kw)
            t0 = time.perf_counter()
            out = fn(params, batch, caches, *a, **kw)
            torch.cuda.synchronize()
            chunk_ms.append((time.perf_counter() - t0) * 1e3)
            return out
        return call

    eng._decode = wrap(eng._decode, "decode")
    eng._prefill_chunk = wrap(eng._prefill_chunk, "chunk")
    eng._prefill = wrap(eng._prefill, "prefill")
    return log


def _b_expected(model, log, max_len, layers):
    """What the logged forwards imply for kernel B (``launches_by_shape``
    form): a decode step's rows are its slots and MLA re-expands every
    slot's ``max_len`` cache rows; a chunk writes ``chunk_rows`` a row
    (a singleton padded to two where the stack allows) and re-expands its
    side cache; a monolithic prefill expands its own tokens."""
    want = collections.Counter()
    for kind, b, n in log:
        if kind == "decode":
            rows, exp = b, b * max_len
        elif kind == "chunk":
            rows, exp = b * model.chunk_rows(n), b * max_len
        else:
            rows = exp = b * n
        want += _b_forward_shapes(model.cfg, layers, rows, exp,
                                  kind == "decode")
    return dict(want)


def _launch_deltas(before, after):
    return {k: after.get(k, 0) - before.get(k, 0)
            for k in set(before) | set(after)
            if after.get(k, 0) - before.get(k, 0)}


def _variants(**counts):
    """Kernel B's launches by variant as the wrapper counts them: ``counts``
    and 0 for every other variant id."""
    from repro_torch.kernels.dequant_matmul import VARIANTS
    return dict(dict.fromkeys(VARIANTS, 0), **counts)


def _b_by_variant(counts):
    """Kernel B's launches by variant in a :func:`ops.launch_counts`-form
    count, the variants that launched only."""
    return {v: n for v, n in
            counts["dequant_matmul.launches_by_variant"].items() if n}


def _served(dev, model, tree, cfg, reqs, label, check_b=True, repeat=False):
    """Serve ``reqs`` eagerly on ``cfg`` over the quantized ``tree`` (a
    store of its own, sharing the tree): tokens, step ms, the forwards
    made and kernel B's launches by shape, held to what the forwards imply
    (``check_b``); ``repeat`` serves the same requests again on the same
    engine and holds the tokens equal run to run."""
    from repro_torch.kernels import dequant_matmul as dm
    from repro_torch.serving import ServeEngine, WeightStore
    eng = ServeEngine(model, None, cfg, store=WeightStore(
        serving_params=tree, device=dev), device=dev)
    chunk_ms = []
    log = _log_forwards(eng, chunk_ms)
    layers = model.cfg.n_layers
    runs = []
    for _ in range(2 if repeat else 1):
        del log[:], chunk_ms[:]
        b0 = dict(dm.launches_by_shape)
        steps0 = len(getattr(eng.scheduler, "step_ms_log", ()))
        t0 = time.perf_counter()
        outs = eng.generate(reqs)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        got = _launch_deltas(b0, dm.launches_by_shape)
        want = _b_expected(model, log, cfg.max_len, layers)
        if check_b and got != want:
            raise AssertionError(f"{label}: kernel B launches by shape {got},"
                                 f" the path implies {want}")
        kinds = collections.Counter(k for k, _, _ in log)
        run = {"run_s": run_s, "forwards": dict(kinds),
               "chunk_rows": sorted({b * n for k, b, n in log
                                     if k == "chunk"}),
               "chunk_forward_ms": _percentiles(chunk_ms),
               "tokens": [o.tokens for o in outs],
               "dequant_matmul_by_shape": got,
               "dequant_matmul_by_variant": dict(collections.Counter(
                   k.split()[0] for k in got for _ in range(got[k])))}
        st = eng.stats()["scheduler"]
        if st.kind == "continuous":
            steps = list(eng.scheduler.step_ms_log)[steps0:]
            run.update(step_ms=_percentiles(steps), sampling_steps=len(steps),
                       admissions=[e for e in eng.scheduler.admission_log
                                   if e["request_id"] in {r.request_id
                                                          for r in reqs}
                                   ][-len(reqs):],
                       waves=st.waves, pendings_started=st.pendings_started)
        else:
            run.update(rounds=[dict(r) for r in eng.stats()["round_log"]])
        runs.append(run)
        for o, r in zip(outs, reqs):
            if len(o.tokens) != r.max_new_tokens or \
                    not all(0 <= t < model.cfg.vocab for t in o.tokens):
                raise AssertionError(f"{label}: request {r.request_id}: bad "
                                     f"tokens {o.tokens}")
    if repeat and runs[0]["tokens"] != runs[1]["tokens"]:
        raise AssertionError(f"{label}: tokens differ run to run")
    return eng, runs


def _quantized_engine(dev, model, params, cfg, stacked=()):
    """An engine that quantizes ``params`` (SQuant w8) on the card: the
    quantize breakdown, kernel A's launches (one flip and one scale pass a
    bucket, ``MAX_LEAVES`` leaves a launch, every bucket native and grouped
    except those whose tags ``stacked`` names, which must take the stacked
    route: there a grouped bucket takes one row-major flip launch a chunk
    and no scale pass, a whole-row one (``gNone``) no kernel) and the peak
    above the weights."""
    from repro_torch.kernels import dequant_matmul as dm
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import paged_attention_quant as paq
    from repro_torch.kernels import squant_flip as sf
    from repro_torch.serving import ServeEngine
    _reset_launches(dm, pa, paq, sf)
    weights = _tree_bytes(params)
    allocated = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    eng = ServeEngine(model, params, cfg, device=dev)
    peak = (torch.cuda.max_memory_allocated() - allocated) / 1e9
    qrep = eng.quant_report
    buckets = _a_buckets(qrep)
    slices = collections.Counter()
    for lr in qrep.layers:
        slices[lr.bucket] += lr.shape[0] if len(lr.shape) == 3 else 1
    want_scale = sum(-(-slices[b.key] // sf.MAX_LEAVES)
                     for b in qrep.buckets if b.route == "native")
    want = want_scale + sum(1 for b in qrep.buckets if b.route == "stacked"
                            and not b.key.endswith("gNone"))
    quantize = {"report": qrep.summary(), "total_ms": qrep.total_millis,
                "dispatch_ms": qrep.dispatch_millis,
                "sync_ms": qrep.sync_millis,
                "staged_ms": eng.store.current.staged_ms,
                "buckets": [{"key": b.key, "route": b.route,
                             "dispatch_ms": b.dispatch_millis}
                            for b in qrep.buckets],
                "launches": {"squant_flip": sf.launches,
                             "squant_flip_by_route": dict(
                                 sf.launches_by_route),
                             "squant_scale": sf.scale_launches},
                "peak_gb_above_weights": peak, "weights_gb": weights / 1e9}
    routes = {b.key: b.route for b in qrep.buckets}
    if not set(stacked) <= set(routes) or any(
            r != "stacked" if k in stacked
            else r != "native" or "g128" not in k for k, r in routes.items()):
        raise AssertionError(f"the buckets' routes are not those expected "
                             f"(every bucket native and grouped, the stacked "
                             f"route for {list(stacked)} only): "
                             f"{quantize['buckets']}")
    if stacked:
        quantize["stacked_buckets"] = list(stacked)
    if sf.launches != want or sf.scale_launches != want_scale:
        raise AssertionError(f"kernel A launches {sf.launches} (scale pass "
                             f"{sf.scale_launches}), the buckets imply {want} "
                             f"({want_scale})")
    return eng, quantize, buckets


def profile_mla_decode(dev, seed, tree, model, steps=4):
    """One contiguous decode step of 12a's model and tree, eight slots of
    its chat traffic admitted, traced (:func:`_profile_steps`): kernel B's
    device time split into the ``kv_up`` re-expansion (the step's only
    ``mma`` launches, on the slots' whole caches) and the other
    projections (``tcgemv``)."""
    from repro_torch.serving import ServeEngine, WeightStore
    eng = ServeEngine(model, None, contiguous_config(),
                      store=WeightStore(serving_params=tree, device=dev),
                      device=dev)
    kv = eng.scheduler.kv
    reqs = chat_requests(seed, model.cfg.vocab)[:eng.cfg.max_slots]
    slots = list(range(len(reqs)))
    kv.admit([(i, r) for i, r in enumerate(reqs)], slots,
             max(len(r.prompt) for r in reqs), eng.params)

    def step():
        nxt = kv.logits.argmax(-1)
        nxt.cpu()                                        # the step's host sync
        kv.decode(eng.params, nxt, slots)

    line = _profile_steps(
        step, steps, f"12a profile of a contiguous MLA decode step, "
        f"{model.cfg.name}", {"layers": model.cfg.n_layers,
                              "slots": len(slots),
                              "expanded_rows": len(slots) * eng.cfg.max_len},
        b_part=lambda grid, name: "kv_up_reexpansion" if "pf_kernel" in name
        else "other_projections")
    eng.close()
    return line


def drive_mla(dev, seed, layers):
    """12a: ``minicpm3-4b`` at full width and ``layers`` of its 62 layers
    (15i serves the same width tensor-parallel): random
    float32 weights from ``seed`` (bf16 embedding), SQuant w8 by kernel A,
    served real-quantized in bfloat16 on the contiguous continuous
    scheduler (8 slots, 64-token chunks) with phase 6's twelve chat
    requests twice (tokens equal run to run), on the round scheduler with
    phase 3's six requests, kernel B's launches by shape held to what the
    forwards imply each time; one decode step traced; the same engine with
    the weight-absorbed decode (``MLAConfig(absorb=True)``), timed, tokens
    not gated. Returns kernel A's and B's launches, kernel A's buckets and
    the line."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import dequant_matmul as dm
    from repro_torch.models.model import build_model
    from repro_torch.serving import ServeConfig

    t_phase = time.perf_counter()
    full = get_config(MLA_ARCH)
    cfg = dataclasses.replace(full, n_layers=layers)
    model = build_model(cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    t0 = time.perf_counter()
    params = model.init(gen, device=dev)
    torch.cuda.synchronize()
    init_ms = (time.perf_counter() - t0) * 1e3
    eng, quantize, buckets = _quantized_engine(dev, model, params,
                                               contiguous_config())
    quantize["init_ms"] = init_ms
    del params
    torch.cuda.empty_cache()
    tree = eng.params
    eng.close()
    a_n = quantize["launches"]["squant_flip"]
    s_n = quantize["launches"]["squant_scale"]
    b0 = dm.launches
    reqs = chat_requests(seed, cfg.vocab)
    ceng, cont = _served(dev, model, tree, contiguous_config(), reqs,
                         "12a contiguous", repeat=True)
    ceng.close()
    lengths, max_batch, max_new, max_len = ROUND_TRAFFIC
    rreqs = make_requests(seed, cfg.vocab, lengths, max_new)
    reng, rnd = _served(dev, model, tree, ServeConfig(
        max_batch=max_batch, max_len=max_len, quantize_weights="squant",
        weight_bits=8, dequantize_for_compute=False), rreqs, "12a round")
    reng.close()
    b_n = dm.launches - b0
    prof = profile_mla_decode(dev, seed, tree, model)
    amodel = build_model(dataclasses.replace(cfg, mla=dataclasses.replace(
        cfg.mla, absorb=True)))
    aeng, absorbed = _served(dev, amodel, tree, contiguous_config(), reqs,
                             "12a absorbed", check_b=False)
    aeng.close()
    same = sum(a == b for x, y in zip(cont[0]["tokens"],
                                      absorbed[0]["tokens"])
               for a, b in zip(x, y))
    line = {"phase": "12a MLA, contiguous continuous + round, "
                     f"{MLA_ARCH} w8, {layers} of {full.n_layers} layers "
                     "(62 before 15i came; cut for the script's time limit)",
            "model": cfg.name,
            "layers": cfg.n_layers, "full_depth": layers == full.n_layers,
            "d_model": cfg.d_model, "d_ff": cfg.d_ff, "vocab": cfg.vocab,
            "mla": dataclasses.asdict(cfg.mla), "weight_bits": 8,
            "activation_dtype": cfg.dtype, "quantize": quantize,
            "serve_config": {k: getattr(contiguous_config(), k) for k in (
                "scheduler", "kv_backend", "max_slots", "max_len",
                "prefill_chunk")},
            "prompt_lengths": [len(r.prompt) for r in reqs],
            "continuous_runs": cont, "tokens_equal_run_to_run": True,
            "round": rnd[0], "decode_step_profile": prof,
            "absorbed": {k: absorbed[0][k] for k in (
                "run_s", "step_ms", "forwards", "dequant_matmul_by_variant")},
            "absorbed_tokens_equal_expanded_not_gated":
                f"{same}/{sum(len(t) for t in cont[0]['tokens'])}",
            "launches": {"squant_flip": a_n, "squant_scale": s_n,
                         "dequant_matmul": b_n},
            "seconds": time.perf_counter() - t_phase}
    emit(line)
    del tree
    torch.cuda.empty_cache()
    return a_n, s_n, b_n, buckets, line


def drive_swa(dev, seed, layers):
    """12b: ``mixtral-8x7b`` at full width and ``layers`` of its 32 layers
    (8 experts top-2, window 4096): SQuant w8 with the expert banks
    quantized where they are stored, served in bfloat16 on the contiguous
    continuous scheduler (8 slots, 64-token chunks, max_len 4736) with 12
    requests of 4160-4480 prompt tokens (every prefill and decode wraps
    the ring; four admitted mid-flight) twice: tokens equal run to run,
    kernel B's launches by shape held to what the forwards imply (experts
    and attention). Returns kernel A's and B's launches, kernel A's
    buckets and the line."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import dequant_matmul as dm
    from repro_torch.models.model import build_model

    t_phase = time.perf_counter()
    full = get_config(SWA_ARCH)
    cfg = dataclasses.replace(full, n_layers=layers)
    model = build_model(cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    t0 = time.perf_counter()
    params = model.init(gen, device=dev)
    torch.cuda.synchronize()
    init_ms = (time.perf_counter() - t0) * 1e3
    scfg = contiguous_config(max_len=SWA_MAX_LEN)
    eng, quantize, buckets = _quantized_engine(dev, model, params, scfg)
    quantize["init_ms"] = init_ms
    del params
    torch.cuda.empty_cache()
    tree = eng.params
    eng.close()
    a_n = quantize["launches"]["squant_flip"]
    s_n = quantize["launches"]["squant_scale"]
    b0 = dm.launches
    reqs = swa_requests(seed, cfg.vocab)
    seng, runs = _served(dev, model, tree, scfg, reqs, "12b", repeat=True)
    ring = seng.scheduler.kv._cache["list"][0]["b0"]["k"].shape[1]
    seng.close()
    b_n = dm.launches - b0
    adm = runs[0]["admissions"]
    midflight = [e for e in adm if e["request_id"] >= 8]
    first = [e for e in adm if e["request_id"] < 8]
    parts = kernel_b_parts(cfg, runs[0]["dequant_matmul_by_shape"])
    line = {"phase": f"12b sliding window + MoE, contiguous continuous, "
                     f"{SWA_ARCH} w8", "model": cfg.name, "layers": layers,
            "full_depth": layers == full.n_layers,
            "reduced": None if layers == full.n_layers else
            {"n_layers": f"{full.n_layers} -> {layers} (6 until phase 15 "
                         f"came, 4 until 15l-n came, 2 until 15o (vi)-(vii) "
                         f"and 15p-q came)"},
            "d_model": cfg.d_model, "d_ff": cfg.d_ff, "vocab": cfg.vocab,
            "window": cfg.window, "ring_slots": ring,
            "moe": dataclasses.asdict(cfg.moe), "weight_bits": 8,
            "activation_dtype": cfg.dtype, "quantize": quantize,
            "serve_config": {k: getattr(scfg, k) for k in (
                "scheduler", "kv_backend", "max_slots", "max_len",
                "prefill_chunk")},
            "prompt_lengths": [len(r.prompt) for r in reqs],
            "max_new_tokens": [r.max_new_tokens for r in reqs],
            "first_wave_clock": max(e["clock"] for e in first),
            "midflight_admissions": midflight,
            "last_position": max(e["clock"] + reqs[e["request_id"]]
                                 .max_new_tokens for e in adm) - 1,
            "runs": [{k: v for k, v in r.items() if k != "tokens"}
                     for r in runs],
            "tokens_equal_run_to_run": True,
            "dequant_matmul_by_part": parts,
            "tokens": runs[0]["tokens"],
            "launches": {"squant_flip": a_n, "squant_scale": s_n,
                         "dequant_matmul": b_n},
            "seconds": time.perf_counter() - t_phase}
    emit(line)
    if ring != cfg.window or len(midflight) != 4 or any(
            e["chunks"] < 2 for e in midflight) or runs[0]["waves"] != 1 \
            or min(len(r.prompt) for r in reqs) <= cfg.window:
        raise AssertionError(f"12b: ring {ring} slots, mid-flight "
                             f"admissions {midflight}, waves "
                             f"{runs[0]['waves']}: expected the window's "
                             f"slots, one fresh wave and four chunked "
                             f"mid-flight admissions past the window")
    del tree
    torch.cuda.empty_cache()
    return a_n, s_n, b_n, buckets, line


def _codes_vs_plain(params, tree):
    """Every quantized leaf of the kernels' tree against the plain
    versions, leaf by leaf (an expert bank slice by slice, its codes rows
    ``i*out .. (i+1)*out``): scales bit-identical to the plain scale pass,
    codes equal up to the tie rule. A leaf whose input is no longer than a
    group quantizes whole-row, on the plain version in the path too:
    counted under ``whole_row_leaves``, its codes held equal."""
    from repro_torch.kernels import squant_flip as sf
    from repro_torch.kernels.ref import explain_code_differences
    from repro_torch.quant.qtypes import QuantizedTensor
    fp = _leaves(params)
    ties = {"rows": 0, "rows_differing": 0, "unexplained": 0, "leaves": 0,
            "whole_row_leaves": 0}
    kw = dict(bits=8, group_size=128)
    for path, a in _leaves(tree).items():
        if not isinstance(a, QuantizedTensor):
            continue
        w = fp[path]
        if w.shape[-2] <= kw["group_size"]:
            s = sf.squant_scales_plain([w], 8)
            want = sf.squant_flip_plain(w.T, s.reshape(-1, 1), bits=8,
                                        group_size=None)
            if w.ndim != 2 or not torch.equal(a.scale.reshape(s.shape), s) \
                    or not torch.equal(a.data, want):
                raise AssertionError(f"whole-row codes differ from the plain "
                                     f"version at {path}")
            ties["whole_row_leaves"] += 1
            continue
        slices = [w] if w.ndim == 2 else list(w.unbind(0))
        out = a.shape[0] // len(slices)
        s = a.scale.reshape(len(slices), out)
        if not torch.equal(s, sf.squant_scales_plain(slices, 8)):
            raise AssertionError(f"scales differ from the plain scale pass "
                                 f"at {path}")
        for i, sl in enumerate(slices):
            want = sf.squant_flip_leaves_plain([sl], s[i:i + 1], **kw)[0]
            res = explain_code_differences(
                sl.T, s[i][:, None], a.data[i * out:(i + 1) * out], want,
                **kw)
            for k in res:
                ties[k] += res[k]
            ties["leaves"] += 1
    if ties["unexplained"]:
        raise AssertionError(f"codes differ beyond the tie rule: {ties}")
    return ties


def _decode_vs_plain(dev, model, tree, prompt, steps=8):
    """Prefill and ``steps`` greedy decode steps through the kernels, then
    the same on the same tree under ``force_backend("ref")`` teacher-forced
    on the kernels' tokens: the plain path's greedy token equal at every
    step, logits within phase 5's 1e-3 of the largest."""
    from repro_torch.kernels import ops

    def run(tree, forced=None):
        cache = model.init_cache(prompt.shape[0], prompt.shape[1] + steps + 1,
                                 device=dev)
        lg, cache = model.prefill(tree, {"tokens": prompt}, cache)
        logits, toks = [lg], []
        for i in range(steps):
            nxt = lg.argmax(-1) if forced is None else forced[i]
            toks.append(nxt)
            lg, cache = model.decode_step(tree, nxt[:, None], cache)
            logits.append(lg)
        return torch.stack(logits), toks

    c0 = ops.launch_counts()
    lk, tk = run(tree)
    by = _b_by_variant(ops.launches_between(c0, ops.launch_counts()))
    with ops.force_backend("ref"):
        lp, _ = run(tree, forced=tk)
    torch.cuda.synchronize()
    err, mag = float((lk - lp).abs().max()), float(lp.abs().max())
    equal = bool(torch.equal(lk.argmax(-1), lp.argmax(-1)))
    out = {"prompt": list(prompt.shape), "decode_steps": steps,
           "logits_max_abs_err": err, "logits_max_abs": mag,
           "teacher_forced_tokens_equal": equal,
           "dequant_matmul_by_variant": by}
    if not equal or err > 1e-3 * mag:
        raise AssertionError(f"kernels vs plain at 2 layers: {out}")
    return out


def _kv_up_rows_probe(dev, gen, qt):
    """Whether kernel B's rows depend on how many rows share the launch, at
    the ``kv_up`` weight (the re-expansion's): the first rows of launches
    of 4096 down to 8 rows against the 4096-row launch's, bit for bit, in
    float32 and bfloat16, with the variant each took."""
    from repro_torch.kernels import dequant_matmul as dm
    from repro_torch.kernels import ops
    x = torch.randn((4096, qt.shape[1]), generator=gen, device=dev)
    out = {}
    for dt in (torch.float32, torch.bfloat16):
        xd = x.to(dt)
        full = ops.dequant_matmul(xd, qt)
        by = {}
        for r in (2048, 512, 64, 16, 8):
            part = ops.dequant_matmul(xd[:r].contiguous(), qt)
            var = dm.launch_plan(xd[:r], qt.data, qt.shape[0], 1, 128, 8)[0]
            by[str(r)] = {"variant": var,
                          "rows_equal_4096_row_launch": bool(
                              torch.equal(part, full[:r]))}
        out[str(dt).replace("torch.", "")] = {
            "variant_4096": dm.launch_plan(xd, qt.data, qt.shape[0], 1, 128,
                                           8)[0], "by_rows": by}
    return out


def _agreement(dev, model, tree, reqs, cfg, oracle_cfg):
    """Teacher-forced greedy agreement of ``cfg``'s engine against
    ``oracle_cfg``'s on the same quantized tree (a store each)."""
    from repro_torch.serving import ServeEngine, WeightStore
    from repro_torch.serving.equivalence import (greedy_token_agreement,
                                                 oracle_tokens)
    eng = ServeEngine(model, None, oracle_cfg, store=WeightStore(
        serving_params=tree, device=dev), device=dev)
    oracle = oracle_tokens(eng.generate(reqs))
    eng.close()
    eng = ServeEngine(model, None, cfg, store=WeightStore(
        serving_params=tree, device=dev), device=dev)
    rep = greedy_token_agreement(eng, reqs, oracle)
    eng.close()
    return rep, oracle


def swa_reference_case():
    """12c's published-capacity traffic at the reduced width (the
    ``SWA_REFERENCE_*`` constants): (model, float32 params on the CPU from a
    CPU generator seeded 0, so the card and the CPU test serve the same
    numbers, requests, the 8-slot and the one-slot oracle's ServeConfig
    keywords)."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    cfg = dataclasses.replace(
        get_config(SWA_ARCH, reduced=True), n_layers=2, dtype="float32",
        window=SWA_REFERENCE_WINDOW, moe=get_config(SWA_ARCH).moe)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    reqs = make_requests(0, cfg.vocab, [SWA_REFERENCE_PROMPT] * 4, SWA_NEW)
    kw = dict(scheduler="continuous", max_len=512, prefill_chunk=64)
    return model, params, reqs, dict(kw, max_batch=8), dict(kw, max_batch=1)


def swa_reference_agreement(dev):
    """The port on ``dev`` at :func:`swa_reference_case`: the 8-slot
    chunked engine's teacher-forced agreement with the one-slot chunked
    oracle (an AgreementReport)."""
    from repro_torch.serving import ServeConfig
    from repro_torch.training.optimizer import tree_map
    model, params, reqs, kw, one = swa_reference_case()
    rep, _ = _agreement(dev, model, tree_map(lambda t: t.to(dev), params),
                        reqs, ServeConfig(**kw), ServeConfig(**one))
    return rep


def mla_swa_vs_plain(dev, seed):
    """12c: each architecture at full width and 2 layers in float32: (i)
    SQuant w8 codes of kernel A against the plain versions' leaf by leaf,
    and a prefill plus 8 decode steps through the kernels against the
    plain versions on the same tree (mixtral's 4160-token prompt wraps the
    ring); (ii) teacher-forced
    agreement of the 8-slot chunked contiguous engine, on prompts of one
    length (so that no slot is padded): MLA against the one-slot
    monolithic oracle, gated at 0.98 with the reference's ``mla`` floor
    printed beside it, with the ``kv_up`` re-expansion's row-count
    probe; mixtral against the one-slot oracle admitting in the same
    64-token chunks, gated at the reference's budget (sliding_window x
    moe) with routing that drops no token; the published capacity's rate
    gated at the reference engine's reading on this traffic
    (``SWA_REFERENCE_MATCHED``), and the port at that traffic and on those
    weights (:func:`swa_reference_agreement`) gated to make the same
    matches; the one-slot monolithic oracle's rate printed."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core.pipeline import quantize_tree
    from repro_torch.models.model import build_model
    from repro_torch.serving.equivalence import (AGREEMENT_BUDGETS,
                                                 agreement_budget)
    t_phase = time.perf_counter()
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    line = {"phase": "12c MLA and the sliding-window ring at 2 layers "
                     "(float32): kernels vs plain versions, agreement"}
    for arch in (MLA_ARCH, SWA_ARCH):
        fails = []
        cfg = dataclasses.replace(get_config(arch), n_layers=2,
                                  dtype="float32")
        model = build_model(cfg)
        params = model.init(gen, device=dev)
        tree, _ = quantize_tree(params, method="squant", bits=8, device=dev)
        codes = _codes_vs_plain(params, tree)
        del params
        torch.cuda.empty_cache()
        plen = 64 if cfg.mla is not None else SWA_PROMPTS[0]
        prompt = torch.randint(0, cfg.vocab, (2, plen), generator=gen,
                               device=dev)
        plain = _decode_vs_plain(dev, model, tree, prompt)
        rng = np.random.default_rng(seed)
        if cfg.mla is not None:
            ccfg = contiguous_config()
            reqs = make_requests(seed, cfg.vocab, [256] * 8, 32)
            rep, oracle = _agreement(dev, model, tree, reqs, ccfg,
                                     contiguous_config(max_slots=1,
                                                       prefill_chunk=0))
            gate = 0.98
            agree = {"against": "contiguous, one slot, monolithic",
                     "gated": gate, "reference_floor_mla":
                         AGREEMENT_BUDGETS["mla"],
                     "kv_up_rows_probe": _kv_up_rows_probe(
                         dev, gen, tree["stack"]["list"][0]["b0"]["attn"]
                         ["kv_up"]["w"])}
            if rep.rate < 1.0:
                margin = oracle_margins(dev, model, tree, reqs, oracle)
                agree["float32_top2_margin_at_misses"] = sorted(
                    margin[p] for p in rep.mismatches if p in margin)
                agree["float32_top2_margin_all"] = _quantiles(
                    list(margin.values()))
        else:
            ccfg = contiguous_config(max_len=SWA_MAX_LEN)
            length = int(rng.integers(SWA_PROMPTS[0], SWA_PROMPTS[1] + 1))
            reqs = make_requests(seed, cfg.vocab, [length] * 4, SWA_NEW)
            one = dataclasses.replace(ccfg, max_slots=1)
            # a contiguous pending chunks its requests together, so an
            # 8-slot chunk routes 4 x 64 tokens under one capacity where the
            # one-slot oracle routes 64: the tokens each drops differ, and
            # over 4 000-token prompts the drops compound. Gated: routing
            # with a capacity that drops nothing (capacity_factor E / k),
            # where a token's experts do not depend on its chunk's company
            dropless = build_model(dataclasses.replace(
                cfg, moe=dataclasses.replace(
                    cfg.moe, capacity_factor=cfg.moe.n_experts
                    / cfg.moe.top_k)))
            rep, _ = _agreement(dev, dropless, tree, reqs, ccfg, one)
            pub, _ = _agreement(dev, model, tree, reqs, ccfg, one)
            mono, _ = _agreement(dev, model, tree, reqs, ccfg,
                                 dataclasses.replace(one, prefill_chunk=0))
            gate = agreement_budget(ccfg, cfg)
            # the published capacity, gated at the reference engine's own
            # reading on this traffic (pinned by the CPU test on the
            # reduced width's weights), and the port on the card at that
            # traffic and those weights, gated to make the same matches
            ref = swa_reference_agreement(dev)
            ref_rate = SWA_REFERENCE_MATCHED / (4 * SWA_NEW)
            if pub.rate < ref_rate or (ref.matched, ref.compared) != (
                    SWA_REFERENCE_MATCHED, 4 * SWA_NEW):
                fails.append(f"published capacity {pub.rate:.4f} (the "
                             f"reference's reading {ref_rate:.4f}); at the "
                             f"reduced width {ref.matched}/{ref.compared} "
                             f"(the reference's {SWA_REFERENCE_MATCHED})")
            agree = {"against": "contiguous, one slot, admission in the "
                                "same 64-token chunks", "gated": gate,
                     "gated_routing": "capacity_factor "
                     f"{cfg.moe.n_experts / cfg.moe.top_k} (no token "
                     "dropped)",
                     "published_capacity_rate": pub.rate,
                     "published_capacity_matched": pub.matched,
                     "published_capacity_gated_at_reference_reading":
                         ref_rate,
                     "reference_traffic_at_reduced_width": {
                         "matched": ref.matched, "compared": ref.compared,
                         "per_request": ref.per_request,
                         "gated_equal_to_reference_matched":
                             SWA_REFERENCE_MATCHED},
                     "rate_against_monolithic_oracle_not_gated": mono.rate,
                     "matched_against_monolithic_oracle": mono.matched}
        agree.update(rate=rep.rate, matched=rep.matched,
                     compared=rep.compared, requests=len(reqs),
                     prompt_length=len(reqs[0].prompt),
                     mismatches=[list(p) for p in rep.mismatches])
        line[arch] = {"codes_tie_rule": codes, "kernels_vs_plain": plain,
                      "agreement": agree}
        del tree
        torch.cuda.empty_cache()
        if rep.rate < gate:
            fails.append(f"agreement {rep.rate:.4f} < {gate}")
        if fails:
            emit(line)
            raise AssertionError(f"12c {arch}: {'; '.join(fails)}")
    line["seconds"] = time.perf_counter() - t_phase
    emit(line)
    return line


def drive_phase12(dev, seed, layers12, memory, layers12a):
    """Phase 12 (12a, 12b, 12c), each part's memory gated like a phase's.
    Returns the kernels' launches by part and the shapes phase 2 holds
    kernels A and B to: kernel A's buckets and kernel B's launch shapes
    (its plan cache, emptied before a part and read after it) by part."""
    from repro_torch.kernels import dequant_matmul as dm
    t0 = time.perf_counter()
    dm._plans.clear()
    a_a, s_a, b_a, buckets_a, _ = drive_mla(dev, seed, layers12a)
    plans_a = dm.cached_plans()
    phase_memory("12a", memory)
    dm._plans.clear()
    a_b, s_b, b_b, buckets_b, _ = drive_swa(dev, seed, layers12)
    plans_b = dm.cached_plans()
    phase_memory("12b", memory)
    mla_swa_vs_plain(dev, seed)
    phase_memory("12c", memory)
    emit({"phase": "12 seconds", "seconds": time.perf_counter() - t0})
    launches = {"squant_flip": {"12a": a_a, "12b": a_b},
                "squant_scale": {"12a": s_a, "12b": s_b},
                "dequant_matmul": {"12a": b_a, "12b": b_b}}
    return launches, {"a": {"12a": buckets_a, "12b": buckets_b},
                      "b": {"12a": plans_a, "12b": plans_b}}


# ---------------------------------------------------------------------------
# phase 13: the recurrent mixers (rwkv, mamba) on the contiguous path
# ---------------------------------------------------------------------------

RWKV_ARCH = "rwkv6-1.6b"
JAMBA_ARCH = "jamba-1.5-large-398b"
JAMBA_LAYERS = 8        # one period of jamba's block pattern, all 16 experts
# 13c's configurations: the rows of the reference's chunked-prefill sweep
# (tests/test_chunked_archs.py): rwkv at 2 layers, jamba's mixer isolated
# beside one attention layer, no MoE
RECURRENT_ISOLATED = {
    JAMBA_ARCH: dict(n_layers=2, block_pattern=("m", "a"), moe=None),
    RWKV_ARCH: dict(n_layers=2)}
# 13c's agreement traffic: eight prompts of one length (a contiguous wave
# left-pads a shorter prompt, and the recurrence absorbs the pads) and
# RECURRENT_NEW new tokens each, the 8-slot engine (64-token chunks)
# against the one-slot monolithic oracle. RECURRENT_REFERENCE_MATCHED: the
# reference engine's teacher-forced matches on that traffic at the reduced
# width (``recurrent_reference_case``; pinned by
# tests/test_torch_recurrent_models.py), of 8 x RECURRENT_NEW
RECURRENT_PROMPT, RECURRENT_NEW = 128, 32
RECURRENT_REFERENCE_MATCHED = {JAMBA_ARCH: 256, RWKV_ARCH: 256}


def recurrent_reference_case(arch):
    """13c's traffic at the reduced width of ``arch`` (its
    ``RECURRENT_ISOLATED`` configuration, float32, weights from a CPU
    generator seeded 0 so that the card and the CPU test serve the same
    numbers): (model, params on the CPU, requests, the 8-slot chunked and
    the one-slot monolithic oracle's ServeConfig keywords)."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    cfg = dataclasses.replace(get_config(arch, reduced=True), dtype="float32",
                              **RECURRENT_ISOLATED[arch])
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    reqs = make_requests(0, cfg.vocab, [RECURRENT_PROMPT] * 8, RECURRENT_NEW)
    kw = dict(scheduler="continuous", max_len=256, prefill_chunk=64)
    return model, params, reqs, dict(kw, max_batch=8), \
        dict(kw, max_batch=1, prefill_chunk=0)


def recurrent_reference_agreement(dev, arch):
    """The port on ``dev`` at :func:`recurrent_reference_case`: the 8-slot
    chunked engine's teacher-forced agreement with the one-slot monolithic
    oracle (an AgreementReport)."""
    from repro_torch.serving import ServeConfig
    from repro_torch.training.optimizer import tree_map
    model, params, reqs, kw, one = recurrent_reference_case(arch)
    rep, _ = _agreement(dev, model, tree_map(lambda t: t.to(dev), params),
                        reqs, ServeConfig(**kw), ServeConfig(**one))
    return rep


def _recurrent_gap(part):
    """The part of a decode step's other device kernels by the kernel-B
    launch before them (:func:`_profile_steps`' ``gap_part``): rwkv's WKV
    recurrence and ``ln_x`` run between the r/k/v/g projections and the
    output's; mamba's conv, softplus, discretization, state update and
    output contraction between ``in_proj`` and ``out_proj``; rwkv's token
    shifts, lerps, LoRA tanh, norms and residuals elsewhere in a layer."""
    if part == "time_mix_rkvg":
        return "wkv_recurrence_and_ln_x"
    if part in ("mamba_in_proj", "mamba_x_dt_proj"):
        return "mamba_mixer_ops"
    if part in ("decay_lora", "time_mix_out", "channel_mix"):
        return "rwkv_shift_lerp_norm_residual"
    return "other"


def profile_recurrent_decode(dev, seed, tree, model, phase, steps=4):
    """One contiguous decode step of ``model`` over ``tree`` with eight
    slots admitted (64-token prompts), traced (:func:`_profile_steps`):
    kernel B's device time split by the part each launch serves (read from
    the launch order of :func:`_forward_linears`; the split is dropped if
    the trace's kernel-B launches are not ``steps`` times that list), the
    other kernels by :func:`_recurrent_gap`, and a summary: the mixers'
    ops, the expert launches, other kernel B, the rest."""
    from repro_torch.serving import ServeEngine, WeightStore
    eng = ServeEngine(model, None, contiguous_config(),
                      store=WeightStore(serving_params=tree, device=dev),
                      device=dev)
    kv = eng.scheduler.kv
    reqs = make_requests(seed, model.cfg.vocab, [64] * eng.cfg.max_slots, 8)
    slots = list(range(len(reqs)))
    kv.admit([(i, r) for i, r in enumerate(reqs)], slots, 64, eng.params)
    order = [p for p, *_ in _forward_linears(model.cfg, model.cfg.n_layers,
                                             len(slots), len(slots), True)]
    seen = [0]

    def b_part(grid, name):
        seen[0] += 1
        return order[(seen[0] - 1) % len(order)]

    def step():
        nxt = kv.logits.argmax(-1)
        nxt.cpu()                                        # the step's host sync
        kv.decode(eng.params, nxt, slots)

    line = _profile_steps(step, steps, f"{phase} profile of a contiguous "
                          f"decode step, {model.cfg.name}",
                          {"layers": model.cfg.n_layers, "slots": len(slots),
                           "kernel_b_launches_per_step": len(order)},
                          b_part=b_part, gap_part=_recurrent_gap)
    eng.close()
    by = line["device_ms_per_step_by_part"]
    ok = seen[0] == steps * len(order)
    summary = {"kernel_b_split_by_launch_order_valid": ok,
               "kernel_b_launches_traced": seen[0]}
    if ok:
        b = {k[len("dequant_matmul_"):]: v for k, v in by.items()
             if k.startswith("dequant_matmul_")}
        summary.update(
            mixer_ops_ms=by.get("wkv_recurrence_and_ln_x", 0.0)
            + by.get("mamba_mixer_ops", 0.0)
            + by.get("rwkv_shift_lerp_norm_residual", 0.0),
            experts_ms=b.get("experts", 0.0),
            other_kernel_b_ms=sum(v for k, v in b.items() if k != "experts"),
            other_ms=by.get("other", 0.0)
            + by.get("host_to_device_copies", 0.0))
    line["summary"] = summary
    emit({"phase": f"{phase} decode step split", **summary})
    return line


def _serve_recurrent(dev, seed, model, tree, label):
    """13a's and 13b's traffic on ``tree``: phase 6's chat requests on the
    contiguous continuous path twice (tokens equal run to run) and phase
    3's on the round scheduler, kernel B's launches by shape held to what
    the forwards imply each time. Returns (continuous runs, round run,
    kernel B launches)."""
    from repro_torch.kernels import dequant_matmul as dm
    from repro_torch.serving import ServeConfig
    b0 = dm.launches
    reqs = chat_requests(seed, model.cfg.vocab)
    ceng, cont = _served(dev, model, tree, contiguous_config(), reqs,
                         f"{label} contiguous", repeat=True)
    ceng.close()
    lengths, max_batch, max_new, max_len = ROUND_TRAFFIC
    rreqs = make_requests(seed, model.cfg.vocab, lengths, max_new)
    reng, rnd = _served(dev, model, tree, ServeConfig(
        max_batch=max_batch, max_len=max_len, quantize_weights="squant",
        weight_bits=8, dequantize_for_compute=False), rreqs, f"{label} round")
    reng.close()
    return cont, rnd[0], dm.launches - b0, [len(r.prompt) for r in reqs]


def _serve_line(phase, cfg, full, quantize, cont, rnd, prompts, prof):
    return {"phase": phase, "model": cfg.name, "layers": cfg.n_layers,
            "full_depth": cfg.n_layers == full.n_layers,
            "reduced": None if cfg.n_layers == full.n_layers else
            {"n_layers": f"{full.n_layers} -> {cfg.n_layers}"},
            "d_model": cfg.d_model, "d_ff": cfg.d_ff, "vocab": cfg.vocab,
            "weight_bits": 8, "activation_dtype": cfg.dtype,
            "quantize": quantize,
            "serve_config": {k: getattr(contiguous_config(), k) for k in (
                "scheduler", "kv_backend", "max_slots", "max_len",
                "prefill_chunk")},
            "prompt_lengths": prompts, "continuous_runs": cont,
            "tokens_equal_run_to_run": True, "round": rnd,
            "dequant_matmul_by_part_continuous": _b_parts_by_label(
                cfg, cont[0]["dequant_matmul_by_shape"]),
            "decode_step_profile": prof}


def _b_parts_by_label(cfg, by_shape):
    """Kernel B's launches by weight shape (``launches_by_shape``) named by
    the part of :func:`_block_linears` whose weight has that shape (shapes
    two parts share are named together)."""
    from repro_torch.models.transformer import layer_plan
    names = collections.defaultdict(set)
    for kind, moe in layer_plan(cfg):
        for part, _, mm, nn in _block_linears(cfg, kind, moe, 1, 1, True):
            names[(mm, nn)].add(part)
    if not cfg.tie_embeddings:
        names[(cfg.vocab, cfg.d_model)].add("lm_head")
    out = {}
    for key, n in by_shape.items():
        var, shape = key.split()
        mn = tuple(int(v) for v in shape.split("x"))
        part = "+".join(sorted(names.get(mn, {"unknown"})))
        by = out.setdefault(part, {})
        by[var] = by.get(var, 0) + n
    return out


def drive_rwkv(dev, seed, layers):
    """13a: ``rwkv6-1.6b`` at full width and ``layers`` of its 24 layers:
    random float32 weights from ``seed`` (bf16 embedding and head), SQuant
    w8 (kernel A on every grouped bucket; the decay LoRA's up-projection,
    64 inputs, quantizes whole-row on the plain version, and the bf16 head
    on the stacked route), served in bfloat16 on the contiguous continuous
    path and the round scheduler (:func:`_serve_recurrent`), one decode
    step traced. Returns kernel A's and B's launches, kernel A's buckets
    (those it ran) and the line."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model

    t_phase = time.perf_counter()
    full = get_config(RWKV_ARCH)
    cfg = dataclasses.replace(full, n_layers=layers)
    model = build_model(cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    t0 = time.perf_counter()
    params = model.init(gen, device=dev)
    torch.cuda.synchronize()
    init_ms = (time.perf_counter() - t0) * 1e3
    d = cfg.d_model
    stacked = (f"({d},64)x{layers} float32 gNone",
               f"({cfg.vocab},{d})x1 bfloat16 g128")
    eng, quantize, buckets = _quantized_engine(dev, model, params,
                                               contiguous_config(), stacked)
    quantize["init_ms"] = init_ms
    quantize["whole_row_bucket_plain_route"] = stacked[0]
    del params
    torch.cuda.empty_cache()
    tree = eng.params
    eng.close()
    a_n = quantize["launches"]["squant_flip"]
    s_n = quantize["launches"]["squant_scale"]
    cont, rnd, b_n, prompts = _serve_recurrent(dev, seed, model, tree, "13a")
    prof = profile_recurrent_decode(dev, seed, tree, model, "13a")
    line = _serve_line(f"13a rwkv, contiguous continuous + round, "
                       f"{RWKV_ARCH} w8", cfg, full, quantize, cont, rnd,
                       prompts, prof)
    line.update(launches={"squant_flip": a_n, "squant_scale": s_n,
                          "dequant_matmul": b_n},
                seconds=time.perf_counter() - t_phase)
    emit(line)
    del tree
    torch.cuda.empty_cache()
    return a_n, s_n, b_n, [b for b in buckets if b[2] > 128], line


def _leafwise_quantized(dev, model, seed):
    """``model``'s tree made on the card one quantizable leaf at a time and
    quantized as it is made (SQuant w8, ``quantize_tree`` on a one-leaf
    tree), its float32 freed before the next: an (in, out) kernel or an
    (experts, in, out) bank with ``_init_dense``'s std 1/sqrt(in), the
    untied head in the model dtype with std 0.02, as ``LM.init`` makes
    them; the other leaves as ``LM.init`` makes them (norm gains, the
    embedding, each MoE router as ``init_moe`` does, and each mamba mixer's
    conv, dt bias, A and D from ``init_mamba`` itself, whose four
    projections are dropped and remade one at a time). Returns (tree, the
    quantize summary, kernel A's buckets by call shape)."""
    from repro_torch.core.pipeline import (_flatten, _rebuild,
                                           is_quantizable, quantize_tree)
    from repro_torch.kernels import dequant_matmul as dm
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import paged_attention_quant as paq
    from repro_torch.kernels import squant_flip as sf
    from repro_torch.models import mamba as mamba_lib
    from repro_torch.models.layers import (_init_dense, init_embedding,
                                           init_norm)
    cfg = model.cfg
    _reset_launches(dm, pa, paq, sf)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    meta = model.init(None, device="meta")
    allocated = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    leaves, mixers, calls = [], {}, collections.Counter()
    want_flip = want_scale = 0
    quant_ms = make_ms = 0.0
    routes = collections.Counter()
    for path, m in _flatten(meta):
        shape = tuple(m.shape)
        if is_quantizable(path, m):
            tm = time.perf_counter()
            std = 0.02 if path[0] == "lm_head" else 1.0 / math.sqrt(shape[-2])
            w = torch.randn(shape, generator=gen, dtype=m.dtype,
                            device=dev).mul_(std)
            torch.cuda.synchronize()
            make_ms += (time.perf_counter() - tm) * 1e3
            q, rep = quantize_tree({"w": w}, method="squant", bits=8,
                                   device=dev)
            del w
            quant_ms += rep.total_millis
            leaves.append(q["w"])
            e = shape[0] if len(shape) == 3 else 1
            for b in rep.buckets:
                routes[f"{b.route} {b.key.split()[-1]}"] += 1
                if b.route == "native":
                    want_flip += -(-e // sf.MAX_LEAVES)
                    want_scale += -(-e // sf.MAX_LEAVES)
                elif not b.key.endswith("gNone"):
                    want_flip += 1
                calls[(e, e) + shape[-2:]] += 1
            continue
        if path[-1] == "gain":
            leaf = init_norm(shape[0], plus_one=cfg.norm_plus_one,
                             device=dev)["gain"]
        elif path == ("embedding", "embedding"):
            leaf = init_embedding(gen, shape[0], shape[1], m.dtype,
                                  device=dev)["embedding"]
        elif "router" in path:
            leaf = _init_dense(gen, shape[0], shape[1], scale=0.02,
                               device=dev)["w"]
        elif "mixer" in path:
            key = path[:-1]
            if key not in mixers:
                mc = cfg.mamba
                mix = mamba_lib.init_mamba(gen, cfg.d_model, mc.d_state,
                                           mc.d_conv, mc.expand, mc.dt_rank,
                                           device=dev)
                mixers[key] = {k: v for k, v in mix.items()
                               if not isinstance(v, dict)}
                del mix
            leaf = mixers[key][path[-1]]
        else:
            raise ValueError(f"no rule makes the leaf {path} {shape}")
        if tuple(leaf.shape) != shape or leaf.dtype != m.dtype:
            raise AssertionError(f"{path}: made {tuple(leaf.shape)} "
                                 f"{leaf.dtype}, init makes {shape} {m.dtype}")
        leaves.append(leaf)
    del mixers
    tree = _rebuild(meta, iter(leaves))
    torch.cuda.synchronize()
    total_ms = (time.perf_counter() - t0) * 1e3
    peak = (torch.cuda.max_memory_allocated() - allocated) / 1e9
    if sf.launches != want_flip or sf.scale_launches != want_scale:
        raise AssertionError(f"kernel A launches {sf.launches} (scale pass "
                             f"{sf.scale_launches}), the per-leaf calls imply "
                             f"{want_flip} ({want_scale})")
    quantize = {"build_and_quantize_ms": total_ms,
                "quantize_ms_sum_of_calls": quant_ms,
                "make_leaves_ms": make_ms,
                "calls": sum(calls.values()),
                "buckets_by_route_and_group": dict(routes),
                "launches": {"squant_flip": sf.launches,
                             "squant_flip_by_route": dict(
                                 sf.launches_by_route),
                             "squant_scale": sf.scale_launches},
                "launches_implied_by_calls": {"squant_flip": want_flip,
                                              "squant_scale": want_scale},
                "parameters": sum(math.prod(t.shape) for _, t in
                                  _flatten(meta)),
                "peak_gb_above_start": peak,
                "served_tree_gb": _tree_bytes(tree) / 1e9}
    # one call's launch at each call shape (a bank's slices, or one leaf)
    buckets = [(e, e, kin, nch) for (e, _, kin, nch) in calls if kin > 128]
    quantize["calls_by_shape"] = {f"{e}x{kin}x{nch}": n for (e, _, kin, nch),
                                  n in calls.items()}
    return tree, quantize, buckets


def drive_jamba(dev, seed):
    """13b: ``jamba-1.5-large-398b`` at full width and one period of its
    block pattern (8 of its 72 layers: seven mamba layers and one attention
    layer, 16 experts top-2 on every other layer), made and quantized on
    the card one leaf at a time (:func:`_leafwise_quantized`: the float32
    period, ~180 GB, never exists whole), served in bfloat16 as 13a is,
    one decode step traced. Returns kernel A's and B's launches, kernel A's
    buckets by call and the line."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model

    t_phase = time.perf_counter()
    full = get_config(JAMBA_ARCH)
    cfg = dataclasses.replace(full, n_layers=JAMBA_LAYERS)
    model = build_model(cfg)
    tree, quantize, buckets = _leafwise_quantized(dev, model, seed)
    emit({"phase": "13b jamba period made and quantized leaf by leaf",
          **quantize})
    a_n = quantize["launches"]["squant_flip"]
    s_n = quantize["launches"]["squant_scale"]
    cont, rnd, b_n, prompts = _serve_recurrent(dev, seed, model, tree, "13b")
    prof = profile_recurrent_decode(dev, seed, tree, model, "13b")
    line = _serve_line(f"13b mamba + MoE, contiguous continuous + round, "
                       f"{JAMBA_ARCH} w8", cfg, full, quantize, cont, rnd,
                       prompts, prof)
    line.update(moe=dataclasses.asdict(cfg.moe),
                block_pattern=list(cfg.block_pattern),
                launches={"squant_flip": a_n, "squant_scale": s_n,
                          "dequant_matmul": b_n},
                seconds=time.perf_counter() - t_phase)
    emit(line)
    del tree
    torch.cuda.empty_cache()
    return a_n, s_n, b_n, buckets, line


def recurrent_vs_plain(dev, seed):
    """13c: rwkv and jamba's isolated mixer (``RECURRENT_ISOLATED``) at full
    width and 2 layers in float32: (i) SQuant w8 codes of kernel A against
    the plain versions leaf by leaf, and a prefill plus 8 decode steps
    through the kernels against the plain versions on the same tree; (ii)
    teacher-forced agreement of the 8-slot chunked contiguous engine
    against the one-slot monolithic oracle on ``RECURRENT_PROMPT``-token
    prompts of one length, gated at the reference's budget
    (``AGREEMENT_BUDGETS``), the float32 top-2 margins at the misses, and
    the port at the reduced width on the same traffic
    (:func:`recurrent_reference_agreement`) beside the reference engine's
    pinned reading, gated at the budget."""
    from repro_torch.configs import get_config
    from repro_torch.core.pipeline import quantize_tree
    from repro_torch.models.model import build_model
    from repro_torch.serving.equivalence import (AGREEMENT_BUDGETS,
                                                 agreement_budget)
    t_phase = time.perf_counter()
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    line = {"phase": "13c rwkv and mamba at 2 layers (float32): kernels vs "
                     "plain versions, agreement"}
    for arch in (RWKV_ARCH, JAMBA_ARCH):
        cfg = dataclasses.replace(get_config(arch), dtype="float32",
                                  **RECURRENT_ISOLATED[arch])
        model = build_model(cfg)
        params = model.init(gen, device=dev)
        tree, _ = quantize_tree(params, method="squant", bits=8, device=dev)
        codes = _codes_vs_plain(params, tree)
        del params
        torch.cuda.empty_cache()
        prompt = torch.randint(0, cfg.vocab, (2, 64), generator=gen,
                               device=dev)
        plain = _decode_vs_plain(dev, model, tree, prompt)
        reqs = make_requests(seed, cfg.vocab, [RECURRENT_PROMPT] * 8,
                             RECURRENT_NEW)
        ccfg = contiguous_config()
        rep, oracle = _agreement(dev, model, tree, reqs, ccfg,
                                 contiguous_config(max_slots=1,
                                                   prefill_chunk=0))
        key = "rwkv" if cfg.rwkv else "mamba"
        gate = agreement_budget(ccfg, cfg)
        reduced = recurrent_reference_agreement(dev, arch)
        agree = {"against": "contiguous, one slot, monolithic",
                 "gated": gate, "reference_budget": AGREEMENT_BUDGETS[key],
                 "rate": rep.rate, "matched": rep.matched,
                 "compared": rep.compared, "requests": len(reqs),
                 "prompt_length": RECURRENT_PROMPT,
                 "mismatches": [list(p) for p in rep.mismatches],
                 "reduced_width": {
                     "matched": reduced.matched,
                     "compared": reduced.compared,
                     "reference_engine_matched_pinned":
                         RECURRENT_REFERENCE_MATCHED[arch]}}
        if rep.rate < 1.0:
            margin = oracle_margins(dev, model, tree, reqs, oracle)
            agree["float32_top2_margin_at_misses"] = sorted(
                margin[p] for p in rep.mismatches if p in margin)
            agree["float32_top2_margin_all"] = _quantiles(
                list(margin.values()))
        line[arch] = {"config": RECURRENT_ISOLATED[arch],
                      "codes_tie_rule": codes, "kernels_vs_plain": plain,
                      "agreement": agree}
        del tree
        torch.cuda.empty_cache()
        if rep.rate < gate or reduced.rate < gate \
                or agree["gated"] != AGREEMENT_BUDGETS[key]:
            emit(line)
            raise AssertionError(f"13c {arch}: agreement {rep.rate:.4f}, at "
                                 f"the reduced width {reduced.rate:.4f}, "
                                 f"below {gate}")
    line["seconds"] = time.perf_counter() - t_phase
    emit(line)
    return line


def kernel_b_phase13_times(dev, gen, phase13):
    """Phase 13's kernel-B cells (``timed``: (label, M, N, rows)) and
    jamba's MoE layer of expert launches at decode (``experts``), timed as
    the main path's cells are."""
    out = {"cells": [dict(_b_timed(dev, gen, m, n, b, 8, torch.bfloat16),
                          label=label)
                     for label, m, n, b in phase13["timed"]],
           "experts": _expert_layer_times(dev, gen, phase13["experts"])}
    torch.cuda.empty_cache()
    return out


def drive_phase13(dev, seed, layers13, memory):
    """Phase 13 (13a, 13b, 13c), each part's memory gated like a phase's.
    Returns the kernels' launches by part and the shapes phase 2 holds
    kernels A and B to: kernel A's buckets and kernel B's launch shapes
    (its plan cache, emptied before a part and read after it) by part."""
    from repro_torch.kernels import dequant_matmul as dm
    t0 = time.perf_counter()
    dm._plans.clear()
    a_a, s_a, b_a, buckets_a, _ = drive_rwkv(dev, seed, layers13)
    plans_a = dm.cached_plans()
    phase_memory("13a", memory)
    dm._plans.clear()
    a_b, s_b, b_b, buckets_b, _ = drive_jamba(dev, seed)
    plans_b = dm.cached_plans()
    phase_memory("13b", memory)
    recurrent_vs_plain(dev, seed)
    phase_memory("13c", memory)
    emit({"phase": "13 seconds", "seconds": time.perf_counter() - t0})
    launches = {"squant_flip": {"13a": a_a, "13b": a_b},
                "squant_scale": {"13a": s_a, "13b": s_b},
                "dequant_matmul": {"13a": b_a, "13b": b_b}}
    return launches, {"a": {"13a": buckets_a, "13b": buckets_b},
                      "b": {"13a": plans_a, "13b": plans_b}}


SEAMLESS_ARCH = "seamless-m4t-medium"
# 14a's traffic: one round of ENCDEC_BATCH requests of one ENCDEC_PROMPT-token
# prompt length (the round scheduler feeds a request plen // enc_ratio = 64
# float32 zero frames) and ENCDEC_NEW new tokens each
ENCDEC_PROMPT, ENCDEC_NEW, ENCDEC_BATCH = 256, 32, 8
ENCDEC_MAX_LEN = 320
# 14c: the depth of the float32 agreement model (encoder and decoder alike)
ENCDEC_AGREE_LAYERS, ENCDEC_AGREE_PROMPT = 2, 128
# 14d: the training batches (rows, tokens a row; frames a row = seq // 4)
ENCDEC_TRAIN_BATCH, ENCDEC_TRAIN_SEQ, ENCDEC_TRAIN_STEPS = 8, 512, 10


def encdec_round_config(**over):
    """14a's serve configuration: the round scheduler (the reference gates
    the continuous one off encoder-decoder models), SQuant w8, served
    real-quantized."""
    from repro_torch.serving import ServeConfig
    kw = dict(max_batch=ENCDEC_BATCH, max_len=ENCDEC_MAX_LEN,
              quantize_weights="squant", weight_bits=8,
              dequantize_for_compute=False)
    kw.update(over)
    return ServeConfig(**kw)


def _encdec_linears(cfg, rows, enc_rows, enc_dtype, encode):
    """Kernel B's launches of one encoder-decoder forward in call order, as
    (part, rows, M, N, activation dtype): with ``encode``, each encoder
    layer's q, k, v, o and FFN projections on ``enc_rows`` frame rows in
    the frames' dtype ``enc_dtype``; then each decoder layer's
    self-attention q, k, v, o and cross-attention q on ``rows`` in the
    residual stream's dtype, the cross K/V on the encoder output's
    ``enc_rows`` rows in its dtype, the cross o in that dtype (the
    attention's output takes V's), and the FFN's two in the stream's dtype
    after the cross output joins it (promoted as ``jnp`` promotes: a
    bfloat16 stream meets a float32 encoder output in layer 0 and is
    float32 from there); the untied head last."""
    d, q, f = cfg.d_model, cfg.n_heads * cfg.head_dim, cfg.d_ff
    out = []
    if encode:
        for _ in range(cfg.encoder_layers):
            out += [("enc_qkv", enc_rows, q, d, enc_dtype)] * 3 + [
                ("enc_o", enc_rows, d, q, enc_dtype),
                ("enc_ffn", enc_rows, f, d, enc_dtype),
                ("enc_ffn", enc_rows, d, f, enc_dtype)]
    x = cfg.dtype
    for _ in range(cfg.n_layers):
        out += [("self_qkv", rows, q, d, x)] * 3 + [
            ("self_o", rows, d, q, x), ("cross_q", rows, q, d, x),
            ("cross_kv", enc_rows, q, d, enc_dtype),
            ("cross_kv", enc_rows, q, d, enc_dtype),
            ("cross_o", rows, d, q, enc_dtype)]
        x = "float32" if "float32" in (x, enc_dtype) else x
        out += [("ffn", rows, f, d, x), ("ffn", rows, d, f, x)]
    out.append(("head", rows, cfg.vocab, d, x))
    return out


def _encdec_part(part):
    """The coarse part of a :func:`_encdec_linears` label: encoder, cross
    K/V, head, or the decoder's other projections."""
    if part.startswith("enc_"):
        return "encoder"
    return part if part in ("cross_kv", "head") else "decoder"


def _encdec_variant(rows, dtype):
    """Kernel B's variant for ``rows`` rows of ``dtype`` on the path's
    aligned shapes (N a multiple of 128): bfloat16 as :func:`_variant`;
    float32 takes the float32 instances, ``tcgemv32`` up to 16 rows and
    ``mma32`` above."""
    if dtype == "bfloat16":
        return _variant(rows)
    return "tcgemv32" if rows <= 16 else "mma32"


def _encdec_expected(cfg, log, enc_len, enc_dtype="float32"):
    """What the logged forwards (:func:`_log_forwards`) imply for kernel B:
    (launches by ``dequant_matmul.shape_key``, launches by part and
    variant, launches by dtype). A prefill of ``b`` rows of ``n`` tokens
    encodes ``b * enc_len`` frame rows; a decode step runs ``b`` rows over
    the cached encoder output."""
    from repro_torch.kernels.dequant_matmul import shape_key
    shapes, parts, dts = (collections.Counter() for _ in range(3))
    for kind, b, n in log:
        rows = b * n if kind == "prefill" else b
        for part, r, m, nn, dt in _encdec_linears(cfg, rows, b * enc_len,
                                                  enc_dtype,
                                                  kind == "prefill"):
            v = _encdec_variant(r, dt)
            shapes[shape_key(v, m, nn)] += 1
            parts[f"{_encdec_part(part)} {v}"] += 1
            dts[dt] += 1
    return dict(shapes), dict(parts), dict(dts)


def _serve_encdec_round(dev, model, tree, reqs, label):
    """``reqs`` (one round) on the round scheduler over the quantized
    ``tree`` (a store of its own): tokens checked, prefill ms, the decode
    step ms (between consecutive sampling steps: one decode forward, its
    sample and the step's host sync), device memory, and kernel B's
    launches by weight shape held equal to what the forwards imply
    (:func:`_encdec_expected`)."""
    from repro_torch.kernels import dequant_matmul as dm
    from repro_torch.serving import ServeEngine, WeightStore
    eng = ServeEngine(model, None, encdec_round_config(), store=WeightStore(
        serving_params=tree, device=dev), device=dev)
    log = _log_forwards(eng, [])
    eng.scheduler.step_log = []
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    b0 = dict(dm.launches_by_shape)
    t0 = time.perf_counter()
    outs = eng.generate(reqs)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    got = _launch_deltas(b0, dm.launches_by_shape)
    plen = max(len(r.prompt) for r in reqs)
    want, parts, dts = _encdec_expected(
        model.cfg, log, max(1, plen // model.cfg.enc_ratio))
    if got != want:
        raise AssertionError(f"{label}: kernel B launches by shape {got}, "
                             f"the path implies {want}")
    for o, r in zip(outs, reqs):
        if len(o.tokens) != r.max_new_tokens or \
                not all(0 <= t < model.cfg.vocab for t in o.tokens):
            raise AssertionError(f"{label}: request {r.request_id}: bad "
                                 f"tokens {o.tokens}")
    ts = [e["t"] for e in eng.scheduler.step_log]
    rounds = [dict(r) for r in eng.stats()["round_log"]]
    eng.close()
    return {"run_s": run_s, "rounds": rounds,
            "forwards": dict(collections.Counter(k for k, _, _ in log)),
            "prefill_ms": [r["prefill_ms"] for r in rounds],
            "decode_step_ms": _percentiles(
                [(b - a) * 1e3 for a, b in zip(ts, ts[1:])]),
            "memory_gb": {"before_round": before / 1e9,
                          "peak_during_round": peak / 1e9},
            "tokens": [o.tokens for o in outs],
            "dequant_matmul_by_shape": got,
            "dequant_matmul_by_variant": dict(sum(
                (collections.Counter({k.split()[0]: n})
                 for k, n in got.items()), collections.Counter())),
            "dequant_matmul_by_part_and_variant": parts,
            "dequant_matmul_by_dtype": dts,
            "dequant_matmul": sum(got.values())}


def profile_encdec_decode(dev, seed, model, tree, steps=4):
    """One round-path decode step of 14a's model over ``tree`` (eight rows
    of ENCDEC_PROMPT-token prompts prefilled over the scheduler's float32
    zero frames), traced (:func:`_profile_steps`): kernel B's device time
    by part (cross K/V, the decoder's other projections, the head) and
    variant, read from the launch order of :func:`_encdec_linears` (the
    split is dropped if the trace's kernel-B launches are not ``steps``
    times that list); the kernels after the self-attention's q/k/v and the
    cross K/V launches (rotary, cache write, the attention products and
    softmax) as attention, the rest (norms, residuals, casts, the
    activation, the embedding, the sample) as other."""
    cfg = model.cfg
    b, enc_len = ENCDEC_BATCH, ENCDEC_PROMPT // cfg.enc_ratio
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    prompt = torch.randint(0, cfg.vocab, (b, ENCDEC_PROMPT), generator=gen,
                           device=dev)
    frames = torch.zeros((b, enc_len, cfg.d_model), dtype=torch.float32,
                         device=dev)
    lg, cache = model.prefill(tree, {"tokens": prompt, "enc_frames": frames},
                              model.init_cache(b, ENCDEC_MAX_LEN, device=dev))
    state = {"lg": lg, "cache": cache}
    order = [(p, _encdec_variant(r, dt)) for p, r, _, _, dt in
             _encdec_linears(cfg, b, b * enc_len, "float32", False)]
    seen = [0]

    def b_part(grid, name):
        seen[0] += 1
        part, var = order[(seen[0] - 1) % len(order)]
        return f"{part}|{var}"

    def gap_part(owner):
        if owner is not None and owner.split("|")[0] in ("self_qkv",
                                                          "cross_kv"):
            return "attention"
        return "other"

    def step():
        nxt = state["lg"].argmax(-1)
        nxt.cpu()                                        # the step's host sync
        state["lg"], state["cache"] = model.decode_step(
            tree, nxt[:, None], state["cache"])

    line = _profile_steps(step, steps, f"14a profile of a round-path decode "
                          f"step, {cfg.name}",
                          {"layers": cfg.n_layers, "rows": b,
                           "encoder_frames_a_row": enc_len,
                           "kernel_b_launches_per_step": len(order)},
                          b_part=b_part, gap_part=gap_part)
    by = line["device_ms_per_step_by_part"]
    ok = seen[0] == steps * len(order)
    summary = {"kernel_b_split_by_launch_order_valid": ok,
               "kernel_b_launches_traced": seen[0],
               "device_kernels_per_step": line["device_kernels_per_step"],
               "device_busy_ms_per_step": line["device_busy_ms_per_step"],
               "device_busy_share_of_untraced_wall":
                   line["device_busy_share_of_untraced_wall"]}
    if ok:
        kb = collections.defaultdict(float)
        for k, v in by.items():
            if k.startswith("dequant_matmul_"):
                part, var = k[len("dequant_matmul_"):].split("|")
                kb[f"{_encdec_part(part)} {var}"] += v
        summary.update(kernel_b_ms_by_part_and_variant=dict(kb),
                       kernel_b_ms=sum(kb.values()),
                       attention_ms=by.get("attention", 0.0),
                       other_ms=by.get("other", 0.0)
                       + by.get("host_to_device_copies", 0.0))
    line["summary"] = summary
    emit({"phase": "14a decode step split", **summary})
    return line


def _head_codes_vs_plain(w, qt):
    """The untied bfloat16 head, quantized on the stacked route (its (out,
    in) view's max scales in bfloat16, then the row-major flip kernel on
    the float32 values of view and scales), against the plain version on
    those float32 inputs: scales equal to ``core.dispatch._scales`` of the
    view, codes equal up to the tie rule (its 256 206 rows end in a ragged
    tile)."""
    from repro_torch.core.dispatch import _scales
    from repro_torch.kernels import squant_flip as sf
    from repro_torch.kernels.ref import explain_code_differences
    view = w.T
    s = _scales(view[None], 8, "max")[0].float()
    if not torch.equal(qt.scale.reshape(s.shape).float(), s):
        raise AssertionError("the head's scales differ from _scales")
    w32 = view.float().contiguous()
    want = sf.squant_flip_plain(w32, s, bits=8, group_size=128)
    res = explain_code_differences(w32, s, qt.data, want, bits=8,
                                   group_size=128)
    if res["unexplained"]:
        raise AssertionError(f"the head's codes differ beyond the tie rule: "
                             f"{res}")
    return dict(res, shape=list(qt.shape), dtype=str(w.dtype))


def _encdec_decode(dev, model, tree, prompt, frames, steps, forced=None):
    """Prefill over ``frames`` and ``steps`` decode steps, greedy or fed
    ``forced`` tokens: (the logits of every step stacked, the tokens fed,
    the encoder output the prefill cached)."""
    cache = model.init_cache(prompt.shape[0], prompt.shape[1] + steps + 1,
                             device=dev)
    lg, cache = model.prefill(tree, {"tokens": prompt, "enc_frames": frames},
                              cache)
    enc = cache["enc_out"]
    logits, toks = [lg], []
    for i in range(steps):
        nxt = lg.argmax(-1) if forced is None else forced[i]
        toks.append(nxt)
        lg, cache = model.decode_step(tree, nxt[:, None], cache)
        logits.append(lg)
    return torch.stack(logits), toks, enc


def encdec_vs_plain(dev, seed, model, params, tree):
    """14b: 14a's full-width, full-depth tree against the plain versions:
    (i) kernel A's codes of every leaf (:func:`_codes_vs_plain`; the bf16
    head by :func:`_head_codes_vs_plain`); (ii) for random frames (numpy,
    from ``seed``) in float32 and in bfloat16: ``LM.prefill`` and 4 greedy
    decode steps through the kernels, then the same under
    ``force_backend("ref")`` teacher-forced on the kernels' tokens: the
    encoder output and the logits within 2e-2 of the largest (phase 5's
    bfloat16 gate), the logits' dtype the frames' (float32 frames promote
    the bfloat16 decoder), and kernel B's launches by shape equal to what
    the forwards imply."""
    import numpy as np
    from repro_torch.kernels import dequant_matmul as dm
    from repro_torch.kernels import ops
    t_phase = time.perf_counter()
    cfg = model.cfg
    rest = [{k: v for k, v in t.items() if k != "lm_head"}
            for t in (params, tree)]
    codes = _codes_vs_plain(*rest)
    head = _head_codes_vs_plain(params["lm_head"]["w"],
                                tree["lm_head"]["w"])
    rng = np.random.default_rng(seed)
    b, s, steps = 2, 64, 4
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab, (b, s))).to(dev)
    frames = torch.from_numpy(rng.standard_normal(
        (b, s // cfg.enc_ratio, cfg.d_model)).astype(np.float32)).to(dev)
    line = {"phase": f"14b kernels vs plain versions, {cfg.name} at full "
                     f"width and depth (bfloat16 model)",
            "codes_tie_rule": codes, "head_codes_tie_rule": head,
            "prompt": [b, s], "frames": list(frames.shape),
            "decode_steps": steps}
    for fdt in (torch.float32, torch.bfloat16):
        name = str(fdt).replace("torch.", "")
        fr = frames.to(fdt)
        b0 = dict(dm.launches_by_shape)
        lk, tk, ek = _encdec_decode(dev, model, tree, prompt, fr, steps)
        torch.cuda.synchronize()
        got = _launch_deltas(b0, dm.launches_by_shape)
        with ops.force_backend("ref"):
            lp, _, ep = _encdec_decode(dev, model, tree, prompt, fr, steps,
                                       forced=tk)
        torch.cuda.synchronize()
        log = [("prefill", b, s)] + [("decode", b, 1)] * steps
        want, parts, dts = _encdec_expected(cfg, log, s // cfg.enc_ratio,
                                            name)
        err = float((lk.float() - lp.float()).abs().max())
        mag = float(lp.float().abs().max())
        e_err = float((ek.float() - ep.float()).abs().max())
        e_mag = float(ep.float().abs().max())
        row = {"logits_dtype": str(lk.dtype).replace("torch.", ""),
               "encoder_output_dtype": str(ek.dtype).replace("torch.", ""),
               "logits_max_abs_err": err, "logits_max_abs": mag,
               "encoder_output_max_abs_err": e_err,
               "encoder_output_max_abs": e_mag,
               "teacher_forced_tokens_equal": bool(torch.equal(
                   lk.argmax(-1), lp.argmax(-1))),
               "dequant_matmul_by_part_and_variant": parts,
               "dequant_matmul_by_dtype": dts, "gate": 2e-2}
        line[f"frames_{name}"] = row
        if got != want or row["logits_dtype"] != name \
                or err > 2e-2 * mag or e_err > 2e-2 * e_mag:
            emit(line)
            raise AssertionError(f"14b over {name} frames: {row}; kernel B "
                                 f"launches {got}, the path implies {want}")
        del lk, lp
    line["seconds"] = time.perf_counter() - t_phase
    emit(line)
    return line


def drive_encdec(dev, seed):
    """14a and 14b: ``seamless-m4t-medium`` at full width and depth (12
    encoder + 12 decoder layers), random weights from ``seed`` (float32
    dense kernels, bf16 embedding and untied head), SQuant w8 by kernel A
    (three native buckets, the bf16 head on the stacked route), served in
    bfloat16 on the round scheduler with one round of ENCDEC_BATCH requests
    of ENCDEC_PROMPT tokens (the scheduler's float32 zero frames: the
    decoder runs float32 from layer 0's cross-attention on, so kernel B
    runs its float32 instances on every projection but layer 0's first
    five), kernel B's launches by shape held to what the forwards imply
    and a decode step's to 121 (5 bfloat16 on ``tcgemv``, 116 float32:
    ``tcgemv32`` 92, ``mma32`` 24; a prefill's to ``mma`` 5 and ``mma32``
    188), one decode step
    traced, the continuous scheduler refused with the reference's gate;
    then 14b (:func:`encdec_vs_plain`). Returns kernel A's and B's
    launches, kernel A's buckets and the line."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    t_phase = time.perf_counter()
    cfg = get_config(SEAMLESS_ARCH)
    model = build_model(cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    t0 = time.perf_counter()
    params = model.init(gen, device=dev)
    torch.cuda.synchronize()
    init_ms = (time.perf_counter() - t0) * 1e3
    head = f"({cfg.vocab},{cfg.d_model})x1 bfloat16 g128"
    eng, quantize, buckets = _quantized_engine(dev, model, params,
                                               encdec_round_config(), (head,))
    quantize["init_ms"] = init_ms
    tree = eng.params
    eng.close()
    a_n = quantize["launches"]["squant_flip"]
    s_n = quantize["launches"]["squant_scale"]
    per_step = _encdec_linears(cfg, ENCDEC_BATCH,
                               ENCDEC_BATCH * ENCDEC_PROMPT // cfg.enc_ratio,
                               "float32", False)
    step_dts = collections.Counter(dt for *_, dt in per_step)
    enc = sum(p.startswith("enc_") for p, *_ in _encdec_linears(
        cfg, 1, 1, "float32", True))
    # ten projections a decoder layer and the head (121 at 12 layers), five
    # of them bfloat16 (layer 0's self-attention q, k, v, o and cross q);
    # six a layer of the encoder's (72). By variant: a step's bfloat16 five
    # on tcgemv, its float32 ones on tcgemv32 but the cross K/V on the 8 x
    # 64 encoder rows (mma32); a prefill's five bfloat16 on mma and the
    # rest on mma32; never gemv or tiled
    per = 10 * cfg.n_layers + 1
    step_by = collections.Counter(_encdec_variant(r, dt)
                                  for _, r, _, _, dt in per_step)
    prefill_by = collections.Counter(
        _encdec_variant(r, dt) for _, r, _, _, dt in _encdec_linears(
            cfg, ENCDEC_BATCH * ENCDEC_PROMPT,
            ENCDEC_BATCH * ENCDEC_PROMPT // cfg.enc_ratio, "float32", True))
    if (len(per_step), step_dts["bfloat16"], step_dts["float32"], enc) != \
            (per, 5, per - 5, 6 * cfg.encoder_layers) or step_by != {
                "tcgemv": 5, "tcgemv32": per - 5 - 2 * cfg.n_layers,
                "mma32": 2 * cfg.n_layers} or prefill_by != {
                "mma": 5, "mma32": per - 5 + enc}:
        raise AssertionError(f"a decode step implies {len(per_step)} kernel-B "
                             f"launches ({dict(step_dts)}; {dict(step_by)}), "
                             f"a prefill's encoder {enc} ({dict(prefill_by)})")
    reqs = make_requests(seed, cfg.vocab, [ENCDEC_PROMPT] * ENCDEC_BATCH,
                         ENCDEC_NEW)
    served = _serve_encdec_round(dev, model, tree, reqs, "14a")
    try:
        from repro_torch.serving import ServeEngine
        ServeEngine(model, tree, encdec_round_config(scheduler="continuous"),
                    device=dev)
        raise AssertionError("14a: the continuous scheduler served an "
                             "encoder-decoder model")
    except NotImplementedError as e:
        gate = str(e)
    if "does not support encoder-decoder" not in gate:
        raise AssertionError(f"14a: the continuous scheduler raised {gate}")
    prof = profile_encdec_decode(dev, seed, model, tree)
    line = {"phase": f"14a encoder-decoder, round scheduler, "
                     f"{SEAMLESS_ARCH} w8", "model": cfg.name,
            "layers": {"encoder": cfg.encoder_layers,
                       "decoder": cfg.n_layers},
            "full_depth": True, "reduced": None, "d_model": cfg.d_model,
            "n_heads": cfg.n_heads, "d_ff": cfg.d_ff, "vocab": cfg.vocab,
            "weight_bits": 8, "model_dtype": cfg.dtype,
            "frames": "float32 zeros, (rows, plen // enc_ratio, d_model), "
                      "the round scheduler's",
            "params": _numel(params), "quantize": quantize,
            "serve_config": {k: getattr(encdec_round_config(), k) for k in (
                "scheduler", "max_batch", "max_len", "quantize_weights",
                "weight_bits", "dequantize_for_compute")},
            "requests": len(reqs), "prompt_length": ENCDEC_PROMPT,
            "new_tokens": ENCDEC_NEW, "round": served,
            "kernel_b_per_prefill_by_variant": dict(prefill_by),
            "kernel_b_per_decode_step": {
                "launches": len(per_step), "by_dtype": dict(step_dts),
                "by_variant": dict(step_by),
                "by_part_and_variant": dict(collections.Counter(
                    f"{_encdec_part(p)} {_encdec_variant(r, dt)}"
                    for p, r, _, _, dt in per_step))},
            "kernel_b_encoder_per_prefill": enc,
            "continuous_refused": gate, "decode_step_profile": prof,
            "launches": {"squant_flip": a_n, "squant_scale": s_n,
                         "dequant_matmul": served["dequant_matmul"]}}
    line["seconds_14a"] = time.perf_counter() - t_phase
    emit(line)
    encdec_vs_plain(dev, seed, model, params, tree)
    del params, tree
    torch.cuda.empty_cache()
    return a_n, s_n, served["dequant_matmul"], buckets, line


def encdec_agreement(dev, seed):
    """14c: seamless at full width and ENCDEC_AGREE_LAYERS encoder and
    decoder layers in float32, SQuant w8: kernel A's codes against the
    plain versions leaf by leaf; eight prompts of one length
    (ENCDEC_AGREE_PROMPT tokens) over random frames (numpy, from ``seed``):
    the plain path (``force_backend("ref")``) decodes ENCDEC_NEW tokens a
    row greedily, the kernel path teacher-forced on them; its greedy token
    against the plain path's at every step, gated at 0.95 (13c's gate)."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core.pipeline import quantize_tree
    from repro_torch.kernels import ops
    from repro_torch.models.model import build_model
    t_phase = time.perf_counter()
    full = get_config(SEAMLESS_ARCH)
    cfg = dataclasses.replace(full, dtype="float32",
                              n_layers=ENCDEC_AGREE_LAYERS,
                              encoder_layers=ENCDEC_AGREE_LAYERS)
    model = build_model(cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    params = model.init(gen, device=dev)
    tree, _ = quantize_tree(params, method="squant", bits=8, device=dev)
    codes = _codes_vs_plain(params, tree)
    del params
    torch.cuda.empty_cache()
    rng = np.random.default_rng(seed + 1)
    n, s = 8, ENCDEC_AGREE_PROMPT
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab, (n, s))).to(dev)
    frames = torch.from_numpy(rng.standard_normal(
        (n, s // cfg.enc_ratio, cfg.d_model)).astype(np.float32)).to(dev)
    with ops.force_backend("ref"):
        lp, oracle, _ = _encdec_decode(dev, model, tree, prompt, frames,
                                       ENCDEC_NEW)
    c0 = ops.launch_counts()
    lk, _, _ = _encdec_decode(dev, model, tree, prompt, frames, ENCDEC_NEW,
                              forced=oracle)
    by = _b_by_variant(ops.launches_between(c0, ops.launch_counts()))
    # step i's proposal: the argmax of the logits before token i is fed
    got = lk[:ENCDEC_NEW].argmax(-1)
    want = torch.stack(oracle)
    hits = got == want
    rate = float(hits.float().mean())
    top2 = lp[:ENCDEC_NEW].float().topk(2, dim=-1).values
    margin = (top2[..., 0] - top2[..., 1])
    line = {"phase": "14c agreement of the kernel path with the plain path, "
                     f"{cfg.name} at {ENCDEC_AGREE_LAYERS} + "
                     f"{ENCDEC_AGREE_LAYERS} layers (float32)",
            "reduced": {k: f"{getattr(full, k)} -> {ENCDEC_AGREE_LAYERS}"
                        for k in ("n_layers", "encoder_layers")},
            "codes_tie_rule": codes, "requests": n, "prompt_length": s,
            "frames": list(frames.shape), "new_tokens": ENCDEC_NEW,
            "matched": int(hits.sum()), "compared": hits.numel(),
            "rate": rate, "gated": 0.95, "dequant_matmul_by_variant": by,
            "logits_max_abs_err": float((lk - lp).abs().max()),
            "logits_max_abs": float(lp.abs().max()),
            "plain_top2_margin_at_misses": sorted(
                float(v) for v in margin[~hits]),
            "plain_top2_margin_all": _quantiles(margin.flatten().tolist()),
            "seconds": time.perf_counter() - t_phase}
    emit(line)
    del tree
    torch.cuda.empty_cache()
    if rate < 0.95:
        raise AssertionError(f"14c: agreement {rate:.4f} below 0.95")
    return line


def train_encdec(dev, seed, card):
    """14d: seamless as published (bf16 embedding and head, float32 dense
    kernels, remat) at full width and depth, ENCDEC_TRAIN_STEPS steps of
    ``make_train_step`` on ``markov_batches`` with float32 ``enc_frames``
    (ENCDEC_TRAIN_BATCH rows of ENCDEC_TRAIN_SEQ tokens, seq / enc_ratio
    frames a row); gates: a finite loss that falls from step 1 to the last.
    Then SQuant w8 of the trained tree (kernel A) served one round of 14a's
    traffic (kernel B's launches held to what the forwards imply)."""
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import markov_batches
    from repro_torch.models.model import build_model
    from repro_torch.serving import ServeEngine
    from repro_torch.training import train_loop as tl
    from repro_torch.training.optimizer import AdamWConfig, adamw_init
    t_phase = time.perf_counter()
    cfg = get_config(SEAMLESS_ARCH)
    if not cfg.remat:
        raise AssertionError("seamless: remat is off")
    model = build_model(cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    torch.cuda.synchronize()
    allocated0 = torch.cuda.memory_allocated()
    params = model.init(gen, device=dev)
    n_params, n_flop = _numel(params), _flop_params(cfg, params)
    n_enc = _numel(params["encoder"])
    b, seq, steps = ENCDEC_TRAIN_BATCH, ENCDEC_TRAIN_SEQ, ENCDEC_TRAIN_STEPS
    frames = seq // cfg.enc_ratio
    t0 = time.perf_counter()
    host = [x for x, _ in zip(markov_batches(
        b, seq, cfg.vocab, seed, encdec_dim=cfg.d_model,
        enc_ratio=cfg.enc_ratio), range(steps))]
    data_s = time.perf_counter() - t0
    batches = [tl.to_device(x, dev) for x in host]
    ocfg = AdamWConfig(lr=3e-4, warmup_steps=min(20, steps // 5),
                       decay_steps=steps)
    step = tl.make_train_step(model, ocfg)
    opt = adamw_init(params)
    torch.cuda.synchronize()
    state_gb = (torch.cuda.memory_allocated() - allocated0) / 1e9
    torch.cuda.reset_peak_memory_stats()
    params, opt, run = _train_steps(step, params, opt, batches)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = run["losses"]
    p50 = _percentiles(run["step_ms"][2:])["p50"]       # steps 3 on
    fb_p50 = _percentiles(run["forward_backward_ms"][2:])["p50"]
    op_p50 = _percentiles(run["optimizer_ms"][2:])["p50"]
    tokens = b * seq
    del opt, batches
    torch.cuda.empty_cache()
    line = {"phase": f"14d training at full width and depth, {cfg.name}",
            "card": card, "model": cfg.name,
            "layers": {"encoder": cfg.encoder_layers,
                       "decoder": cfg.n_layers}, "reduced": None,
            "dtype": {"embedding_and_head": cfg.dtype,
                      "dense_kernels": "float32",
                      "activations": "bfloat16 to layer 0's cross-attention, "
                                     "float32 after (float32 frames)"},
            "remat": cfg.remat,
            "tf32": bool(torch.backends.cuda.matmul.allow_tf32),
            "params": n_params, "encoder_params": n_enc,
            "state_gb": state_gb,
            "data": f"markov_batches({b}, {seq}, {cfg.vocab}, {seed}, "
                    f"encdec_dim={cfg.d_model}, enc_ratio={cfg.enc_ratio})",
            "frames_a_row": frames, "data_host_s": data_s,
            "optimizer": dataclasses.asdict(ocfg), "steps": steps,
            "losses": losses, "step_ms": run["step_ms"],
            "step_ms_p50_steps_3_on": p50, "tokens_per_step": tokens,
            "tokens_per_s": tokens / (p50 / 1e3),
            "forward_backward_ms": run["forward_backward_ms"],
            "optimizer_ms": run["optimizer_ms"],
            "forward_backward_ms_p50": fb_p50, "optimizer_ms_p50": op_p50,
            "optimizer_share": op_p50 / (fb_p50 + op_p50),
            "peak_memory_gb": peak_gb,
            "mfu": 6 * n_flop * tokens / (p50 / 1e3)
            / PEAK_FLOPS["bfloat16"],
            "mfu_formula": "6 * (params - embedding) * tokens / step s / 989 "
                           "TFLOP/s (H100 SXM dense bf16 peak); counts the "
                           "encoder's parameters once a token",
            "mfu_encoder_at_frames": 6 * ((n_flop - n_enc) * tokens
                                          + n_enc * b * frames)
            / (p50 / 1e3) / PEAK_FLOPS["bfloat16"],
            "flop_params": n_flop}
    bad = [x for x in losses if not math.isfinite(x)]
    if bad or not losses[-1] < losses[0]:
        emit(line)
        raise AssertionError(f"14d: losses {losses} not finite or not "
                             f"falling")
    eng, quantize, _ = _quantized_engine(
        dev, model, params, encdec_round_config(),
        (f"({cfg.vocab},{cfg.d_model})x1 bfloat16 g128",))
    tree = eng.params
    eng.close()
    del params
    torch.cuda.empty_cache()
    reqs = make_requests(seed + 1, cfg.vocab, [ENCDEC_PROMPT] * ENCDEC_BATCH,
                         ENCDEC_NEW)
    served = _serve_encdec_round(dev, model, tree, reqs, "14d")
    line.update(quantize_trained=quantize, served_round=served,
                launches={"squant_flip": quantize["launches"]["squant_flip"],
                          "squant_scale": quantize["launches"]["squant_scale"],
                          "dequant_matmul": served["dequant_matmul"]},
                seconds=time.perf_counter() - t_phase)
    emit(line)
    del tree
    torch.cuda.empty_cache()
    return line


def kernel_b_phase14_times(dev, gen, cells, old=True):
    """Phase 14's kernel-B cells, float32 activations (``cells``: (label, M,
    N, rows)), timed as the main path's cells are (:func:`_b_timed`: cold
    L2) three ways in the same call on the same inputs: the float32
    instance the rule picks (``tcgemv32`` up to 16 rows, ``mma32`` above;
    checked), the CUDA-core variant it replaced (``gemv`` / ``tiled``, by
    an explicit plan: ``old_ms``; not timed where ``old`` is False), and
    ``torch.matmul``
    in float32 on pre-dequantized weights with
    ``torch.backends.cuda.matmul.allow_tf32`` as main sets it, False, so
    its arithmetic is float32's (``library_ms``). ``bound_ms``: max(bytes /
    3.35 TB/s, 3 x 2BMN / 989 TFLOP/s), three bf16 passes at the dense bf16
    peak, the least time float32-exact products on the tensor cores take;
    ``bound_ms_cuda_cores``: the bound at 67 TFLOP/s, the float32 peak
    without tensor cores, beside it for the older rows."""
    from repro_torch.kernels import dequant_matmul as dm
    out = []
    for label, m, n, b in cells:
        # the rule's variant (aligned pointers; N not a multiple of 128
        # takes tiled above 16 rows, which has no older variant beside it)
        want = dm.variant(b, n, 128 if n % 128 == 0 else n, 1, 8, False, 0,
                          0)
        old_plan = {"tcgemv32": ("gemv", 1, n // 128),
                    "mma32": ("tiled", 1, n // 128)}.get(want) if old \
            else None
        row = dict(_b_timed(dev, gen, m, n, b, 8, torch.float32,
                            also={"old": old_plan} if old_plan else None),
                   label=label, old_variant=old_plan and old_plan[0])
        if row["variant"] != want:
            raise AssertionError(f"kernel B at {label} took {row}")
        t_bytes = (m * n + m * 4 + 4 * b * n + 4 * b * m) / HBM_BYTES_PER_S * 1e3
        t_ops = 3 * 2.0 * b * m * n / PEAK_FLOPS["bfloat16"] * 1e3
        row.update(bound_ms_cuda_cores=row["bound_ms"],
                   bound_by_cuda_cores=row["bound_by"],
                   bound_ms=max(t_bytes, t_ops),
                   bound_by="bytes" if t_bytes >= t_ops else "operations")
        row.update(bound_share=row["bound_ms"] / row["ms"],
                   speedup_over_old=row["old_ms"] / row["ms"]
                   if old_plan else None,
                   speedup_over_library=row["library_ms"] / row["ms"])
        out.append(row)
        torch.cuda.empty_cache()
    return {"cells": out,
            "torch_matmul_allow_tf32": bool(
                torch.backends.cuda.matmul.allow_tf32),
            "peak_flops_used": {
                "bound_ms": "3 x 989e12: three bf16 passes (hi, mid, lo) on "
                            "the H100 SXM's dense bf16 tensor cores",
                "bound_ms_cuda_cores": "67e12 float32 (H100 SXM, CUDA "
                                       "cores), the earlier bound"}}


def drive_phase14(dev, seed, card, memory):
    """Phase 14 (14a + 14b, 14c, 14d), each part's memory gated like a
    phase's. Returns the kernels' launches by part and the shapes phase 2
    holds kernels A and B to (kernel A's buckets and kernel B's launch
    shapes, its plan cache emptied before a part and read after it)."""
    from repro_torch.kernels import dequant_matmul as dm
    t0 = time.perf_counter()
    dm._plans.clear()
    a_a, s_a, b_a, buckets, line_a = drive_encdec(dev, seed)
    plans_a = dm.cached_plans()
    phase_memory("14a-b", memory)
    encdec_agreement(dev, seed)
    phase_memory("14c", memory)
    dm._plans.clear()
    d = train_encdec(dev, seed, card)
    plans_d = dm.cached_plans()
    phase_memory("14d", memory)
    emit({"phase": "14 seconds", "seconds": time.perf_counter() - t0})
    launches = {"squant_flip": {"14a": a_a,
                                "14d": d["launches"]["squant_flip"]},
                "squant_scale": {"14a": s_a,
                                 "14d": d["launches"]["squant_scale"]},
                "dequant_matmul": {"14a": b_a,
                                   "14d": d["launches"]["dequant_matmul"]},
                "dequant_matmul_by_variant": {
                    "14a": line_a["round"]["dequant_matmul_by_variant"],
                    "14d": d["served_round"]["dequant_matmul_by_variant"]}}
    return launches, {"a": {"14a": buckets},
                      "b": {"14a-b": plans_a, "14d": plans_d}}


# ---------------------------------------------------------------------------
# phase 15: the distributed layer (process groups, device meshes, DTensor
# placements, sharded quantization, reshard-on-restore, the int8 ring and
# pod-compressed training) on the one card
# ---------------------------------------------------------------------------

P15B_LAYERS = 1                    # 15b: granite's layers (of 40)
P15_RING_FLOATS = 100_000_000      # 15c: floats a rank contributes
P15_TRAIN_STEPS = 30               # 15d
# 15d's Markov stream runs over the first 512 token ids of the model's
# 32 000 (the width is kept): 30 steps of 1 024 tokens show no fall in the
# loss on a 32 000-state chain (10.51 -> 10.56 on the card, PERF.md)
P15_DATA_VOCAB = 512


def _sync_dev(dev):
    if dev.type == "cuda":
        torch.cuda.current_stream(dev).synchronize()


def _free(dev):
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def _granite_tree(dev, seed, layers):
    """granite-3-8b at full width and ``layers`` layers, float32 dense
    kernels from ``seed`` (phase 3's tree)."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    cfg = dataclasses.replace(get_config("granite-3-8b"), n_layers=layers)
    model = build_model(cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return model, model.init(gen, device=dev)


def _qt_leaves(tree, path=()):
    """``[(path, QuantizedTensor)]`` of a pipeline tree."""
    from repro_torch.quant.qtypes import QuantizedTensor
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _qt_leaves(tree[k],
                                                            path + (k,))]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree)
                for x in _qt_leaves(v, path + (str(i),))]
    return [(path, tree)] if isinstance(tree, QuantizedTensor) else []


def _qt_equal(a, b):
    """Codes and scales of two pipeline trees (DTensors gathered) bit for
    bit; returns the leaves compared."""
    from repro_torch.distributed.sharding import gather_tree
    la, lb = _qt_leaves(gather_tree(a)), _qt_leaves(gather_tree(b))
    if [p for p, _ in la] != [p for p, _ in lb] or not la:
        raise AssertionError("the trees' quantized leaves differ in paths")
    for (p, x), (_, y) in zip(la, lb):
        if not (torch.equal(x.data, y.data) and torch.equal(x.scale,
                                                            y.scale)):
            raise AssertionError(f"codes or scales differ at {p}")
    return len(la)


def _qdict(tree):
    """A pipeline tree's ``{"w": QuantizedTensor}`` nodes in the serving
    format (``w_q``/``w_q4`` + ``w_scale``; the same tensors)."""
    from repro_torch.quant.qtypes import QuantizedTensor
    if isinstance(tree, dict):
        w = tree.get("w")
        if isinstance(w, QuantizedTensor):
            out = {k: _qdict(v) for k, v in tree.items() if k != "w"}
            out["w_q4" if w.packed else "w_q"] = w.data
            out["w_scale"] = w.scale
            return out
        return {k: _qdict(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_qdict(v) for v in tree]
    return tree


def phase15a(dev, seed, layers):
    """15a: a real one-rank NCCL mesh through the real code path (JAX's own
    suite runs its mesh path on one device this way): granite-3-8b at full
    width and ``layers`` layers, ``quantize_tree(mesh=make_quantize_mesh())``
    against ``mesh=None`` (codes and scales bit-equal, one kernel-A launch
    and one scale pass a bucket, one synchronization), ``save_serving`` then
    ``restore_serving(mesh=)`` (leaves byte-equal), and a short round served
    on the restored (placed) tree: tokens equal the unplaced tree's, kernel
    B's launches those the round implies."""
    import torch.distributed as dist
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.core import pipeline
    from repro_torch.distributed import group
    from repro_torch.distributed.sharding import gather_tree
    from repro_torch.launch.mesh import make_quantize_mesh
    from repro_torch.quant.apply import quant_tree_meta
    from repro_torch.serving import ServeConfig, ServeEngine
    from repro_torch.serving.weights import WeightStore
    dm, pa, paq, sf = _kernel_modules()

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    mesh = make_quantize_mesh()                  # a one-rank group of its own
    group_ms = (time.perf_counter() - t0) * 1e3
    backend = dist.get_backend()
    if backend != "nccl" or dist.get_world_size() != 1:
        raise AssertionError(f"15a runs a one-rank NCCL group, got "
                             f"{backend} x {dist.get_world_size()}")
    model, params = _granite_tree(dev, seed, layers)
    syncs = []
    real_sync = pipeline._sync
    pipeline._sync = lambda d: (syncs.append(1), real_sync(d))
    try:
        _reset_launches(dm, pa, paq, sf)
        _sync_dev(dev)
        t0 = time.perf_counter()
        sharded, rep = pipeline.quantize_tree(params, method="squant",
                                              bits=8, mesh=mesh)
        _sync_dev(dev)
        quantize_ms = (time.perf_counter() - t0) * 1e3
        a_n, s_n = sf.launches, sf.scale_launches
        a_routes = dict(sf.launches_by_route)
        n_syncs = len(syncs)
    finally:
        pipeline._sync = real_sync
    plain, _ = pipeline.quantize_tree(params, method="squant", bits=8,
                                      device=dev)
    del params
    if n_syncs != 1:
        raise AssertionError(f"quantize_tree(mesh=) synchronized {n_syncs} "
                             f"times, not once")
    if a_n != len(rep.buckets) or s_n != len(rep.buckets):
        raise AssertionError(f"kernel A launches {a_n} (scale {s_n}), "
                             f"buckets {len(rep.buckets)}")
    if not all(b.route == "native" for b in rep.buckets):
        raise AssertionError("a bucket of the sharded run was stacked")
    wq = sharded["stack"]["list"][0]["b0"]["attn"]["wq"]["w"]
    if type(wq.data).__name__ != "DTensor":
        raise AssertionError("the sharded tree's codes are not DTensors")
    n_leaves = _qt_equal(sharded, plain)
    shards = [(s.device, s.rows, s.pad_rows) for s in rep.shards]
    from repro_torch.core.dispatch import shard_rows
    want_rows = sum(int(b.key[1:].split(",")[0]) * b.num_layers
                    for b in rep.buckets)
    if shards != [(0, want_rows, 0)] or \
            shard_rows(want_rows, 1) != [(want_rows, 0)]:
        raise AssertionError(f"shards {shards}, rows {want_rows}")

    # save_serving, restore_serving(mesh=): byte-equal leaves
    qd = _qdict(gather_tree(sharded))
    del sharded
    import tempfile
    d = tempfile.mkdtemp(prefix="chip_smoke_p15a_")
    try:
        ck = Checkpointer(d, async_save=False)
        t0 = time.perf_counter()
        ck.save_serving(1, qd, quant_meta=quant_tree_meta(8, "squant", 128,
                                                          rep))
        save_ms = (time.perf_counter() - t0) * 1e3
        _sync_dev(dev)
        t0 = time.perf_counter()
        placed, _, _ = ck.restore_serving(
            expect={"quantize_weights": "squant", "weight_bits": 8},
            mesh=mesh)
        _sync_dev(dev)
        restore_ms = (time.perf_counter() - t0) * 1e3
        restore_split = dict(ck.timings)
    finally:
        import shutil
        shutil.rmtree(d, ignore_errors=True)
    got, want = _leaves(gather_tree(placed)), _leaves(qd)
    if list(got) != list(want):
        raise AssertionError("restored tree's keys differ from the saved")
    for (k, x), y in zip(got.items(), want.values()):
        if not _same_bytes(x, y):
            raise AssertionError(f"restored leaf {k} differs from the saved")

    # a short round on the restored (placed) tree and on the unplaced one
    lengths, max_batch, _, _ = ROUND_TRAFFIC
    max_new = 8
    lengths = lengths[:max_batch]
    toks, b_counts, staged = [], [], []
    for tree in (placed, qd):
        _reset_launches(dm, pa, paq, sf)
        store = WeightStore(serving_params=tree, device=dev)
        eng = ServeEngine(model, cfg=ServeConfig(
            max_batch=max_batch, max_len=256, quantize_weights="squant",
            weight_bits=8), store=store, device=dev)
        outs = eng.generate(make_requests(seed, model.cfg.vocab, lengths,
                                          max_new))
        _sync_dev(dev)
        toks.append([o.tokens for o in outs])
        b_counts.append(dm.launches)
        staged.append(store.current.staged_ms)
        eng.close()
        del eng, store
    want_b = 7 * layers * (1 + max_new)          # one round: prefill + decodes
    if toks[0] != toks[1]:
        raise AssertionError(f"tokens on the restored placed tree differ "
                             f"from the unplaced tree's: {toks}")
    if b_counts != [want_b, want_b]:
        raise AssertionError(f"kernel B launches {b_counts}, the round "
                             f"implies {want_b}")
    del placed, qd, plain
    group.shutdown()
    _free(dev)
    line = {"phase": "15a one-rank NCCL mesh, granite-3-8b w8",
            "backend": backend, "ranks": 1, "layers": layers,
            "reduced": {"n_layers": f"40 -> {layers} (4 until 15o (vi)-(vii) "
                                    f"and 15p-q came)"},
            "d_model": model.cfg.d_model, "d_ff": model.cfg.d_ff,
            "group_and_mesh_ms": group_ms, "quantize_ms": quantize_ms,
            "quant_report": rep.summary(),
            "shards": shards, "syncs": n_syncs,
            "buckets": [b.key for b in rep.buckets],
            "leaves_bit_equal_to_mesh_none": n_leaves,
            "save_ms": save_ms, "restore_ms": restore_ms,
            "restore_split_ms": restore_split,
            "stage_ms_placed_vs_unplaced": staged,
            "tokens_equal": True, "requests": len(lengths),
            "max_new": max_new,
            "launches": {"squant_flip": a_n, "squant_flip_by_route": a_routes,
                         "squant_scale": s_n, "dequant_matmul": b_counts[0],
                         "dequant_matmul_unplaced": b_counts[1]},
            "seconds": time.perf_counter() - t_phase}
    emit(line)
    return {"squant_flip": a_n, "squant_scale": s_n,
            "dequant_matmul": b_counts[0]}


def _p15_ranks(seed, layers, ckpt, ring_floats, train_steps, ref_path,
               ref_path_h, ref_path_k, ref_path_n):
    """15b-15n on one rank of four sharing the card over gloo (run by
    ``run_local``): returns host numbers only."""
    import numpy as np
    import torch.distributed as dist
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.core import pipeline
    from repro_torch.distributed import group
    from repro_torch.distributed.sharding import (gather_tree,
                                                  reshard_serving_tree)
    from repro_torch.launch.mesh import make_quantize_mesh
    from repro_torch.quant.apply import quant_tree_meta
    from repro_torch.runtime.elastic import make_elastic_mesh
    from repro_torch.training import grad_compression as gc
    dm, pa, paq, sf = _kernel_modules()
    dev = group.device()
    rank, world = dist.get_rank(), dist.get_world_size()
    out = {"rank": rank, "backend": dist.get_backend(), "world": world}

    # ---- 15b: sharded quantization, each rank's slab through kernel A
    model, params = _granite_tree(dev, seed, layers)
    mesh = make_quantize_mesh(world)
    _reset_launches(dm, pa, paq, sf)
    dist.barrier()
    _sync_dev(dev)
    t0 = time.perf_counter()
    sharded, rep = pipeline.quantize_tree(params, method="squant", bits=8,
                                          mesh=mesh)
    _sync_dev(dev)
    out["quantize_ms"] = (time.perf_counter() - t0) * 1e3
    out["launches"] = {"squant_flip": sf.launches,
                       "squant_flip_by_route": dict(sf.launches_by_route),
                       "squant_scale": sf.scale_launches}
    out["shards"] = [(s.device, s.rows, s.pad_rows) for s in rep.shards]
    out["buckets"] = [(b.key, b.num_layers, b.route) for b in rep.buckets]
    t0 = time.perf_counter()
    full = gather_tree(sharded)                  # collective: every rank
    _sync_dev(dev)
    out["gather_ms"] = (time.perf_counter() - t0) * 1e3
    del sharded
    if rank == 0:
        plain, _ = pipeline.quantize_tree(params, method="squant", bits=8,
                                          device=dev)
        out["leaves_bit_equal"] = _qt_equal(full, plain)
        del plain
    del params
    # save from the 4-rank mesh (placed; the save gathers, rank 0 writes)
    qd = _qdict(full)
    del full
    elastic = make_elastic_mesh(world, prefer_model=2)
    t0 = time.perf_counter()
    Checkpointer(ckpt, async_save=False).save_serving(
        1, reshard_serving_tree(qd, elastic),
        quant_meta=quant_tree_meta(8, "squant", 128, rep))
    dist.barrier()
    out["save_ms"] = (time.perf_counter() - t0) * 1e3
    del qd
    _free(dev)
    # elastic restore: a 2-rank mesh (ranks 0 and 1; every rank makes it)
    out["restore"] = _p15_restore(ckpt)
    dist.barrier()

    # ---- 15c: the int8 ring on 4 ranks, 100 M floats each
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed * 1000 + rank)
    n = ring_floats - ring_floats % (world * gc.BLOCK)
    x = torch.randn(n, generator=gen, device=dev)
    total = group.all_reduce(x.clone())
    dist.barrier()
    _sync_dev(dev)
    t0 = time.perf_counter()
    red = gc.ring_allreduce_i8(x, None)
    _sync_dev(dev)
    ring_ms = (time.perf_counter() - t0) * 1e3
    out["ring"] = {"floats": n, "ms": ring_ms,
                   "ms_per_hop": ring_ms / (2 * (world - 1)),
                   "rel_err": float((red - total).abs().max()
                                    / total.abs().max()),
                   "digest": float(red.double().sum()),
                   "first": red[:8].tolist()}
    gathered = torch.empty(world * 8, device=dev)
    group.all_gather_into(gathered, red[:4096:512].contiguous())
    out["ring"]["identical_on_ranks"] = bool(
        (gathered.view(world, 8) == gathered.view(world, 8)[0]).all())
    del x, total, red
    _free(dev)

    # ---- 15d: pod-compressed training, 2 pods x 2 data
    out["train"] = _p15_train(dev, seed, train_steps)
    _free(dev)
    # ---- 15e-f: tensor-parallel serving and training
    out["tp"] = _p15ef_ranks(seed, ref_path)
    _free(dev)
    # ---- 15g-h: expert-parallel MoE serving and training
    out["ep"] = _p15gh_ranks(seed, ref_path_h)
    _free(dev)
    # ---- 15i-k: MLA and the ring under 'model', MLA training
    out["mr"] = _p15ijk_ranks(seed, ref_path_k)
    _free(dev)
    # ---- 15l-n: mamba and rwkv under 'model', rwkv training
    out["rec"] = _p15lmn_ranks(seed, ref_path_n)
    return out


def _p15_model():
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    cfg = dataclasses.replace(get_config("granite-3-8b", reduced=True),
                              **TRAIN_SIZE_100M)
    return build_model(cfg)


def _p15_batches(steps):
    from repro_torch.data.synthetic import markov_batches
    return [b for b, _ in zip(markov_batches(16, 64, P15_DATA_VOCAB,
                                             seed=7), range(steps))]


P15_OPT = dict(lr=3e-3, warmup_steps=5, decay_steps=100)


def _p15_train(dev, seed, steps):
    """15d on this rank: ``make_train_step(pod_compress=True)`` on a
    (pod 2, data 2) mesh, the global batch sliced per rank."""
    from repro_torch.distributed.group import make_mesh
    from repro_torch.training import train_loop as tl
    from repro_torch.training.optimizer import (AdamWConfig, adamw_init,
                                                tree_leaves)
    model = _p15_model()
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    params = model.init(gen, device=dev)
    opt = adamw_init(params)
    mesh = make_mesh((2, 2), ("pod", "data"))
    step = tl.make_train_step(model, AdamWConfig(**P15_OPT),
                              pod_compress=True, mesh=mesh)
    step.timed = True
    err = tl.init_pod_error(params, 2)
    shapes = [tuple(e.shape) for e in tree_leaves(err)]
    losses, splits, step_ms = [], [], []
    for b in _p15_batches(steps):
        b = tl.to_device(b, dev)
        t0 = time.perf_counter()
        params, opt, err, met = step(params, opt, err, b)
        losses.append(float(met["loss"]))
        step_ms.append((time.perf_counter() - t0) * 1e3)
        splits.append(dict(step.split_ms))
    if [tuple(e.shape) for e in tree_leaves(err)] != shapes:
        raise AssertionError("the error buffers changed shape")
    digest = float(sum(p.double().sum() for p in tree_leaves(params)))
    return {"losses": losses, "step_ms": step_ms, "split_ms": splits,
            "params_digest": digest, "error_shapes_stable": True}


def _p15_restore(ckpt):
    """15b's elastic restore: the checkpoint written from the 4-rank mesh
    onto ``make_elastic_mesh(2)`` (ranks 0 and 1; a rank outside it
    restores nothing); returns a digest of every leaf (gathered) per key."""
    import torch.distributed as dist
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.distributed import group
    from repro_torch.distributed.sharding import gather_tree
    from repro_torch.runtime.elastic import make_elastic_mesh
    dev = group.device()
    mesh = make_elastic_mesh(2)
    if mesh.get_coordinate() is None:
        return None
    _sync_dev(dev)
    t0 = time.perf_counter()
    placed, _, _ = Checkpointer(ckpt).restore_serving(mesh=mesh)
    _sync_dev(dev)
    ms = (time.perf_counter() - t0) * 1e3
    digests = {}
    for k, v in _leaves(gather_tree(placed)).items():
        digests[k] = _digest(v)
    local = placed["stack"]["list"][0]["b0"]["attn"]["wq"]["w_q"]
    return {"rank": dist.get_rank(), "mesh": tuple(mesh.shape),
            "restore_ms": ms, "digests": digests,
            "local_shard": tuple(local.to_local().shape)}


def _digests_of_checkpoint(ckpt, dev):
    """The saved leaves' digests, read back on one device (no mesh)."""
    from repro_torch.checkpoint import Checkpointer
    tree, _, _ = Checkpointer(ckpt).restore_serving(device=dev)
    return {k: _digest(v) for k, v in _leaves(tree).items()}


def _digest(t):
    """sha256 of a tensor's dtype, shape and bytes."""
    import hashlib
    h = hashlib.sha256(f"{t.dtype} {tuple(t.shape)}".encode())
    h.update(t.detach().contiguous().view(torch.uint8).cpu().numpy()
             .tobytes())
    return h.hexdigest()


def _p15_plain(dev, seed):
    """15d's plain one-rank step on the same global batches: its losses."""
    from repro_torch.training import train_loop as tl
    from repro_torch.training.optimizer import AdamWConfig, adamw_init
    model = _p15_model()
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    params = model.init(gen, device=dev)
    opt = adamw_init(params)
    step = tl.make_train_step(model, AdamWConfig(**P15_OPT))
    plain = []
    for b in _p15_batches(P15_TRAIN_STEPS):
        params, opt, met = step(params, opt, tl.to_device(b, dev))
        plain.append(float(met["loss"]))
    del params, opt, model
    _free(dev)
    return plain


def _four_ranks_beside(dev, fn, args, here, ranks=4):
    """``fn(*args)`` on four (or ``ranks``) gloo rank processes sharing
    the card (``run_local``, on a thread) while ``here()`` runs in this
    process: (the ranks' results, their seconds, ``here()``'s result)."""
    import threading
    from repro_torch.distributed.group import run_local
    four = {}

    def run_four():
        t0 = time.perf_counter()
        try:
            four["ranks"] = run_local(fn, ranks, backend="gloo",
                                      device=dev.type, args=args,
                                      timeout=900)
        except BaseException as e:          # raised on this thread below
            four["error"] = e
        four["s"] = time.perf_counter() - t0

    th = threading.Thread(target=run_four, daemon=True)
    th.start()
    try:
        mine = here()
    finally:
        th.join()
    if "error" in four:
        raise four["error"]
    return four["ranks"], four["s"], mine


def phase15bcd(dev, seed, card):
    """15b-15n: four ranks sharing the card over gloo (sharded quantization
    of granite at full width, save from the 4-rank mesh; the int8 ring over
    100 M floats a rank; pod-compressed training of the 100m model, 2 pods
    x 2 data; between 15b and 15c ranks 0 and 1 restore the checkpoint
    onto a 2-rank elastic mesh; then 15e-f, :func:`phase15ef`, 15g-h,
    :func:`phase15gh`, 15i-k, :func:`phase15ijk`, and 15l-n,
    :func:`phase15lmn`, in the same processes); 15d's, 15f's, 15h's, 15k's
    and 15n's plain one-rank steps on the same global batches run here, in
    this process, while the four ranks run (most of 15d's time is theirs
    starting up). Returns kernel A's launches by rank and 15e-f's, 15g-h's,
    15i-k's and 15l-n's summaries."""
    import tempfile
    import shutil

    ckpt = tempfile.mkdtemp(prefix="chip_smoke_p15b_")
    work = tempfile.mkdtemp(prefix="chip_smoke_p15f_")
    ref_path = os.path.join(work, "one_rank.pt")
    ref_path_h = os.path.join(work, "one_rank_h.pt")
    ref_path_k = os.path.join(work, "one_rank_k.pt")
    ref_path_n = os.path.join(work, "one_rank_n.pt")
    t_phase = time.perf_counter()

    def here():
        plain = _p15_plain(dev, seed)
        t0 = time.perf_counter()
        plain_f = _p15f_one_rank(dev, seed, ref_path)
        t1 = time.perf_counter()
        plain_h = _p15h_one_rank(dev, seed, ref_path_h)
        t2 = time.perf_counter()
        plain_k = _p15k_one_rank(dev, seed, ref_path_k)
        t3 = time.perf_counter()
        plain_n = _p15n_one_rank(dev, seed, ref_path_n)
        t4 = time.perf_counter()
        # last: the ranks' 15q waits for it, so its state and theirs never
        # share the card
        plain_q = _p15q_one_rank(dev, seed, ref_path + ".q")
        return (plain, plain_f, t1 - t0, plain_h, t2 - t1, plain_k, t3 - t2,
                plain_n, t4 - t3, plain_q, time.perf_counter() - t4)

    try:
        ranks, four_s, (plain, plain_f, plain_f_s, plain_h, plain_h_s,
                        plain_k, plain_k_s, plain_n, plain_n_s, plain_q,
                        plain_q_s) = \
            _four_ranks_beside(dev, _p15_ranks, (
                seed, P15B_LAYERS, ckpt, P15_RING_FLOATS, P15_TRAIN_STEPS,
                ref_path,
                ref_path_h, ref_path_k, ref_path_n), here)
        saved = _digests_of_checkpoint(ckpt, dev)
        restored = [r["restore"] for r in ranks if r["restore"] is not None]
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
        shutil.rmtree(work, ignore_errors=True)
    from repro_torch.core.dispatch import shard_rows
    r0 = ranks[0]
    # 15b gates
    if r0.get("leaves_bit_equal", 0) <= 0:
        raise AssertionError("15b: rank 0 compared no leaves")
    want = [[0, 0] for _ in range(4)]
    for key, nl, _ in r0["buckets"]:
        for d, (r, p) in enumerate(shard_rows(
                int(key[1:].split(",")[0]) * nl, 4)):
            want[d][0] += r
            want[d][1] += p
    want = [(d, r, p) for d, (r, p) in enumerate(want)]
    for r in ranks:
        if r["shards"] != want:
            raise AssertionError(f"15b: rank {r['rank']} shards {r['shards']}"
                                 f" != shard_rows {want}")
        if r["launches"]["squant_flip"] == 0:
            raise AssertionError(f"15b: rank {r['rank']} launched no kernel A")
        if r["backend"] != "gloo" or r["world"] != 4:
            raise AssertionError("15b: not four gloo ranks")
    if [r["rank"] for r in restored] != [0, 1]:
        raise AssertionError("15b: the elastic mesh is not ranks 0 and 1")
    for r in restored:
        if r["digests"] != saved:
            raise AssertionError(f"15b: rank {r['rank']}'s restored leaves "
                                 f"differ from the saved ones")
    emit({"phase": "15b sharded quantization on 4 ranks sharing the card "
                   f"(gloo), granite-3-8b w8 at full width, {P15B_LAYERS} "
                   "layer; checkpoint from the 4-rank mesh restored on a "
                   "2-rank elastic mesh",
          "backend": "gloo", "ranks": 4, "layers": P15B_LAYERS,
          "reduced": P15_CUTS["15b"],
          "buckets": r0["buckets"], "shards": want,
          "leaves_bit_equal_to_mesh_none": r0["leaves_bit_equal"],
          "quantize_ms_by_rank": [r["quantize_ms"] for r in ranks],
          "gather_ms_by_rank": [r["gather_ms"] for r in ranks],
          "save_ms_by_rank": [r["save_ms"] for r in ranks],
          "kernel_a_by_rank": [r["launches"] for r in ranks],
          "note": "four CUDA contexts share one card: these are not a "
                  "speed-up over one rank",
          "restore": {"ranks": 2, "backend": "gloo",
                      "mesh": restored[0]["mesh"],
                      "local_wq_shard": restored[0]["local_shard"],
                      "restore_ms_by_rank": [r["restore_ms"]
                                             for r in restored],
                      "leaves_equal": len(saved)},
          "run_local_seconds_15b_f": four_s})
    # 15c gates
    rings = [r["ring"] for r in ranks]
    if not all(x["identical_on_ranks"] for x in rings) or \
            len({(x["digest"], tuple(x["first"])) for x in rings}) != 1:
        raise AssertionError("15c: the ring's result differs between ranks")
    if not rings[0]["rel_err"] < 0.03:
        raise AssertionError(f"15c: relative error {rings[0]['rel_err']}")
    emit({"phase": "15c int8 ring all-reduce, 4 ranks sharing the card "
                   "(gloo)", "backend": "gloo", "ranks": 4,
          "floats_per_rank": rings[0]["floats"],
          "rel_err_vs_float32_sum": rings[0]["rel_err"], "gate": 0.03,
          "identical_on_every_rank": True,
          "ms_by_rank": [x["ms"] for x in rings],
          "ms_per_hop_by_rank": [x["ms_per_hop"] for x in rings],
          "note": "each hop is staged through pinned host memory and sent "
                  "over gloo's loopback TCP between processes on one "
                  "card: not an interconnect number"})
    # 15d: the compressed step's losses against the plain step's
    trains = [r["train"] for r in ranks]
    if len({t["params_digest"] for t in trains}) != 1:
        raise AssertionError("15d: the ranks' parameters differ")
    comp = trains[0]["losses"]
    import numpy as np
    p0, p1 = np.mean(plain[:5]), np.mean(plain[-5:])
    c0, c1 = np.mean(comp[:5]), np.mean(comp[-5:])
    gates = {"plain_falls": bool(p1 < 0.8 * p0),
             "compressed_falls": bool(c1 < 0.8 * c0),
             "tracks_plain": bool(abs(c1 - p1) < 0.25 * p0)}
    split = {k: _percentiles([s[k] for s in trains[0]["split_ms"][3:]])[
        "p50"] for k in trains[0]["split_ms"][-1]}
    emit({"phase": "15d pod-compressed training, 2 pods x 2 data ranks "
                   "sharing the card (gloo), examples/train_then_quantize.py "
                   "--size 100m", "backend": "gloo", "ranks": 4,
          "steps": P15_TRAIN_STEPS, "global_batch": "16 x 64",
          "data": f"markov_batches(16, 64, {P15_DATA_VOCAB}, seed=7): "
                  f"the first {P15_DATA_VOCAB} of the 32 000 token ids",
          "optimizer": P15_OPT,
          "plain_first5_last5": [p0, p1], "compressed_first5_last5": [c0, c1],
          "gates": gates, "error_shapes_stable": all(
              t["error_shapes_stable"] for t in trains),
          "step_ms_p50_steps_4_on": _percentiles(
              trains[0]["step_ms"][3:])["p50"],
          "split_ms_p50_rank0": split,
          "note": "in-pod all-reduce and ring staged through host memory "
                  "over gloo between processes on one card",
          "seconds": time.perf_counter() - t_phase})
    if not all(gates.values()):
        raise AssertionError(f"15d: the learning contract failed: {gates}")
    ef = _p15ef_report([r["tp"] for r in ranks], plain_f, plain_f_s, card,
                       four_s, t_phase, plain_q, plain_q_s)
    gh = _p15gh_report([r["ep"] for r in ranks], plain_h, plain_h_s, card,
                       four_s, t_phase)
    mr = _p15ijk_report([r["mr"] for r in ranks], plain_k, plain_k_s, card,
                        four_s, t_phase)
    rec = _p15lmn_report([r["rec"] for r in ranks], plain_n, plain_n_s,
                         card, four_s, t_phase)
    return {"squant_flip": [r["launches"]["squant_flip"] for r in ranks],
            "squant_scale": [r["launches"]["squant_scale"] for r in ranks],
            "tp": ef, "ep": gh, "mr": mr, "rec": rec}


# ---------------------------------------------------------------------------
# phase 15e-f: tensor-parallel execution over 'model' (four gloo ranks
# sharing the card, as 15b-d)
# ---------------------------------------------------------------------------

# depths cut when phase 15o came (the script's time limit; widths
# unchanged), each in its phase's line
P15_CUTS = {"15b": "granite 2 -> 1 of 40 layers (when 15o (vi)-(vii) and "
                   "15p-q came)",
            "15e": "granite 2 -> 1 of 40 layers (4 before 15g-h came)",
            "15f": "granite 2 -> 1 of 40 layers",
            "15g": "moonshot 2 -> 1 of 48 layers (when 15o (vi)-(vii) and "
                   "15p-q came)",
            "15i": "minicpm3 4 -> 2 of 62 layers, 2 -> 1 when 15o (vi)-(vii) "
                   "and 15p-q came",
            "15k": "minicpm3 2 -> 1 of 62 layers",
            "15m": "rwkv6-1.6b 4 -> 2 of 24 layers, 2 -> 1 when 15o "
                   "(vi)-(vii) and 15p-q came",
            "15n": "rwkv6-1.6b 2 -> 1 of 24 layers"}
P15E_LAYERS = 1          # 15e's granite at full width (of 40)
P15E_SMALL = 1           # 15e's free-running token gates and int4 per-group
P15E_PROMPT = (8, 256)   # 15e's prefill: 8 rows of 256 tokens
P15E_STEPS = 16          # 15e's greedy decode steps
P15F_LAYERS = 1          # 15f's granite at full width (of 40)
P15F_STEPS = 5
P15F_BATCH = (4, 256)
# AdamW's update moves by up to lr * dg / eps when a gradient element
# moves by dg (most where |g| is near zero); the partial sums over 'model'
# round the gradients differently from one rank's products, so the
# parameter gate at STEP_TOL runs eps 1e-3 (tests/torch_tp_workers.py)
P15F_OPT = dict(lr=1e-4, warmup_steps=0, decay_steps=10, eps=1e-3)
STEP_TOL = dict(rtol=1e-4, atol_rms=1e-5)   # tests/test_torch_train_step.py
GRAD_TOL = dict(rtol=2e-4, atol=2e-5)       # the same file's


def _tp_granite(layers, dtype="float32"):
    """granite-3-8b at full width and ``layers`` layers in ``dtype``."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    return build_model(dataclasses.replace(get_config("granite-3-8b"),
                                           n_layers=layers, dtype=dtype))


def _tp_params(model, dev, seed):
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return model.init(gen, device=dev)


def _first_layers(tree, n):
    """``tree`` with the first ``n`` layers of its stack."""
    return dict(tree, stack={"list": tree["stack"]["list"][:n]})


def _group_scale_tree(params, bits, group_size):
    """Every dense kernel ``{"w": (in, out)}`` of ``params`` as a
    ``QuantizedTensor`` of round-to-nearest codes under one max scale per
    ``group_size`` input columns of each output row, ``(out, in /
    group_size)``: the serving format's per-group option kernel B takes
    (SQuant's trees keep one scale a row). An expert bank ``(E, in, out)``
    becomes the pipeline's ``(E·out, in)`` carrier the same way; an MoE
    router stays as it is (the pipeline never quantizes one)."""
    from repro_torch.quant.qtypes import from_codes, qmax_for_bits
    from repro_torch.quant.scales import compute_scale

    def one(node, key=""):
        if isinstance(node, dict):
            w = node.get("w")
            if key != "router" and isinstance(w, torch.Tensor) and \
                    w.ndim in (2, 3):
                w = w.T.contiguous() if w.ndim == 2 else \
                    w.transpose(1, 2).reshape(-1, w.shape[1])
                sc = compute_scale(w, bits, group_size=group_size)
                q = qmax_for_bits(bits)
                codes = torch.clamp(torch.round(
                    w / sc.repeat_interleave(group_size, dim=1)), -q, q)
                return dict(node, w=from_codes(codes.to(torch.int8), sc,
                                               bits, group_size))
            return {k: one(v, k) for k, v in node.items()}
        if isinstance(node, list):
            return [one(v) for v in node]
        return node
    return one(params)


def _slab_launches(buckets, ndev, d, slice_rows=None):
    """Kernel-A launches and scale passes rank ``d`` of ``ndev`` makes for
    ``buckets`` ((key, leaves, route)), one a piece of its row slab
    (``core.dispatch.quantize_codes_sharded``): on the native route a flip
    and a scale pass a piece, on the stacked route one flip (its scales
    are torch ops), and none for a whole-row (``gNone``) bucket, which the
    flip kernel does not take. The native route reads a bank's expert
    slices as its leaves: ``slice_rows`` maps such a bucket's
    ``"(E·out,in)"`` to the rows of one slice (``out``)."""
    from repro_torch.core.dispatch import shard_rows, slab_pieces
    n = {"squant_flip": 0, "squant_scale": 0}
    for key, nl, route in buckets:
        m = int(key[1:].split(",")[0])
        rows = m * nl
        slabs = shard_rows(rows, ndev)
        per = sum(slabs[0])
        r0 = min(d * per, rows)
        r1 = r0 + slabs[d][0]
        leaf = (slice_rows or {}).get(key.split(")")[0] + ")", m)
        if r1 <= r0 or key.endswith("gNone"):
            continue
        if route == "native":
            pieces = len(slab_pieces(r0, r1, leaf))
            n["squant_flip"] += pieces
            n["squant_scale"] += pieces
        else:
            n["squant_flip"] += 1
    return n


def _per_rank(n, unit, tp):
    """A rank's width of ``n`` units of ``unit`` on a 'model' axis of
    ``tp``: its replica group's shard, ``n / gcd(n, tp)`` units
    (``sharding.replica_groups``; ``n / tp`` where ``tp`` divides ``n``)."""
    return n // math.gcd(n, tp) * unit


def _tp_local_shapes(cfg, tp):
    """{(M, N): launches a forward} of kernel B on a rank's local shards
    (``tp`` ranks): the seven projections of each layer (heads and FFN
    columns on replica groups where 'model' does not divide them), and
    an untied head (vocab-parallel where 'model' divides the vocabulary)."""
    d = cfg.d_model
    q = _per_rank(cfg.n_heads, cfg.head_dim, tp)
    kv = _per_rank(cfg.n_kv_heads, cfg.head_dim, tp)
    f = _per_rank(cfg.d_ff, 1, tp)
    out = collections.Counter()
    for m, n in ((q, d), (kv, d), (kv, d), (d, q), (f, d), (f, d), (d, f)):
        out[(m, n)] += cfg.n_layers
    if not cfg.tie_embeddings:
        v = cfg.vocab
        out[(v // tp if v % tp == 0 else v, d)] += 1
    return dict(out)


def _by_weight_shape(by_shape):
    """``dm.launches_by_shape`` summed over variants, by (M, N)."""
    out = collections.Counter()
    for key, n in by_shape.items():
        m, k = key.split(" ")[-1].split("x")
        out[(int(m), int(k))] += n
    return dict(out)


def _tp_serve(dev, model, tree, prompt, steps, forced=None, mesh=None,
              chunks=(), frames=None):
    """A prefill of ``prompt`` on the contiguous cache (over the encoder
    ``frames`` of an encoder-decoder), the token blocks of ``chunks``
    continued at the clock after it (``prefill_chunk``; an
    encoder-decoder's chunk forward over the cache's encoder output, the
    reference's forward mode), then ``steps`` greedy decode steps (fed
    ``forced`` where given), under ``mesh`` (None: one rank): the last-row
    logits of every forward (float32, on the device), the tokens picked,
    every routing's expert indices (an MoE stack's), the prefill's, each
    chunk's and each step's ms and a step's tensor-parallel collectives'
    ms."""
    from repro_torch.distributed import group
    from repro_torch.distributed.sharding import activate_mesh
    from repro_torch.models.moe import recording_routes
    b, s = prompt.shape
    rows = s + sum(c.shape[1] for c in chunks) + steps + 1
    logits, toks, chunk_ms, step_ms, coll_ms = [], [], [], [], []
    enc = {} if frames is None else {"enc_frames": frames}
    with activate_mesh(mesh), recording_routes() as routes:
        cache = model.init_cache(b, rows, device=dev)
        _sync_dev(dev)
        t0 = time.perf_counter()
        lg, cache = model.prefill(tree, {"tokens": prompt, **enc}, cache)
        _sync_dev(dev)
        prefill_ms = (time.perf_counter() - t0) * 1e3
        for c in chunks:
            logits.append(lg.float())
            toks.append(lg.argmax(-1))
            t0 = time.perf_counter()
            if frames is None:
                lg, cache = model.prefill_chunk(tree, {"tokens": c}, cache)
            else:
                lg, cache = model.forward(
                    tree, {"tokens": c, "enc_out": cache["enc_out"]},
                    mode="chunk", caches=cache)
                lg = lg[:, -1]
            _sync_dev(dev)
            chunk_ms.append((time.perf_counter() - t0) * 1e3)
        for i in range(steps + 1):
            logits.append(lg.float())
            toks.append(lg.argmax(-1))
            if i == steps:
                break
            feed = toks[-1] if forced is None else forced[i]
            c0 = group.MODEL_COLLECTIVES["ms"]
            t0 = time.perf_counter()
            lg, cache = model.decode_step(tree, feed[:, None], cache)
            _sync_dev(dev)
            step_ms.append((time.perf_counter() - t0) * 1e3)
            coll_ms.append(group.MODEL_COLLECTIVES["ms"] - c0)
    return {"logits": logits, "tokens": toks, "routes": list(routes),
            "prefill_ms": prefill_ms, "chunk_ms": chunk_ms,
            "step_ms": step_ms, "collective_ms": coll_ms}


def _routes_digest(routes):
    return float(sum((r.double() * (i + 1)).sum()
                     for i, r in enumerate(routes)))


def _serve_case_vs_one_rank(dev, model, tree, mesh, prompt, chunks, steps,
                            forced, want_shapes, local=None, frames=None):
    """One serving case of phase 15 on this rank: the one-rank forward on
    the whole ``tree`` (rank 0), its decode tokens fed to every rank where
    ``forced``, then the tensor-parallel forward on this rank's shards
    under ``mesh`` (``local``, or ``tp_local`` of ``tree``), over the
    encoder ``frames`` of an encoder-decoder. Returns the case's row:
    kernel B's
    launches by local weight shape and variant against ``want_shapes``,
    the times, digests, and (rank 0) the agreement with the one-rank
    forward."""
    import numpy as np
    import torch.distributed as dist
    from repro_torch.distributed import group
    from repro_torch.distributed.sharding import tp_local
    dmod, pa, paq, sf = _kernel_modules()
    ref = None
    if dist.get_rank() == 0:
        ref = _tp_serve(dev, model, tree, prompt, steps, chunks=chunks,
                        frames=frames)
    feed = [[t.cpu() for t in ref["tokens"][len(chunks):-1]]
            if forced and ref is not None else None]
    dist.broadcast_object_list(feed, src=0)
    feed = None if feed[0] is None else [t.to(dev) for t in feed[0]]
    local = tp_local(tree, mesh, cfg=model.cfg) if local is None else local
    _reset_launches(dmod, pa, paq, sf)
    c0 = dict(group.MODEL_COLLECTIVES)
    dist.barrier()
    got = _tp_serve(dev, model, local, prompt, steps, forced=feed,
                    mesh=mesh, chunks=chunks, frames=frames)
    row = {"launches_by_weight_shape": {
               f"{k[0]}x{k[1]}": v for k, v in
               _by_weight_shape(dmod.launches_by_shape).items()},
           "launches_by_variant": {k: v for k, v in
                                   dmod.launches_by_variant.items() if v},
           "kernel_b": dmod.launches,
           "want_by_weight_shape": {f"{k[0]}x{k[1]}": v
                                    for k, v in want_shapes.items() if v},
           "model_collectives": group.MODEL_COLLECTIVES["calls"]
           - c0["calls"],
           "prefill_ms": got["prefill_ms"], "chunk_ms": got["chunk_ms"],
           "step_ms": got["step_ms"], "collective_ms": got["collective_ms"],
           "routings": len(got["routes"]),
           "routes_digest": _routes_digest(got["routes"]),
           "last_logits_digest": float(got["logits"][-1].double().sum()),
           "tokens_digest": float(sum((t.double() * (i + 1)).sum()
                                      for i, t in enumerate(got["tokens"])))}
    if ref is not None:
        big = max(float(x.abs().max()) for x in ref["logits"])
        row["max_abs_err_over_max_logit"] = max(
            float((x - y).abs().max()) for x, y in
            zip(got["logits"], ref["logits"])) / big
        row["tokens_equal"] = all(torch.equal(x, y) for x, y in
                                  zip(got["tokens"], ref["tokens"]))
        row["tokens_agree"] = float(np.mean([
            float((x == y).float().mean()) for x, y in
            zip(got["tokens"], ref["tokens"])]))
        row["routes_equal"] = len(got["routes"]) == len(ref["routes"]) \
            and all(torch.equal(x, y) for x, y in
                    zip(got["routes"], ref["routes"]))
        row["routes_agree"] = float(np.mean([
            float((x == y).float().mean()) for x, y in
            zip(got["routes"], ref["routes"])])) if ref["routes"] else None
        row["one_rank_prefill_ms"] = ref["prefill_ms"]
        row["one_rank_chunk_ms"] = ref["chunk_ms"]
        row["one_rank_step_ms"] = ref["step_ms"]
    del local, got, ref
    _free(dev)
    return row


def _p15e_rank(dev, seed):
    """15e on this rank of four (see :func:`phase15ef`): host numbers."""
    import numpy as np
    import torch.distributed as dist
    from repro_torch.core import pipeline
    from repro_torch.distributed.group import make_mesh
    from repro_torch.distributed.sharding import gather_tree
    from repro_torch.kernels import dequant_matmul as dm
    from repro_torch.launch.mesh import make_quantize_mesh
    dmod, pa, paq, sf = _kernel_modules()
    rank, world = dist.get_rank(), dist.get_world_size()
    out = {"rank": rank}
    model = _tp_granite(P15E_LAYERS)
    small = _tp_granite(P15E_SMALL)
    params = _tp_params(model, dev, seed)
    g4 = _group_scale_tree(_first_layers(params, P15E_SMALL), 4, 128)
    qmesh = make_quantize_mesh(world)
    _reset_launches(dmod, pa, paq, sf)
    dist.barrier()
    _sync_dev(dev)
    t0 = time.perf_counter()
    sharded, rep = pipeline.quantize_tree(params, method="squant", bits=8,
                                          mesh=qmesh)
    _sync_dev(dev)
    out["quantize_ms"] = (time.perf_counter() - t0) * 1e3
    out["buckets"] = [(b.key, b.num_layers, b.route) for b in rep.buckets]
    out["kernel_a"] = {"squant_flip": sf.launches,
                       "squant_scale": sf.scale_launches}
    whole = gather_tree(sharded)
    del sharded, params
    _free(dev)
    mesh = make_mesh((1, world), ("data", "model"))
    rng = np.random.default_rng(seed)
    prompt = torch.from_numpy(rng.integers(
        0, model.cfg.vocab, size=P15E_PROMPT)).to(dev)
    cases = (("w8 float32", model, whole, True),
             ("w8 bfloat16", _tp_granite(P15E_LAYERS, "bfloat16"),
              _retyped(whole, torch.bfloat16), True),
             (f"w8 float32 {P15E_SMALL} layers", small,
              _first_layers(whole, P15E_SMALL), False),
             (f"w4 per-group scales float32 {P15E_SMALL} layers", small, g4,
              False))
    out["cases"] = {}
    dm._plans.clear()
    for name, m, tree, forced in cases:
        out["cases"][name] = _serve_case_vs_one_rank(
            dev, m, tree, mesh, prompt, (), P15E_STEPS, forced,
            {k: v * (P15E_STEPS + 1) for k, v in
             _tp_local_shapes(m.cfg, world).items()})
    out["plans"] = dm.cached_plans()
    del whole, g4
    _free(dev)
    return out


def _p15f_batches():
    from repro_torch.data.synthetic import markov_batches
    return [b for b, _ in zip(markov_batches(*P15F_BATCH, P15_DATA_VOCAB,
                                             seed=11), range(P15F_STEPS))]


def _p15f_rank(dev, seed, ref_path):
    """15f on this rank of four: the tensor-parallel step on (data 2,
    model 2), its metrics and split, and its final shards against the
    one-rank parameters the script's process saved at ``ref_path``."""
    import torch.distributed as dist
    from repro_torch.distributed.group import make_mesh
    from repro_torch.distributed.sharding import shard_index, tp_place
    from repro_torch.training import train_loop as tl
    from repro_torch.training.optimizer import AdamWConfig, adamw_init
    model = _tp_granite(P15F_LAYERS)
    mesh = make_mesh((2, 2), ("data", "model"))
    placed = tp_place(_tp_params(model, dev, seed), mesh, cfg=model.cfg)
    _free(dev)
    opt = adamw_init(placed)
    step = tl.make_train_step(model, AdamWConfig(**P15F_OPT), mesh=mesh)
    step.timed = True
    losses, norms, step_ms, splits = [], [], [], []
    dist.barrier()
    for b in _p15f_batches():
        b = tl.to_device(b, dev)
        _sync_dev(dev)
        t0 = time.perf_counter()
        placed, opt, met = step(placed, opt, b)
        losses.append(float(met["loss"]))
        step_ms.append((time.perf_counter() - t0) * 1e3)
        norms.append(float(met["grad_norm"]))
        splits.append(dict(step.split_ms))
    del opt
    _free(dev)
    _wait_until(lambda: os.path.exists(ref_path + ".done"), 600,
                "15f's one-rank parameters")
    ref = torch.load(ref_path, mmap=True, map_location="cpu")
    worst = 0.0
    sizes = tuple(mesh.shape)
    for k, t in _leaves(placed).items():
        idx = shard_index(t.shape, t.placements, sizes,
                          mesh.get_coordinate())
        want = ref[k][idx].to(dev)
        rms = float(ref[k].double().square().mean().sqrt())
        excess = ((t.to_local() - want).abs() - STEP_TOL["rtol"] * want.abs()
                  - STEP_TOL["atol_rms"] * rms).max()
        worst = max(worst, float(excess))
    return {"losses": losses, "grad_norms": norms, "step_ms": step_ms,
            "split_ms": splits, "shards_excess_over_step_tol": worst,
            "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9}


P15P_LAYERS = 2          # 15p's seamless: 2 + 2 of its 12 + 12 layers
P15P_PROMPT = (4, 64)    # 15p's prefill, over 64 / 4 random frames a row
P15P_STEPS = 16          # 15p's greedy decode steps
P15Q_LAYERS = 2          # 15q's seamless train step: 2 + 2 layers
P15Q_STEPS = 3
P15Q_BATCH = (4, 128)    # tokens; 128 / 4 random frames a row
P15Q_OPT = P15F_OPT
# 15q's whole step (AdamW) runs on (data 2, model 2), where the vocabulary
# is vocab-parallel: at 'model' 4 the replicated float32 embedding and head
# (1.05 GB each) make a rank's step ~18 GB, and four of them beside the
# script's process ran out of the card's memory (PERF.md, 15q)
P15Q_STEP_MESH = (2, 2)


def _tp_seamless(layers, dtype="float32"):
    """seamless-m4t-medium at full width, ``layers`` encoder and
    ``layers`` decoder layers, in ``dtype``: 16 heads of 64, d_ff 4 096,
    an untied head over 256 206 tokens (2 x 128 103: vocab-parallel at
    'model' 2, replicated at 4)."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    return build_model(dataclasses.replace(
        get_config(SEAMLESS_ARCH), n_layers=layers, encoder_layers=layers,
        dtype=dtype))


def _encdec_local_shapes(cfg, tp, forwards, encodes):
    """{(M, N): launches} of kernel B on a rank's local seamless shards
    (``tp`` ranks) over ``forwards`` forwards, ``encodes`` of them running
    the encoder: each encoder layer's q, k, v, o, wi and wdown, each
    decoder layer's self-attention q, k, v, o, cross-attention q, k, v, o,
    wi and wdown, and the untied head (vocab-parallel where 'model'
    divides the vocabulary)."""
    d, v = cfg.d_model, cfg.vocab
    h = _per_rank(cfg.n_heads, cfg.head_dim, tp)
    kv = _per_rank(cfg.n_kv_heads, cfg.head_dim, tp)
    f = _per_rank(cfg.d_ff, 1, tp)
    out = collections.Counter()
    for mn in ((h, d), (h, d), (h, d), (d, h), (f, d), (d, f)):
        out[mn] += cfg.encoder_layers * encodes
    for mn in ((h, d), (kv, d), (kv, d), (d, h), (h, d), (h, d), (h, d),
               (d, h), (f, d), (d, f)):
        out[mn] += cfg.n_layers * forwards
    out[(v // tp if v % tp == 0 else v, d)] += forwards
    return dict(out)


def _frames(seed, b, t, d):
    """Random float32 encoder frames ``(b, t, d)`` (numpy)."""
    import numpy as np
    return np.random.default_rng(seed).standard_normal(
        (b, t, d)).astype(np.float32)


def _p15p_rank(dev, seed):
    """15p on this rank of four (see :func:`phase15ef`): host numbers."""
    import numpy as np
    import torch.distributed as dist
    from repro_torch.distributed.group import make_mesh
    from repro_torch.kernels import dequant_matmul as dm
    from repro_torch.launch.mesh import make_quantize_mesh
    rank, world = dist.get_rank(), dist.get_world_size()
    model = _tp_seamless(P15P_LAYERS)
    cfg = model.cfg
    params = _tp_params(model, dev, seed)
    dist.barrier()
    t0 = time.perf_counter()
    whole, buckets, kernel_a = _quantized_on_slabs(
        params, 8, make_quantize_mesh(world), dev)
    out = {"rank": rank, "quantize_ms": (time.perf_counter() - t0) * 1e3,
           "buckets": buckets, "kernel_a": kernel_a}
    del params
    _free(dev)
    mesh = make_mesh((1, world), ("data", "model"))
    rng = np.random.default_rng(seed)
    b, s = P15P_PROMPT
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab, size=(b, s))).to(dev)
    chunks = [torch.from_numpy(rng.integers(0, cfg.vocab,
                                            size=(b, P15_CHUNK))).to(dev)]
    frames = torch.from_numpy(_frames(seed, b, s // cfg.enc_ratio,
                                      cfg.d_model)).to(dev)
    want = _encdec_local_shapes(cfg, world, 1 + len(chunks) + P15P_STEPS, 1)
    cases = (("w8 float32", model, whole),
             ("w8 bfloat16", _tp_seamless(P15P_LAYERS, "bfloat16"),
              _retyped(whole, torch.bfloat16)))
    out["cases"] = {}
    dm._plans.clear()
    for name, m, tree in cases:
        out["cases"][name] = _serve_case_vs_one_rank(
            dev, m, tree, mesh, prompt, chunks, P15P_STEPS, True, want,
            frames=frames)
    out["plans"] = dm.cached_plans()
    del whole, cases
    _free(dev)
    return out


def _p15q_batches(d):
    """15q's batches: Markov tokens over the first
    :data:`P15_DATA_VOCAB` ids and random float32 frames."""
    b, s = P15Q_BATCH
    return [dict(bt, enc_frames=_frames(37 + i, b, s // 4, d))
            for i, bt in enumerate(_markov(P15Q_BATCH, P15Q_STEPS, 31))]


def _p15q_rank(dev, seed, ref_path):
    """15q on this rank of four, started after the one-rank side has run
    and freed its memory: seamless's tensor-parallel step on (data 1,
    model 4), its first batch's gradients and grad norm
    (``step.averaged_grads``) against the one-rank ones saved at
    ``ref_path + ".grads"``; then the whole step (norm, AdamW) on
    :data:`P15Q_STEP_MESH` against the one-rank steps saved at
    ``ref_path`` (:func:`_tp_train_vs_saved`)."""
    from repro_torch.distributed.group import make_mesh
    from repro_torch.distributed.sharding import tp_place
    from repro_torch.training import train_loop as tl
    from repro_torch.training.optimizer import AdamWConfig
    _wait_until(lambda: os.path.exists(ref_path + ".done"), 900,
                "15q's one-rank gradients and parameters")
    model = _tp_seamless(P15Q_LAYERS)
    batches = _p15q_batches(model.cfg.d_model)
    mesh = make_mesh((1, 4), ("data", "model"))
    placed = tp_place(_tp_params(model, dev, seed), mesh, cfg=model.cfg)
    step = tl.make_train_step(model, AdamWConfig(**P15Q_OPT), mesh=mesh)
    loss, met, grads = step.averaged_grads(placed,
                                           tl.to_device(batches[0], dev))
    ref = torch.load(ref_path + ".grads", mmap=True, map_location="cpu")
    out = {"loss": float(loss), "grad_norm": float(met["grad_norm"])}
    out["grads_excess_over_grad_tol"], out["grads_max_rel_err"] = \
        _grads_vs_saved(dev, grads, placed, ref, mesh, GRAD_TOL)
    out["grads_peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    del ref, grads, placed
    _free(dev)
    out["step"] = _tp_train_vs_saved(
        dev, seed, model, batches, P15Q_OPT, ref_path, "15q",
        ("encoder", "layers", "0"), shape=P15Q_STEP_MESH)
    return out


def _p15q_one_rank(dev, seed, ref_path):
    """15q's one-rank side: the first batch's gradients, loss and grad
    norm (:func:`_one_rank_grads_saved`, at ``ref_path + ".grads"``), then
    the plain steps (:func:`_one_rank_train_saved`, at ``ref_path``)."""
    model = _tp_seamless(P15Q_LAYERS)
    batches = _p15q_batches(model.cfg.d_model)
    params = _tp_params(model, dev, seed)
    grads = _one_rank_grads_saved(dev, model, params, batches[:1],
                                  ref_path + ".grads")
    return {"grads": grads, "step": _one_rank_train_saved(
        dev, seed, model, batches, P15Q_OPT, ref_path, params=params)}


def _p15ef_ranks(seed, ref_path):
    """15e, 15f, 15p, then 15q, on one rank of four sharing the card over
    gloo (run by ``run_local``); 15q's one-rank step saved at ``ref_path
    + ".q"``."""
    from repro_torch.distributed import group
    torch.backends.cuda.matmul.allow_tf32 = False     # float32 means float32
    dev = group.device()
    out = {}
    for key, fn, args in (("e", _p15e_rank, (seed,)),
                          ("f", _p15f_rank, (seed, ref_path)),
                          ("p", _p15p_rank, (seed,)),
                          ("q", _p15q_rank, (seed, ref_path + ".q"))):
        _free(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        out[key] = fn(dev, *args)
        out[key]["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
        out[key]["seconds"] = time.perf_counter() - t0
    return out


def _p15f_one_rank(dev, seed, ref_path):
    """15f's plain one-rank step on the same global batches: its losses and
    grad norms; its final parameters saved to ``ref_path`` (then
    ``ref_path + ".done"``) for the ranks."""
    from repro_torch.training import train_loop as tl
    from repro_torch.training.optimizer import AdamWConfig, adamw_init
    model = _tp_granite(P15F_LAYERS)
    params = _tp_params(model, dev, seed)
    opt = adamw_init(params)
    step = tl.make_train_step(model, AdamWConfig(**P15F_OPT))
    losses, norms = [], []
    for b in _p15f_batches():
        params, opt, met = step(params, opt, tl.to_device(b, dev))
        losses.append(float(met["loss"]))
        norms.append(float(met["grad_norm"]))
    del opt
    torch.save({k: v.cpu() for k, v in _leaves(params).items()}, ref_path)
    del params
    _free(dev)
    open(ref_path + ".done", "w").close()
    return losses, norms


def phase15ef(dev, seed, card):
    """15e-f: tensor-parallel execution over 'model' on four gloo ranks
    sharing the card (one ``run_local``), every number beside the card's
    name and power limit.

    15e, serving: granite-3-8b at full width and :data:`P15E_LAYERS`
    layers in float32, quantized SQuant w8 over the four ranks' row slabs
    (kernel A), gathered, each rank's tensor-parallel tree cut by
    ``tp_local`` on (data 1, model 4); a prefill of 8 x 256 tokens and 16
    greedy decode steps on the contiguous cache under ``activate_mesh``,
    the one-rank forward's tokens fed to both (rank 0 runs the one-rank
    forward on the whole tree first). Gates: each rank's kernel-B launches
    by local weight shape 7 x L x forwards as the shards imply, kernel A's
    those of 15b's rule, the logits within 1e-4 of the one-rank's largest
    |logit|, every rank's last logits the same; at :data:`P15E_SMALL`
    layers, free-running greedy tokens equal to the one-rank forward's, w8
    and int4 with one scale per 128-group (``_group_scale_tree``, the case
    that cuts a row-parallel leaf's per-group scales), the latter's logits
    within 2e-2. The bfloat16 forward's agreement is reported, not gated.

    15f, training: granite at full width and :data:`P15F_LAYERS` layers in
    float32 on (data 2, model 2), :data:`P15F_STEPS` steps of 4 x 256
    tokens; the plain one-rank step trains here, in this process, while
    the ranks run 15e. Gates: losses and grad norms within 1e-4 relative
    of the one-rank step's, every rank's parameter shards within
    ``STEP_TOL`` of the one-rank parameters' slices.

    15p, the encoder-decoder serving under 'model': seamless-m4t-medium
    at full width and :data:`P15P_LAYERS` + :data:`P15P_LAYERS` of its 12
    + 12 layers in float32, quantized SQuant w8 over the ranks' slabs, on
    (data 1, model 4): 4 of 16 heads of every encoder layer,
    self-attention and cross-attention, 1 024 of 4 096 FFN columns, the
    embedding and head replicated (vocab 256 206), the encoder output and
    the cache's ``enc_out`` whole; random frames encoded, a prefill of
    :data:`P15P_PROMPT`, one 64-token chunk over the cache's encoder
    output and 16 decode steps, w8 float32 and bfloat16, against the
    one-rank forward on rank 0. Gates as 15e's (float32 within 1e-4).

    15q, its train step on (data 1, model 4): :data:`P15Q_STEPS` steps of
    :data:`P15Q_BATCH` tokens over random frames against the plain
    one-rank step trained here first. Gates as 15f's."""
    import tempfile
    import shutil

    t_phase = time.perf_counter()
    work = tempfile.mkdtemp(prefix="chip_smoke_p15f_")
    ref_path = os.path.join(work, "one_rank.pt")

    def here():
        t0 = time.perf_counter()
        plain_f = _p15f_one_rank(dev, seed, ref_path)
        t1 = time.perf_counter()
        plain_q = _p15q_one_rank(dev, seed, ref_path + ".q")
        return plain_f, t1 - t0, plain_q, time.perf_counter() - t1

    try:
        ranks, four_s, (plain, plain_s, plain_q, plain_q_s) = \
            _four_ranks_beside(dev, _p15ef_ranks, (seed, ref_path), here)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return _p15ef_report(ranks, plain, plain_s, card, four_s, t_phase,
                         plain_q, plain_q_s)


def _p15ef_report(ranks, plain, plain_s, card, four_s, t_phase, plain_q,
                  plain_q_s):
    """15e-f's and 15p-q's gates and lines from the four ranks' results
    and the one-rank steps' ``plain`` and ``plain_q`` (losses, grad
    norms) run here in ``plain_s`` and ``plain_q_s``; returns the
    launches and shapes :func:`drive_phase15` reports."""
    plain_losses, plain_norms = plain
    es, fs = [r["e"] for r in ranks], [r["f"] for r in ranks]

    # 15e gates
    buckets = es[0]["buckets"]
    for r in es:
        want_a = _slab_launches(buckets, 4, r["rank"])
        if r["kernel_a"] != want_a:
            raise AssertionError(f"15e: rank {r['rank']} kernel A "
                                 f"{r['kernel_a']}, the slabs imply {want_a}")
    _serve_rows_agree(es, "15e")
    c0 = es[0]["cases"]
    names = list(c0)
    gates = {names[0]: c0[names[0]]["max_abs_err_over_max_logit"] <= 1e-4,
             names[2]: c0[names[2]]["max_abs_err_over_max_logit"] <= 1e-4
             and c0[names[2]]["tokens_equal"],
             names[3]: c0[names[3]]["max_abs_err_over_max_logit"] <= 2e-2
             and c0[names[3]]["tokens_equal"]}

    emit({"phase": "15e tensor-parallel serving, 4 ranks sharing the card "
                   "(gloo), mesh (data 1, model 4), granite-3-8b SQuant w8 "
                   f"at full width, {P15E_LAYERS} layers (w4: "
                   f"{P15E_SMALL}; 4 and 2 before 15g-h came, 2 and 1 "
                   "before 15o came, cut for the script's time limit)",
          "reduced": P15_CUTS["15e"],
          "card": card, "backend": "gloo",
          "ranks": 4, "prompt": list(P15E_PROMPT), "decode_steps": P15E_STEPS,
          "quantize_ms_by_rank": [r["quantize_ms"] for r in es],
          "kernel_a_by_rank": [r["kernel_a"] for r in es],
          "cases": {n: _serve_cell(c0[n]) for n in names},
          "gates": gates, "gate": "float32 logits within 1e-4 of the "
          "one-rank forward's largest |logit| (int4: 2e-2), free-running "
          f"tokens equal at {P15E_SMALL} layers; bfloat16 reported",
          "peak_gb_by_rank": [r["peak_gb"] for r in es],
          "seconds_by_rank": [r["seconds"] for r in es],
          "note": "four CUDA contexts share one card and every all-reduce "
                  "is staged through host memory over gloo: not a speed-up "
                  "over one rank, not an interconnect number"})
    if not all(gates.values()):
        raise AssertionError(f"15e: agreement gates failed: {gates}")

    # 15f gates
    worst_loss = max(abs(a - b) / abs(b) for r in fs
                     for a, b in zip(r["losses"], plain_losses))
    worst_norm = max(abs(a - b) / abs(b) for r in fs
                     for a, b in zip(r["grad_norms"], plain_norms))
    excess = max(r["shards_excess_over_step_tol"] for r in fs)
    split = {k: _percentiles([s[k] for s in fs[0]["split_ms"][1:]])["p50"]
             for k in fs[0]["split_ms"][-1]}
    emit({"phase": "15f tensor-parallel training, 4 ranks sharing the card "
                   "(gloo), mesh (data 2, model 2), granite-3-8b at full "
                   f"width, {P15F_LAYERS} layers, float32",
          "reduced": P15_CUTS["15f"], "card": card,
          "backend": "gloo", "ranks": 4, "steps": P15F_STEPS,
          "global_batch": list(P15F_BATCH), "optimizer": P15F_OPT,
          "losses": fs[0]["losses"], "one_rank_losses": plain_losses,
          "grad_norms": fs[0]["grad_norms"], "one_rank_grad_norms":
          plain_norms, "max_rel_diff_loss": worst_loss,
          "max_rel_diff_grad_norm": worst_norm,
          "shards_max_excess_over_step_tol": excess,
          "step_ms_p50_steps_2_on": _percentiles(fs[0]["step_ms"][1:])["p50"],
          "split_ms_p50_rank0": split,
          "peak_gb_by_rank": [r["peak_gb"] for r in fs],
          "one_rank_seconds": plain_s,
          "seconds_by_rank": [r["seconds"] for r in fs],
          "run_local_seconds": four_s,
          "seconds_since_the_ranks_started": time.perf_counter() - t_phase})
    if not (worst_loss <= 1e-4 and worst_norm <= 1e-4 and excess <= 0):
        raise AssertionError(f"15f: losses {worst_loss}, grad norms "
                             f"{worst_norm}, shards over STEP_TOL by {excess}")
    encdec = _p15pq_report([r["p"] for r in ranks], [r["q"] for r in ranks],
                           plain_q, plain_q_s, card)
    local = _tp_local_shapes(_tp_granite(P15E_LAYERS).cfg, 4)
    return {k: [r["e"]["kernel_a"][k] + r["p"]["kernel_a"][k]
                for r in ranks] for k in ("squant_flip", "squant_scale")} | {
        "dequant_matmul": [sum(c["kernel_b"] for x in (r["e"], r["p"])
                               for c in x["cases"].values()) for r in ranks],
        "plans": es[0]["plans"], "plans_15p": encdec["plans"],
        "local_shapes": sorted(local),
        "encdec_local_shapes": encdec["local_shapes"]}


def _p15pq_report(ps, qs, plain, plain_s, card):
    """15p's and 15q's gates and lines (see :func:`phase15ef`)."""
    for r in ps:
        want_a = _slab_launches(ps[0]["buckets"], 4, r["rank"])
        if r["kernel_a"] != want_a:
            raise AssertionError(f"15p: rank {r['rank']} kernel A "
                                 f"{r['kernel_a']}, the slabs imply {want_a}")
    _serve_rows_agree(ps, "15p")
    c0 = ps[0]["cases"]
    err = c0["w8 float32"]["max_abs_err_over_max_logit"]
    cfg = _tp_seamless(P15P_LAYERS).cfg
    shapes = _encdec_local_shapes(cfg, 4, 1, 1)
    note = ("four CUDA contexts share one card and every collective is "
            "staged through host memory over gloo: agreement and launch "
            "counts, not a speed-up over one rank")
    emit({"phase": "15p the encoder-decoder under tensor-parallel serving, "
                   "4 ranks sharing the card (gloo), mesh (data 1, model 4), "
                   "seamless-m4t-medium SQuant w8 at full width, "
                   f"{P15P_LAYERS} + {P15P_LAYERS} of 12 + 12 layers, "
                   "float32: 4 of 16 heads of every encoder, self- and "
                   "cross-attention layer, 1 024 of 4 096 FFN columns, the "
                   "embedding and head replicated (vocab 256 206), the "
                   "encoder output whole on every rank",
          "reduced": f"seamless 12 + 12 -> {P15P_LAYERS} + {P15P_LAYERS} "
                     f"layers", "card": card, "backend": "gloo", "ranks": 4,
          "prompt": list(P15P_PROMPT), "frames_a_row":
          P15P_PROMPT[1] // cfg.enc_ratio, "chunks": [P15_CHUNK],
          "decode_steps": P15P_STEPS,
          "local_shapes": sorted(f"{m}x{n}" for m, n in shapes),
          "quantize_ms_by_rank": [r["quantize_ms"] for r in ps],
          "kernel_a_by_rank": [r["kernel_a"] for r in ps],
          "cases": {n: _serve_cell(c0[n]) for n in c0},
          "gate": "w8 float32 logits within 1e-4 of the one-rank forward's "
                  "largest |logit|, fed the one-rank tokens; bfloat16 "
                  "reported",
          "peak_gb_by_rank": [r["peak_gb"] for r in ps],
          "seconds_by_rank": [r["seconds"] for r in ps], "note": note})
    if not err <= 1e-4:
        raise AssertionError(f"15p: w8 float32 logits {err} of the largest, "
                             f"over 1e-4")
    (g_losses, g_norms), (q_losses, q_norms) = plain["grads"], plain["step"]
    g_loss = max(abs(r["loss"] - g_losses[0]) / abs(g_losses[0])
                 for r in qs)
    g_norm = max(abs(r["grad_norm"] - g_norms[0]) / abs(g_norms[0])
                 for r in qs)
    g_excess = max(r["grads_excess_over_grad_tol"] for r in qs)
    st = [r["step"] for r in qs]
    loss = max(abs(a - b) / abs(b) for r in st
               for a, b in zip(r["losses"], q_losses))
    norm = max(abs(a - b) / abs(b) for r in st
               for a, b in zip(r["grad_norms"], q_norms))
    excess = max(r["shards_excess_over_step_tol"] for r in st)
    emit({"phase": "15q the encoder-decoder's tensor-parallel train step, 4 "
                   "ranks sharing the card (gloo), seamless-m4t-medium at "
                   f"full width, {P15Q_LAYERS} + {P15Q_LAYERS} layers, "
                   "float32, over random frames: its gradients on (data 1, "
                   "model 4), the whole step (AdamW) on (data "
                   f"{P15Q_STEP_MESH[0]}, model {P15Q_STEP_MESH[1]})",
          "reduced": f"seamless 12 + 12 -> {P15Q_LAYERS} + {P15Q_LAYERS} "
                     f"layers", "card": card, "backend": "gloo", "ranks": 4,
          "steps": P15Q_STEPS, "global_batch": list(P15Q_BATCH),
          "optimizer": P15Q_OPT,
          "model4_loss": qs[0]["loss"], "one_rank_loss": g_losses[0],
          "model4_grad_norm": qs[0]["grad_norm"],
          "one_rank_grad_norm": g_norms[0],
          "model4_max_rel_diff_loss": g_loss,
          "model4_max_rel_diff_grad_norm": g_norm,
          "model4_grads_max_excess_over_grad_tol": g_excess,
          "model4_grads_max_rel_err_by_rank": [r["grads_max_rel_err"]
                                               for r in qs],
          "model4_grads_peak_gb_by_rank": [r["grads_peak_gb"] for r in qs],
          "grad_tol": GRAD_TOL, "step_mesh": list(P15Q_STEP_MESH),
          "losses": st[0]["losses"], "one_rank_losses": q_losses,
          "grad_norms": st[0]["grad_norms"], "one_rank_grad_norms": q_norms,
          "max_rel_diff_loss": loss, "max_rel_diff_grad_norm": norm,
          "shards_max_excess_over_step_tol": excess,
          "local_encoder_layer_step_mesh": st[0]["local_shards"],
          "ms_by_step_rank0": st[0]["step_ms"],
          "split_ms_rank0": st[0]["split_ms"],
          "peak_gb_by_rank": [r["peak_gb"] for r in qs],
          "one_rank_seconds": plain_s,
          "seconds_by_rank": [r["seconds"] for r in qs], "note": note})
    if not (max(g_loss, g_norm, loss, norm) <= 1e-4
            and max(g_excess, excess) <= 0):
        raise AssertionError(f"15q: 'model' 4 loss {g_loss}, norm {g_norm}, "
                             f"gradients over GRAD_TOL by {g_excess}; steps' "
                             f"losses {loss}, norms {norm}, shards over "
                             f"STEP_TOL by {excess}")
    return {"plans": ps[0]["plans"], "local_shapes": sorted(shapes)}


# ---------------------------------------------------------------------------
# phase 15g-h: expert-parallel MoE over 'model' (four gloo ranks sharing
# the card, after 15e-f in the same processes)
# ---------------------------------------------------------------------------

P15G_LAYERS = 1          # 15g's moonshot at full width (of 48)
P15G_SMALL = 1           # 15g's int4 per-group case
P15G_PROMPT = (4, 64)    # 15g's prefill (the vocab-parallel logits of every
                         # position are gathered whole: 4 x 64 x 163 840)
P15G_STEPS = 16          # 15g's greedy decode steps
P15H_LAYERS = 1          # 15h's moonshot at full width (of 48)
P15H_STEPS = 3
P15H_BATCH = (4, 128)
P15H_BINDING_CF = 1.0    # 15h's Part-0 check: capacity = the mean load
P15H_OPT = P15F_OPT


def _ep_moonshot(layers, dtype="float32", cf=None):
    """moonshot-v1-16b-a3b at full width and ``layers`` layers in
    ``dtype`` (``capacity_factor`` ``cf`` where given)."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    cfg = get_config(MOE_ARCH)
    moe = cfg.moe if cf is None else dataclasses.replace(
        cfg.moe, capacity_factor=cf)
    return build_model(dataclasses.replace(cfg, n_layers=layers,
                                           dtype=dtype, moe=moe))


def _ep_local_shapes(cfg, tp):
    """{(M, N): launches a forward} of kernel B on a rank's local shards
    (``tp`` ranks) of an MoE stack: q, k, v, o (heads on replica groups
    where 'model' does not divide them), and each local expert's wi, wg
    and wdown: E / tp whole experts, or, where 'model' does not divide
    the experts (the 'expert_ff' fallback), every expert's d_ff / tp FFN
    columns."""
    from repro_torch.distributed.sharding import expert_ff
    d, f, e = cfg.d_model, cfg.d_ff, cfg.moe.n_experts
    q = _per_rank(cfg.n_heads, cfg.head_dim, tp)
    kv = _per_rank(cfg.n_kv_heads, cfg.head_dim, tp)
    e, f = (e, f // tp) if expert_ff(e, tp) else (e // tp, f)
    out = collections.Counter()
    for (m, n), k in (((q, d), 1), ((kv, d), 2), ((d, q), 1),
                      ((f, d), 2 * e), ((d, f), e)):
        out[(m, n)] += k * cfg.n_layers
    return dict(out)


def _p15g_rank(dev, seed):
    """15g on this rank of four (see :func:`phase15gh`): host numbers."""
    import numpy as np
    import torch.distributed as dist
    from repro_torch.core import pipeline
    from repro_torch.distributed.group import make_mesh
    from repro_torch.distributed.sharding import gather_tree
    from repro_torch.kernels import dequant_matmul as dm
    from repro_torch.launch.mesh import make_quantize_mesh
    dmod, pa, paq, sf = _kernel_modules()
    rank, world = dist.get_rank(), dist.get_world_size()
    out = {"rank": rank}
    model = _ep_moonshot(P15G_LAYERS)
    small = _ep_moonshot(P15G_SMALL)
    params = _tp_params(model, dev, seed)
    g4 = _group_scale_tree(_first_layers(params, P15G_SMALL), 4, 128)
    qmesh = make_quantize_mesh(world)
    _reset_launches(dmod, pa, paq, sf)
    dist.barrier()
    _sync_dev(dev)
    t0 = time.perf_counter()
    sharded, rep = pipeline.quantize_tree(params, method="squant", bits=8,
                                          mesh=qmesh)
    _sync_dev(dev)
    out["quantize_ms"] = (time.perf_counter() - t0) * 1e3
    out["buckets"] = [(b.key, b.num_layers, b.route) for b in rep.buckets]
    out["kernel_a"] = {"squant_flip": sf.launches,
                       "squant_scale": sf.scale_launches}
    whole = gather_tree(sharded)
    del sharded, params
    _free(dev)
    mesh = make_mesh((1, world), ("data", "model"))
    rng = np.random.default_rng(seed)
    prompt = torch.from_numpy(rng.integers(
        0, model.cfg.vocab, size=P15G_PROMPT)).to(dev)
    # (name, model, tree, fed the one-rank tokens)
    cases = (("w8 float32", model, whole, False),
             ("w8 bfloat16", _ep_moonshot(P15G_LAYERS, "bfloat16"),
              _retyped(whole, torch.bfloat16), True),
             (f"w4 per-group scales float32 {P15G_SMALL} layer", small, g4,
              False))
    out["cases"] = {}
    dm._plans.clear()
    for name, m, tree, forced in cases:
        out["cases"][name] = _serve_case_vs_one_rank(
            dev, m, tree, mesh, prompt, (), P15G_STEPS, forced,
            {k: v * (P15G_STEPS + 1) for k, v in
             _ep_local_shapes(m.cfg, world).items()})
    out["plans"] = dm.cached_plans()
    del whole, g4
    _free(dev)
    return out


def _p15h_batches():
    from repro_torch.data.synthetic import markov_batches
    return [b for b, _ in zip(markov_batches(*P15H_BATCH, P15_DATA_VOCAB,
                                             seed=13), range(P15H_STEPS))]


def _p15h_rank(dev, seed, ref_path):
    """15h on this rank of four: first the Part-0 check (the step's
    averaged loss and ``moe_aux`` of the first batch at
    :data:`P15H_BINDING_CF`, routed over both 'data' ranks), then the
    expert-parallel step on (data 2, model 2), its metrics and split, and
    its final shards against the one-rank parameters the script's process
    saved at ``ref_path``."""
    import torch.distributed as dist
    from repro_torch.distributed.group import make_mesh
    from repro_torch.distributed.sharding import shard_index, tp_place
    from repro_torch.training import train_loop as tl
    from repro_torch.training.optimizer import AdamWConfig, adamw_init
    model = _ep_moonshot(P15H_LAYERS)
    mesh = make_mesh((2, 2), ("data", "model"))
    placed = tp_place(_tp_params(model, dev, seed), mesh, cfg=model.cfg)
    _free(dev)
    batches = [tl.to_device(b, dev) for b in _p15h_batches()]
    binding = tl.make_train_step(_ep_moonshot(P15H_LAYERS,
                                              cf=P15H_BINDING_CF),
                                 AdamWConfig(**P15H_OPT), mesh=mesh)
    loss, met, g = binding.averaged_grads(placed, batches[0])
    part0 = {"loss": float(loss), "moe_aux": float(met["moe_aux"])}
    del g, binding
    opt = adamw_init(placed)
    step = tl.make_train_step(model, AdamWConfig(**P15H_OPT), mesh=mesh)
    step.timed = True
    losses, norms, auxes, step_ms, splits = [], [], [], [], []
    dist.barrier()
    for b in batches:
        _sync_dev(dev)
        t0 = time.perf_counter()
        placed, opt, met = step(placed, opt, b)
        losses.append(float(met["loss"]))
        step_ms.append((time.perf_counter() - t0) * 1e3)
        norms.append(float(met["grad_norm"]))
        auxes.append(float(met["moe_aux"]))
        splits.append(dict(step.split_ms))
    del opt
    _free(dev)
    _wait_until(lambda: os.path.exists(ref_path + ".done"), 900,
                "15h's one-rank parameters")
    ref = torch.load(ref_path, mmap=True, map_location="cpu")
    worst = 0.0
    sizes = tuple(mesh.shape)
    for k, t in _leaves(placed).items():
        idx = shard_index(t.shape, t.placements, sizes,
                          mesh.get_coordinate())
        want = ref["params"][k][idx].to(dev)
        rms = float(ref["params"][k].double().square().mean().sqrt())
        excess = ((t.to_local() - want).abs() - STEP_TOL["rtol"] * want.abs()
                  - STEP_TOL["atol_rms"] * rms).max()
        worst = max(worst, float(excess))
    local_bank = tuple(placed["stack"]["list"][0]["b0"]["moe"]["wi"]["w"]
                       .to_local().shape)
    del placed
    _free(dev)
    return {"part0": part0, "losses": losses, "grad_norms": norms,
            "moe_aux": auxes, "step_ms": step_ms, "split_ms": splits,
            "shards_excess_over_step_tol": worst, "local_wi": local_bank,
            "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9}


def _p15gh_ranks(seed, ref_path):
    """15g, then 15h, on one rank of four sharing the card over gloo."""
    from repro_torch.distributed import group
    torch.backends.cuda.matmul.allow_tf32 = False     # float32 means float32
    dev = group.device()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    g = _p15g_rank(dev, seed)
    g["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    g["seconds"] = time.perf_counter() - t0
    _free(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    h = _p15h_rank(dev, seed, ref_path)
    h["seconds"] = time.perf_counter() - t0
    return {"g": g, "h": h}


def _p15h_one_rank(dev, seed, ref_path):
    """15h's plain one-rank step on the same global batches, and the
    Part-0 check's loss and ``moe_aux`` of the first batch at
    :data:`P15H_BINDING_CF` on one rank; the final parameters saved to
    ``ref_path`` (then ``ref_path + ".done"``) for the ranks. Returns the
    losses, grad norms, ``moe_aux`` values and the check's numbers."""
    from repro_torch.training import train_loop as tl
    from repro_torch.training.optimizer import AdamWConfig, adamw_init
    model = _ep_moonshot(P15H_LAYERS)
    params = _tp_params(model, dev, seed)
    batches = [tl.to_device(b, dev) for b in _p15h_batches()]
    binding = _ep_moonshot(P15H_LAYERS, cf=P15H_BINDING_CF)
    loss, met, g = tl._value_and_grad(binding.train_loss, params, batches[0])
    part0 = {"loss": float(loss), "moe_aux": float(met["moe_aux"])}
    del g
    opt = adamw_init(params)
    step = tl.make_train_step(model, AdamWConfig(**P15H_OPT))
    losses, norms, auxes = [], [], []
    for b in batches:
        params, opt, met = step(params, opt, b)
        losses.append(float(met["loss"]))
        norms.append(float(met["grad_norm"]))
        auxes.append(float(met["moe_aux"]))
    del opt
    torch.save({"params": {k: v.cpu() for k, v in _leaves(params).items()}},
               ref_path)
    del params
    _free(dev)
    open(ref_path + ".done", "w").close()
    return {"losses": losses, "grad_norms": norms, "moe_aux": auxes,
            "part0": part0}


def phase15gh(dev, seed, card):
    """15g-h alone (``--expert-parallel``): four gloo ranks sharing the
    card (one ``run_local``) beside 15h's one-rank step here; what
    :func:`phase15bcd` runs after 15e-f in the same processes.

    15g, serving: moonshot-v1-16b-a3b at full width and
    :data:`P15G_LAYERS` layers in float32, quantized SQuant w8 over the
    four ranks' row slabs (kernel A), gathered, each rank's
    expert-parallel tree cut by ``tp_local`` on (data 1, model 4): 16 of
    the 64 experts a rank, the router whole, the vocab-parallel tied
    embedding and head a quarter of the vocabulary; a prefill of 4 x 64
    tokens and 16 greedy decode steps on the contiguous cache under
    ``activate_mesh``, against the one-rank forward (rank 0 runs it on the
    whole tree first). Gates: each rank's kernel-B launches by local
    weight shape as the shards imply (16 experts x 3 banks and 4
    attention projections a layer, each forward), kernel A's those of
    15b's rule, every rank's routes, tokens and last logits the same; in
    float32 every token's experts equal to the one-rank forward's at every
    layer of every forward, the logits within 1e-4 of its largest |logit|
    and the free-running tokens equal (w8, and at :data:`P15G_SMALL` layer
    int4 with one scale per 128-group, the latter's logits within 2e-2).
    The bfloat16 forward (fed the one-rank tokens) is reported, not
    gated.

    15h, training: moonshot at full width and :data:`P15H_LAYERS` layer
    in float32 on (data 2, model 2), :data:`P15H_STEPS` steps of 4 x 128
    tokens; the plain one-rank step trains here, in this process. Gates:
    losses and grad norms within 1e-4 relative of the one-rank step's,
    every rank's parameter shards within ``STEP_TOL`` of the one-rank
    parameters' slices; and the routing check: the step's averaged loss
    and ``moe_aux`` of the first batch at ``capacity_factor``
    :data:`P15H_BINDING_CF` (capacity binds) within 1e-4 relative of one
    rank's on the global batch."""
    import tempfile
    import shutil

    t_phase = time.perf_counter()
    work = tempfile.mkdtemp(prefix="chip_smoke_p15h_")
    ref_path = os.path.join(work, "one_rank.pt")

    def here():
        t0 = time.perf_counter()
        return _p15h_one_rank(dev, seed, ref_path), time.perf_counter() - t0

    try:
        ranks, four_s, (plain, plain_s) = _four_ranks_beside(
            dev, _p15gh_ranks, (seed, ref_path), here)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return _p15gh_report(ranks, plain, plain_s, card, four_s, t_phase)


def _p15gh_report(ranks, plain, plain_s, card, four_s, t_phase):
    """15g-h's gates and lines from the four ranks' results and 15h's
    one-rank results ``plain`` (run here in ``plain_s``); returns the
    launches and shapes :func:`drive_phase15` reports."""
    gs, hs = [r["g"] for r in ranks], [r["h"] for r in ranks]

    # 15g gates
    buckets = gs[0]["buckets"]
    cfg = _ep_moonshot(P15G_LAYERS).cfg
    for r in gs:
        want_a = _slab_launches(buckets, 4, r["rank"], _bank_slices(cfg))
        if r["kernel_a"] != want_a:
            raise AssertionError(f"15g: rank {r['rank']} kernel A "
                                 f"{r['kernel_a']}, the slabs imply {want_a}")
    _serve_rows_agree(gs, "15g")
    c0 = gs[0]["cases"]
    names = list(c0)

    def agrees(row, tol):
        return row["max_abs_err_over_max_logit"] <= tol \
            and row["tokens_equal"] and row["routes_equal"]
    gates = {names[0]: agrees(c0[names[0]], 1e-4),
             names[2]: agrees(c0[names[2]], 2e-2)}

    emit({"phase": "15g expert-parallel serving, 4 ranks sharing the card "
                   "(gloo), mesh (data 1, model 4), moonshot-v1-16b-a3b "
                   f"SQuant w8 at full width, {P15G_LAYERS} of 48 layers "
                   f"(int4 per-group: {P15G_SMALL}), 16 of 64 experts a "
                   "rank, vocab-parallel tied embedding and head",
          "reduced": P15_CUTS["15g"],
          "card": card, "backend": "gloo", "ranks": 4,
          "prompt": list(P15G_PROMPT), "decode_steps": P15G_STEPS,
          "quantize_ms_by_rank": [r["quantize_ms"] for r in gs],
          "kernel_a_by_rank": [r["kernel_a"] for r in gs],
          "cases": {n: _serve_cell(c0[n]) for n in names},
          "gates": gates, "gate": "float32: every token's experts equal to "
          "the one-rank forward's at every layer, logits within 1e-4 of its "
          "largest |logit| (int4 per-group: 2e-2), free-running tokens "
          "equal; bfloat16 (fed the one-rank tokens) reported",
          "peak_gb_by_rank": [r["peak_gb"] for r in gs],
          "seconds_by_rank": [r["seconds"] for r in gs],
          "note": "four CUDA contexts share one card and every collective "
                  "is staged through host memory over gloo: not an "
                  "expert-parallel speed, not an interconnect number"})
    if not all(gates.values()):
        raise AssertionError(f"15g: agreement gates failed: {gates}")

    # 15h gates
    worst_loss = max(abs(a - b) / abs(b) for r in hs
                     for a, b in zip(r["losses"], plain["losses"]))
    worst_norm = max(abs(a - b) / abs(b) for r in hs
                     for a, b in zip(r["grad_norms"], plain["grad_norms"]))
    excess = max(r["shards_excess_over_step_tol"] for r in hs)
    p0 = plain["part0"]
    part0 = max(abs(r["part0"][k] - p0[k]) / abs(p0[k]) for r in hs
                for k in ("loss", "moe_aux"))
    split = {k: _percentiles([s[k] for s in hs[0]["split_ms"][1:]])["p50"]
             for k in hs[0]["split_ms"][-1]}
    emit({"phase": "15h expert-parallel training, 4 ranks sharing the card "
                   "(gloo), mesh (data 2, model 2), moonshot-v1-16b-a3b at "
                   f"full width, {P15H_LAYERS} of 48 layers, float32, 32 of "
                   "64 experts a rank", "card": card,
          "backend": "gloo", "ranks": 4, "steps": P15H_STEPS,
          "global_batch": list(P15H_BATCH), "optimizer": P15H_OPT,
          "losses": hs[0]["losses"], "one_rank_losses": plain["losses"],
          "grad_norms": hs[0]["grad_norms"],
          "one_rank_grad_norms": plain["grad_norms"],
          "moe_aux": hs[0]["moe_aux"], "one_rank_moe_aux": plain["moe_aux"],
          "max_rel_diff_loss": worst_loss,
          "max_rel_diff_grad_norm": worst_norm,
          "shards_max_excess_over_step_tol": excess,
          "routing_check": {"capacity_factor": P15H_BINDING_CF,
                            "one_rank": p0, "rank0": hs[0]["part0"],
                            "max_rel_diff": part0, "gate": 1e-4},
          "local_wi_shard": hs[0]["local_wi"],
          "step_ms_p50_steps_2_on": _percentiles(hs[0]["step_ms"][1:])["p50"],
          "split_ms_p50_rank0": split,
          "peak_gb_by_rank": [r["peak_gb"] for r in hs],
          "one_rank_seconds": plain_s,
          "seconds_by_rank": [r["seconds"] for r in hs],
          "run_local_seconds": four_s,
          "seconds_since_the_ranks_started": time.perf_counter() - t_phase})
    if not (worst_loss <= 1e-4 and worst_norm <= 1e-4 and excess <= 0
            and part0 <= 1e-4):
        raise AssertionError(f"15h: losses {worst_loss}, grad norms "
                             f"{worst_norm}, shards over STEP_TOL by "
                             f"{excess}, routing check {part0}")
    return {"squant_flip": [r["kernel_a"]["squant_flip"] for r in gs],
            "squant_scale": [r["kernel_a"]["squant_scale"] for r in gs],
            "dequant_matmul": [sum(c["kernel_b"] for c in r["cases"].values())
                               for r in gs],
            "plans": gs[0]["plans"],
            "local_shapes": sorted(_ep_local_shapes(cfg, 4)),
            "capacity_rows": math.ceil(
                P15G_PROMPT[0] * P15G_PROMPT[1] * cfg.moe.top_k
                * cfg.moe.capacity_factor / cfg.moe.n_experts)}


# ---------------------------------------------------------------------------
# phase 15i-k: MLA and the sliding-window ring under tensor-parallel
# execution over 'model' (four gloo ranks sharing the card, after 15g-h in
# the same processes)
# ---------------------------------------------------------------------------

P15I_LAYERS = 1          # 15i's minicpm3 at full width (of 62)
P15I_SMALL = 1           # 15i's int4 case and its free-running tokens
P15I_PROMPT = (8, 256)   # 15i's prefill
P15I_CHUNKS = 1          # 15i's 64-token chunks after the prefill
P15I_STEPS = 16          # 15i's greedy decode steps
P15J_LAYERS = 1          # 15j's mixtral at full width (of 32)
P15J_PROMPT = (1, 4096)  # 15j's prefill: fills the 4096-slot ring
P15J_CHUNKS = 2          # 15j's 64-token chunks: the ring's continuation
P15J_STEPS = 16          # 15j's greedy decode steps
P15K_LAYERS = 1          # 15k's minicpm3 at full width (of 62)
P15K_STEPS = 5
P15K_BATCH = (4, 256)
P15K_OPT = P15F_OPT
P15_CHUNK = 64


def _tp_minicpm3(layers, dtype="float32", absorb=False):
    """minicpm3-4b at full width and ``layers`` layers in ``dtype``, the
    absorbed decode where ``absorb``."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    cfg = get_config(MLA_ARCH)
    return build_model(dataclasses.replace(
        cfg, n_layers=layers, dtype=dtype,
        mla=dataclasses.replace(cfg.mla, absorb=absorb)))


def _tp_mixtral(layers, dtype="float32"):
    """mixtral-8x7b at full width and ``layers`` layers in ``dtype``."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    return build_model(dataclasses.replace(get_config(SWA_ARCH),
                                           n_layers=layers, dtype=dtype))


def _mla_local_shapes(cfg, tp, forwards, decodes):
    """{(M, N): launches} of kernel B on a rank's local MLA shards (``tp``
    ranks) over ``forwards`` forwards of which ``decodes`` are decode
    steps: q_down, q_up, kv_down, kv_up, wo, wi, wg and wdown each layer
    of each forward, but no ``kv_up`` at an absorbed decode step (its
    products there are torch ops)."""
    m, d, h = cfg.mla, cfg.d_model, cfg.n_heads
    f = _per_rank(cfg.d_ff, 1, tp)
    out = collections.Counter()
    kv_up = (_per_rank(h, m.nope_dim + m.v_dim, tp), m.kv_lora)
    for mn in ((m.q_lora // tp, d),
               (_per_rank(h, m.nope_dim + m.rope_dim, tp), m.q_lora),
               ((m.kv_lora + m.rope_dim) // tp, d), kv_up,
               (d, _per_rank(h, m.v_dim, tp)), (f, d), (f, d), (d, f)):
        out[mn] += cfg.n_layers * forwards
    if m.absorb:
        out[kv_up] -= cfg.n_layers * decodes
    return dict(out)


def _swa_local_shapes(cfg, tp, forwards):
    """{(M, N): launches} of kernel B on a rank's local mixtral shards
    over ``forwards`` forwards: q, k, v, o and each local expert's wi, wg
    and wdown (:func:`_ep_local_shapes`); the tied head is the local
    embedding's ``torch.matmul``."""
    return {k: v * forwards for k, v in _ep_local_shapes(cfg, tp).items()}


def _serve_cell(row):
    """A serving case's line: agreement, times and kernel B's launches."""
    steps = row["step_ms"][1:]              # the first step pays start-up
    coll = row["collective_ms"][1:]
    return {"max_abs_err_over_max_logit":
            row.get("max_abs_err_over_max_logit"),
            "tokens_equal": row.get("tokens_equal"),
            "tokens_agree": row.get("tokens_agree"),
            "routes_equal": row.get("routes_equal"),
            "routes_agree": row.get("routes_agree"),
            "routings": row["routings"],
            "prefill_ms": row["prefill_ms"], "chunk_ms": row["chunk_ms"],
            "decode_step_ms_p50": _percentiles(steps)["p50"],
            "collectives_ms_p50": _percentiles(coll)["p50"],
            "compute_ms_p50": _percentiles(
                [s - c for s, c in zip(steps, coll)])["p50"],
            "one_rank_prefill_ms": row.get("one_rank_prefill_ms"),
            "one_rank_chunk_ms": row.get("one_rank_chunk_ms"),
            "one_rank_decode_step_ms_p50": _percentiles(
                row["one_rank_step_ms"][1:])["p50"]
            if "one_rank_step_ms" in row else None,
            "model_collectives": row["model_collectives"],
            "kernel_b_by_variant": row["launches_by_variant"],
            "kernel_b_by_local_weight_shape": row["launches_by_weight_shape"]}


def _serve_rows_agree(rows, label):
    """Every rank's kernel-B launches as the shards imply, and every rank
    the same logits, routes and tokens as rank 0 (``rows``: by rank)."""
    for r in rows:
        for name, row in r["cases"].items():
            if row["launches_by_weight_shape"] != row["want_by_weight_shape"]:
                raise AssertionError(
                    f"{label} {name}: rank {r['rank']} kernel B by shape "
                    f"{row['launches_by_weight_shape']}, the shards imply "
                    f"{row['want_by_weight_shape']}")
            for key in ("last_logits_digest", "routes_digest",
                        "tokens_digest"):
                if row[key] != rows[0]["cases"][name][key]:
                    raise AssertionError(f"{label} {name}: the ranks' {key} "
                                         f"differ")


def _quantized_on_slabs(params, bits, qmesh, dev):
    """``params`` quantized SQuant ``bits`` over ``qmesh``'s ranks' row
    slabs (kernel A on this rank's), gathered whole: (tree, buckets,
    kernel A's and the scale pass's launches)."""
    from repro_torch.core import pipeline
    from repro_torch.distributed.sharding import gather_tree
    dmod, pa, paq, sf = _kernel_modules()
    _reset_launches(dmod, pa, paq, sf)
    sharded, rep = pipeline.quantize_tree(params, method="squant", bits=bits,
                                          mesh=qmesh)
    _sync_dev(dev)
    launches = {"squant_flip": sf.launches, "squant_scale": sf.scale_launches}
    return (gather_tree(sharded),
            [(b.key, b.num_layers, b.route) for b in rep.buckets], launches)


def _p15i_rank(dev, seed):
    """15i on this rank of four (see :func:`phase15ijk`): host numbers."""
    import numpy as np
    import torch.distributed as dist
    from repro_torch.distributed.group import make_mesh
    from repro_torch.kernels import dequant_matmul as dm
    from repro_torch.launch.mesh import make_quantize_mesh
    rank, world = dist.get_rank(), dist.get_world_size()
    out = {"rank": rank}
    model = _tp_minicpm3(P15I_LAYERS)
    params = _tp_params(model, dev, seed)
    qmesh = make_quantize_mesh(world)
    dist.barrier()
    t0 = time.perf_counter()
    whole, out["buckets"], out["kernel_a"] = _quantized_on_slabs(
        params, 8, qmesh, dev)
    out["quantize_ms"] = (time.perf_counter() - t0) * 1e3
    w4, out["buckets_w4"], out["kernel_a_w4"] = _quantized_on_slabs(
        _first_layers(params, P15I_SMALL), 4, qmesh, dev)
    del params
    _free(dev)
    mesh = make_mesh((1, world), ("data", "model"))
    rng = np.random.default_rng(seed)
    vocab = model.cfg.vocab
    prompt = torch.from_numpy(rng.integers(0, vocab, size=P15I_PROMPT)
                              ).to(dev)
    chunks = [torch.from_numpy(rng.integers(
        0, vocab, size=(P15I_PROMPT[0], P15_CHUNK))).to(dev)
        for _ in range(P15I_CHUNKS)]
    forwards = 1 + P15I_CHUNKS + P15I_STEPS
    # (name, model, tree, fed the one-rank tokens)
    cases = (("w8 float32", model, whole, True),
             ("w8 float32 absorbed", _tp_minicpm3(P15I_LAYERS, absorb=True),
              whole, True),
             ("w8 bfloat16", _tp_minicpm3(P15I_LAYERS, "bfloat16"),
              _retyped(whole, torch.bfloat16), True),
             (f"w4 float32 {P15I_SMALL} layer",
              _tp_minicpm3(P15I_SMALL), w4, False))
    out["cases"] = {}
    dm._plans.clear()
    for name, m, tree, forced in cases:
        out["cases"][name] = _serve_case_vs_one_rank(
            dev, m, tree, mesh, prompt, chunks, P15I_STEPS, forced,
            _mla_local_shapes(m.cfg, world, forwards, P15I_STEPS))
    out["plans"] = dm.cached_plans()
    del whole, w4
    _free(dev)
    return out


def _block_generator(dev, seed, *key):
    """A generator on ``dev`` seeded from ``seed`` and the integers of
    ``key`` (a leaf's index in tree order, a block's): the random values
    of one block of one leaf, the same on every rank that makes it."""
    gen = torch.Generator(device=dev)
    h = seed
    for k in key:
        h = (h * 1_000_003 + k + 1) % (2 ** 62)
    gen.manual_seed(h)
    return gen


def _mamba_vectors(gen, cfg, dev):
    """A mamba mixer's conv, dt bias, A and D as ``init_mamba`` makes them
    (its four projections left out)."""
    mc, f32 = cfg.mamba, dict(dtype=torch.float32, device=dev)
    d_inner = mc.expand * cfg.d_model
    a = torch.arange(1, mc.d_state + 1, **f32)[None].repeat(d_inner, 1)
    lo, hi = math.log(1e-3), math.log(1e-1)
    u = torch.rand((d_inner,), generator=gen, **f32) * (hi - lo) + lo
    return {"conv_w": torch.randn((mc.d_conv, d_inner), generator=gen,
                                  **f32).mul_(1.0 / math.sqrt(mc.d_conv)),
            "conv_b": torch.zeros((d_inner,), **f32),
            "dt_bias": torch.log(torch.expm1(torch.exp(u))),
            "a_log": torch.log(a), "d_skip": torch.ones((d_inner,), **f32)}


def _slab_quantized(dev, shape, bits, qmesh, make_piece):
    """A quantizable leaf of ``shape`` ((in, out) or (experts, in, out))
    quantized SQuant ``bits`` with only this rank's row slab made: the
    slab's rows of the pipeline's ``(E·out, in)`` view split as
    ``core.dispatch.quantize_codes_sharded`` splits them (its pieces,
    ``slab_pieces``), each piece made by ``make_piece(i, b0, b1, c0, n)``
    (float32, the stored layout of experts ``b0 .. b1 - 1``' columns ``c0
    .. c0 + n - 1``) and quantized alone by ``quantize_tree`` (kernel A:
    a flip and a scale pass a piece; output channels are independent, so
    the codes are the whole leaf's rows), then all-gathered over
    ``qmesh``. Returns (the whole ``QuantizedTensor``, the leaf's bucket
    as ``quantize_tree(mesh=)`` would report it, kernel A's launches and
    the scale pass's)."""
    from repro_torch.core import pipeline
    from repro_torch.core.dispatch import shard_rows, slab_pieces
    from repro_torch.distributed import group as dgroup
    from repro_torch.quant.qtypes import QuantizedTensor
    dmod, pa, paq, sf = _kernel_modules()
    inn, out = shape[-2], shape[-1]
    rows = out * (shape[0] if len(shape) == 3 else 1)
    ndev = qmesh.shape[0]
    d = qmesh.get_local_rank("data")
    slabs = shard_rows(rows, ndev)
    per = sum(slabs[0])
    r0 = min(d * per, rows)
    codes, scales, route, key = [], [], None, None
    _reset_launches(dmod, pa, paq, sf)
    for i, (b0, b1, c0, n) in enumerate(slab_pieces(r0, r0 + slabs[d][0],
                                                    out)):
        w = make_piece(i, b0, b1, c0, n)
        if len(shape) == 2:
            w = w[0]
        q, rep = pipeline.quantize_tree({"w": w}, method="squant", bits=bits,
                                        device=dev)
        del w
        codes.append(q["w"].data.reshape(-1, q["w"].data.shape[-1]))
        scales.append(q["w"].scale.reshape(-1, 1).to(torch.float32))
        key, route = rep.buckets[0].key, rep.buckets[0].route
    _sync_dev(dev)
    launches = {"squant_flip": sf.launches, "squant_scale": sf.scale_launches}
    cols = (inn + 1) // 2 if bits <= 4 else inn
    if slabs[d][1]:
        codes.append(torch.zeros((slabs[d][1], cols), dtype=torch.int8,
                                 device=dev))
        scales.append(torch.zeros((slabs[d][1], 1), dtype=torch.float32,
                                  device=dev))
    all_c = torch.empty((ndev * per, cols), dtype=torch.int8, device=dev)
    all_s = torch.empty((ndev * per, 1), dtype=torch.float32, device=dev)
    group = qmesh.get_group("data")
    dgroup.all_gather_into(all_c, torch.cat(codes), group)
    dgroup.all_gather_into(all_s, torch.cat(scales), group)
    del codes, scales
    qt = QuantizedTensor(data=all_c[:rows].contiguous(),
                         scale=all_s[:rows].contiguous(), bits=bits,
                         group_size=None, shape=(rows, inn))
    # the whole leaf's bucket key (a rank whose slab holds no row reports
    # none; rank 0's always holds some)
    tail = key.split(")x", 1)[1] if key else ""
    return qt, (f"({rows},{inn})x{tail}", 1, route), launches


def _leafwise_tp(dev, model, seed, qmesh, mesh, keep_whole, bits=8):
    """``model``'s tree made on the card one leaf at a time, each rank
    making only what it quantizes or keeps, from per-block seeds
    (:func:`_block_generator`: the leaf's index in tree order and the
    block's, so every rank that makes a block makes the same values): a
    quantizable leaf's row slab of ``qmesh``'s ranks, quantized SQuant
    ``bits`` there (kernel A, :func:`_slab_quantized`) and gathered whole
    as codes (int8), then cut to this rank's ``tp_local`` shard (``cfg``:
    replica groups where 'model' does not divide the heads or FFN
    columns); the embedding in blocks of ``ceil(vocab / ranks)`` rows, of
    which a vocab-parallel rank makes its own and a replicated one all;
    norms as ``LM.init`` makes them, each router as ``init_moe`` does, each
    mamba mixer's conv, dt bias, A and D as ``init_mamba`` does. A dense
    kernel or an expert bank is ``_init_dense``'s std over its slab; the
    float32 leaf never exists whole on a rank. ``mesh``'s 'model' axis
    spans ``qmesh``'s ranks. Returns (this rank's local tree, the whole
    quantized tree where ``keep_whole`` else None: rank 0's one-rank
    reference, made from the same blocks, kernel A's buckets, its launches
    and the scale pass's)."""
    from repro_torch.core.pipeline import _flatten, _rebuild, is_quantizable
    from repro_torch.distributed.sharding import (activate_mesh, tp_local,
                                                  vocab_parallel)
    from repro_torch.models.layers import _init_dense, init_norm
    cfg = model.cfg
    ndev = qmesh.shape[0]
    if mesh.shape[mesh.mesh_dim_names.index("model")] != ndev:
        raise ValueError("_leafwise_tp: 'model' must span the quantize mesh")
    k = mesh.get_local_rank("model")
    meta = model.init(None, device="meta")
    local, whole, buckets, mixers = [], [], [], {}
    launches = {"squant_flip": 0, "squant_scale": 0}
    for li, (path, m) in enumerate(_flatten(meta)):
        shape = tuple(m.shape)
        if is_quantizable(path, m):
            std = 1.0 / math.sqrt(shape[-2])

            def piece(i, b0, b1, c0, n, li=li, shape=shape, std=std):
                g = _block_generator(dev, seed, li, k, i)
                return torch.randn((b1 - b0, shape[-2], n), generator=g,
                                   dtype=m.dtype, device=dev).mul_(std)
            leaf, bk, n = _slab_quantized(dev, shape, bits, qmesh, piece)
            buckets.append(bk)
            for key in launches:
                launches[key] += n[key]
        elif path[-1] == "gain":
            leaf = init_norm(shape[0], plus_one=cfg.norm_plus_one,
                             device=dev)["gain"]
        elif path == ("embedding", "embedding"):
            per = -(-shape[0] // ndev)
            with activate_mesh(mesh):
                mine_only = vocab_parallel(shape[0]) and not keep_whole
            blocks = [k] if mine_only else range(ndev)
            leaf = torch.cat([torch.randn(
                (min(per, shape[0] - j * per), shape[1]),
                generator=_block_generator(dev, seed, li, j), dtype=m.dtype,
                device=dev).mul_(0.02) for j in blocks])
        elif "router" in path:
            leaf = _init_dense(_block_generator(dev, seed, li), shape[0],
                               shape[1], scale=0.02, device=dev)["w"]
        elif "mixer" in path:
            if path[:-1] not in mixers:
                mixers = {path[:-1]: _mamba_vectors(
                    _block_generator(dev, seed, li), cfg, dev)}
            leaf = mixers[path[:-1]][path[-1]]
        else:
            raise ValueError(f"no rule makes the leaf {path} {shape}")
        if path == ("embedding", "embedding") and leaf.shape[0] != shape[0]:
            cut = leaf                       # this rank's vocabulary rows
        else:
            cut = leaf
            for key in reversed(path):
                cut = {key: cut}
            cut = tp_local(cut, mesh, cfg=cfg)
            for key in path:
                cut = cut[key]
        local.append(cut)
        if keep_whole:
            whole.append(leaf)
        del leaf, cut
        _free(dev)
    del mixers
    return (_rebuild(meta, iter(local)),
            _rebuild(meta, iter(whole)) if keep_whole else None,
            buckets, launches)


def _p15j_rank(dev, seed):
    """15j on this rank of four (see :func:`phase15ijk`): host numbers."""
    import numpy as np
    import torch.distributed as dist
    from repro_torch.distributed.group import make_mesh
    from repro_torch.kernels import dequant_matmul as dm
    from repro_torch.launch.mesh import make_quantize_mesh
    rank, world = dist.get_rank(), dist.get_world_size()
    out = {"rank": rank}
    model = _tp_mixtral(P15J_LAYERS)
    mesh = make_mesh((1, world), ("data", "model"))
    qmesh = make_quantize_mesh(world)
    torch.cuda.reset_peak_memory_stats(dev)
    dist.barrier()
    t0 = time.perf_counter()
    local, whole, out["buckets"], out["kernel_a"] = _leafwise_tp(
        dev, model, seed, qmesh, mesh, keep_whole=rank == 0)
    _sync_dev(dev)
    out["build_and_quantize_ms"] = (time.perf_counter() - t0) * 1e3
    out["build_peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    out["local_gb"] = _tree_bytes(local) / 1e9
    rng = np.random.default_rng(seed)
    vocab = model.cfg.vocab
    prompt = torch.from_numpy(rng.integers(0, vocab, size=P15J_PROMPT)
                              ).to(dev)
    chunks = [torch.from_numpy(rng.integers(
        0, vocab, size=(P15J_PROMPT[0], P15_CHUNK))).to(dev)
        for _ in range(P15J_CHUNKS)]
    forwards = 1 + P15J_CHUNKS + P15J_STEPS
    dm._plans.clear()
    # the one-rank forward on rank 0's whole tree; every rank's on the
    # shards cut as the leaves were made
    out["cases"] = {"w8 float32": _serve_case_vs_one_rank(
        dev, model, whole, mesh, prompt, chunks, P15J_STEPS, True,
        _swa_local_shapes(model.cfg, world, forwards), local=local)}
    out["plans"] = dm.cached_plans()
    out["ring_slots"] = min(P15J_PROMPT[1] + P15_CHUNK * P15J_CHUNKS
                            + P15J_STEPS + 1, model.cfg.window)
    del local, whole
    _free(dev)
    return out


def _markov(batch, steps, seed):
    from repro_torch.data.synthetic import markov_batches
    return [b for b, _ in zip(markov_batches(*batch, P15_DATA_VOCAB,
                                             seed=seed), range(steps))]


def _p15k_batches():
    return _markov(P15K_BATCH, P15K_STEPS, 17)


def _blockwise_fp(dev, model, seed, tp, mesh=None):
    """``model``'s float32 tree made from per-block seeds
    (:func:`_block_generator`): a leaf that 'model' cuts on a (data 1,
    model ``tp``) mesh (``make_tp_shardings`` with the config) is ``tp``
    blocks along the cut dim, every other leaf one block; kernels at
    ``_init_dense``'s std, the embedding and an untied head at 0.02, norms
    as ``init_norm`` makes them. With ``mesh`` (a ``DeviceMesh`` of that
    shape): this rank's ``tp_place`` tree of DTensors, each rank making only
    its blocks; without: the whole tree (the one-rank reference), the same
    values."""
    from torch.distributed.tensor import DTensor
    from repro_torch.core.pipeline import _flatten, _rebuild
    from repro_torch.distributed.sharding import (AbstractMesh, MeshSharding,
                                                  _get_path,
                                                  make_tp_shardings)
    from repro_torch.models.layers import init_norm
    cfg = model.cfg
    meta = model.init(None, device="meta")
    specs = make_tp_shardings(AbstractMesh((1, tp), ("data", "model")), meta,
                              cfg)
    mine = None if mesh is None else mesh.get_local_rank("model")
    leaves = []
    for li, (path, m) in enumerate(_flatten(meta)):
        shape, spec = tuple(m.shape), _get_path(specs, path).spec
        if path[-1] == "gain":
            leaf = init_norm(shape[0], plus_one=cfg.norm_plus_one,
                             device=dev)["gain"]
        elif path[-1] in ("w", "embedding"):
            std = 0.02 if path[0] in ("embedding", "lm_head") else \
                1.0 / math.sqrt(shape[-2])
            d = spec.index("model") if "model" in spec else None
            part = shape if d is None else \
                shape[:d] + (shape[d] // tp,) + shape[d + 1:]
            blocks = [0] if d is None else range(tp) if mine is None \
                else [mine]
            leaf = torch.cat([torch.randn(
                part, generator=_block_generator(dev, seed, li, j),
                dtype=m.dtype, device=dev).mul_(std) for j in blocks],
                dim=d or 0)
        else:
            raise ValueError(f"no rule makes the leaf {path} {shape}")
        if mesh is not None:
            leaf = DTensor.from_local(
                leaf, mesh, MeshSharding(mesh, spec).placements,
                run_check=False, shape=shape,
                stride=torch.empty(shape, device="meta").stride())
        leaves.append(leaf)
    return _rebuild(meta, iter(leaves))


def _tp_train_vs_saved(dev, seed, model, batches, opt_cfg, ref_path, what,
                       node, shape=(2, 2), placed=None):
    """A tensor-parallel train step on a (data, model) mesh of ``shape``
    on this rank (15k and 15n: (data 2, model 2) of four; 15o (v) and
    (vii): (data 1, model 16); 15q: (data 1, model 4)) from ``placed``
    (default: ``tp_place`` of the seed's ``LM.init``): its metrics and
    split over ``batches``, and its final shards against the one-rank
    parameters the script's process saved at ``ref_path``
    (:func:`_one_rank_train_saved`); the local shapes of the leaves under
    ``node`` (a path into the tree)."""
    import torch.distributed as dist
    from repro_torch.distributed.group import make_mesh
    from repro_torch.distributed.sharding import shard_index, tp_place
    from repro_torch.training import train_loop as tl
    from repro_torch.training.optimizer import AdamWConfig, adamw_init
    if placed is None:
        mesh = make_mesh(shape, ("data", "model"))
        placed = tp_place(_tp_params(model, dev, seed), mesh, cfg=model.cfg)
    else:
        mesh = next(iter(_leaves(placed).values())).device_mesh
    _free(dev)
    opt = adamw_init(placed)
    step = tl.make_train_step(model, AdamWConfig(**opt_cfg), mesh=mesh)
    step.timed = True
    losses, norms, step_ms, splits = [], [], [], []
    dist.barrier()
    for b in batches:
        b = tl.to_device(b, dev)
        _sync_dev(dev)
        t0 = time.perf_counter()
        placed, opt, met = step(placed, opt, b)
        losses.append(float(met["loss"]))
        step_ms.append((time.perf_counter() - t0) * 1e3)
        norms.append(float(met["grad_norm"]))
        splits.append(dict(step.split_ms))
    del opt
    _free(dev)
    _wait_until(lambda: os.path.exists(ref_path + ".done"), 900,
                f"{what}'s one-rank parameters")
    ref = torch.load(ref_path, mmap=True, map_location="cpu")
    worst = 0.0
    sizes = tuple(mesh.shape)
    for k, t in _leaves(placed).items():
        idx = shard_index(t.shape, t.placements, sizes,
                          mesh.get_coordinate())
        want = ref["params"][k][idx].to(dev)
        excess = ((t.to_local() - want).abs() - STEP_TOL["rtol"] * want.abs()
                  - STEP_TOL["atol_rms"] * ref["rms"][k]).max()
        worst = max(worst, float(excess))
        del want
    del ref
    sub = placed
    for k in node:
        sub = sub[int(k)] if isinstance(sub, list) else sub[k]
    local = {k: tuple(t.to_local().shape) for k, t in _leaves(sub).items()}
    del placed, sub
    _free(dev)
    return {"losses": losses, "grad_norms": norms, "step_ms": step_ms,
            "split_ms": splits, "shards_excess_over_step_tol": worst,
            "local_shards": local,
            "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9}


def _p15k_rank(dev, seed, ref_path):
    """15k on this rank of four: the tensor-parallel MLA step."""
    return _tp_train_vs_saved(dev, seed, _tp_minicpm3(P15K_LAYERS),
                              _p15k_batches(), P15K_OPT, ref_path, "15k",
                              ("stack", "list", "0", "b0", "attn"))


def _one_rank_train_saved(dev, seed, model, batches, opt_cfg, ref_path,
                          params=None):
    """The plain one-rank step on the same global batches as
    :func:`_tp_train_vs_saved`'s, from ``params`` (default: the seed's
    ``LM.init``): its losses and grad norms; its final parameters and each
    leaf's root mean square saved to ``ref_path`` (then ``ref_path +
    ".done"``) for the ranks."""
    from repro_torch.training import train_loop as tl
    from repro_torch.training.optimizer import AdamWConfig, adamw_init
    if params is None:
        params = _tp_params(model, dev, seed)
    opt = adamw_init(params)
    step = tl.make_train_step(model, AdamWConfig(**opt_cfg))
    losses, norms = [], []
    for b in batches:
        params, opt, met = step(params, opt, tl.to_device(b, dev))
        losses.append(float(met["loss"]))
        norms.append(float(met["grad_norm"]))
    del opt
    flat = _leaves(params)
    torch.save({"params": {k: v.cpu() for k, v in flat.items()},
                "rms": {k: float(v.double().square().mean().sqrt())
                        for k, v in flat.items()}}, ref_path)
    del params, flat
    _free(dev)
    open(ref_path + ".done", "w").close()
    return losses, norms


def _p15k_one_rank(dev, seed, ref_path):
    """15k's plain one-rank step (:func:`_one_rank_train_saved`)."""
    return _one_rank_train_saved(dev, seed, _tp_minicpm3(P15K_LAYERS),
                                 _p15k_batches(), P15K_OPT, ref_path)


def _p15ijk_ranks(seed, ref_path):
    """15i, 15j, then 15k, on one rank of four sharing the card over gloo
    (run by ``run_local``)."""
    from repro_torch.distributed import group
    torch.backends.cuda.matmul.allow_tf32 = False     # float32 means float32
    dev = group.device()
    out = {}
    for key, fn, args in (("i", _p15i_rank, (dev, seed)),
                          ("j", _p15j_rank, (dev, seed)),
                          ("k", _p15k_rank, (dev, seed, ref_path))):
        _free(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        out[key] = fn(*args)
        out[key].setdefault("peak_gb",
                            torch.cuda.max_memory_allocated(dev) / 1e9)
        out[key]["seconds"] = time.perf_counter() - t0
    return out


def phase15ijk(dev, seed, card):
    """15i-k alone (``--mla-ring-parallel``): four gloo ranks sharing the
    card (one ``run_local``) beside 15k's one-rank step here; what
    :func:`phase15bcd` runs after 15g-h in the same processes.

    15i, MLA serving: minicpm3-4b at full width and :data:`P15I_LAYERS`
    layers in float32, quantized SQuant w8 over the four ranks' row slabs
    (kernel A), gathered, each rank's tree cut by ``tp_local`` on (data 1,
    model 4): 10 of the 40 heads a rank (``q_up`` / ``kv_up`` columns,
    ``wo`` rows), the latent down-projections cut on their outputs and
    gathered whole in the forward, the compressed cache whole, the
    vocab-parallel tied embedding and head a quarter of the vocabulary; a
    prefill of 8 x 256 tokens, one 64-token chunk and 16 greedy decode
    steps under ``activate_mesh`` against the one-rank forward (rank 0 on
    the whole tree first, its decode tokens fed to both): w8, the absorbed
    decode, bfloat16, and at :data:`P15I_SMALL` layer SQuant int4
    (per-channel scales: a 128-group cut of ``wdown``'s 1 600 local input
    columns would split a group) free-running. Gates: each rank's kernel-B
    launches by local weight shape as the shards imply, kernel A's those
    of 15b's rule, every rank's logits and tokens the same; float32
    logits within 1e-4 of the one-rank forward's largest |logit| (w8,
    absorbed, int4) and int4's free-running tokens equal. bfloat16 is
    reported.

    15j, the ring with experts over 'model': mixtral-8x7b at full width
    and :data:`P15J_LAYERS` layer in float32, made and quantized one leaf
    at a time on the ranks' slabs (:func:`_leafwise_tp`: no rank holds
    the float32 tree), each rank keeping its shards (2 of 8 experts, 8 of
    32 q heads, 2 of 8 KV heads, 8 000 of the 32 000 vocabulary rows),
    rank 0 the whole tree for the one-rank forward; a prefill of 1 x 4 096
    that fills the 4 096-slot ring, two 64-token chunks past the window
    (the ring's continuation, wrapped) and 16 decode steps, fed the
    one-rank tokens. Gates: kernel B by local weight shape, kernel A by
    the slabs' pieces at expert slices, every rank the same; logits within
    1e-4 of the largest |logit| and every routing's expert picks equal.

    15k, MLA training: minicpm3 at :data:`P15K_LAYERS` layers in float32
    on (data 2, model 2), :data:`P15K_STEPS` steps of 4 x 256 tokens
    beside the plain one-rank step here. Gates: losses and grad norms
    within 1e-4 relative, every rank's shards within ``STEP_TOL``.
    mixtral's step is held on the CPU only (its float32 layer with AdamW
    state is ~27 GB, four of it beside a one-rank reference do not fit the
    card)."""
    import tempfile
    import shutil

    t_phase = time.perf_counter()
    work = tempfile.mkdtemp(prefix="chip_smoke_p15k_")
    ref_path = os.path.join(work, "one_rank.pt")

    def here():
        t0 = time.perf_counter()
        return _p15k_one_rank(dev, seed, ref_path), time.perf_counter() - t0

    try:
        ranks, four_s, (plain, plain_s) = _four_ranks_beside(
            dev, _p15ijk_ranks, (seed, ref_path), here)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return _p15ijk_report(ranks, plain, plain_s, card, four_s, t_phase)


def _p15ijk_report(ranks, plain, plain_s, card, four_s, t_phase):
    """15i-k's gates and lines from the four ranks' results and 15k's
    one-rank ``plain`` (losses, grad norms) run here in ``plain_s``;
    returns the launches and shapes :func:`drive_phase15` reports."""
    plain_losses, plain_norms = plain
    i_s, j_s, k_s = ([r[key] for r in ranks] for key in "ijk")

    # 15i gates
    for r in i_s:
        for buckets, got in ((r["buckets"], r["kernel_a"]),
                             (r["buckets_w4"], r["kernel_a_w4"])):
            want_a = _slab_launches(buckets, 4, r["rank"])
            if got != want_a:
                raise AssertionError(f"15i: rank {r['rank']} kernel A {got}, "
                                     f"the slabs imply {want_a}")
    _serve_rows_agree(i_s, "15i")
    c0 = i_s[0]["cases"]
    names = list(c0)
    gates = {names[0]: c0[names[0]]["max_abs_err_over_max_logit"] <= 1e-4,
             names[1]: c0[names[1]]["max_abs_err_over_max_logit"] <= 1e-4,
             names[3]: c0[names[3]]["max_abs_err_over_max_logit"] <= 1e-4
             and c0[names[3]]["tokens_equal"]}
    mla = _tp_minicpm3(P15I_LAYERS).cfg
    emit({"phase": "15i MLA tensor-parallel serving, 4 ranks sharing the "
                   "card (gloo), mesh (data 1, model 4), minicpm3-4b SQuant "
                   f"w8 at full width, {P15I_LAYERS} of 62 layers (int4: "
                   f"{P15I_SMALL}), 10 of 40 heads a rank, the compressed "
                   "cache whole, vocab-parallel tied embedding and head",
          "reduced": P15_CUTS["15i"],
          "card": card, "backend": "gloo", "ranks": 4,
          "prompt": list(P15I_PROMPT), "chunks": [P15_CHUNK] * P15I_CHUNKS,
          "decode_steps": P15I_STEPS,
          "local_shapes": sorted(f"{m}x{n}" for m, n in _mla_local_shapes(
              mla, 4, 1, 0)),
          "quantize_ms_by_rank": [r["quantize_ms"] for r in i_s],
          "kernel_a_by_rank": [r["kernel_a"] for r in i_s],
          "kernel_a_w4_by_rank": [r["kernel_a_w4"] for r in i_s],
          "cases": {n: _serve_cell(c0[n]) for n in names},
          "gates": gates, "gate": "float32 logits within 1e-4 of the "
          "one-rank forward's largest |logit| (w8, absorbed, int4), int4's "
          f"free-running tokens equal at {P15I_SMALL} layer; the others fed "
          "the one-rank tokens; bfloat16 reported",
          "peak_gb_by_rank": [r["peak_gb"] for r in i_s],
          "seconds_by_rank": [r["seconds"] for r in i_s],
          "note": "four CUDA contexts share one card and every collective "
                  "is staged through host memory over gloo: not a speed-up "
                  "over one rank, not an interconnect number"})
    if not all(gates.values()):
        raise AssertionError(f"15i: agreement gates failed: {gates}")

    # 15j gates
    swa = _tp_mixtral(P15J_LAYERS).cfg
    for r in j_s:
        want_a = _slab_launches(r["buckets"], 4, r["rank"], _bank_slices(swa))
        if r["kernel_a"] != want_a:
            raise AssertionError(f"15j: rank {r['rank']} kernel A "
                                 f"{r['kernel_a']}, the slabs imply {want_a}")
    _serve_rows_agree(j_s, "15j")
    j0 = j_s[0]["cases"]["w8 float32"]
    gate_j = j0["max_abs_err_over_max_logit"] <= 1e-4 and j0["routes_equal"]
    emit({"phase": "15j the sliding-window ring with experts over 'model', "
                   "4 ranks sharing the card (gloo), mesh (data 1, model 4), "
                   f"mixtral-8x7b SQuant w8 at full width, {P15J_LAYERS} of "
                   "32 layers, float32, made and quantized leaf by leaf on "
                   "the ranks' slabs; 2 of 8 experts, 8 of 32 q and 2 of 8 "
                   "KV heads, 8 000 of 32 000 vocabulary rows a rank",
          "card": card, "backend": "gloo", "ranks": 4,
          "prompt": list(P15J_PROMPT), "ring_slots": j_s[0]["ring_slots"],
          "chunks": [P15_CHUNK] * P15J_CHUNKS, "decode_steps": P15J_STEPS,
          "local_shapes": sorted(f"{m}x{n}" for m, n in
                                 _ep_local_shapes(swa, 4)),
          "build_and_quantize_ms_by_rank": [r["build_and_quantize_ms"]
                                            for r in j_s],
          "build_peak_gb_by_rank": [r["build_peak_gb"] for r in j_s],
          "local_tree_gb_by_rank": [r["local_gb"] for r in j_s],
          "kernel_a_by_rank": [r["kernel_a"] for r in j_s],
          "case": _serve_cell(j0), "gate_passed": gate_j,
          "gate": "logits within 1e-4 of the one-rank forward's largest "
                  "|logit| and every routing's expert picks equal, fed the "
                  "one-rank tokens",
          "peak_gb_by_rank": [r["peak_gb"] for r in j_s],
          "seconds_by_rank": [r["seconds"] for r in j_s]})
    if not gate_j:
        raise AssertionError(f"15j: agreement gate failed: "
                             f"{_serve_cell(j0)}")

    # 15k gates
    worst_loss = max(abs(a - b) / abs(b) for r in k_s
                     for a, b in zip(r["losses"], plain_losses))
    worst_norm = max(abs(a - b) / abs(b) for r in k_s
                     for a, b in zip(r["grad_norms"], plain_norms))
    excess = max(r["shards_excess_over_step_tol"] for r in k_s)
    split = {k: _percentiles([s[k] for s in k_s[0]["split_ms"][1:]])["p50"]
             for k in k_s[0]["split_ms"][-1]}
    emit({"phase": "15k MLA tensor-parallel training, 4 ranks sharing the "
                   "card (gloo), mesh (data 2, model 2), minicpm3-4b at full "
                   f"width, {P15K_LAYERS} of 62 layers, float32 (mixtral's "
                   "step: CPU tests only)", "reduced": P15_CUTS["15k"],
          "card": card,
          "backend": "gloo", "ranks": 4, "steps": P15K_STEPS,
          "global_batch": list(P15K_BATCH), "optimizer": P15K_OPT,
          "losses": k_s[0]["losses"], "one_rank_losses": plain_losses,
          "grad_norms": k_s[0]["grad_norms"],
          "one_rank_grad_norms": plain_norms,
          "max_rel_diff_loss": worst_loss,
          "max_rel_diff_grad_norm": worst_norm,
          "shards_max_excess_over_step_tol": excess,
          "local_attention_shards": k_s[0]["local_shards"],
          "step_ms_p50_steps_2_on": _percentiles(k_s[0]["step_ms"][1:])["p50"],
          "split_ms_p50_rank0": split,
          "peak_gb_by_rank": [r["peak_gb"] for r in k_s],
          "one_rank_seconds": plain_s,
          "seconds_by_rank": [r["seconds"] for r in k_s],
          "run_local_seconds": four_s,
          "seconds_since_the_ranks_started": time.perf_counter() - t_phase})
    if not (worst_loss <= 1e-4 and worst_norm <= 1e-4 and excess <= 0):
        raise AssertionError(f"15k: losses {worst_loss}, grad norms "
                             f"{worst_norm}, shards over STEP_TOL by {excess}")
    mla_shapes = sorted(_mla_local_shapes(mla, 4, 1, 0))
    swa_shapes = sorted(_ep_local_shapes(swa, 4))
    return {"squant_flip": [r["kernel_a"]["squant_flip"]
                            + r["kernel_a_w4"]["squant_flip"] for r in i_s],
            "squant_scale": [r["kernel_a"]["squant_scale"]
                             + r["kernel_a_w4"]["squant_scale"] for r in i_s],
            "squant_flip_15j": [r["kernel_a"]["squant_flip"] for r in j_s],
            "squant_scale_15j": [r["kernel_a"]["squant_scale"] for r in j_s],
            "dequant_matmul": [sum(c["kernel_b"] for c in r["cases"].values())
                               for r in i_s],
            "dequant_matmul_15j": [sum(c["kernel_b"] for c in
                                       r["cases"].values()) for r in j_s],
            "plans": {"15i": i_s[0]["plans"], "15j": j_s[0]["plans"]},
            "mla_local_shapes": mla_shapes, "swa_local_shapes": swa_shapes,
            "mla_kv_up": (_per_rank(mla.n_heads, mla.mla.nope_dim
                                    + mla.mla.v_dim, 4), mla.mla.kv_lora),
            "swa_capacity_rows": math.ceil(
                P15J_PROMPT[0] * P15J_PROMPT[1] * swa.moe.top_k
                * swa.moe.capacity_factor / swa.moe.n_experts),
            "mla_expand_rows": P15I_PROMPT[0] * (
                P15I_PROMPT[1] + P15_CHUNK * P15I_CHUNKS + P15I_STEPS + 1)}


def _phase15ij_cells(mr):
    """Phase 2's kernel-B cells of 15i-j (label, M, N, rows), timed with
    float32 activations (their paths' dtype; 15i's bf16 launch shapes are
    compared, not timed): minicpm3's seven local shapes at 15i's decode
    batch and prefill rows, ``kv_up`` at the rows of a whole-cache
    re-expansion; mixtral's local attention shapes at 15j's decode row and
    prefill rows, its local experts at the decode row and the prefill's
    capacity."""
    b, rows = P15I_PROMPT[0], P15I_PROMPT[0] * P15I_PROMPT[1]
    mla = mr["mla_local_shapes"]
    kv_up = mr["mla_kv_up"]
    swa = _tp_mixtral(P15J_LAYERS).cfg
    experts = {(swa.d_ff, swa.d_model), (swa.d_model, swa.d_ff)}
    f32 = [(f"15i local {m}x{n} decode", m, n, b) for m, n in mla]
    f32 += [(f"15i local {m}x{n} prefill", m, n, rows) for m, n in mla]
    f32.append((f"15i local kv_up {kv_up[0]}x{kv_up[1]} whole-cache "
                f"re-expansion", *kv_up, mr["mla_expand_rows"]))
    for m, n in mr["swa_local_shapes"]:
        big = mr["swa_capacity_rows"] if (m, n) in experts \
            else P15J_PROMPT[0] * P15J_PROMPT[1]
        f32 += [(f"15j local {m}x{n} decode", m, n, P15J_PROMPT[0]),
                (f"15j local {m}x{n} prefill", m, n, big)]
    return f32


# ---------------------------------------------------------------------------
# phase 15l-n: mamba and rwkv under tensor-parallel execution over 'model'
# (four gloo ranks sharing the card, after 15i-k in the same processes)
# ---------------------------------------------------------------------------

P15L_LAYERS = 2          # 15l's jamba: RECURRENT_ISOLATED's ("m", "a") cut
P15L_SMALL = 1           # 15l's int4 case: one mamba layer
P15M_LAYERS = 1          # 15m's rwkv6-1.6b at full width (of 24)
P15M_SMALL = 1           # 15m's int4 case
P15LM_PROMPT = (8, 256)  # 15l-m's prefill
P15LM_CHUNKS = 1         # 15l-m's 64-token chunks after the prefill
P15LM_STEPS = 16         # 15l-m's greedy decode steps
P15N_LAYERS = 1          # 15n's rwkv6-1.6b at full width (of 24)
P15N_STEPS = 5
P15N_BATCH = (4, 256)
P15N_OPT = P15F_OPT
RWKV_DECAY_LORA = 64     # models.rwkv.init_rwkv_timemix's decay LoRA rank


def _tp_jamba(layers, dtype="float32"):
    """jamba-1.5-large at full width, mamba then attention (the first
    ``layers`` of ("m", "a")), no MoE, in ``dtype``."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    return build_model(dataclasses.replace(
        get_config(JAMBA_ARCH), n_layers=layers,
        block_pattern=("m", "a")[:layers], moe=None, dtype=dtype))


def _tp_rwkv(layers, dtype="float32"):
    """rwkv6-1.6b at full width and ``layers`` layers in ``dtype``."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    return build_model(dataclasses.replace(get_config(RWKV_ARCH),
                                           n_layers=layers, dtype=dtype))


def _recurrent_local_shapes(cfg, tp):
    """{(M, N): launches a forward} of kernel B on a rank's local shards
    (``tp`` ranks) of a jamba stack without experts or an rwkv stack:
    mamba's ``in_proj`` (x and z of its channels), ``x_proj``
    (row-parallel), ``dt_proj`` and ``out_proj``; attention's q, k, v, o;
    the dense FFN's three; rwkv's time-mix r, k, v, g, o and the whole
    decay LoRA, its channel mix's k, v, r; and the vocab-parallel untied
    head."""
    from repro_torch.models.transformer import layer_plan, n_periods
    d, f = cfg.d_model, cfg.d_ff
    out = collections.Counter()
    for kind, _ in layer_plan(cfg) * n_periods(cfg):
        if kind == "rwkv":
            parts = (((d // tp, d), 5), ((RWKV_DECAY_LORA, d), 1),
                     ((d, RWKV_DECAY_LORA), 1), ((d, d // tp), 1),
                     ((f // tp, d), 1), ((d, f // tp), 1))
        elif kind == "m":
            mc = cfg.mamba
            di = mc.expand * d
            r = mc.dt_rank or max(1, d // 16)
            parts = (((2 * di // tp, d), 1), ((r + 2 * mc.d_state, di // tp),
                                             1),
                     ((di // tp, r), 1), ((d, di // tp), 1))
        else:
            q, kv = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
            parts = (((q // tp, d), 1), ((kv // tp, d), 2),
                     ((d, q // tp), 1))
        if kind != "rwkv":
            parts += (((f // tp, d), 2), ((d, f // tp), 1))
        for mn, k in parts:
            out[mn] += k
    out[(cfg.vocab // tp, d)] += 1
    return dict(out)


def _strided_probe(dev, mesh, cfg):
    """The paired cut of mamba's ``in_proj`` on this torch and card: a
    (16, 32) tensor placed as ``tp_local`` / ``tp_place`` place
    ``in_proj`` of config ``cfg`` (a strided shard of split 2 on 'model'), its AdamW moment
    (``zeros_like``) on the same placements, and gathered back whole
    (``group.full_tensor``, through the host on gloo)."""
    from repro_torch.distributed.group import full_tensor
    from repro_torch.distributed.sharding import make_tp_shardings, place
    from repro_torch.training.optimizer import adamw_init
    t = torch.arange(16 * 32, dtype=torch.float32, device=dev).view(16, 32)
    sh = make_tp_shardings(mesh, {"in_proj": {"w": t}}, cfg)["in_proj"]["w"]
    dt = place(t, sh)
    k, n = mesh.get_local_rank("model"), mesh.shape[1]
    per = 16 // n
    cols = list(range(k * per, (k + 1) * per)) + \
        list(range(16 + k * per, 16 + (k + 1) * per))
    moment = adamw_init({"w": dt})["m"]["w"]
    return {"placements": repr(dt.placements),
            "local_is_the_paired_cut": bool(torch.equal(dt.to_local(),
                                                        t[:, cols])),
            "moment_placements_kept": moment.placements == dt.placements,
            "gathered_bit_equal": bool(torch.equal(full_tensor(dt), t))}


def _serve_cases(dev, mesh, prompt, chunks, cases):
    """Each case ``(name, model, whole tree, local tree, fed the one-rank
    tokens)`` through :func:`_serve_case_vs_one_rank`, kernel B's launches
    held to :func:`_recurrent_local_shapes`; and every launch plan."""
    from repro_torch.kernels import dequant_matmul as dm
    forwards = 1 + len(chunks) + P15LM_STEPS
    out = {}
    dm._plans.clear()
    for name, m, tree, loc, forced in cases:
        want = {k: v * forwards for k, v in
                _recurrent_local_shapes(m.cfg, mesh.shape[1]).items()}
        out[name] = _serve_case_vs_one_rank(
            dev, m, tree, mesh, prompt, chunks, P15LM_STEPS, forced, want,
            local=loc)
    return out, dm.cached_plans()


def _prompt_and_chunks(dev, seed, vocab):
    import numpy as np
    rng = np.random.default_rng(seed)
    prompt = torch.from_numpy(rng.integers(0, vocab, size=P15LM_PROMPT)
                              ).to(dev)
    chunks = [torch.from_numpy(rng.integers(
        0, vocab, size=(P15LM_PROMPT[0], P15_CHUNK))).to(dev)
        for _ in range(P15LM_CHUNKS)]
    return prompt, chunks


def _p15l_rank(dev, seed):
    """15l on this rank of four (see :func:`phase15lmn`): host numbers."""
    import torch.distributed as dist
    from repro_torch.distributed.group import make_mesh
    from repro_torch.launch.mesh import make_quantize_mesh
    rank, world = dist.get_rank(), dist.get_world_size()
    model, small = _tp_jamba(P15L_LAYERS), _tp_jamba(P15L_SMALL)
    mesh = make_mesh((1, world), ("data", "model"))
    qmesh = make_quantize_mesh(world)
    out = {"rank": rank, "strided_probe": _strided_probe(dev, mesh, model.cfg)}
    torch.cuda.reset_peak_memory_stats(dev)
    dist.barrier()
    t0 = time.perf_counter()
    local, whole, out["buckets"], out["kernel_a"] = _leafwise_tp(
        dev, model, seed, qmesh, mesh, keep_whole=rank == 0)
    _sync_dev(dev)
    out["build_and_quantize_ms"] = (time.perf_counter() - t0) * 1e3
    out["build_peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    out["local_gb"] = _tree_bytes(local) / 1e9
    local4, whole4, out["buckets_w4"], out["kernel_a_w4"] = _leafwise_tp(
        dev, small, seed, qmesh, mesh, keep_whole=rank == 0, bits=4)
    prompt, chunks = _prompt_and_chunks(dev, seed, model.cfg.vocab)
    bf = torch.bfloat16
    # (name, model, whole tree (rank 0), local tree, fed the one-rank tokens)
    cases = (("w8 float32", model, whole, local, True),
             ("w8 bfloat16", _tp_jamba(P15L_LAYERS, "bfloat16"),
              whole and _retyped(whole, bf), _retyped(local, bf), True),
             (f"w4 float32 {P15L_SMALL} layer", small, whole4, local4,
              False))
    out["cases"], out["plans"] = _serve_cases(dev, mesh, prompt, chunks,
                                              cases)
    mixer = local["stack"]["list"][0]["b0"]["mixer"]
    out["local_mixer"] = {k: list(v.shape) for k, v in _leaves(mixer).items()}
    del local, whole, local4, whole4, cases
    _free(dev)
    return out


def _p15m_rank(dev, seed):
    """15m on this rank of four (see :func:`phase15lmn`): host numbers."""
    import torch.distributed as dist
    from repro_torch.distributed.group import make_mesh
    from repro_torch.distributed.sharding import tp_local
    from repro_torch.launch.mesh import make_quantize_mesh
    rank, world = dist.get_rank(), dist.get_world_size()
    out = {"rank": rank}
    model, small = _tp_rwkv(P15M_LAYERS), _tp_rwkv(P15M_SMALL)
    params = _tp_params(model, dev, seed)
    qmesh = make_quantize_mesh(world)
    dist.barrier()
    t0 = time.perf_counter()
    whole, out["buckets"], out["kernel_a"] = _quantized_on_slabs(
        params, 8, qmesh, dev)
    out["quantize_ms"] = (time.perf_counter() - t0) * 1e3
    w4, out["buckets_w4"], out["kernel_a_w4"] = _quantized_on_slabs(
        _first_layers(params, P15M_SMALL), 4, qmesh, dev)
    del params
    _free(dev)
    mesh = make_mesh((1, world), ("data", "model"))
    prompt, chunks = _prompt_and_chunks(dev, seed, model.cfg.vocab)
    bf = torch.bfloat16
    local = tp_local(whole, mesh, cfg=model.cfg)
    cases = (("w8 float32", model, whole, local, True),
             ("w8 bfloat16", _tp_rwkv(P15M_LAYERS, "bfloat16"),
              _retyped(whole, bf), _retyped(local, bf), True),
             (f"w4 float32 {P15M_SMALL} layer", small, w4,
              tp_local(w4, mesh, cfg=small.cfg), False))
    out["cases"], out["plans"] = _serve_cases(dev, mesh, prompt, chunks,
                                              cases)
    del whole, w4, local, cases
    _free(dev)
    return out


def _p15n_batches():
    return _markov(P15N_BATCH, P15N_STEPS, 19)


def _p15n_rank(dev, seed, ref_path):
    """15n on this rank of four: the tensor-parallel rwkv step."""
    return _tp_train_vs_saved(dev, seed, _tp_rwkv(P15N_LAYERS),
                              _p15n_batches(), P15N_OPT, ref_path, "15n",
                              ("stack", "list", "0", "b0"))


def _p15n_one_rank(dev, seed, ref_path):
    """15n's plain one-rank step (:func:`_one_rank_train_saved`)."""
    return _one_rank_train_saved(dev, seed, _tp_rwkv(P15N_LAYERS),
                                 _p15n_batches(), P15N_OPT, ref_path)


def _p15lmn_ranks(seed, ref_path):
    """15l, 15m, then 15n, on one rank of four sharing the card over gloo
    (run by ``run_local``)."""
    from repro_torch.distributed import group
    torch.backends.cuda.matmul.allow_tf32 = False     # float32 means float32
    dev = group.device()
    out = {}
    for key, fn, args in (("l", _p15l_rank, (dev, seed)),
                          ("m", _p15m_rank, (dev, seed)),
                          ("n", _p15n_rank, (dev, seed, ref_path))):
        _free(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        out[key] = fn(*args)
        out[key].setdefault("peak_gb",
                            torch.cuda.max_memory_allocated(dev) / 1e9)
        out[key]["seconds"] = time.perf_counter() - t0
    return out


def phase15lmn(dev, seed, card):
    """15l-n alone (``--recurrent-parallel``): four gloo ranks sharing the
    card (one ``run_local``) beside 15n's one-rank step here; what
    :func:`phase15bcd` runs after 15i-k in the same processes.

    15l, mamba serving: jamba-1.5-large at full width, mamba then
    attention (:data:`P15L_LAYERS` of 72 layers, no MoE: 13c's isolated
    cut), float32, made and quantized SQuant w8 leaf by leaf on the four
    ranks' row slabs (:func:`_leafwise_tp`: no rank holds the 11.4 GB
    float32 tree), each rank keeping its shards on (data 1, model 4):
    4 096 of the 16 384 ``d_inner`` channels (``in_proj``'s x and z
    columns of them, ``x_proj`` row-parallel), 16 of 64 q and 2 of 8 KV
    heads, a quarter of the FFN and 16 384 of the 65 536 vocabulary rows;
    rank 0 keeps the whole tree for the one-rank forward. A prefill of 8
    x 256, one 64-token chunk and 16 greedy decode steps under
    ``activate_mesh`` against the one-rank forward (its tokens fed to
    both): w8 float32, bfloat16, and SQuant int4 at :data:`P15L_SMALL`
    mamba layer free-running. The paired cut's strided shard is probed
    first on this torch (:func:`_strided_probe`).

    15m, rwkv serving: rwkv6-1.6b at full width and :data:`P15M_LAYERS`
    layers, quantized on the slabs, gathered and cut by ``tp_local``: 8
    of 32 heads a rank (the wkv state of them), the decay LoRA whole, a
    quarter of the channel mix and of the vocabulary; the same traffic and
    cases (the prefill's 256 tokens through ``wkv_chunked``, decode through
    ``wkv_scan``).

    Gates of both: each rank's kernel-B launches by local weight shape as
    the shards imply, kernel A's as the slabs imply, every rank the same
    logits and tokens; float32 logits within 1e-4 of the one-rank
    forward's largest |logit| (w8, int4) and int4's free-running tokens
    equal. bfloat16 is reported.

    15n, rwkv training: rwkv6-1.6b at :data:`P15N_LAYERS` layers in
    float32 on (data 2, model 2), :data:`P15N_STEPS` steps of 4 x 256
    tokens beside the plain one-rank step here. Gates: losses and grad
    norms within 1e-4 relative, every rank's shards within ``STEP_TOL``,
    and the loss falling. jamba's step under 'model' is held on the CPU
    only: at full width its embedding and head alone are 1.07 B
    parameters (~17 GB with AdamW), and four ranks beside a one-rank
    reference do not fit one card."""
    import tempfile
    import shutil

    t_phase = time.perf_counter()
    work = tempfile.mkdtemp(prefix="chip_smoke_p15n_")
    ref_path = os.path.join(work, "one_rank.pt")

    def here():
        t0 = time.perf_counter()
        return _p15n_one_rank(dev, seed, ref_path), time.perf_counter() - t0

    try:
        ranks, four_s, (plain, plain_s) = _four_ranks_beside(
            dev, _p15lmn_ranks, (seed, ref_path), here)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return _p15lmn_report(ranks, plain, plain_s, card, four_s, t_phase)


def _recurrent_serve_gates(rows, label):
    """15l's or 15m's kernel-A and agreement gates on the four ranks'
    ``rows``; returns rank 0's cases and their gates."""
    for r in rows:
        for buckets, got in ((r["buckets"], r["kernel_a"]),
                             (r["buckets_w4"], r["kernel_a_w4"])):
            want_a = _slab_launches(buckets, 4, r["rank"])
            if got != want_a:
                raise AssertionError(f"{label}: rank {r['rank']} kernel A "
                                     f"{got}, the slabs imply {want_a}")
    _serve_rows_agree(rows, label)
    c0 = rows[0]["cases"]
    names = list(c0)
    gates = {names[0]: c0[names[0]]["max_abs_err_over_max_logit"] <= 1e-4,
             names[2]: c0[names[2]]["max_abs_err_over_max_logit"] <= 1e-4
             and c0[names[2]]["tokens_equal"]}
    if not all(gates.values()):
        raise AssertionError(f"{label}: agreement gates failed: {gates}, "
                             f"{ {n: _serve_cell(c0[n]) for n in names} }")
    return c0, gates


def _p15lmn_report(ranks, plain, plain_s, card, four_s, t_phase):
    """15l-n's gates and lines from the four ranks' results and 15n's
    one-rank ``plain`` (losses, grad norms) run here in ``plain_s``;
    returns the launches and shapes :func:`drive_phase15` reports."""
    plain_losses, plain_norms = plain
    l_s, m_s, n_s = ([r[key] for r in ranks] for key in "lmn")
    gate = "float32 logits within 1e-4 of the one-rank forward's largest " \
           "|logit| (w8, int4), int4's free-running tokens equal; w8 fed " \
           "the one-rank tokens; bfloat16 reported"
    note = "four CUDA contexts share one card and every collective is " \
           "staged through host memory over gloo: not a speed-up over one " \
           "rank, not an interconnect number"

    # 15l
    probe = [r["strided_probe"] for r in l_s]
    if not all(p["local_is_the_paired_cut"] and p["moment_placements_kept"]
               and p["gathered_bit_equal"] for p in probe):
        raise AssertionError(f"15l: the paired cut's strided shard: {probe}")
    c0, gates = _recurrent_serve_gates(l_s, "15l")
    jamba = _tp_jamba(P15L_LAYERS).cfg
    emit({"phase": "15l mamba tensor-parallel serving, 4 ranks sharing the "
                   "card (gloo), mesh (data 1, model 4), jamba-1.5-large "
                   "SQuant w8 at full width, mamba then attention "
                   f"({P15L_LAYERS} of 72 layers, no MoE; int4: "
                   f"{P15L_SMALL} mamba layer), float32, made and quantized "
                   "leaf by leaf on the ranks' slabs; 4 096 of 16 384 "
                   "d_inner channels (in_proj's x and z of them), 16 of 64 "
                   "q and 2 of 8 KV heads, 16 384 of 65 536 vocabulary rows "
                   "a rank",
          "card": card, "backend": "gloo", "ranks": 4,
          "torch": torch.__version__, "strided_probe": probe[0],
          "prompt": list(P15LM_PROMPT), "chunks": [P15_CHUNK] * P15LM_CHUNKS,
          "decode_steps": P15LM_STEPS,
          "local_shapes": sorted(f"{m}x{n}" for m, n in
                                 _recurrent_local_shapes(jamba, 4)),
          "local_mixer": l_s[0]["local_mixer"],
          "build_and_quantize_ms_by_rank": [r["build_and_quantize_ms"]
                                            for r in l_s],
          "build_peak_gb_by_rank": [r["build_peak_gb"] for r in l_s],
          "local_tree_gb_by_rank": [r["local_gb"] for r in l_s],
          "kernel_a_by_rank": [r["kernel_a"] for r in l_s],
          "kernel_a_w4_by_rank": [r["kernel_a_w4"] for r in l_s],
          "cases": {n: _serve_cell(c0[n]) for n in c0},
          "gates": gates, "gate": gate,
          "peak_gb_by_rank": [r["peak_gb"] for r in l_s],
          "seconds_by_rank": [r["seconds"] for r in l_s], "note": note})

    # 15m
    c0, gates = _recurrent_serve_gates(m_s, "15m")
    rwkv = _tp_rwkv(P15M_LAYERS).cfg
    emit({"phase": "15m rwkv tensor-parallel serving, 4 ranks sharing the "
                   "card (gloo), mesh (data 1, model 4), rwkv6-1.6b SQuant "
                   f"w8 at full width, {P15M_LAYERS} of 24 layers (int4: "
                   f"{P15M_SMALL}), float32; 8 of 32 heads a rank, the "
                   "decay LoRA whole, 16 384 of 65 536 vocabulary rows",
          "reduced": P15_CUTS["15m"],
          "card": card, "backend": "gloo", "ranks": 4,
          "prompt": list(P15LM_PROMPT), "chunks": [P15_CHUNK] * P15LM_CHUNKS,
          "decode_steps": P15LM_STEPS,
          "local_shapes": sorted(f"{m}x{n}" for m, n in
                                 _recurrent_local_shapes(rwkv, 4)),
          "quantize_ms_by_rank": [r["quantize_ms"] for r in m_s],
          "kernel_a_by_rank": [r["kernel_a"] for r in m_s],
          "kernel_a_w4_by_rank": [r["kernel_a_w4"] for r in m_s],
          "cases": {n: _serve_cell(c0[n]) for n in c0},
          "gates": gates, "gate": gate,
          "peak_gb_by_rank": [r["peak_gb"] for r in m_s],
          "seconds_by_rank": [r["seconds"] for r in m_s], "note": note})

    # 15n
    worst_loss = max(abs(a - b) / abs(b) for r in n_s
                     for a, b in zip(r["losses"], plain_losses))
    worst_norm = max(abs(a - b) / abs(b) for r in n_s
                     for a, b in zip(r["grad_norms"], plain_norms))
    excess = max(r["shards_excess_over_step_tol"] for r in n_s)
    falls = plain_losses[-1] < plain_losses[0]
    split = {k: _percentiles([s[k] for s in n_s[0]["split_ms"][1:]])["p50"]
             for k in n_s[0]["split_ms"][-1]}
    emit({"phase": "15n rwkv tensor-parallel training, 4 ranks sharing the "
                   "card (gloo), mesh (data 2, model 2), rwkv6-1.6b at full "
                   f"width, {P15N_LAYERS} of 24 layers, float32 (jamba's "
                   "step: CPU tests only)", "reduced": P15_CUTS["15n"],
          "card": card,
          "backend": "gloo", "ranks": 4, "steps": P15N_STEPS,
          "global_batch": list(P15N_BATCH), "optimizer": P15N_OPT,
          "losses": n_s[0]["losses"], "one_rank_losses": plain_losses,
          "grad_norms": n_s[0]["grad_norms"],
          "one_rank_grad_norms": plain_norms,
          "max_rel_diff_loss": worst_loss,
          "max_rel_diff_grad_norm": worst_norm,
          "shards_max_excess_over_step_tol": excess, "loss_falls": falls,
          "local_block_shards": n_s[0]["local_shards"],
          "step_ms_p50_steps_2_on": _percentiles(n_s[0]["step_ms"][1:])["p50"],
          "split_ms_p50_rank0": split,
          "peak_gb_by_rank": [r["peak_gb"] for r in n_s],
          "one_rank_seconds": plain_s,
          "seconds_by_rank": [r["seconds"] for r in n_s],
          "run_local_seconds": four_s,
          "seconds_since_the_ranks_started": time.perf_counter() - t_phase})
    if not (worst_loss <= 1e-4 and worst_norm <= 1e-4 and excess <= 0
            and falls):
        raise AssertionError(f"15n: losses {worst_loss}, grad norms "
                             f"{worst_norm}, shards over STEP_TOL by "
                             f"{excess}, loss falls {falls}")
    return {"squant_flip_15l": [r["kernel_a"]["squant_flip"]
                                + r["kernel_a_w4"]["squant_flip"]
                                for r in l_s],
            "squant_scale_15l": [r["kernel_a"]["squant_scale"]
                                 + r["kernel_a_w4"]["squant_scale"]
                                 for r in l_s],
            "squant_flip_15m": [r["kernel_a"]["squant_flip"]
                                + r["kernel_a_w4"]["squant_flip"]
                                for r in m_s],
            "squant_scale_15m": [r["kernel_a"]["squant_scale"]
                                 + r["kernel_a_w4"]["squant_scale"]
                                 for r in m_s],
            "dequant_matmul_15l": [sum(c["kernel_b"] for c in
                                       r["cases"].values()) for r in l_s],
            "dequant_matmul_15m": [sum(c["kernel_b"] for c in
                                       r["cases"].values()) for r in m_s],
            "plans": {"15l": l_s[0]["plans"], "15m": m_s[0]["plans"]},
            "jamba_local_shapes": sorted(_recurrent_local_shapes(jamba, 4)),
            "rwkv_local_shapes": sorted(_recurrent_local_shapes(rwkv, 4))}


def _phase15lm_cells(rec):
    """Phase 2's kernel-B cells of 15l-m (label, M, N, rows), timed with
    float32 activations (their paths' dtype): each local weight shape of
    jamba's and rwkv's shards at the decode batch and the prefill's rows."""
    b, rows = P15LM_PROMPT[0], P15LM_PROMPT[0] * P15LM_PROMPT[1]
    out = []
    for label, shapes in (("15l", rec["jamba_local_shapes"]),
                          ("15m", rec["rwkv_local_shapes"])):
        for m, n in shapes:
            out += [(f"{label} local {m}x{n} decode", m, n, b),
                    (f"{label} local {m}x{n} prefill", m, n, rows)]
    return out


# ---------------------------------------------------------------------------
# phase 15o: heads and FFN widths 'model' 16 does not divide (replica
# groups), sixteen gloo ranks sharing the card
# ---------------------------------------------------------------------------

P15O_RANKS = 16          # the production mesh's 'model' axis (16 x 16)
P15O_LAYERS = 1          # each model's depth: granite of 40, minitron of
#                          32, minicpm3 of 62
P15O_PROMPT = (4, 64)    # shard_logits gathers whole logits on every rank
P15O_CHUNKS = 1
P15O_STEPS = 16
P15O_TRAIN_LAYERS = 1    # 15o (iv): granite's train-step gradients
P15O_TRAIN_STEPS = 3     # batches, each on the same parameters
P15O_TRAIN_BATCH = (2, 128)
P15O_OPT = P15F_OPT
P15O_STEP_GATE = 1e-6    # losses and grad norms, relative, against one rank
# 15o (v): the whole train step (norm, clip, AdamW) at 'model' 16 on
# granite's reduced config with 6 q / 2 KV heads and d_ff 130, each on
# replica groups of 8 ranks (tests/torch_tp_workers.py's case at 'model'
# 4); the clip binds, so the step's own norm scales every update
P15O_GROUPS = dict(dtype="float32", n_layers=2, d_model=128, n_heads=6,
                   n_kv_heads=2, head_dim=32, d_ff=130, vocab=P15_DATA_VOCAB)
P15O_GROUP_STEPS = 3
P15O_GROUP_BATCH = (8, 64)
P15O_GROUP_OPT = dict(lr=3e-3, warmup_steps=0, decay_steps=10, eps=1e-3,
                      clip_norm=0.05)


def _tp_minitron(layers, dtype="float32"):
    """minitron-4b (arXiv:2407.14679) at full width and ``layers`` layers
    in ``dtype``: 24 q / 8 KV heads of 128, d_ff 9216, an untied head over
    256 000 tokens."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    return build_model(dataclasses.replace(get_config("minitron-4b"),
                                           n_layers=layers, dtype=dtype))


# 15o's models: (key, model-making function), each at P15O_LAYERS;
# mixtral's 8 experts on 'model' 16 take the 'expert_ff' fallback
P15O_MODELS = (("granite", _tp_granite), ("minitron", _tp_minitron),
               ("minicpm3", _tp_minicpm3), ("mixtral", _tp_mixtral))
# 15o (vii): mixtral's AdamW update runs on the card only where a rank's
# predicted state, ~7 x its float32 parameters (the functional update
# holds the old and new parameters and moments at once), fits this
# budget: sixteen ranks share the card's 80 GB
P15O_RANK_BUDGET_GB = 4.0


def _p15o_shapes(cfg, tp, forwards):
    """{(M, N): launches} of kernel B on a rank's 15o shards over
    ``forwards`` forwards (the last :data:`P15O_STEPS` of them decode
    steps)."""
    if cfg.mla is not None:
        return _mla_local_shapes(cfg, tp, forwards, P15O_STEPS)
    if cfg.moe is not None:
        return _swa_local_shapes(cfg, tp, forwards)
    return {k: v * forwards for k, v in _tp_local_shapes(cfg, tp).items()}


def _bank_slices(cfg):
    """:func:`_slab_launches`' ``slice_rows`` of an MoE stack's expert
    banks: the rows of one expert's slice of each ``(E·out,in)`` bucket
    (None for a dense stack)."""
    if cfg.moe is None:
        return None
    e, d, f = cfg.moe.n_experts, cfg.d_model, cfg.d_ff
    return {f"({e * f},{d})": f, f"({e * d},{f})": d}


def _rank_params(model, tp):
    """The parameters a rank holds of ``model``'s ``tp_place`` tree on
    (data 1, model ``tp``): a leaf 'model' cuts a ``tp``-th, a leaf it
    holds whole (replica groups, the router, the norms) whole."""
    from repro_torch.core.pipeline import _flatten
    from repro_torch.distributed.sharding import (AbstractMesh, _get_path,
                                                  make_tp_shardings)
    meta = model.init(None, device="meta")
    specs = make_tp_shardings(AbstractMesh((1, tp), ("data", "model")), meta,
                              model.cfg)
    return sum(m.numel() // (tp if "model" in _get_path(specs, p).spec
                             else 1) for p, m in _flatten(meta))


def _p15o_update_gb(model, tp):
    """15o (vii)'s predicted peak of a rank's train step with the AdamW
    update, GB: 7 x its float32 parameters (:func:`_rank_params`)."""
    return 7 * 4 * _rank_params(model, tp) / 1e9


def _p15o_batches():
    return _markov(P15O_TRAIN_BATCH, P15O_TRAIN_STEPS, 23)


def _tp_granite_groups():
    """granite-3-8b's reduced config at :data:`P15O_GROUPS` (15o (v))."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    return build_model(dataclasses.replace(
        get_config("granite-3-8b", reduced=True), **P15O_GROUPS))


def _p15o_group_batches():
    return _markov(P15O_GROUP_BATCH, P15O_GROUP_STEPS, 29)


def _p15o_rank(dev, seed, ref_path):
    """15o on this rank of sixteen (see :func:`phase15o`): host numbers."""
    import numpy as np
    import torch.distributed as dist
    from repro_torch.distributed.group import make_mesh
    from repro_torch.kernels import dequant_matmul as dm
    from repro_torch.launch.mesh import make_quantize_mesh
    rank, world = dist.get_rank(), dist.get_world_size()
    mesh = make_mesh((1, world), ("data", "model"))
    qmesh = make_quantize_mesh(world)
    forwards = 1 + P15O_CHUNKS + P15O_STEPS
    bf = torch.bfloat16
    out = {"rank": rank}
    for key, build in P15O_MODELS:
        _free(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        model = build(P15O_LAYERS)
        dist.barrier()
        t1 = time.perf_counter()
        local, whole, buckets, kernel_a = _leafwise_tp(
            dev, model, seed, qmesh, mesh, keep_whole=rank == 0)
        _sync_dev(dev)
        row = {"build_and_quantize_ms": (time.perf_counter() - t1) * 1e3,
               "build_peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
               "local_gb": _tree_bytes(local) / 1e9, "buckets": buckets,
               "kernel_a": kernel_a}
        rng = np.random.default_rng(seed)
        vocab = model.cfg.vocab
        prompt = torch.from_numpy(rng.integers(0, vocab, size=P15O_PROMPT)
                                  ).to(dev)
        chunks = [torch.from_numpy(rng.integers(
            0, vocab, size=(P15O_PROMPT[0], P15_CHUNK))).to(dev)
            for _ in range(P15O_CHUNKS)]
        # (name, model, whole tree (rank 0), local tree)
        cases = (("w8 float32", model, whole, local),
                 ("w8 bfloat16", build(P15O_LAYERS, "bfloat16"),
                  whole and _retyped(whole, bf), _retyped(local, bf)))
        row["cases"] = {}
        dm._plans.clear()
        for name, m, tree, loc in cases:
            row["cases"][name] = _serve_case_vs_one_rank(
                dev, m, tree, mesh, prompt, chunks, P15O_STEPS, True,
                _p15o_shapes(m.cfg, world, forwards), local=loc)
        row["plans"] = dm.cached_plans()
        del local, whole, cases
        _free(dev)
        row["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
        row["seconds"] = time.perf_counter() - t0
        out[key] = row
    _free(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    out["train"] = _p15o_grads_rank(dev, seed, ref_path, mesh)
    out["train"]["seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["group_step"] = _tp_train_vs_saved(
        dev, seed, _tp_granite_groups(), _p15o_group_batches(),
        P15O_GROUP_OPT, ref_path + ".step", "15o (v)",
        ("stack", "list", "0", "b0"), shape=(1, world))
    out["group_step"]["seconds"] = time.perf_counter() - t0
    _free(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    out["mixtral_train"] = _p15o_mixtral_train_rank(dev, seed, ref_path,
                                                    mesh)
    out["mixtral_train"]["seconds"] = time.perf_counter() - t0
    return out


def _grads_vs_saved(dev, grads, placed, ref, mesh, tol):
    """This rank's gradient shards (``grads``, plain tensors laid out as
    ``placed``'s DTensors) against the one-rank gradients ``ref`` (a
    mapped file's dict, whole leaves): the largest excess over ``tol``
    and the largest difference over the leaf's largest |gradient|,
    compared a few MB at a time (sixteen ranks share the card)."""
    from repro_torch.distributed.sharding import shard_index
    flat = _leaves(placed)
    worst = worst_rel = 0.0
    for k, g in _leaves(grads).items():
        t = flat[k]
        want = ref[k][shard_index(t.shape, t.placements, tuple(mesh.shape),
                                  mesh.get_coordinate())]
        big = dif = 0.0
        for r0 in range(0, g.shape[0], 2048):
            w = want[r0:r0 + 2048].to(dev)
            d = (g[r0:r0 + 2048] - w).abs()
            worst = max(worst, float((d - tol["rtol"] * w.abs()
                                      - tol["atol"]).max()))
            big = max(big, float(w.abs().max()))
            dif = max(dif, float(d.max()))
            del w, d
        worst_rel = max(worst_rel, dif / max(big, 1e-30))
    return worst, worst_rel


def _p15o_mixtral_train_rank(dev, seed, ref_path, mesh):
    """15o (vii) on this rank: mixtral's train step at full width and
    :data:`P15O_TRAIN_LAYERS` layer, float32, on (data 1, model 16), its
    8 experts on the 'expert_ff' fallback (every expert's 896 of 14 336
    FFN columns a rank) and its KV heads on replica groups of two, made
    blockwise (:func:`_blockwise_fp`): the first batch's gradients and
    the step's grad norm (``step.averaged_grads``) against the one-rank
    ones saved at ``ref_path + ".mixtral"``; then, where the predicted
    state fits (:func:`_p15o_update_gb`), :data:`P15O_TRAIN_STEPS` whole
    steps (norm, AdamW) against the one-rank steps saved at ``ref_path +
    ".mixtral_step"`` (:func:`_tp_train_vs_saved`)."""
    import torch.distributed as dist
    from repro_torch.training import train_loop as tl
    from repro_torch.training.optimizer import AdamWConfig
    model = _tp_mixtral(P15O_TRAIN_LAYERS)
    tp = mesh.shape[1]
    placed = _blockwise_fp(dev, model, seed, tp, mesh)
    step = tl.make_train_step(model, AdamWConfig(**P15O_OPT), mesh=mesh)
    b0 = tl.to_device(_p15o_batches()[0], dev)
    dist.barrier()
    _sync_dev(dev)
    t0 = time.perf_counter()
    loss, met, grads = step.averaged_grads(placed, b0)
    _sync_dev(dev)
    out = {"loss": float(loss), "grad_norm": float(met["grad_norm"]),
           "grads_ms": (time.perf_counter() - t0) * 1e3,
           "predicted_update_gb": _p15o_update_gb(model, tp),
           "rank_params": _rank_params(model, tp)}
    _wait_until(lambda: os.path.exists(ref_path + ".mixtral.done"), 900,
                "15o (vii)'s one-rank gradients")
    ref = torch.load(ref_path + ".mixtral", mmap=True, map_location="cpu")
    out["grads_excess_over_grad_tol"], out["grads_max_rel_err"] = \
        _grads_vs_saved(dev, grads, placed, ref, mesh, GRAD_TOL)
    out["local_moe"] = {k: tuple(t.to_local().shape) for k, t in
                        _leaves(placed).items() if "/moe/" in k}
    out["grads_peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    del ref, grads
    _free(dev)
    if out["predicted_update_gb"] <= P15O_RANK_BUDGET_GB:
        out["step"] = _tp_train_vs_saved(
            dev, seed, model, _p15o_batches(), P15O_OPT,
            ref_path + ".mixtral_step", "15o (vii)",
            ("stack", "list", "0", "b0", "moe"), placed=placed)
    del placed
    _free(dev)
    out["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    return out


def _p15o_grads_rank(dev, seed, ref_path, mesh):
    """15o (iv) on this rank: granite's tensor-parallel train step's
    gradients (``step.averaged_grads``: the loss, gradients and global
    grad norm the step updates with) on each batch of
    :func:`_p15o_batches`, all on the same parameters, made blockwise
    (:func:`_blockwise_fp`); the loss and the step's grad norm of each,
    and the first batch's gradient shards against the one-rank gradients
    saved at ``ref_path``."""
    import torch.distributed as dist
    from repro_torch.training import train_loop as tl
    from repro_torch.training.optimizer import AdamWConfig
    model = _tp_granite(P15O_TRAIN_LAYERS)
    placed = _blockwise_fp(dev, model, seed, mesh.shape[1], mesh)
    step = tl.make_train_step(model, AdamWConfig(**P15O_OPT), mesh=mesh)
    flat = dict(_leaves(placed))
    losses, norms, step_ms, worst, worst_rel = [], [], [], 0.0, 0.0
    dist.barrier()
    for i, b in enumerate(_p15o_batches()):
        b = tl.to_device(b, dev)
        _sync_dev(dev)
        t0 = time.perf_counter()
        loss, met, grads = step.averaged_grads(placed, b)
        norms.append(float(met["grad_norm"]))
        losses.append(float(loss))
        step_ms.append((time.perf_counter() - t0) * 1e3)
        if i == 0:
            _wait_until(lambda: os.path.exists(ref_path + ".done"), 900,
                        "15o (iv)'s one-rank gradients")
            ref = torch.load(ref_path, mmap=True, map_location="cpu")
            worst, worst_rel = _grads_vs_saved(dev, grads, placed, ref, mesh,
                                               GRAD_TOL)
            del ref
        del grads
    local = {k: tuple(t.to_local().shape) for k, t in flat.items()
             if "/attn/" in k}
    del placed, flat
    _free(dev)
    return {"losses": losses, "grad_norms": norms, "step_ms": step_ms,
            "grads_excess_over_grad_tol": worst,
            "grads_max_rel_err": worst_rel, "local_attention": local,
            "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9}


def _one_rank_grads_saved(dev, model, params, batches, path):
    """The one-rank loss and global grad norm of each of ``batches`` on
    ``params``, the first batch's gradients saved to ``path`` (then
    ``path + ".done"``)."""
    from repro_torch.training import train_loop as tl
    from repro_torch.training.optimizer import global_norm
    losses, norms = [], []
    for i, b in enumerate(batches):
        loss, _, g = tl._value_and_grad(model.train_loss, params,
                                        tl.to_device(b, dev))
        losses.append(float(loss))
        norms.append(float(global_norm(g)))
        if i == 0:
            torch.save({k: v.cpu() for k, v in _leaves(g).items()}, path)
        del g
    _free(dev)
    open(path + ".done", "w").close()
    return losses, norms


def _p15o_one_rank_grads(dev, seed, ref_path):
    """15o (iv)'s one-rank side: granite's whole tree of the same blocks,
    the loss and global grad norm of each batch, the first batch's
    gradients saved to ``ref_path`` (then ``ref_path + ".done"``); then
    (v)'s one-rank steps (:func:`_one_rank_train_saved`, saved to
    ``ref_path + ".step"``); then (vii)'s: mixtral's whole tree of the
    same blocks, its first batch's gradients (``ref_path + ".mixtral"``)
    and, where a rank's predicted state fits, its steps (``ref_path +
    ".mixtral_step"``). Returns each part's losses and norms."""
    model = _tp_granite(P15O_TRAIN_LAYERS)
    params = _blockwise_fp(dev, model, seed, P15O_RANKS)
    grads = _one_rank_grads_saved(dev, model, params, _p15o_batches(),
                                  ref_path)
    del params
    _free(dev)
    group = _one_rank_train_saved(dev, seed, _tp_granite_groups(),
                                  _p15o_group_batches(), P15O_GROUP_OPT,
                                  ref_path + ".step")
    model = _tp_mixtral(P15O_TRAIN_LAYERS)
    params = _blockwise_fp(dev, model, seed, P15O_RANKS)
    mixtral = {"grads": _one_rank_grads_saved(
        dev, model, params, _p15o_batches()[:1], ref_path + ".mixtral")}
    if _p15o_update_gb(model, P15O_RANKS) <= P15O_RANK_BUDGET_GB:
        mixtral["step"] = _one_rank_train_saved(
            dev, seed, model, _p15o_batches(), P15O_OPT,
            ref_path + ".mixtral_step", params=params)
    del params
    _free(dev)
    return grads, group, mixtral


def _p15o_ranks(seed, ref_path):
    """15o on one rank of sixteen sharing the card over gloo (run by
    ``run_local``)."""
    from repro_torch.distributed import group
    torch.backends.cuda.matmul.allow_tf32 = False     # float32 means float32
    return _p15o_rank(group.device(), seed, ref_path)


def phase15o(dev, seed, card):
    """15o (``--heads-parallel`` alone; in the full script after 15b-n):
    heads and FFN widths that the production mesh's 'model' axis of 16
    does not divide, on sixteen gloo ranks sharing the card (one
    ``run_local``) beside (iv)'s one-rank step here. Each rank holds its
    replica group's shard (``sharding.replica_groups``): a count ``n`` of
    q heads, KV heads or FFN columns is ``gcd(n, 16)`` shards, each held
    by ``16 / gcd`` ranks, and only the first rank of a q (or FFN) group
    adds its row-parallel product.

    (i) granite-3-8b, (ii) minitron-4b (arXiv:2407.14679) and (iii)
    minicpm3-4b (MLA, 40 heads) at full width and :data:`P15O_LAYERS`
    layer, float32, made and quantized SQuant w8 leaf by leaf, each rank
    making only its row slab (:func:`_leafwise_tp`), on (data 1, model
    16): granite 2 of 32 q heads and one of 8 KV heads a rank (two ranks
    a KV head), 800 of 12 800 FFN columns, its head replicated (vocab
    49 155); minitron 3 of 24 q heads and one KV head a rank, each shared
    by two ranks, 576 of 9 216 FFN columns, 16 000 of 256 000 vocabulary
    rows and of its untied head; minicpm3 5 of 40 heads a rank (two ranks
    each), 400 of 6 400 FFN columns. A prefill of :data:`P15O_PROMPT`,
    one 64-token chunk and 16 greedy decode steps under
    ``activate_mesh`` against the one-rank forward on rank 0 (its tokens
    fed to every rank), w8 float32 and bfloat16.

    (iv) granite's train step at :data:`P15O_TRAIN_LAYERS` layer in
    float32 on (data 1, model 16): its gradients (``step.averaged_grads``,
    what the step updates with) on :data:`P15O_TRAIN_STEPS` batches of
    :data:`P15O_TRAIN_BATCH`, each rank making only its shards from
    per-block seeds (:func:`_blockwise_fp`), its KV-head leaves whole on
    every rank (``tp_place``'s ``Replicate``) and narrowed in the forward;
    the one-rank gradients of the same blocks run here first; the grad
    norm is the step's own (``averaged_grads``' metrics). The AdamW
    update is not run at this width on the card: it does not fit (its
    vocabulary 49 155 leaves the float32 embedding, 0.8 GB, whole on every
    rank, and with its gradient, two moments and the update's new copies
    that is ~6 GB a rank; minitron's vocab-parallel tree still needs ~4.6
    GB: both ran out of memory on the card).

    (v) the whole train step (the step's norm, the clip, which binds, and
    the AdamW update) at 'model' 16 on granite's reduced config
    (:data:`P15O_GROUPS`: 6 q / 2 KV heads and d_ff 130, each on replica
    groups of 8 ranks, their leaves whole on every rank), 3 steps against
    the one-rank steps run here first.

    (vi) mixtral-8x7b (arXiv:2401.04088) served as (i)-(iii) are: its 8
    experts, which 16 does not divide, on the 'expert_ff' fallback (every
    rank holds every expert's 896 of 14 336 FFN columns: 3 x 8 kernel-B
    expert launches a layer a forward, ``wdown`` row-parallel), 2 of 32 q
    heads and one of 8 KV heads a rank (two ranks a KV head), 2 000 of
    32 000 vocabulary rows.

    (vii) mixtral's train step at :data:`P15O_TRAIN_LAYERS` layer in
    float32, made blockwise: the first batch's gradients and the step's
    grad norm against the one-rank ones; then, where a rank's predicted
    state (7 x its float32 parameters, :func:`_p15o_update_gb`) fits
    :data:`P15O_RANK_BUDGET_GB`, the whole step (norm, AdamW) for
    :data:`P15O_TRAIN_STEPS` steps against the one-rank steps, both
    one-rank parts run here first.

    Gates: every rank's kernel-B launches by local weight shape as the
    shards imply and kernel A's as the slabs imply, every rank the same
    logits and tokens, w8 float32 logits within 1e-4 of the one-rank
    forward's largest |logit| (bfloat16 reported); (iv)'s losses and grad
    norms within :data:`P15O_STEP_GATE` relative of the one-rank ones and
    every rank's gradient shards of the first batch within
    :data:`GRAD_TOL`; (v)'s losses and the step's grad norms within
    :data:`P15O_STEP_GATE` and every rank's final shards (the replica
    groups' whole leaves) within ``STEP_TOL`` of the one-rank parameters;
    (vii)'s as (iv)'s and, where the update ran, as (v)'s. Every rank's
    peak memory is reported."""
    import tempfile
    import shutil

    t_phase = time.perf_counter()
    work = tempfile.mkdtemp(prefix="chip_smoke_p15o_")
    ref_path = os.path.join(work, "one_rank.pt")

    try:
        t0 = time.perf_counter()
        plain = _p15o_one_rank_grads(dev, seed, ref_path)
        plain_s = time.perf_counter() - t0
        ranks, n_s, _ = _four_ranks_beside(
            dev, _p15o_ranks, (seed, ref_path), lambda: None,
            ranks=P15O_RANKS)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return _p15o_report(ranks, plain, plain_s, card, n_s, t_phase)


def _p15o_report(ranks, plain, plain_s, card, n_s, t_phase):
    """15o's gates and lines from the sixteen ranks' results and (iv)'s
    one-rank ``plain`` (losses, grad norms) run here in ``plain_s``;
    returns the launches, plans and local shapes :func:`drive_phase15`
    reports."""
    tp = len(ranks)
    note = "sixteen CUDA contexts share one card and every collective is " \
           "staged through host memory over gloo: agreement and launch " \
           "counts, not a speed-up over one rank"
    labels = {"granite": "(i) granite-3-8b, 2 of 32 q heads, 1 of 8 KV "
                         "heads (2 ranks a KV head), 800 of 12 800 FFN "
                         "columns a rank, the head replicated",
              "minitron": "(ii) minitron-4b (arXiv:2407.14679), 3 of 24 q "
                          "heads and 1 of 8 KV heads (2 ranks each), 576 "
                          "of 9 216 FFN columns, 16 000 of 256 000 "
                          "vocabulary rows a rank",
              "minicpm3": "(iii) minicpm3-4b (MLA), 5 of 40 heads (2 ranks "
                          "each), 400 of 6 400 FFN columns a rank",
              "mixtral": "(vi) mixtral-8x7b (arXiv:2401.04088), its 8 "
                         "experts on the 'expert_ff' fallback: every "
                         "expert's 896 of 14 336 FFN columns a rank (3 x 8 "
                         "expert launches a layer a forward), 2 of 32 q "
                         "heads, 1 of 8 KV heads (2 ranks a KV head), 2 000 "
                         "of 32 000 vocabulary rows a rank"}
    out = {"squant_flip": [], "squant_scale": [], "dequant_matmul": [],
           "plans": {}, "local_shapes": {}}
    for key, build in P15O_MODELS:
        rows = [dict(r[key], rank=r["rank"]) for r in ranks]
        cfg = build(P15O_LAYERS).cfg
        for r in rows:
            want_a = _slab_launches(r["buckets"], tp, r["rank"],
                                    _bank_slices(cfg))
            if r["kernel_a"] != want_a:
                raise AssertionError(f"15o {key}: rank {r['rank']} kernel A "
                                     f"{r['kernel_a']}, the slabs imply "
                                     f"{want_a}")
        _serve_rows_agree(rows, f"15o {key}")
        c0 = rows[0]["cases"]
        err = c0["w8 float32"]["max_abs_err_over_max_logit"]
        shapes = _p15o_shapes(cfg, tp, 1)
        emit({"phase": f"15o heads, FFN widths and experts 'model' 16 does "
                       f"not divide, {tp} ranks sharing the card (gloo), mesh "
                       f"(data 1, model {tp}), {labels[key]}; SQuant w8 at "
                       f"full width, {P15O_LAYERS} layer, float32, made and "
                       f"quantized leaf by leaf on the ranks' slabs",
              "card": card, "backend": "gloo", "ranks": tp,
              "prompt": list(P15O_PROMPT),
              "chunks": [P15_CHUNK] * P15O_CHUNKS,
              "decode_steps": P15O_STEPS,
              "local_shapes": sorted(f"{m}x{n}" for m, n in shapes),
              "kernel_a_by_rank": [r["kernel_a"] for r in rows],
              "build_and_quantize_ms_by_rank": [
                  r["build_and_quantize_ms"] for r in rows],
              "build_peak_gb_by_rank": [r["build_peak_gb"] for r in rows],
              "local_tree_gb_by_rank": [r["local_gb"] for r in rows],
              "cases": {n: _serve_cell(c0[n]) for n in c0},
              "gate": "w8 float32 logits within 1e-4 of the one-rank "
                      "forward's largest |logit|, fed the one-rank tokens; "
                      "bfloat16 reported",
              "peak_gb_by_rank": [r["peak_gb"] for r in rows],
              "seconds_by_rank": [r["seconds"] for r in rows],
              "note": note})
        if not err <= 1e-4:
            raise AssertionError(f"15o {key}: w8 float32 logits {err} of "
                                 f"the largest, over 1e-4")
        out["squant_flip"].append([r["kernel_a"]["squant_flip"]
                                   for r in rows])
        out["squant_scale"].append([r["kernel_a"]["squant_scale"]
                                    for r in rows])
        out["dequant_matmul"].append([sum(c["kernel_b"] for c in
                                          r["cases"].values()) for r in rows])
        out["plans"][f"15o {key}"] = rows[0]["plans"]
        out["local_shapes"][key] = sorted(shapes)
    # the per-model lists summed by rank
    for k in ("squant_flip", "squant_scale", "dequant_matmul"):
        out[k] = [sum(v) for v in zip(*out[k])]
    (plain_losses, plain_norms), group, mixtral = plain
    t_s = [r["train"] for r in ranks]
    worst_loss = max(abs(a - b) / abs(b) for r in t_s
                     for a, b in zip(r["losses"], plain_losses))
    worst_norm = max(abs(a - b) / abs(b) for r in t_s
                     for a, b in zip(r["grad_norms"], plain_norms))
    excess = max(r["grads_excess_over_grad_tol"] for r in t_s)
    emit({"phase": f"15o (iv) granite-3-8b train-step gradients on replica "
                   f"groups, {tp} ranks sharing the card (gloo), mesh (data "
                   f"1, model {tp}), full width, {P15O_TRAIN_LAYERS} of 40 "
                   f"layers, float32; the KV heads' leaves whole on every "
                   f"rank; the step's gradients and grad norm, the AdamW "
                   f"update not run at this width (its state does not fit "
                   f"sixteen ranks on one card; (v) runs it)", "card": card,
          "backend": "gloo", "ranks": tp, "batches": P15O_TRAIN_STEPS,
          "global_batch": list(P15O_TRAIN_BATCH),
          "losses": t_s[0]["losses"], "one_rank_losses": plain_losses,
          "grad_norms": t_s[0]["grad_norms"],
          "one_rank_grad_norms": plain_norms,
          "max_rel_diff_loss": worst_loss,
          "max_rel_diff_grad_norm": worst_norm, "gate": P15O_STEP_GATE,
          "grads_max_excess_over_grad_tol": excess,
          "grad_tol": GRAD_TOL,
          "grads_max_rel_err_by_rank": [r["grads_max_rel_err"]
                                        for r in t_s],
          "local_attention_shards": t_s[0]["local_attention"],
          "ms_by_batch_rank0": t_s[0]["step_ms"],
          "peak_gb_by_rank": [r["peak_gb"] for r in t_s],
          "one_rank_seconds": plain_s,
          "seconds_by_rank": [r["seconds"] for r in t_s],
          "run_local_seconds": n_s,
          "seconds_since_the_ranks_started": time.perf_counter() - t_phase,
          "note": note})
    if not (worst_loss <= P15O_STEP_GATE and worst_norm <= P15O_STEP_GATE
            and excess <= 0):
        raise AssertionError(f"15o (iv): losses {worst_loss}, grad norms "
                             f"{worst_norm}, gradients over GRAD_TOL by "
                             f"{excess}")
    g_losses, g_norms = group
    g_s = [r["group_step"] for r in ranks]
    g_loss = max(abs(a - b) / abs(b) for r in g_s
                 for a, b in zip(r["losses"], g_losses))
    g_norm = max(abs(a - b) / abs(b) for r in g_s
                 for a, b in zip(r["grad_norms"], g_norms))
    g_excess = max(r["shards_excess_over_step_tol"] for r in g_s)
    emit({"phase": f"15o (v) the train step with its norm, clip and AdamW "
                   f"update on replica groups, {tp} ranks sharing the card "
                   f"(gloo), mesh (data 1, model {tp}): granite-3-8b's "
                   f"reduced config with 6 q / 2 KV heads and d_ff 130 "
                   f"(each on replica groups of 8 ranks, their leaves whole "
                   f"on every rank), float32", "card": card,
          "backend": "gloo", "ranks": tp, "config": P15O_GROUPS,
          "opt": P15O_GROUP_OPT, "steps": P15O_GROUP_STEPS,
          "global_batch": list(P15O_GROUP_BATCH),
          "losses": g_s[0]["losses"], "one_rank_losses": g_losses,
          "grad_norms": g_s[0]["grad_norms"], "one_rank_grad_norms": g_norms,
          "max_rel_diff_loss": g_loss, "max_rel_diff_grad_norm": g_norm,
          "gate": P15O_STEP_GATE,
          "shards_max_excess_over_step_tol": g_excess,
          "step_tol": STEP_TOL, "local_shards": g_s[0]["local_shards"],
          "ms_by_step_rank0": g_s[0]["step_ms"],
          "split_ms_rank0": g_s[0]["split_ms"],
          "seconds_by_rank": [r["seconds"] for r in g_s], "note": note})
    if not (g_loss <= P15O_STEP_GATE and g_norm <= P15O_STEP_GATE
            and g_excess <= 0):
        raise AssertionError(f"15o (v): losses {g_loss}, grad norms "
                             f"{g_norm}, shards over STEP_TOL by {g_excess}")
    _p15o_mixtral_report([r["mixtral_train"] for r in ranks], mixtral, card,
                         note)
    return out


def _p15o_mixtral_report(m_s, plain, card, note):
    """15o (vii)'s line and gates: each rank's first-batch loss and grad
    norm within :data:`P15O_STEP_GATE` of the one-rank ones and its
    gradient shards within :data:`GRAD_TOL`; where the update ran,
    (v)'s gates on its steps."""
    tp = len(m_s)
    (g_losses, g_norms) = plain["grads"]
    loss = max(abs(r["loss"] - g_losses[0]) / abs(g_losses[0]) for r in m_s)
    norm = max(abs(r["grad_norm"] - g_norms[0]) / abs(g_norms[0])
               for r in m_s)
    excess = max(r["grads_excess_over_grad_tol"] for r in m_s)
    pred = m_s[0]["predicted_update_gb"]
    line = {"phase": f"15o (vii) mixtral-8x7b train step, its 8 experts on "
                     f"the 'expert_ff' fallback, {tp} ranks sharing the card "
                     f"(gloo), mesh (data 1, model {tp}), full width, "
                     f"{P15O_TRAIN_LAYERS} of 32 layers, float32",
            "card": card, "backend": "gloo", "ranks": tp,
            "global_batch": list(P15O_TRAIN_BATCH),
            "rank_params": m_s[0]["rank_params"],
            "predicted_update_gb_a_rank": pred,
            "budget_gb_a_rank": P15O_RANK_BUDGET_GB,
            "update_run": "step" in m_s[0],
            "loss": m_s[0]["loss"], "one_rank_loss": g_losses[0],
            "grad_norm": m_s[0]["grad_norm"], "one_rank_grad_norm": g_norms[0],
            "max_rel_diff_loss": loss, "max_rel_diff_grad_norm": norm,
            "gate": P15O_STEP_GATE,
            "grads_max_excess_over_grad_tol": excess,
            "grad_tol": GRAD_TOL,
            "grads_max_rel_err_by_rank": [r["grads_max_rel_err"]
                                          for r in m_s],
            "local_moe_shards": m_s[0]["local_moe"],
            "grads_ms_by_rank": [r["grads_ms"] for r in m_s],
            "grads_peak_gb_by_rank": [r["grads_peak_gb"] for r in m_s],
            "peak_gb_by_rank": [r["peak_gb"] for r in m_s],
            "seconds_by_rank": [r["seconds"] for r in m_s], "note": note}
    gates = [loss <= P15O_STEP_GATE, norm <= P15O_STEP_GATE, excess <= 0]
    if "step" in m_s[0]:
        st = [r["step"] for r in m_s]
        s_losses, s_norms = plain["step"]
        s_loss = max(abs(a - b) / abs(b) for r in st
                     for a, b in zip(r["losses"], s_losses))
        s_norm = max(abs(a - b) / abs(b) for r in st
                     for a, b in zip(r["grad_norms"], s_norms))
        s_excess = max(r["shards_excess_over_step_tol"] for r in st)
        line.update({"steps": P15O_TRAIN_STEPS, "opt": P15O_OPT,
                     "losses": st[0]["losses"], "one_rank_losses": s_losses,
                     "grad_norms": st[0]["grad_norms"],
                     "one_rank_grad_norms": s_norms,
                     "steps_max_rel_diff_loss": s_loss,
                     "steps_max_rel_diff_grad_norm": s_norm,
                     "shards_max_excess_over_step_tol": s_excess,
                     "step_tol": STEP_TOL,
                     "ms_by_step_rank0": st[0]["step_ms"],
                     "split_ms_rank0": st[0]["split_ms"],
                     "step_peak_gb_by_rank": [r["peak_gb"] for r in st]})
        gates += [s_loss <= P15O_STEP_GATE, s_norm <= P15O_STEP_GATE,
                  s_excess <= 0]
    emit(line)
    if not all(gates):
        raise AssertionError(f"15o (vii): gates {gates} (losses, norms, "
                             f"gradients; the steps' losses, norms, shards)")


def _phase15o_cells(o):
    """Phase 2's kernel-B cells of 15o (label, M, N, rows), timed with
    float32 activations (the path's dtype): each local weight shape of
    the three models' shards at the decode batch and the prefill's
    rows."""
    b, rows = P15O_PROMPT[0], P15O_PROMPT[0] * P15O_PROMPT[1]
    out = []
    for key, shapes in o["local_shapes"].items():
        for m, n in shapes:
            out += [(f"15o {key} local {m}x{n} decode", m, n, b),
                    (f"15o {key} local {m}x{n} prefill", m, n, rows)]
    return out


def drive_phase15(dev, seed, layers, card, memory):
    """Phase 15 (15a, 15b-d, 15e-f, 15g-h, 15i-k, 15l-n, 15o), memory
    gated like a phase's; returns the kernels' launches by part, and
    15e's, 15g's, 15i's, 15j's, 15l's, 15m's and 15o's kernel-B launch
    shapes (``plans``) and local weight shapes for phase 2."""
    t0 = time.perf_counter()
    a = phase15a(dev, seed, layers)
    phase_memory("15a", memory)
    bcd = phase15bcd(dev, seed, card)
    ef, gh, mr, rec = bcd["tp"], bcd["ep"], bcd["mr"], bcd["rec"]
    phase_memory("15b-n", memory)
    t_o = time.perf_counter()
    o = phase15o(dev, seed, card)
    phase_memory("15o", memory)
    emit({"phase": "15 seconds", "seconds": time.perf_counter() - t0,
          "15o_seconds": time.perf_counter() - t_o})
    return {"squant_flip": {"15a": a["squant_flip"],
                            "15b_by_rank": bcd["squant_flip"],
                            "15e_by_rank": ef["squant_flip"],
                            "15g_by_rank": gh["squant_flip"],
                            "15i_by_rank": mr["squant_flip"],
                            "15j_by_rank": mr["squant_flip_15j"],
                            "15l_by_rank": rec["squant_flip_15l"],
                            "15m_by_rank": rec["squant_flip_15m"],
                            "15o_by_rank": o["squant_flip"]},
            "squant_scale": {"15a": a["squant_scale"],
                             "15b_by_rank": bcd["squant_scale"],
                             "15e_by_rank": ef["squant_scale"],
                             "15g_by_rank": gh["squant_scale"],
                             "15i_by_rank": mr["squant_scale"],
                             "15j_by_rank": mr["squant_scale_15j"],
                             "15l_by_rank": rec["squant_scale_15l"],
                             "15m_by_rank": rec["squant_scale_15m"],
                             "15o_by_rank": o["squant_scale"]},
            "dequant_matmul": {"15a": a["dequant_matmul"],
                               "15e_by_rank": ef["dequant_matmul"],
                               "15g_by_rank": gh["dequant_matmul"],
                               "15i_by_rank": mr["dequant_matmul"],
                               "15j_by_rank": mr["dequant_matmul_15j"],
                               "15l_by_rank": rec["dequant_matmul_15l"],
                               "15m_by_rank": rec["dequant_matmul_15m"],
                               "15o_by_rank": o["dequant_matmul"]},
            "plans": {"15e": ef["plans"], "15p": ef["plans_15p"],
                      "15g": gh["plans"], **mr["plans"], **rec["plans"],
                      **o["plans"]},
            "local_shapes": ef["local_shapes"],
            "encdec_local_shapes": ef["encdec_local_shapes"],
            "ep_local_shapes": gh["local_shapes"],
            "ep_capacity_rows": gh["capacity_rows"],
            "mla_ring": mr, "recurrent": rec, "heads": o}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--layers", type=int, default=40,
                    help="depth of the w8 runs of phases 3 and 6 (40 = the "
                    "full model)")
    ap.add_argument("--layers4", type=int, default=4,
                    help="depth of the w4 main-path run")
    ap.add_argument("--layers7", type=int, default=4,
                    help="depth of the int8-KV continuous run")
    ap.add_argument("--layers8", type=int, default=4,
                    help="depth of the speculative run (w8 verifier, w4 "
                    "drafter; 4 of 40 since 15o (vi)-(vii) and 15p-q came, "
                    "6 since phases 15l-n came, 12 since phase 15 came, to "
                    "keep the script inside its time limit)")
    ap.add_argument("--layers9", type=int, default=4,
                    help="depth of the native checkpoint run (9a; 4 of 40 "
                    "since 15o (vi)-(vii) and 15p-q came, 6 since phases "
                    "15l-n came, 12 since phase 15 came, to keep the script "
                    "inside its time limit; its kernel-B count is then held "
                    "to phase 6's tree served at the same depth)")
    ap.add_argument("--layers10", type=int, default=1,
                    help="depth of the MoE run (10a; 1 of moonshot's 48 "
                    "layers since phase 15o came, 2 since phases 15l-n "
                    "came, 4 since phases 15e-f "
                    "came, 8 since phase 15 came, to keep the script inside "
                    "its time limit; 16 fit one 80 GB card in float32 "
                    "before quantization)")
    ap.add_argument("--layers11", type=int, default=8,
                    help="depth of the full-width training run (11a; 8 of "
                    "granite's 40 layers: float32 weights, grads and AdamW "
                    "moments of 40 layers do not fit one card)")
    ap.add_argument("--layers12", type=int, default=1,
                    help="depth of the sliding-window + MoE run (12b; 1 of "
                    "mixtral's 32 layers since 15o (vi)-(vii) and 15p-q "
                    "came, 2 since phases 15l-n came, 4 since phase 15 "
                    "came, to keep the script inside its time limit; 32 "
                    "layers of float32 weights are ~180 GB)")
    ap.add_argument("--layers12a", type=int, default=8,
                    help="depth of the MLA run (12a; 8 of minicpm3's 62 "
                    "layers since phase 15i came, to keep the script inside "
                    "its time limit; 15i serves the same width "
                    "tensor-parallel)")
    ap.add_argument("--layers13", type=int, default=4,
                    help="depth of the rwkv run (13a; 4 of rwkv's 24 layers "
                    "since phase 15m came, to keep the script inside its "
                    "time limit: 15m serves the same width tensor-parallel; "
                    "24 = the full model)")
    ap.add_argument("--layers15", type=int, default=2,
                    help="depth of the one-rank mesh run (15a; 2 of "
                    "granite's 40 layers since 15o (vi)-(vii) and 15p-q "
                    "came, 4 before, to keep the script inside its time "
                    "limit)")
    ap.add_argument("--train-steps", type=int, default=200,
                    help="training steps of the trained models of 11b and "
                    "11c (ii) (200 since phase 15o came, 300 since phases "
                    "15l-n came, 600 before, to keep the script inside its "
                    "time limit)")
    ap.add_argument("--capture-sync-probe", action="store_true",
                    help="only print what another thread's stream and "
                    "device synchronization do to a CUDA-graph capture "
                    "(phase 9b runs this in a process of its own)")
    ap.add_argument("--agreement-variants", action="store_true",
                    help="only build, then measure phase 6's and 7's "
                    "agreement with one kernel at a time swapped for its "
                    "plain version, and with float32 activations (and "
                    "--profile, if given); prints no ok line")
    ap.add_argument("--tensor-parallel", action="store_true",
                    help="only build, then run phases 15e, 15f, 15p and 15q "
                    "(tensor-parallel serving and training of granite and "
                    "of the encoder-decoder on four gloo ranks sharing the "
                    "card); prints no ok line")
    ap.add_argument("--expert-parallel", action="store_true",
                    help="only build, then run phases 15g and 15h "
                    "(expert-parallel MoE serving and training on four "
                    "gloo ranks sharing the card); prints no ok line")
    ap.add_argument("--mla-ring-parallel", action="store_true",
                    help="only build, then run phases 15i, 15j and 15k (MLA "
                    "and the sliding-window ring under tensor-parallel "
                    "serving, MLA training, on four gloo ranks sharing the "
                    "card); prints no ok line")
    ap.add_argument("--recurrent-parallel", action="store_true",
                    help="only build, then run phases 15l, 15m and 15n "
                    "(mamba and rwkv under tensor-parallel serving, rwkv "
                    "training, on four gloo ranks sharing the card); prints "
                    "no ok line")
    ap.add_argument("--heads-parallel", action="store_true",
                    help="only build, then run phase 15o (heads, FFN "
                    "widths and experts 'model' 16 does not divide: "
                    "granite, minitron, minicpm3 and mixtral serving, "
                    "granite and mixtral training, on sixteen gloo ranks "
                    "sharing the card); prints no ok line")
    ap.add_argument("--profile", action="store_true",
                    help="also trace a few decode steps and admission chunk "
                    "forwards (the paged ones captured and eager), a verify "
                    "forward and a draft chain, and one quantize_tree of "
                    "the tree with torch.profiler and print where their "
                    "time goes")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this script measures the port on a GPU and has no CPU "
              "mode", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    if args.capture_sync_probe:
        emit(capture_sync_probe(dev))
        return 0
    torch.backends.cuda.matmul.allow_tf32 = False     # float32 means float32
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    built = _build.build_all()
    emit({"phase": "1 card and build", "card": card, "python": sys.version.split()[0],
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "build_seconds": built, "nvcc_flags": " ".join(_build.NVCC_FLAGS)})

    if args.tensor_parallel:
        phase15ef(dev, args.seed, card)
        return 1
    if args.expert_parallel:
        phase15gh(dev, args.seed, card)
        return 1
    if args.mla_ring_parallel:
        phase15ijk(dev, args.seed, card)
        return 1
    if args.recurrent_parallel:
        phase15lmn(dev, args.seed, card)
        return 1
    if args.heads_parallel:
        t0 = time.perf_counter()
        phase15o(dev, args.seed, card)
        emit({"phase": "15o seconds", "seconds": time.perf_counter() - t0})
        return 1
    if args.agreement_variants:
        agreement_variants(dev, args.seed, args.layers, args.layers7)
        if args.profile:
            profile_decode(dev, args.seed, args.layers)
        return 1

    lengths, max_batch, max_new, _ = ROUND_TRAFFIC   # two rounds of 4
    # The reduced-depth w4 run goes first: it also pays the one-time costs
    # (loading the kernels' libraries, cuBLAS and allocator start-up), so the
    # full-depth run's times are the path's own. Both run before phase 2,
    # which times kernel A at the bucket shapes the full-depth tree produced.
    memory = []
    drive(dev, args.seed, args.layers4, 4, lengths, max_batch, max_new,
          "4 main path, granite-3-8b w4")
    phase_memory("4", memory)
    a_n, b_n, buckets, s_n = drive(dev, args.seed, args.layers, 8, lengths,
                                  max_batch, max_new,
                                  "3 main path, granite-3-8b w8")
    phase_memory("3", memory)

    _, b6_n, c_n, path_lengths, _ = drive_continuous(
        dev, args.seed, args.layers,
        "6 main path, continuous + paged + chunked, granite-3-8b w8")
    phase_memory("6", memory)
    _, _, d_n, _, _ = drive_continuous(
        dev, args.seed, args.layers7,
        "7 int8 KV, continuous + paged + chunked, granite-3-8b w8",
        quantize_kv=True)
    phase_memory("7", memory)
    b8_n, c8_n, draft_rows = drive_speculative(dev, args.seed, args.layers8,
                                               profile=args.profile)
    phase_memory("8", memory)
    a9_n, b9_n, c9_n = drive_native_checkpoint(
        dev, args.seed, args.layers9,
        b6_n if args.layers9 == args.layers else None)
    phase_memory("9a", memory)
    t9 = time.perf_counter()
    drive_live_reload(dev, args.seed)
    phase_memory("9 live reload", memory)
    probe = run_capture_sync_probe()
    emit({"phase": "9b a synchronization in another thread during a "
                   "capture (thread_local), in a process of its own",
          "probe": probe, "seconds": time.perf_counter() - t9})
    if not probe.get("stream_sync", {}).get("capture_ok"):
        raise AssertionError(f"a stream synchronization in another thread "
                             f"broke a capture: {probe}")
    drive_clis(dev)
    a10_n, b10_n, c10_n, moe_lengths, moe_entry = drive_moe(
        dev, args.seed, args.layers10, profile=args.profile)
    phase_memory("10", memory)
    l11, s11 = drive_training(dev, args.seed, args.layers11,
                              args.train_steps, card, memory)
    l12, s12 = drive_phase12(dev, args.seed, args.layers12, memory,
                             args.layers12a)
    l13, s13 = drive_phase13(dev, args.seed, args.layers13, memory)
    l14, s14 = drive_phase14(dev, args.seed, card, memory)
    l15 = drive_phase15(dev, args.seed, args.layers15, card, memory)

    from repro_torch.configs import get_config
    moe_cfg = get_config(MOE_ARCH)
    e, layers10 = moe_cfg.moe.n_experts, args.layers10
    banks = moe_expert_shapes(moe_cfg)
    # phase 10's buckets: wi and wg, wdown (expert slices), attention
    moe_buckets = [(2 * layers10 * e, e, moe_cfg.d_model, moe_cfg.d_ff),
                   (layers10 * e, e, moe_cfg.d_ff, moe_cfg.d_model),
                   (4 * layers10, 1, moe_cfg.d_model, moe_cfg.d_model)]
    # the capacity of a monolithic admission of phase 10's longest prompt
    longest = max(moe_entry["prompt_lengths"])
    mono = math.ceil(longest * moe_cfg.moe.top_k
                     * moe_cfg.moe.capacity_factor / e)

    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    # phase 11's trees at 8 and 4 bits (the w8 tree and the drafter's w4),
    # compared; phase 12's and 13's at 8 bits, compared and timed
    ka, ks = check_kernel_a(dev, gen, buckets, moe_buckets, {
        "11": {"bits": (8, 4), "timed": False, "parts": s11["a"]},
        "12": {"bits": (8,), "timed": True, "parts": s12["a"]},
        "13": {"bits": (8,), "timed": True, "parts": s13["a"]},
        "14": {"bits": (8,), "timed": True, "parts": s14["a"]}})
    mla, swa = get_config(MLA_ARCH), get_config(SWA_ARCH)
    kv_down = (mla.mla.kv_lora + mla.mla.rope_dim, mla.d_model)
    kv_up = (mla.n_heads * (mla.mla.nope_dim + mla.mla.v_dim),
             mla.mla.kv_lora)
    slots, max_len = contiguous_config().max_slots, contiguous_config().max_len
    phase12 = {"timed": [("kv_down decode", *kv_down, slots),
                         ("kv_down 64-row chunk", *kv_down, 64),
                         ("kv_up re-expansion at decode", *kv_up,
                          slots * max_len)],
               "experts": {"n_experts": swa.moe.n_experts,
                           "banks": moe_expert_shapes(swa), "rows": [slots]}}
    rwkv, jamba = get_config(RWKV_ARCH), get_config(JAMBA_ARCH)
    j_in = 2 * jamba.mamba.expand * jamba.d_model
    phase13 = {"timed": [("w_lora_b decode (K = 64)", rwkv.d_model, 64,
                          slots),
                         ("w_lora_b 64-row chunk (K = 64)", rwkv.d_model, 64,
                          64),
                         ("w_lora_a decode", 64, rwkv.d_model, slots),
                         ("jamba in_proj decode", j_in, jamba.d_model, slots),
                         ("jamba in_proj 512 rows", j_in, jamba.d_model, 512)],
               "experts": {"n_experts": jamba.moe.n_experts,
                           "banks": moe_expert_shapes(jamba),
                           "rows": [slots]}}
    sm = get_config(SEAMLESS_ARCH)
    d, f, v = sm.d_model, sm.d_ff, sm.vocab
    sb = ENCDEC_BATCH
    sp = sb * ENCDEC_PROMPT
    phase14 = [("q/k/v/o decode", d, d, sb), ("q/k/v/o prefill", d, d, sp),
               ("ffn in decode", f, d, sb), ("ffn in prefill", f, d, sp),
               ("ffn down decode", d, f, sb),
               ("ffn down prefill", d, f, sp),
               ("cross K/V (8 x 64 frame rows)", d, d,
                sb * ENCDEC_PROMPT // sm.enc_ratio),
               ("head decode", v, d, sb), ("head prefill", v, d, sp)]
    moe_local_banks = {(m, n) for _, m, n in banks}
    # phase 6's decode batch (its slots) first, then the round path's; the
    # prefill rows: phase 6's admission chunk and the round path's prefills
    prefill_rows = [paged_config().prefill_chunk, 2 * 128, 4 * 96]
    kb = check_kernel_b(dev, gen, (paged_config().max_slots, max_batch),
                        prefill_rows, (min(draft_rows), max(draft_rows)),
                        experts={"n_experts": e, "banks": banks,
                                 "rows": [paged_config().max_slots, mono]},
                        plans={"11": s11["b"], "12": s12["b"],
                               "13": s13["b"], "14": s14["b"],
                               "15": l15.pop("plans")},
                        phase12=phase12, phase13=phase13, phase14=phase14,
                        phase15=[(f"15e local {m}x{n} decode", m, n,
                                  P15E_PROMPT[0])
                                 for m, n in l15.pop("local_shapes")]
                        + [(f"15p local {m}x{n} decode", m, n,
                            P15P_PROMPT[0])
                           for m, n in l15.pop("encdec_local_shapes")]
                        + [(f"15g local {m}x{n} decode", m, n,
                            P15G_PROMPT[0])
                           for m, n in l15["ep_local_shapes"]]
                        + [(f"15g local expert {m}x{n} prefill capacity",
                            m, n, l15["ep_capacity_rows"])
                           for m, n in l15.pop("ep_local_shapes")
                           if (m, n) in moe_local_banks],
                        phase15ij=_phase15ij_cells(l15.pop("mla_ring")),
                        phase15lm=_phase15lm_cells(l15.pop("recurrent")),
                        phase15o=_phase15o_cells(l15.pop("heads")))
    kc, kd = check_kernels_cd(dev, gen, path_lengths, moe_lengths, s11["c"])
    emit({"phase": "2 kernels vs plain versions", "squant_flip": {
        k: ka[k] for k in ("tie_rule", "max_abs_err", "tolerance",
                           "trees_compared")},
        "dequant_matmul": {k: kb[k] for k in (
            "comparisons", "max_rel_err", "tolerance",
            "launch_shapes_compared", "phase12", "phase13", "phase14",
            "phase15", "phase15ij", "phase15lm", "phase15o")},
        "paged_attention": {k: kc[k] for k in (
            "max_abs_err", "max_abs_err_float32", "tolerance", "trained")},
        "paged_attention_quant": {k: kd[k] for k in (
            "max_abs_err", "max_abs_err_float32", "tolerance")}})
    phase_memory("2", memory)
    slice_vs_plain(dev, args.seed)
    phase_memory("5", memory)
    emit({"phase": "device memory allocated after each phase (GB; after "
                   "the phase returned, and after a garbage collection)",
          "phases": memory})
    if args.profile:
        profile_decode(dev, args.seed, args.layers)
        profile_quantize(dev, args.seed, args.layers)

    ka["launches"], kb["launches"], ks["launches"] = a_n, b_n, s_n
    kb["launches_phase6"], kb["launches_phase8"] = b6_n, b8_n
    kc["launches"], kd["launches"] = c_n, d_n
    kc["launches_phase8"] = c8_n
    ka["launches_phase9"] = a9_n
    kb["launches_phase9"], kc["launches_phase9"] = b9_n, c9_n
    ka["launches_phase10"], kb["launches_phase10"] = a10_n, b10_n
    kc["launches_phase10"] = c10_n
    ks["launches_phase10"] = moe_entry["quantize"]["launches"][
        "squant_scale"]
    kb["launches_phase10_by_part"] = moe_entry["launches"][
        "dequant_matmul_by_part"]
    for k in (ka, kb, kc, ks):
        k["launches_phase11"] = l11[k["name"]]
    for k in (ka, kb, ks):
        k["launches_phase12"] = l12[k["name"]]
        k["launches_phase13"] = l13[k["name"]]
        k["launches_phase14"] = l14[k["name"]]
    kb["launches_phase14_by_variant"] = l14["dequant_matmul_by_variant"]
    for k in (ka, kb, ks):
        k["launches_phase15"] = l15[k["name"]]
    emit({"seconds": time.perf_counter() - t_start})
    print(card, flush=True)
    emit({"kernels": [ka, kb, kc, kd, ks]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
