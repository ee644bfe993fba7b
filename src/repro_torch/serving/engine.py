"""Serving engine: a thin front over the slot scheduler.

The request path SQuant enables: load fp weights → on-the-fly data-free
quantization (no data, no BP — the paper's "on-the-fly framework") → serve
int8/int4 weights with dequant-on-the-fly matmuls.

Scheduling lives in :mod:`repro_torch.serving.scheduler`:

* ``scheduler="round"`` (default) — static rounds of up to ``max_batch``
  left-padded requests; every request in a round waits for the longest one,
  and weight swaps land only between rounds.
* ``scheduler="continuous"`` — a fixed pool of ``max_slots`` decode slots
  over one persistent KV cache: queued requests are admitted into free
  slots at step boundaries, retire on EOS/max-tokens immediately, and a
  staged weight reload drains admission and swaps at a step boundary
  (force-swap after ``swap_deadline_ms``). With ``prefill_chunk > 0`` an
  admission prefill is consumed chunk by chunk across engine steps while
  resident slots keep decoding.

KV-cache layout is a separate axis (``kv_backend``, see
:mod:`repro_torch.serving.kvcache`): ``"contiguous"`` keeps one cache row
per slot; ``"paged"`` (continuous scheduler only) stores K/V in fixed-size
blocks behind per-slot block tables with refcounted shared-prefix reuse and
copy-on-write, decoded through the paged-attention kernel. ``quantize_kv``
stores int8 codes with per-(position, kv-head) scales in either layout.

Weight ownership lives in :class:`repro_torch.serving.weights.WeightStore`,
not the engine: the scheduler *acquires* a weight version at its swap points
and pins it per round, so a concurrent reload can never tear an in-flight
request. ``Completion`` reports ``prefill_ms``/``decode_ms``/``swap_ms`` and
the pinned ``weights_version``.

Self-speculative decoding (``speculative=True``, paged continuous and
greedy only): the store stages (target, draft) pairs, the draft tree
``draft_bits`` wide from the same fp source, and the scheduler runs
draft→verify cycles (:mod:`repro_torch.serving.speculative`) whose tokens
are bit-identical to verifier-only decode.

The compiled step: where the reference jits its forwards and counts the
traces (``trace_counts``), this engine captures CUDA graphs and counts the
captures under the same keys (four, plus ``verify``, ``spec_carry``,
``draft_prefill``, ``draft_chain`` and ``draft_admit`` when speculation is
on). On a CUDA device the paged decode step (one graph at ``(max_slots,
1)``), each admission-chunk width of the paged chunked admission (one graph
per width, on the 1-row side cache), the verify forward (one graph per
``S = k_eff + 1``, its verdict argmax inside) and the draft chain (one graph
per ``k_eff``) are captured on first use and replayed after. Everything
else runs eagerly and its key stays 0: the round scheduler, the contiguous
continuous path (a host-integer shared clock), monolithic admission prefill
and ``admit_rows``, the drafter's admission prefill and row copy, the carry
install (``ROADMAP.md`` M1b); quantization is outside the step. All graphs
are dropped, and captured again on next use, when the scheduler acquires a
new weight version. On the CPU everything runs eagerly and the counts stay
0.

Every ``ServeConfig`` field and every validity-gate row of the reference
package is kept.
"""
from __future__ import annotations

import collections
import dataclasses
import gc
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch

from repro_torch.kernels import ops
from repro_torch.serving.api import Completion, Request
from repro_torch.serving.kvcache import admit_rows
from repro_torch.serving.scheduler import ContinuousScheduler, RoundScheduler
from repro_torch.serving.weights import (WeightStore, make_draft_quantize_fn,
                                         make_weight_pipeline)

__all__ = ["ServeConfig", "Request", "Completion", "ServeEngine",
           "CONFIG_GATES", "ConfigGate", "ARCH_GATES", "ArchGate"]

# ---------------------------------------------------------------------------
# declarative config validation
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ConfigGate:
    """One row of the ServeConfig validity matrix: ``invalid(cfg)`` true
    means the config is rejected with ``error(message)``. Feature-pair
    gates use the uniform ``"unsupported combination: ..."`` prefix;
    plain range/enum rows keep their direct messages. The table replaces
    the accreted ``__post_init__`` if-chain so a new feature lands as a
    row (and one parametrized test enumerates every row), not a branch."""
    name: str
    invalid: Callable[["ServeConfig"], bool]
    error: type
    message: Union[str, Callable[["ServeConfig"], str]]

    def check(self, cfg: "ServeConfig") -> None:
        if self.invalid(cfg):
            msg = self.message(cfg) if callable(self.message) \
                else self.message
            raise self.error(msg)


CONFIG_GATES: Tuple[ConfigGate, ...] = (
    # ---- range / enum rows -------------------------------------------------
    ConfigGate(
        "prefill_chunk_range",
        lambda c: c.prefill_chunk < 0, ValueError,
        "prefill_chunk must be >= 0"),
    ConfigGate(
        "kv_backend_enum",
        lambda c: c.kv_backend not in ("contiguous", "paged"), ValueError,
        lambda c: f"unknown kv_backend {c.kv_backend!r} "
                  "(expected 'contiguous' or 'paged')"),
    ConfigGate(
        "block_size_range",
        lambda c: c.kv_backend == "paged" and c.block_size < 1, ValueError,
        "block_size must be >= 1"),
    ConfigGate(
        "block_size_divides",
        lambda c: c.kv_backend == "paged" and c.block_size >= 1
        and c.max_len % c.block_size != 0, ValueError,
        lambda c: f"block_size ({c.block_size}) must divide max_len "
                  f"({c.max_len}): the per-slot block table must span "
                  "exactly max_len positions for bit-compatibility with "
                  "the contiguous backend"),
    ConfigGate(
        "kv_blocks_range",
        lambda c: c.kv_backend == "paged" and c.kv_blocks < 0, ValueError,
        "kv_blocks must be >= 0"),
    ConfigGate(
        "draft_k_range",
        lambda c: c.speculative and c.draft_k < 1, ValueError,
        "draft_k must be >= 1"),
    ConfigGate(
        "draft_bits_range",
        lambda c: c.speculative and not 2 <= c.draft_bits <= 8, ValueError,
        lambda c: f"draft_bits ({c.draft_bits}) must be in [2, 8]"),
    # ---- feature-pair rows (uniform "unsupported combination:" prefix) -----
    ConfigGate(
        "paged_x_round",
        lambda c: c.kv_backend == "paged" and c.scheduler != "continuous",
        NotImplementedError,
        "unsupported combination: kv_backend='paged' requires "
        "scheduler='continuous' (the round scheduler's per-round caches "
        "are contiguous by construction)"),
    ConfigGate(
        "speculative_x_contiguous",
        lambda c: c.speculative and c.kv_backend != "paged",
        NotImplementedError,
        "unsupported combination: speculative decoding requires "
        "kv_backend='paged' (the verifier rewinds per-slot positions on "
        "draft rejection; the contiguous/lockstep cache has one shared "
        "clock and cannot rewind a single slot)"),
    ConfigGate(
        "speculative_x_quant_kv",
        lambda c: c.speculative and c.quantize_kv,
        NotImplementedError,
        "unsupported combination: speculative x quantize_kv (greedy "
        "acceptance promises tokens bit-identical to verifier-only "
        "decode, which needs the fp KV pool; int8 KV is tolerance-"
        "equivalent only)"),
    ConfigGate(
        "speculative_x_sampling",
        lambda c: c.speculative and (c.temperature > 0 or c.top_k > 0),
        NotImplementedError,
        "unsupported combination: speculative x sampling "
        "(temperature/top_k): greedy acceptance compares argmax tokens; "
        "set temperature=0 and top_k=0"),
)


@dataclasses.dataclass(frozen=True)
class ArchGate:
    """One row of the (ServeConfig × architecture) validity matrix — the
    model-dependent sibling of :data:`CONFIG_GATES`. ``invalid(cfg,
    arch_cfg)`` true rejects the pairing with ``error(message)``. Checked
    once in :class:`ServeEngine.__init__` (the first point where both the
    serve config and the model are known), and enumerated — together with
    ``CONFIG_GATES`` — when the support matrix is rendered.

    Architecture gates are deliberately few: chunked prefill is NOT gated
    on architecture anymore — every decoder-only mixer has a
    chunk-continuation path and serves under its measured agreement budget.
    What remains gated is what has no implementation at all, not what is
    merely tolerance-equivalent."""
    name: str
    invalid: Callable[["ServeConfig", Any], bool]
    error: type
    message: str

    def check(self, cfg: "ServeConfig", arch_cfg: Any) -> None:
        if self.invalid(cfg, arch_cfg):
            raise self.error(self.message)


def _arch_features(arch_cfg) -> Tuple[str, ...]:
    from repro_torch.models.model import arch_features
    return arch_features(arch_cfg)


ARCH_GATES: Tuple[ArchGate, ...] = (
    ArchGate(
        "encdec_x_continuous",
        lambda c, a: c.scheduler == "continuous" and a.is_encdec,
        NotImplementedError,
        "continuous scheduler does not support encoder-decoder models yet "
        "(per-slot encoder outputs have admission-dependent lengths); use "
        "scheduler='round'"),
    ArchGate(
        "paged_x_non_positional_kv",
        lambda c, a: c.kv_backend == "paged" and any(
            f in ("mla", "sliding_window", "mamba", "rwkv")
            for f in _arch_features(a)),
        NotImplementedError,
        "the paged KV cache requires per-position cache rows: MLA "
        "compressed-latent caches, sliding-window rings, and mamba/rwkv "
        "recurrent state cannot be block-paged; use "
        "kv_backend='contiguous' (MoE stacks with plain attention page "
        "fine — only the sequence-mixer cache layout matters)"),
)


@dataclasses.dataclass
class ServeConfig:
    max_batch: int = 8
    max_len: int = 256
    quantize_weights: Optional[str] = None    # None|'rtn'|'squant'|...
    weight_bits: int = 8
    quantize_kv: bool = False
    temperature: float = 0.0
    top_k: int = 0
    eos_id: int = -1                          # -1: never stop early
    pad_id: int = 0
    dequantize_for_compute: bool = True       # fake-quant serve on CPU
    scheduler: str = "round"                  # 'round' | 'continuous'
    max_slots: int = 0                        # slot-pool size (0: max_batch)
    # continuous only: max ms to drain in-flight slots before a staged
    # weight version is force-swapped at a step boundary (None: drain fully)
    swap_deadline_ms: Optional[float] = 250.0
    # continuous only: admission prefill consumes at most this many prompt
    # positions per engine step while resident slots keep decoding, bounding
    # the step-time spike a long-prompt admission causes (0: monolithic
    # prefill, the round scheduler always prefills monolithically).
    # Composes with kv_backend='paged': each pending entry chunk-prefills
    # its own unshared suffix at its own position (no shared clock), so any
    # chunk size works mid-flight and tokens stay bit-identical
    prefill_chunk: int = 0
    # continuous only: after this many mid-flight admissions that skipped
    # the queue head, admission narrows to the head until it lands (FCFS-
    # with-skip would otherwise starve a long request behind a stream of
    # short ones that keeps the pool from ever emptying)
    starvation_limit: int = 32
    # KV-cache backend (see repro_torch.serving.kvcache): 'contiguous' is the
    # original one-cache-row-per-slot layout; 'paged' (continuous scheduler
    # only) stores K/V in fixed-size blocks behind per-slot block tables
    # with shared-prefix reuse and copy-on-write
    kv_backend: str = "contiguous"
    # paged only: positions per KV block; must divide max_len (the per-slot
    # table then spans exactly max_len positions, keeping paged decode
    # shape- and bit-compatible with the contiguous oracle)
    block_size: int = 16
    # paged only: physical blocks in the pool, including the reserved trash
    # block (0: full capacity, max_slots * (max_len // block_size) + 1 —
    # no admission backpressure; smaller pools admit under a block budget)
    kv_blocks: int = 0
    # self-speculative decoding (paged + continuous + greedy only): a
    # draft_bits quantization of the SAME checkpoint autoregressively
    # proposes draft_k-token runs per slot, the serving tree verifies all
    # positions in one batched multi-position forward, and the longest
    # matching prefix is accepted — output tokens stay bit-identical to
    # verifier-only decode (greedy acceptance), only the steps-per-token
    # changes. quantize_kv composes with prefill_chunk AND paged (the
    # former gates are gone; tokens are tolerance-equivalent under int8
    # KV), but NOT with speculative — see CONFIG_GATES.
    speculative: bool = False
    # speculative only: bit-width of the drafter quantized from the same
    # fp tree (the SQuant ladder: sub-second, data-free — drafts for free)
    draft_bits: int = 4
    # speculative only: draft tokens proposed per cycle; the verifier
    # scores all draft_k + 1 positions (carry token + proposals) in one
    # batched multi-position forward
    draft_k: int = 4

    def __post_init__(self):
        for gate in CONFIG_GATES:
            gate.check(self)


class _StepGraph:
    """One captured forward: the CUDA graph, the tensors it was captured on
    (checked before every replay, so a graph whose weights or caches were
    replaced raises instead of reading freed or stale memory), its static
    logits, what its capture's wrapper calls counted (``tally``, in
    ``ops.launch_counts`` form) and its replays. A replay launches its
    kernels without their wrappers, so it counts nothing:
    :meth:`ServeEngine.replay_launches` measures what a replay launches."""

    def __init__(self, graph, params, inputs, logits, tally):
        # ``logits``: the captured forward's static output (a tensor, or a
        # tuple of them: the verify graph's logits and verdict)
        self.graph, self.params, self.inputs = graph, params, inputs
        self.logits, self.tally, self.replays = logits, tally, 0

    def replay(self, params, inputs) -> torch.Tensor:
        if params is not self.params or len(inputs) != len(self.inputs) \
                or any(a is not b for a, b in zip(inputs, self.inputs)):
            raise RuntimeError(
                "a captured step was called on other weights or buffers "
                "than it was captured on (its graphs were not dropped)")
        self.graph.replay()
        self.replays += 1
        return self.logits


def _static_inputs(batch, caches, out) -> tuple:
    """What a captured forward reads by address: the tokens, the clock, the
    block tables, the first cache leaf (standing for the cache) and the
    logits buffer it writes."""
    tokens = batch["tokens"] if isinstance(batch, dict) else batch
    return (tokens, caches["pos"], caches.get("block_tables"),
            caches["list"][0]["b0"]["k"], out)


class ServeEngine:
    def __init__(self, model, params=None, cfg: ServeConfig = None, *,
                 store: Optional[WeightStore] = None, device=None,
                 generator: Optional[torch.Generator] = None,
                 capture: bool = True):
        """``device``: where weights are quantized, caches live and the
        model runs (default: the CUDA device). ``generator``: source of
        randomness for temperature/top-k sampling; must live on ``device``
        (default: a fresh generator there, seeded with 0). ``capture``: on a
        CUDA device, run the paged decode step and the chunk forwards as
        CUDA graphs (see the module docstring); False runs the same path
        eagerly, for A/B comparisons and tests. The CPU always runs
        eagerly."""
        self.cfg = cfg or ServeConfig()
        self.device = torch.device("cuda" if device is None else device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.capture = capture and self.device.type == "cuda"
        # weight preparation (stack unroll + quantize_tree) lives in
        # serving.weights; the engine only consumes versioned serving trees
        self.model, quantize_fn, prepare_fn = \
            make_weight_pipeline(model, self.cfg, device=self.device)
        # model-dependent feasibility (CONFIG_GATES ran in ServeConfig's
        # __post_init__; these rows need the architecture too)
        for gate in ARCH_GATES:
            gate.check(self.cfg, self.model.cfg)
        if self.cfg.scheduler not in ("round", "continuous"):
            raise ValueError(f"unknown scheduler {self.cfg.scheduler!r} "
                             "(expected 'round' or 'continuous')")
        if store is None:
            if params is None:
                raise ValueError("ServeEngine needs params or a store")
            # speculative serving stages a versioned (target, draft) pair:
            # both trees quantized from the one fp source, swapped together
            # so a reload can never mix generations
            draft_fn = make_draft_quantize_fn(model, self.cfg,
                                              device=self.device) \
                if self.cfg.speculative else None
            store = WeightStore(quantize_fn, fp_params=params,
                                prepare_fn=prepare_fn,
                                draft_quantize_fn=draft_fn,
                                device=self.device)
        if self.cfg.speculative and store.current.draft_params is None:
            raise ValueError("speculative serving needs a store that stages "
                             "(target, draft) pairs (a draft_quantize_fn)")
        self.store = store
        if generator is None:
            generator = torch.Generator(device=self.device)
            generator.manual_seed(0)
        self.generator = generator
        # entry points with capture accounting: a counter increments only
        # when a CUDA graph is captured for a new token shape, so tests can
        # assert that same-shape steps never recapture. Monolithic prefill
        # and admit_rows stay eager (their counts stay 0)
        self.trace_counts: Dict[str, int] = \
            {"prefill": 0, "prefill_chunk": 0, "decode": 0, "admit": 0}
        self._graphs: Dict[str, Dict[tuple, _StepGraph]] = {}
        self._graph_pool = None       # one memory pool for all graphs
        self._graph_stream = None     # the side stream of the eager warm-ups
        self.capture_ms = 0.0         # host ms spent capturing, cumulative
        self._prefill = self.model.prefill
        # chunk continuation: one capture per chunk width (the start offset
        # is the static 0-d clock, so it never recaptures)
        self._prefill_chunk = self._graph_counted("prefill_chunk",
                                                  self.model.prefill_chunk)
        self._decode = self._graph_counted("decode", self.model.decode_step)
        self._admit_rows = admit_rows
        self._rounds_total = 0
        # bounded: a long-lived server must not grow per-round state
        self._round_log: collections.deque = collections.deque(maxlen=1024)
        # optional per-step instrumentation hook (tests/benches): called
        # with {"step", "recorded", "version", "draining", "t"} after each
        # lockstep sampling step
        self.on_step = None
        if self.cfg.scheduler == "continuous":
            self.scheduler = ContinuousScheduler(self)
        else:
            self.scheduler = RoundScheduler(self)

    def _graph_counted(self, name: str, fn):
        """The counterpart of the reference's ``_jit_counted``: the model
        entry point ``fn(params, batch, caches)`` captured as one CUDA graph
        per token shape (the reference's trace key), ``trace_counts[name]``
        bumped per capture, and replayed after. Only a call whose clock
        ``caches["pos"]`` is a device tensor is captured (the paged decode
        step, a paged chunk forward): a host integer would be frozen into
        the graph, so those calls, the CPU and ``capture=False`` run ``fn``
        eagerly. The caller passes the same static buffers on every call.
        ``out``: a static buffer the logits are written into (the KV
        cache's, which admissions write in place). Returns ``(logits,
        caches)``; a captured call returns the caller's ``caches`` (updated
        in place; its clock is the caller's input, not advanced)."""
        graphs = self._graphs.setdefault(name, {})

        def counted(params, batch, caches, out=None):
            if not (self.capture and isinstance(caches.get("pos"),
                                                torch.Tensor)):
                return self._run(fn, params, batch, caches, out)
            inputs = _static_inputs(batch, caches, out)
            key = tuple(inputs[0].shape)
            g = graphs.get(key)
            if g is None:
                lg, graphs[key] = self._capture(fn, params, batch, caches,
                                                out, inputs)
                self.trace_counts[name] += 1
                return lg, caches
            return g.replay(params, inputs), caches
        return counted

    @staticmethod
    def _run(fn, params, batch, caches, out):
        lg, caches = fn(params, batch, caches)
        if out is not None:
            out.copy_(lg)
            lg = out
        return lg, caches

    def _capture(self, fn, params, batch, caches, out, inputs):
        """Run ``fn`` once eagerly on a side stream, as ``torch.cuda.graphs``
        asks: that run is this step's own (its launches count as usual) and
        it makes the kernels' one-time attribute and occupancy calls
        outside the capture. Then capture ``fn`` on the same stream into
        the engine's graph pool. A failure raises; nothing carries on
        eagerly."""
        cur = torch.cuda.current_stream(self.device)
        if self._graph_stream is None:
            self._graph_stream = torch.cuda.Stream(self.device)
        if self._graph_pool is None:
            self._graph_pool = torch.cuda.graph_pool_handle()
        side = self._graph_stream
        side.wait_stream(cur)
        # keep_graph: the graph's kernel nodes stay readable
        # (ops.graph_launches); it is instantiated here, as without it
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        with torch.cuda.stream(side):
            lg, _ = self._run(fn, params, batch, caches, out)
            t0 = time.perf_counter()
            before = ops.launch_counts()
            # not torch.cuda.graph: it also synchronizes and empties the
            # allocator's cache, which costs more than the capture.
            # thread_local: the weight store's staging thread may use the
            # card while this thread captures
            # and no garbage collection inside the capture: an object left
            # to the collector that holds a graph (another engine's) would
            # destroy it mid-capture, which invalidates the capture
            collecting = gc.isenabled()
            gc.disable()
            graph.capture_begin(self._graph_pool,
                                capture_error_mode="thread_local")
            try:
                glg, _ = self._run(fn, params, batch, caches, out)
            finally:
                graph.capture_end()
                if collecting:
                    gc.enable()
            graph.instantiate()
            tally = ops.launches_between(before, ops.launch_counts())
            ops.set_launch_counts(before)    # the capture itself ran nothing
            self.capture_ms += (time.perf_counter() - t0) * 1e3
        cur.wait_stream(side)
        return lg, _StepGraph(graph, params, inputs, glg, tally)

    def graph_pool_bytes(self) -> int:
        """Device bytes in the segments of the graphs' memory pool."""
        if self._graph_pool is None:
            return 0
        pool = tuple(self._graph_pool)
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg.get("segment_pool_id", ())) == pool)

    def replay_launches(self) -> Dict[str, Any]:
        """The kernel launches of the live graphs' replays so far,
        measured: each graph's kernel nodes read from the graph the driver
        holds (``ops.graph_launches``: what every replay of it runs), held
        to what its capture's wrapper calls counted (RuntimeError if they
        differ), times its replays. ``ops.launch_counts`` form."""
        now = ops.launch_counts()
        total = ops.launches_between(now, now)
        for name, gs in self._graphs.items():
            for key, g in gs.items():
                measured = ops.graph_launches(g.graph)
                if measured != g.tally:
                    raise RuntimeError(
                        f"the {name} graph at {key} launches {measured} in "
                        f"a replay; its capture counted {g.tally}")
                total = ops.combine_launches(total, measured, g.replays)
        return total

    def _drop_graphs(self) -> None:
        """Drop every captured graph; each is captured again, and counted
        again, on its next call. A graph holds the addresses of the weights
        and caches it was captured on: the scheduler drops them when it
        acquires a new weight version."""
        for gs in self._graphs.values():
            gs.clear()
        self._graph_pool = None           # the pool goes with its graphs

    def _sync(self) -> None:
        """Wait for the work this thread's stream has issued so far
        (callers time around admissions and prefill chunks). Not the whole
        device: a weight stage runs on the store's own stream meanwhile."""
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    # ------------------------------------------------------------ weights
    @property
    def params(self):
        """The live serving tree (current weight version)."""
        return self.store.current.params

    @property
    def quant_report(self):
        return self.store.current.report

    def watch_checkpoints(self, ckpt_dir: str, poll_s: float = 1.0,
                          mesh=None):
        """Hot-reload: poll ``ckpt_dir`` for new COMMITTED steps and stage
        them (quantizing fp trees on the fly, loading quantized trees
        natively); swaps land at the scheduler's next swap point (round
        boundary, or continuous drain/deadline), where the captured steps
        are dropped and captured again on the new tree."""
        self.store.watch(ckpt_dir, poll_s=poll_s, mesh=mesh,
                         expect={"quantize_weights": self.cfg.quantize_weights,
                                 "weight_bits": self.cfg.weight_bits})

    def stats(self) -> Dict[str, Any]:
        """Engine + scheduler + weight-store observability: per-round
        timing log (round scheduler; last 1024 rounds), scheduler counters
        (steps/admissions/drains/forced swaps, KV-backend stats), capture
        counts (``trace_counts``) and the live graphs (count, cumulative
        capture ms, graph-pool bytes), and swap/version counters."""
        return {"rounds": self._rounds_total,
                "round_log": list(self._round_log),
                "scheduler": self.scheduler.stats(),
                "trace_counts": dict(self.trace_counts),
                "graphs": {"live": sum(map(len, self._graphs.values())),
                           "capture_ms": self.capture_ms,
                           "pool_bytes": self.graph_pool_bytes()},
                "weights": self.store.stats()}

    def close(self):
        # the graphs and their pool go now, not at some later collection
        self._drop_graphs()
        self.store.close()

    # ------------------------------------------------------------------ api
    def generate(self, requests: Sequence[Request]) -> List[Completion]:
        return self.scheduler.run(list(requests))
