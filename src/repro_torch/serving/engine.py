"""Serving engine: a thin front over the slot scheduler.

The request path SQuant enables: load fp weights → on-the-fly data-free
quantization (no data, no BP — the paper's "on-the-fly framework") → serve
int8/int4 weights with dequant-on-the-fly matmuls.

Scheduling lives in :mod:`repro_torch.serving.scheduler`:

* ``scheduler="round"`` (default) — static rounds of up to ``max_batch``
  left-padded requests; every request in a round waits for the longest one,
  and weight swaps land only between rounds.

Weight ownership lives in :class:`repro_torch.serving.weights.WeightStore`,
not the engine: the scheduler *acquires* a weight version at its swap points
and pins it per round, so a concurrent reload can never tear an in-flight
request. ``Completion`` reports ``prefill_ms``/``decode_ms``/``swap_ms`` and
the pinned ``weights_version``.

Every ``ServeConfig`` field and every validity-gate row of the reference
package is kept. A valid combination that this package cannot serve yet —
``scheduler="continuous"``, ``kv_backend="paged"``, ``quantize_kv``,
``speculative``, ``prefill_chunk > 0`` — raises
``NotImplementedError("not ported yet: ...")`` in ``ServeEngine.__init__``;
it never runs something else instead.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch

from repro_torch.serving.api import Completion, Request
from repro_torch.serving.scheduler import RoundScheduler
from repro_torch.serving.weights import WeightStore, make_weight_pipeline

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


# valid configurations whose machinery is not part of this package yet
_NOT_PORTED: Tuple[Tuple[str, Callable[["ServeConfig"], bool]], ...] = (
    ("scheduler='continuous'", lambda c: c.scheduler == "continuous"),
    ("kv_backend='paged'", lambda c: c.kv_backend == "paged"),
    ("quantize_kv (int8 KV cache)", lambda c: c.quantize_kv),
    ("speculative decoding", lambda c: c.speculative),
    ("prefill_chunk > 0 (chunked prefill)", lambda c: c.prefill_chunk > 0),
)


class ServeEngine:
    def __init__(self, model, params=None, cfg: ServeConfig = None, *,
                 store: Optional[WeightStore] = None, device=None,
                 generator: Optional[torch.Generator] = None):
        """``device``: where weights are quantized, caches live and the
        model runs (default: the CUDA device). ``generator``: source of
        randomness for temperature/top-k sampling; must live on ``device``
        (default: a fresh generator there, seeded with 0)."""
        self.cfg = cfg or ServeConfig()
        self.device = torch.device("cuda" if device is None else device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
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
        for what, hit in _NOT_PORTED:
            if hit(self.cfg):
                raise NotImplementedError(f"not ported yet: {what}")
        if store is None:
            if params is None:
                raise ValueError("ServeEngine needs params or a store")
            store = WeightStore(quantize_fn, fp_params=params,
                                prepare_fn=prepare_fn, device=self.device)
        self.store = store
        if generator is None:
            generator = torch.Generator(device=self.device)
            generator.manual_seed(0)
        self.generator = generator
        self._rounds_total = 0
        # bounded: a long-lived server must not grow per-round state
        self._round_log: collections.deque = collections.deque(maxlen=1024)
        # optional per-step instrumentation hook (tests/benches): called
        # with {"step", "recorded", "version", "draining", "t"} after each
        # lockstep sampling step
        self.on_step = None
        self.scheduler = RoundScheduler(self)

    # ------------------------------------------------------------ weights
    @property
    def params(self):
        """The live serving tree (current weight version)."""
        return self.store.current.params

    @property
    def quant_report(self):
        return self.store.current.report

    def watch_checkpoints(self, ckpt_dir: str, poll_s: float = 1.0):
        raise NotImplementedError(
            "not ported yet: checkpoint hot-reload (WeightStore.watch)")

    def stats(self) -> Dict[str, Any]:
        """Engine + scheduler + weight-store observability: per-round
        timing log (last 1024 rounds), scheduler counters and swap/version
        counters."""
        return {"rounds": self._rounds_total,
                "round_log": list(self._round_log),
                "scheduler": self.scheduler.stats(),
                "weights": self.store.stats()}

    def close(self):
        self.store.close()

    # ------------------------------------------------------------------ api
    def generate(self, requests: Sequence[Request]) -> List[Completion]:
        return self.scheduler.run(list(requests))
