"""Public serving API: request/response types and typed stats.

This is the deliberate public surface of :mod:`repro_torch.serving` — promoted
out of ``serving/scheduler.py`` when self-speculative decoding forced the
serving loop to grow multi-token-per-step semantics. Import from here (or
from ``repro_torch.serving``); ``repro_torch.serving.scheduler.Request`` and
``repro_torch.serving.engine.Request`` remain as deprecated aliases.

Types
-----
* :class:`Request` — one generation request. ``request_id`` is
  auto-assigned (process-unique) when left unset, and ``eos_id`` can
  override the engine-global ``ServeConfig.eos_id`` per request.
* :class:`Completion` — one finished request, with per-phase timings, the
  pinned weight version, and the speculative-decoding counters.
* :class:`StagedInfo` — the staged weight version a reload-aware
  scheduler compares against its swap deadline.
* :class:`SchedulerStats` — ``scheduler.stats()`` as a typed record
  instead of an ad-hoc dict.

``StagedInfo`` and ``SchedulerStats`` support ``info["key"]`` /
``info.get("key")`` alongside attribute access so existing dict-style
consumers keep working across the API move.

Example (doctest-checked in CI via ``python -m doctest``):

>>> from repro_torch.serving.api import Request, Completion, SchedulerStats
>>> r = Request(prompt=[1, 2, 3], max_new_tokens=4, request_id=7)
>>> (r.request_id, r.eos_id)           # eos_id None: engine default
(7, None)
>>> auto = Request(prompt=[5])
>>> auto.request_id >= 1 << 20         # auto ids never clash with small
True
>>> c = Completion(request_id=7, tokens=[9, 9, 0], prefill_ms=1.5,
...                decode_ms=6.0)
>>> (c.weights_version, c.draft_tokens_accepted)
(1, 0)
>>> st = SchedulerStats(kind="continuous", steps=12, max_slots=4)
>>> st["steps"] == st.steps == 12      # dict-style shim still works
True
>>> st.get("missing", 0)
0
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Dict, List, Optional, Sequence

__all__ = ["Request", "Completion", "StagedInfo", "SchedulerStats"]

# process-unique auto ids for requests constructed without one; starts
# high so explicit small ids (the common test/example pattern) never clash
_AUTO_REQUEST_IDS = itertools.count(1 << 20)


class _ItemAccess:
    """Dict-style read access for dataclass stats records (migration
    shim: the pre-api.py ``stats()``/``staged_info()`` returned dicts)."""

    def __getitem__(self, key: str) -> Any:
        try:
            return getattr(self, key)
        except AttributeError:
            raise KeyError(key) from None

    def get(self, key: str, default: Any = None) -> Any:
        return getattr(self, key, default)

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class Request:
    """One generation request.

    Fields
    ------
    prompt
        Token ids to prefill (ints in ``[0, vocab)``); must be non-empty.
    max_new_tokens
        Exact number of tokens to generate unless ``eos_id`` stops the
        request early; the scheduler reserves cache space for all of them
        at admission.
    request_id
        Correlates the :class:`Completion`. Left at the default (None) it
        is auto-assigned a process-unique id (≥ ``1 << 20``, so explicit
        small ids never clash), for callers that don't need to correlate.
    eos_id
        Per-request end-of-sequence override. None: use the
        engine-global ``ServeConfig.eos_id``; -1: never stop early
        regardless of the engine's.
    """
    prompt: Sequence[int]
    max_new_tokens: int = 16
    request_id: Optional[int] = None
    eos_id: Optional[int] = None

    def __post_init__(self):
        if self.request_id is None:
            self.request_id = next(_AUTO_REQUEST_IDS)


@dataclasses.dataclass
class Completion:
    """One finished request.

    Fields
    ------
    request_id
        Echoes :attr:`Request.request_id`.
    tokens
        Generated token ids, in order — ``len(tokens) <
        max_new_tokens`` only when EOS stopped the request early.
    prefill_ms
        Wall-clock milliseconds spent prefilling this request's prompt
        (all chunks, for a chunked admission).
    decode_ms
        Wall-clock milliseconds from admission to retirement spent in
        decode/verify steps (shared steps are attributed to every
        resident request, not divided among them).
    swap_ms
        Milliseconds of weight-swap stall observed while this request
        was in flight (0.0 when no reload landed).
    weights_version
        ``WeightStore`` version pinned at admission — every token of
        this completion was produced by this version unless
        ``forced_swaps`` is non-zero.
    forced_swaps
        Number of deadline force-swaps that landed while in flight
        (> 0 means later tokens came from a newer weight version).
    steps
        Engine sampling steps the request lived through; with
        speculative decoding this is < ``len(tokens)`` when drafts were
        accepted (each accepted draft token skips a step).
    draft_tokens_proposed
        Speculative decoding only: draft tokens the low-bit tree
        proposed for this request's slot (0 when speculation is off).
    draft_tokens_accepted
        Speculative decoding only: proposed tokens the verifier kept
        (``accepted / proposed`` is this request's acceptance rate).
    """
    request_id: int
    tokens: List[int]
    prefill_ms: float
    decode_ms: float
    swap_ms: float = 0.0
    weights_version: int = 1
    forced_swaps: int = 0
    steps: int = 0
    draft_tokens_proposed: int = 0
    draft_tokens_accepted: int = 0


@dataclasses.dataclass
class StagedInfo(_ItemAccess):
    """A fully-built weight version waiting to be swapped in.

    Fields
    ------
    version
        The ``WeightStore`` version number that will become live at the
        next swap point.
    age_ms
        Milliseconds since the version finished staging — reload-aware
        schedulers compare this against ``swap_deadline_ms`` to decide
        between draining and force-swapping.
    """
    version: int
    age_ms: float


@dataclasses.dataclass
class SchedulerStats(_ItemAccess):
    """Typed ``scheduler.stats()`` record (both schedulers).

    The round scheduler fills only ``kind``/``steps``/``rounds``; the
    continuous scheduler fills everything else. Counters are cumulative
    over the scheduler's lifetime unless noted.

    Fields
    ------
    kind
        ``"round"`` or ``"continuous"``.
    steps
        Engine steps executed (decode or verify dispatches; a step
        serves every resident slot at once).
    rounds
        Round scheduler only: FCFS rounds completed.
    max_slots
        Decode-slot pool size (continuous).
    admitted / retired
        Requests admitted into / retired from the slot pool.
    waves
        Clock-horizon wave resets (the contiguous pool emptying and
        restarting its shared clock at 0).
    drains
        Reload drains entered (admission paused until in-flight slots
        retire or the swap deadline forces).
    forced_swaps
        Deadline force-swaps performed.
    mean_occupancy / max_occupancy
        Resident slots per step — time-averaged mean and peak
        (``mean_occupancy / max_slots`` is pool utilization).
    prefill_chunk
        Configured chunk width in prompt positions (0: monolithic).
    chunk_steps
        Engine steps that carried a chunk-prefill forward.
    pendings_started / pendings_abandoned
        Chunked admissions begun / abandoned by a force-swap (abandoned
        ones re-queue and restart on the new weights).
    step_ms
        Decode step-time tail percentiles in milliseconds:
        ``{"p50": ..., "p95": ..., "p99": ...}``.
    kv
        KV-backend stats passthrough (pool bytes, block counts, prefix
        hit rate — keys depend on the backend).
    speculative
        True when self-speculative decoding is on; the remaining fields
        are its telemetry (zero otherwise).
    spec_cycles
        Draft-verify cycles executed.
    draft_tokens_proposed / draft_tokens_accepted
        Draft tokens offered by the low-bit tree / kept by the
        verifier, summed over all slots.
    acceptance_rate
        ``draft_tokens_accepted / draft_tokens_proposed``.
    accepted_len
        Per-verify-cycle committed tokens per slot, percentiles
        ``{"p50": ..., "p95": ...}`` (1.0 == verifier-only pace).
    """
    kind: str
    steps: int = 0
    rounds: int = 0
    max_slots: int = 0
    admitted: int = 0
    retired: int = 0
    waves: int = 0
    drains: int = 0
    forced_swaps: int = 0
    mean_occupancy: float = 0.0
    max_occupancy: int = 0
    prefill_chunk: int = 0
    chunk_steps: int = 0
    pendings_started: int = 0
    pendings_abandoned: int = 0
    step_ms: Dict[str, float] = dataclasses.field(default_factory=dict)
    kv: Dict[str, Any] = dataclasses.field(default_factory=dict)
    speculative: bool = False
    spec_cycles: int = 0
    draft_tokens_proposed: int = 0
    draft_tokens_accepted: int = 0
    acceptance_rate: float = 0.0
    accepted_len: Dict[str, float] = dataclasses.field(default_factory=dict)
