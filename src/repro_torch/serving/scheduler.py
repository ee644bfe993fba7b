"""Slot schedulers for the serving engine: the static round scheduler and
the reload-aware continuous-batching scheduler.

* :class:`RoundScheduler` — static batching: requests are grouped into
  rounds of up to ``max_batch``, left-padded to the round's longest prompt,
  and decoded in lockstep at a shared clock until every request in the
  round finishes. Prefill/cache/decode are sized to the *actual* round
  batch. Weight swaps land only between rounds.

* :class:`ContinuousScheduler` — a fixed pool of ``max_slots`` decode slots
  over one persistent KV cache. Queued requests are admitted into free slots
  at step boundaries (contiguous backend: left-padded to the shared clock,
  as the round engine pads per round; paged backend: at their own
  positions, shared prefixes reused), and slots retire on EOS/max-tokens
  immediately, so short requests never wait on long ones.

Reload-awareness: when the :class:`~repro_torch.serving.weights.WeightStore`
reports a staged version, the continuous scheduler stops admitting, drains
in-flight slots and swaps at a step boundary — or force-swaps after
``swap_deadline_ms`` of draining, in which case in-flight slots finish on
the new weights (``Completion.forced_swaps`` records it).

Chunked prefill (``ServeConfig.prefill_chunk > 0``): an admission becomes a
pending prefill that consumes at most ``prefill_chunk`` prompt positions
per engine step on a side cache while resident slots keep decoding. On the
contiguous backend it commits up front to the completion clock that the
moving shared clock allows (:class:`PendingPrefill`); on the paged backend
each entry completes at its own prompt length (:class:`PagedPendingPrefill`)
and every chunk size works mid-flight. A forced swap abandons the pending
and re-queues its requests at the front.

Each decode step synchronizes with the host exactly once (the sampled tokens
are read back to decide EOS and to record them).

Self-speculative decoding (``ServeConfig.speculative``, paged only): after
each step's sampling the alive slots run one draft→verify cycle
(:class:`~repro_torch.serving.speculative.SpeculativeDecoder`) instead of
the decode step, with one more host sync for the drafts and the verdict;
the emitted tokens are bit-identical to verifier-only decode.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.serving.api import Completion, Request, SchedulerStats
from repro_torch.serving.kvcache import KVCache
from repro_torch.serving.sampling import sample
from repro_torch.serving.speculative import SpeculativeDecoder


def _req_eos(req: Request, cfg) -> int:
    """Per-request EOS override (None: the engine-global eos_id)."""
    return cfg.eos_id if req.eos_id is None else req.eos_id


@dataclasses.dataclass
class _Slot:
    order: int                    # index into the run()'s request list
    req: Request
    version: int                  # weight version pinned at admission
    clock0: int                   # clock (= padded prompt length) at admission
    t0: float                     # perf_counter right after admission prefill
    prefill_ms: float
    swap_ms: float = 0.0
    forced_swaps: int = 0
    tokens: List[int] = dataclasses.field(default_factory=list)
    steps: int = 0                # engine sampling steps this slot spanned
    proposed: int = 0             # speculative: draft tokens offered
    accepted: int = 0             # speculative: draft tokens kept


@dataclasses.dataclass
class PendingPrefill:
    """A chunked admission in flight on the contiguous backend: its prompt
    (left-padded to the committed completion clock) is consumed
    ``prefill_chunk`` positions per engine step on a side cache; only on
    completion are the rows scattered into the pool and slots created."""
    chosen: List[Tuple[int, Request]]   # (order, request) per row
    slot_ids: List[int]                 # reserved pool rows
    target: int                         # committed completion clock P
    version: int                        # weight version pinned at creation
    tokens: np.ndarray                  # (k, P) left-padded prompt matrix
    done: int = 0                       # positions consumed so far
    cache: Any = None                   # side cache (k rows), lazy init
    logits: Any = None                  # last chunk's final-token logits
    prefill_ms: float = 0.0             # accumulated chunk wall time
    chunks: int = 0

    @property
    def remaining(self) -> int:
        return self.target - self.done

    @property
    def remaining_requests(self) -> int:
        return len(self.chosen)


@dataclasses.dataclass
class PagedPendingPrefill:
    """A chunked admission on the paged backend. No shared clock, so no
    catch-up recurrence and no left-padding: each chosen request completes
    at its OWN prompt length. Entries are consumed in admission order — the
    current entry's unshared suffix is chunk-prefilled on a 1-row side
    cache across engine steps, and on completion its rows are scattered
    into the slot's reserved blocks and the slot starts decoding while
    later entries keep chunking. Every entry's full block budget is
    reserved at creation (``reserve_pending``)."""
    chosen: List[Tuple[int, Request]]   # (order, request), consumed in order
    slot_ids: List[int]                 # reserved slot per entry
    version: int                        # weight version pinned at creation
    entry: int = 0                      # index of the in-progress entry
    lp: int = 0                         # entry's shared-prefix length
    done: int = 0                       # suffix positions consumed (entry)
    suffix: Any = None                  # entry's unshared suffix (np.int64)
    cache: Any = None                   # 1-row side cache (None: not begun)
    logits: Any = None                  # last chunk's final-token logits
    entry_ms: float = 0.0               # accumulated chunk wall time (entry)
    chunks: int = 0                     # chunk forwards issued (entry)

    @property
    def remaining_requests(self) -> int:
        return len(self.chosen) - self.entry


class _SchedulerBase:
    def __init__(self, engine):
        self.eng = engine
        self.cfg = engine.cfg
        self.model = engine.model
        self.store = engine.store
        # all cache state lives behind the KVCache API
        self.kv = KVCache.create(engine)
        self.steps_total = 0

    def _emit_step(self, info: Dict[str, Any]) -> None:
        step_log = getattr(self, "step_log", None)
        if step_log is not None:
            step_log.append(info)
        if self.eng.on_step is not None:
            self.eng.on_step(info)

    def _validate(self, req: Request) -> None:
        """A request needs ``len(prompt) + max_new_tokens`` cache positions."""
        n_prompt = len(req.prompt)
        if n_prompt + req.max_new_tokens > self.cfg.max_len:
            raise ValueError(
                f"request {req.request_id}: prompt ({n_prompt}) + "
                f"max_new_tokens ({req.max_new_tokens}) exceeds "
                f"max_len ({self.cfg.max_len})")
        self.kv.check_request(req)


class RoundScheduler(_SchedulerBase):
    """Static batching: FCFS rounds of up to ``max_batch``; a round ends
    only when its longest request does. Swaps land between rounds."""

    name = "round"

    def __init__(self, engine):
        super().__init__(engine)
        self.step_log: Optional[List[Dict[str, Any]]] = None

    def run(self, requests: List[Request]) -> List[Completion]:
        out: List[Completion] = []
        reqs = list(requests)
        for r in reqs:
            self._validate(r)
        while reqs:
            out.extend(self._run_round(reqs[:self.cfg.max_batch]))
            reqs = reqs[self.cfg.max_batch:]
        return out

    def stats(self) -> SchedulerStats:
        return SchedulerStats(kind=self.name, steps=self.steps_total,
                              rounds=self.eng._rounds_total)

    def _run_round(self, reqs: List[Request]) -> List[Completion]:
        cfg = self.cfg
        dev = self.eng.device
        # the ONLY swap point: in-flight rounds hold `ver` to the end
        ver, swap_ms = self.store.acquire()
        params = ver.params
        # sized to the actual round: a 2-request round on an 8-slot config
        # allocates a 2-row cache
        b = len(reqs)
        plen = max(len(r.prompt) for r in reqs)
        tokens = np.full((b, plen), cfg.pad_id, np.int64)
        for i, r in enumerate(reqs):
            tokens[i, plen - len(r.prompt):] = np.asarray(r.prompt)

        cache = self.kv.fresh(b)
        batch = {"tokens": torch.from_numpy(tokens).to(dev)}
        mcfg = self.model.cfg
        if mcfg.is_encdec:
            # the frontend is a stub: float32 zero frames, one per enc_ratio
            # prompt positions, as the reference feeds (a bfloat16 model
            # therefore decodes in float32 after its first cross-attention)
            batch["enc_frames"] = torch.zeros(
                (b, max(1, plen // mcfg.enc_ratio), mcfg.d_model),
                dtype=torch.float32, device=dev)
        t0 = time.perf_counter()
        logits, cache = self.eng._prefill(params, batch, cache)
        self.eng._sync()
        prefill_ms = (time.perf_counter() - t0) * 1e3

        max_new = max(r.max_new_tokens for r in reqs)
        produced = np.full((b, max_new), cfg.pad_id, np.int32)
        done = np.zeros(b, bool)
        t0 = time.perf_counter()
        for t in range(max_new):
            nxt = sample(logits, self.eng.generator, cfg.temperature,
                         cfg.top_k)
            nxt_np = nxt.cpu().numpy()          # the step's one host sync
            recorded = 0
            for i, r in enumerate(reqs):
                if not done[i] and t < r.max_new_tokens:
                    produced[i, t] = nxt_np[i]
                    recorded += 1
                    if nxt_np[i] == _req_eos(r, cfg):
                        done[i] = True
                else:
                    done[i] = done[i] or t >= r.max_new_tokens
            self.steps_total += 1
            self._emit_step({"step": self.steps_total, "recorded": recorded,
                             "version": ver.version, "draining": False,
                             "t": time.perf_counter()})
            if all(done[i] for i in range(b)):
                break
            logits, cache = self.eng._decode(
                params, nxt[:, None].to(torch.int64), cache)
        self.eng._sync()
        decode_ms = (time.perf_counter() - t0) * 1e3

        # the round ran start-to-finish on `ver`; a version staged mid-round
        # becomes visible only to the next acquire()
        self.eng._rounds_total += 1
        self.eng._round_log.append({"version": ver.version,
                                    "prefill_ms": prefill_ms,
                                    "decode_ms": decode_ms,
                                    "swap_ms": swap_ms,
                                    "requests": b})

        outs = []
        for i, r in enumerate(reqs):
            toks = [int(x) for x in produced[i, :r.max_new_tokens]]
            # truncate at EOS
            eid = _req_eos(r, cfg)
            if eid >= 0 and eid in toks:
                toks = toks[:toks.index(eid) + 1]
            outs.append(Completion(r.request_id, toks, prefill_ms,
                                   decode_ms, swap_ms, ver.version,
                                   steps=len(toks)))
        return outs


# ---------------------------------------------------------------------------
# continuous scheduler (slot pool + reload-aware drain/refill)
# ---------------------------------------------------------------------------

class ContinuousScheduler(_SchedulerBase):
    """Continuous batching over a fixed slot pool with one persistent KV
    cache; admission at step boundaries, per-slot retirement, and
    drain-then-swap (deadline-bounded) around weight reloads."""

    name = "continuous"

    def __init__(self, engine):
        super().__init__(engine)
        self.chunk = int(self.cfg.prefill_chunk or 0)
        self.max_slots = self.kv.max_slots
        self.slots: List[Optional[_Slot]] = [None] * self.max_slots
        # self-speculative decoding: the draft-side state and device
        # plumbing (paged-only, greedy-only, no quantize_kv: CONFIG_GATES)
        self.spec: Optional[SpeculativeDecoder] = None
        if self.cfg.speculative:
            self.spec = SpeculativeDecoder(engine, self.kv)
            self.spec.bind(self)
        self._ver = None              # the currently-acquired WeightVersion
        self._pending_swap_ms = 0.0   # swap time to attribute at admission
        self._kv_version = None       # weight version the KV prefix cache
        #                               was built under (flush on change)
        self._pending = None          # PendingPrefill | PagedPendingPrefill
        self._head_skips = 0          # FCFS-with-skip starvation guard
        # tolerance-equivalence hook (serving.equivalence): called per
        # (request_id, position, proposed_token) right after sampling; a
        # non-None return replaces the token both in the slot's record and
        # in the decode feed (teacher forcing)
        self.token_override = None
        self._last_emit_t: Optional[float] = None
        # observability
        self.admitted = 0
        self.retired = 0
        self.drains = 0
        self.forced_swaps = 0
        self.waves = 0
        self.occupancy_sum = 0
        self.max_occupancy = 0
        self.chunk_steps = 0          # prefill-chunk forwards issued
        self.pendings_started = 0
        self.pendings_abandoned = 0   # force-swap abandoned chunked admits
        self.step_log: Optional[List[Dict[str, Any]]] = None
        # bounded: per-sampling-step wall time, feeds the stats() tail
        # percentiles (the metric chunked prefill exists to bound)
        self.step_ms_log: collections.deque = collections.deque(maxlen=4096)
        # bounded: one entry per admission, observable padding/version
        self.admission_log: collections.deque = \
            collections.deque(maxlen=1024)

    # ------------------------------------------------------------------ api
    def run(self, requests: List[Request]) -> List[Completion]:
        cfg = self.cfg
        dev = self.eng.device
        results: List[Optional[Completion]] = [None] * len(requests)
        queue: "collections.deque[Tuple[int, Request]]" = collections.deque()
        ver, swap_ms = self.store.acquire()
        params = ver.params
        self._ver = ver
        # a version staged between generate() calls swaps at this acquire,
        # bypassing the drain branch — the KV cache must still learn of it
        self._sync_kv_version(ver.version)
        self._pending_swap_ms += swap_ms
        for i, r in enumerate(requests):
            self._validate(r)
            if r.max_new_tokens <= 0:
                results[i] = Completion(r.request_id, [], 0.0, 0.0, 0.0,
                                        ver.version)
                continue
            queue.append((i, r))
        self.kv.begin_run()
        drain_t0 = None
        self._last_emit_t = time.perf_counter()

        while queue or self._pending is not None \
                or any(s is not None for s in self.slots):
            active_ids = [i for i, s in enumerate(self.slots)
                          if s is not None]
            # ---- reload-awareness: drain, then swap at a step boundary ----
            staged = self.store.staged_info()
            if staged is not None:
                if drain_t0 is None:
                    drain_t0 = time.perf_counter()
                    self.drains += 1
                    in_flight = len(active_ids) + (
                        self._pending.remaining_requests
                        if self._pending else 0)
                    self.store.note_drain(in_flight)
                elapsed_ms = (time.perf_counter() - drain_t0) * 1e3
                deadline = cfg.swap_deadline_ms
                # the deadline clock starts when the version finished
                # staging; a chunked admission in flight drains like any
                # other work, and a forced swap abandons it instead (its
                # chunks ran on the old weights) and re-queues its requests
                busy = bool(active_ids) or self._pending is not None
                if not busy or (deadline is not None
                                and staged.age_ms >= deadline):
                    if self._pending is not None:
                        self._abandon_pending(queue)
                    forced = busy
                    ver, sms = self.store.acquire()
                    params = ver.params
                    self._ver = ver
                    self._sync_kv_version(ver.version)
                    self.store.note_swap(forced=forced, drain_ms=elapsed_ms)
                    self._pending_swap_ms += sms
                    if forced:
                        self.forced_swaps += 1
                        for i in active_ids:
                            self.slots[i].forced_swaps += 1
                            self.slots[i].swap_ms += sms
                    drain_t0 = None
            draining = self.store.staged_pending

            # ---- admission into free slots (paused while draining or while
            # a chunked admission is already in flight) ----
            admit_ms = 0.0
            if self._pending is None and queue and not draining:
                free_ids = [i for i, s in enumerate(self.slots) if s is None]
                if free_ids:
                    fresh = len(free_ids) == self.max_slots
                    head = queue[0]
                    limit_head = (not fresh and self._head_skips
                                  >= cfg.starvation_limit)
                    if self.chunk:
                        chosen = self._start_pending(
                            queue, free_ids, fresh, ver.version, limit_head)
                    else:
                        chosen, new_clock = self.kv.pick(
                            queue, len(free_ids), fresh, limit_head)
                        if chosen:
                            if fresh:
                                self.waves += 1
                            t0 = time.perf_counter()
                            self._admit(chosen, free_ids, new_clock, params,
                                        ver.version)
                            admit_ms = (time.perf_counter() - t0) * 1e3
                    # starvation guard: count picks that jumped the queue
                    # head; past the limit, mid-flight admission narrows to
                    # the head, so the pool drains into a fresh wave
                    if fresh or (chosen and head in chosen):
                        self._head_skips = 0
                    elif chosen:
                        self._head_skips += 1

            # ---- chunked admission: consume this step's prefill budget ----
            chunk_ms = 0.0
            if self._pending is not None:
                chunk_ms = self._advance_pending(params)
                p = self._pending
                # paged pendings complete per entry inside the advance; only
                # the contiguous pending waits for the shared clock
                if isinstance(p, PendingPrefill) and p.done >= p.target \
                        and (self.kv.clock == p.target or not active_ids):
                    self._scatter_pending(p)

            active_ids = [i for i, s in enumerate(self.slots)
                          if s is not None]
            if not active_ids:
                # draining with an empty pool (the swap fires next
                # iteration) or a chunked admission still consuming its
                # prompt on an empty pool (chunks run back-to-back)
                continue

            # ---- one step: sample, retire, decode ----
            nxt = sample(self.kv.logits, self.eng.generator, cfg.temperature,
                         cfg.top_k)
            nxt_np = nxt.cpu().numpy()          # the step's one host sync
            if self.token_override is not None:
                nxt_np = nxt_np.copy()
                for i in active_ids:
                    s = self.slots[i]
                    ov = self.token_override(s.req.request_id,
                                             len(s.tokens), int(nxt_np[i]))
                    if ov is not None:
                        nxt_np[i] = ov
                nxt = torch.from_numpy(nxt_np).to(dev)
            recorded = 0
            t_now = time.perf_counter()
            step_ms = (t_now - self._last_emit_t) * 1e3
            self._last_emit_t = t_now
            self.step_ms_log.append(step_ms)
            for i in active_ids:
                s = self.slots[i]
                tok = int(nxt_np[i])
                s.tokens.append(tok)
                s.steps += 1
                recorded += 1
                eid = _req_eos(s.req, cfg)
                if (len(s.tokens) >= s.req.max_new_tokens
                        or (eid >= 0 and tok == eid)):
                    self._finish(results, i, t_now)
            self.steps_total += 1
            self.occupancy_sum += recorded
            self.max_occupancy = max(self.max_occupancy, recorded)
            self._emit_step({"step": self.steps_total,
                             "clock": self.kv.clock,
                             "recorded": recorded, "version": ver.version,
                             "draining": draining, "t": t_now,
                             "step_ms": step_ms, "chunk_ms": chunk_ms,
                             "admit_ms": admit_ms})
            alive = [i for i, s in enumerate(self.slots) if s is not None]
            if alive:
                if self.spec is not None:
                    # the carry token's K/V row is written by the verify
                    # forward with the draft run (no separate decode step)
                    self._spec_cycle(results, params, nxt, alive)
                else:
                    self.kv.decode(params, nxt, alive)
        return results  # type: ignore[return-value]

    def _finish(self, results, slot: int, t_now: float) -> None:
        """Retire slot ``slot`` and record its Completion."""
        s = self.slots[slot]
        results[s.order] = Completion(
            s.req.request_id, s.tokens, s.prefill_ms,
            (t_now - s.t0) * 1e3, s.swap_ms, s.version, s.forced_swaps,
            steps=s.steps, draft_tokens_proposed=s.proposed,
            draft_tokens_accepted=s.accepted)
        self.slots[slot] = None
        self.kv.retire(slot)
        if self.spec is not None:
            self.spec.retire_slot(slot)
        self.retired += 1

    def _spec_cycle(self, results, params, t0, alive: List[int]) -> None:
        """One self-speculative cycle for the ``alive`` slots (their carry
        tokens ``t0`` are already recorded): draft ``k_eff`` proposals,
        verify all ``k_eff + 1`` positions in one forward, emit the longest
        verifier-matching prefix per slot, rewind the rejected suffix, and
        install the divergence-row logits as the slot's pending logits, so
        the next sampled token is exactly what verifier-only decode would
        have produced."""
        cfg = self.cfg
        k_eff, accept, drafts, lg = self.spec.run_cycle(
            params, self._ver.draft_params, t0, alive)
        survivors: List[int] = []
        acc_rows: List[int] = []
        t_now = time.perf_counter()
        for i in alive:
            s = self.slots[i]
            a = int(accept[i])
            eid = _req_eos(s.req, cfg)
            emitted = 0
            retired = False
            for j in range(a):
                tok = int(drafts[i, j])
                s.tokens.append(tok)
                emitted += 1
                if (len(s.tokens) >= s.req.max_new_tokens
                        or (eid >= 0 and tok == eid)):
                    retired = True
                    break
            s.proposed += k_eff
            s.accepted += emitted
            self.spec.accepted += emitted
            self.spec.accepted_len_log.append(1 + emitted)
            if retired:
                self._finish(results, i, t_now)
            else:
                # verify advanced the slot by k_eff + 1: keep the carry
                # token and the accepted drafts, return the rest to the
                # slot's block reservation
                self.kv.rewind(i, k_eff - a)
                self.spec.sync_slot(i)
                survivors.append(i)
                acc_rows.append(a)
        if survivors:
            self.kv.carry_logits(lg, survivors, acc_rows)

    def stats(self) -> SchedulerStats:
        ms = np.asarray(self.step_ms_log, np.float64)
        tail = {f"p{q}": float(np.percentile(ms, q)) for q in (50, 95, 99)} \
            if ms.size else {}
        return SchedulerStats(
            kind=self.name, max_slots=self.max_slots,
            steps=self.steps_total, admitted=self.admitted,
            retired=self.retired, waves=self.waves,
            drains=self.drains, forced_swaps=self.forced_swaps,
            mean_occupancy=(self.occupancy_sum / self.steps_total
                            if self.steps_total else 0.0),
            max_occupancy=self.max_occupancy,
            prefill_chunk=self.chunk,
            chunk_steps=self.chunk_steps,
            pendings_started=self.pendings_started,
            pendings_abandoned=self.pendings_abandoned,
            step_ms=tail,
            kv=self.kv.stats(),
            speculative=self.spec is not None,
            **(self.spec.stats() if self.spec is not None else {}))

    # ------------------------------------------- chunked admission pipeline
    def _start_pending(self, queue, free_ids, fresh: bool,
                       version: int, limit_head: bool = False):
        """Pick requests for a chunked admission. Contiguous: fresh waves
        reuse the contiguous pick (the wave's padding is the target);
        mid-flight picks grow the set under the solved target, re-checking
        every earlier choice as it rises. Paged: ``kv.pick`` for fresh and
        mid-flight alike, and every entry's block budget reserved now."""
        if self.kv.backend == "paged":
            chosen, _ = self.kv.pick(queue, len(free_ids), fresh,
                                     limit_head)
            if not chosen:
                return []
            if fresh:
                self.waves += 1
            slot_ids = list(free_ids[:len(chosen)])
            for (_, r), slot in zip(chosen, slot_ids):
                self.kv.reserve_pending(slot, r)
            self._pending = PagedPendingPrefill(
                chosen=chosen, slot_ids=slot_ids, version=version)
            self.pendings_started += 1
            return chosen
        max_len = self.cfg.max_len
        if fresh:
            chosen, target = self.kv.pick(queue, len(free_ids), True, False)
        else:
            chosen = []
            target = None
            items = [queue[0]] if limit_head else list(queue)
            for item in items:
                if len(chosen) >= len(free_ids):
                    break
                _, r = item
                cand_t = self.kv.solve_target(
                    max([len(r.prompt)]
                        + [len(c.prompt) for _, c in chosen]))
                if cand_t is None:
                    continue
                if (cand_t + r.max_new_tokens <= max_len
                        and all(cand_t + c.max_new_tokens <= max_len
                                for _, c in chosen)):
                    chosen.append(item)
                    target = cand_t
            for item in chosen:
                queue.remove(item)
        if not chosen:
            return []
        if fresh:
            self.waves += 1
        k = len(chosen)
        tokens = np.full((k, target), self.cfg.pad_id, np.int64)
        for j, (_, r) in enumerate(chosen):
            tokens[j, target - len(r.prompt):] = np.asarray(r.prompt)
        self._pending = PendingPrefill(chosen=chosen,
                                       slot_ids=list(free_ids[:k]),
                                       target=target, version=version,
                                       tokens=tokens)
        self.pendings_started += 1
        return chosen

    def _advance_pending(self, params) -> float:
        """Consume up to ``prefill_chunk`` positions of the pending's padded
        prompt on the side cache; returns the chunk's wall time."""
        p = self._pending
        if isinstance(p, PagedPendingPrefill):
            return self._advance_pending_paged(params)
        n = min(self.chunk, p.remaining)
        if n <= 0:
            return 0.0
        if p.cache is None:
            p.cache = self.kv.side_cache(len(p.slot_ids))
        t0 = time.perf_counter()
        toks = torch.from_numpy(
            np.ascontiguousarray(p.tokens[:, p.done:p.done + n])
        ).to(self.eng.device)
        # synchronous on purpose: chunks queued up behind the in-flight
        # decode would build a backlog that the scatter step pays in one
        # spike — the tail this feature bounds
        p.logits, p.cache = self.eng._prefill_chunk(
            params, {"tokens": toks}, p.cache)
        self.eng._sync()
        ms = (time.perf_counter() - t0) * 1e3
        p.prefill_ms += ms
        p.chunks += 1
        p.done += n
        self.chunk_steps += 1
        return ms

    def _advance_pending_paged(self, params) -> float:
        """One chunk step of the current paged pending entry. The first step
        pins + gathers the entry's shared prefix; each step consumes up to
        ``prefill_chunk`` unshared suffix positions on the 1-row side cache;
        a completed entry scatters into its reserved blocks and starts
        decoding at once while later entries keep chunking."""
        p = self._pending
        _, r = p.chosen[p.entry]
        slot = p.slot_ids[p.entry]
        t0 = time.perf_counter()
        if p.cache is None:
            p.lp, p.cache = self.kv.begin_chunked_admit(slot, r)
            p.suffix = np.asarray([int(t) for t in r.prompt[p.lp:]],
                                  np.int64)
            p.done = 0
            p.chunks = 0
            p.entry_ms = 0.0
        n = min(self.chunk, len(p.suffix) - p.done)
        # static inputs (this width's token buffer, the 0-d clock) for the
        # chunk graph of width n; the host keeps the integer clock
        toks, p.cache["pos"] = self.kv.chunk_inputs(
            p.suffix[p.done:p.done + n], p.lp + p.done)
        p.logits, p.cache = self.eng._prefill_chunk(
            params, {"tokens": toks}, p.cache)
        self.eng._sync()
        p.done += n
        p.chunks += 1
        self.chunk_steps += 1
        if p.done >= len(p.suffix):
            self.kv.complete_chunked_admit(slot, r, p.lp, p.cache, p.logits)
            ms = (time.perf_counter() - t0) * 1e3
            p.entry_ms += ms
            order = p.chosen[p.entry][0]
            self.slots[slot] = _Slot(
                order=order, req=r, version=p.version,
                clock0=len(r.prompt), t0=time.perf_counter(),
                prefill_ms=p.entry_ms, swap_ms=self._pending_swap_ms)
            if self.spec is not None:
                # the drafter needs its own prompt K/V before the slot's
                # first cycle: one unpadded batch-1 prefill on the draft
                # tree (only the verifier side is chunked)
                self.spec.admit_slot(slot, r.prompt, self._ver.draft_params)
            self.admission_log.append(
                {"request_id": r.request_id, "slot": slot,
                 "clock": len(r.prompt), "version": p.version,
                 "chunks": p.chunks})
            self.admitted += 1
            p.entry += 1
            p.cache = None
            if p.entry >= len(p.chosen):
                self._pending_swap_ms = 0.0
                self._pending = None
            return ms
        ms = (time.perf_counter() - t0) * 1e3
        p.entry_ms += ms
        return ms

    def _scatter_pending(self, p: PendingPrefill) -> None:
        """A completed contiguous pending joins the pool at its committed
        clock and creates its slots."""
        t0 = time.perf_counter()
        self.kv.scatter(p)
        p.prefill_ms += (time.perf_counter() - t0) * 1e3
        t_now = time.perf_counter()
        for j, (order, r) in enumerate(p.chosen):
            self.slots[p.slot_ids[j]] = _Slot(
                order=order, req=r, version=p.version, clock0=p.target,
                t0=t_now, prefill_ms=p.prefill_ms,
                swap_ms=self._pending_swap_ms)
            self.admission_log.append(
                {"request_id": r.request_id, "slot": p.slot_ids[j],
                 "clock": p.target, "version": p.version,
                 "chunks": p.chunks})
        self._pending_swap_ms = 0.0
        self.admitted += len(p.chosen)
        self._pending = None

    def _abandon_pending(self, queue) -> None:
        """A forced swap lands while a chunked admission is mid-prefill: its
        chunks ran on the outgoing weights, so drop the side cache and
        return its requests to the front of the queue in FCFS order. Paged:
        entries already complete are live slots; the others also release
        their reservations and prefix pins (``abandon_chunked_admit``)."""
        p = self._pending
        if isinstance(p, PagedPendingPrefill):
            for j in range(len(p.chosen) - 1, p.entry - 1, -1):
                self.kv.abandon_chunked_admit(p.slot_ids[j])
                queue.appendleft(p.chosen[j])
        else:
            for item in reversed(p.chosen):
                queue.appendleft(item)
        self._pending = None
        self.pendings_abandoned += 1

    def _sync_kv_version(self, version: int) -> None:
        """Cached prefix K/V blocks and captured steps depend on the weight
        version: whenever the acquired version differs from the one the KV
        cache was built under, flush its reuse state and drop the engine's
        graphs before any admission runs on it."""
        if self._kv_version != version:
            if self._kv_version is not None:
                self.kv.on_weight_swap()
                # captured steps hold the outgoing weights' addresses
                self.eng._drop_graphs()
            self._kv_version = version

    def _admit(self, chosen, free_ids, clock, params, version: int):
        """Admit ``chosen`` into the first ``len(chosen)`` free slots via the
        KV cache (contiguous: one left-padded batch prefill + row scatter;
        paged: per-request prefix lookup + suffix prefill + block scatter,
        each slot at its own prompt length)."""
        k = len(chosen)
        slot_ids = list(free_ids[:k])
        t0 = time.perf_counter()
        self.kv.admit(chosen, slot_ids, clock, params)
        prefill_ms = (time.perf_counter() - t0) * 1e3
        t_now = time.perf_counter()
        for j, (order, r) in enumerate(chosen):
            c0 = clock if clock is not None else len(r.prompt)
            self.slots[slot_ids[j]] = _Slot(
                order=order, req=r, version=version, clock0=c0,
                t0=t_now, prefill_ms=prefill_ms,
                swap_ms=self._pending_swap_ms)
            if self.spec is not None:
                self.spec.admit_slot(slot_ids[j], r.prompt,
                                     self._ver.draft_params)
            self.admission_log.append(
                {"request_id": r.request_id, "slot": slot_ids[j],
                 "clock": c0, "version": version})
        self._pending_swap_ms = 0.0
        self.admitted += k
