"""Slot scheduler for the serving engine: the static round scheduler.

Scheduling model
----------------
Model caches keep ONE decode position (``cache["pos"]``) for the whole
batch, so every sequence in a batch decodes in lockstep at a shared clock.

* :class:`RoundScheduler` — static batching: requests are grouped into
  rounds of up to ``max_batch``, left-padded to the round's longest prompt,
  and decoded in lockstep until every request in the round finishes.
  Prefill/cache/decode are sized to the *actual* round batch. Weight swaps
  land only between rounds: a round holds the ``WeightVersion`` it started
  with to its end.

Each decode step synchronizes with the host exactly once (the sampled tokens
are read back to decide EOS and to record them).

Not ported yet: the continuous-batching scheduler (slot pool, reload-aware
drain, chunked admission).
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.serving.api import Completion, Request, SchedulerStats
from repro_torch.serving.kvcache import KVCache
from repro_torch.serving.sampling import sample


def _req_eos(req: Request, cfg) -> int:
    """Per-request EOS override (None: the engine-global eos_id)."""
    return cfg.eos_id if req.eos_id is None else req.eos_id


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

    def _sync(self) -> None:
        if self.eng.device.type == "cuda":
            torch.cuda.synchronize(self.eng.device)


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
        t0 = time.perf_counter()
        logits, cache = self.model.prefill(params, batch, cache)
        self._sync()
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
            logits, cache = self.model.decode_step(
                params, nxt[:, None].to(torch.int64), cache)
        self._sync()
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
