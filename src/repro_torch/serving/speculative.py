"""Self-speculative decoding: the w4 quantization drafts for the w8 verifier.

SQuant's on-the-fly, data-free quantization produces several bit-widths of
one checkpoint essentially for free (sub-second, no data, no BP), which
turns the quantization ladder into a speculative-decoding ladder: the
serving tree (e.g. w8) is the verifier, and a lower-bit tree
(``ServeConfig.draft_bits``, default w4) of the SAME checkpoint is the
drafter. Both trees are staged and swapped together as one
:class:`~repro_torch.serving.weights.WeightVersion` pair.

Per continuous-scheduler step (paged backend only: per-slot positions and
:meth:`PagedKVCache.rewind` are required):

1. the scheduler samples the carry token ``t0`` from the verifier's pending
   logits, exactly as in verifier-only decode;
2. the draft tree autoregressively proposes ``k_eff <= draft_k`` tokens
   ``d_1..d_k`` on its own contiguous draft cache (the argmax chains on the
   device: no host sync per draft token);
3. the verifier scores all ``k_eff + 1`` positions ``[t0, d_1..d_k]`` in ONE
   multi-position forward (``LM.verify_step`` on the paged pool: row ``j``
   is bit for bit the logits a decode step at that position gives);
4. the longest prefix of drafts matching the verifier's own argmax is
   accepted; the rejected suffix is rolled back (``kv.rewind``) and the
   verifier row at the divergence point becomes the next pending logits, so
   the next ``t0`` is exactly the token verifier-only decode produces there.

Greedy acceptance therefore makes the emitted tokens **bit-identical to
verifier-only decode**: every emitted token is either verified-argmax-equal
to a draft, or the verifier's own argmax. Speculation changes only the
steps per token, never the tokens. The cycle has one host sync, for drafts
and verdict together.

The draft cache is a plain contiguous ``(max_slots, max_len)`` cache with
*per-slot* positions (paged slots are not left-padded), fed through the
per-row decode positions of :mod:`repro_torch.models.attention`. Draft
rewind is position-only: stale draft rows past the accepted length are
masked by position and overwritten by later proposals.

On a CUDA device the draft chain is captured as one CUDA graph per
``k_eff`` (``trace_counts["draft_chain"]``) over static buffers: the draft
positions ``(max_slots,)`` and, per ``k_eff``, a ``(max_slots, k_eff + 1)``
run buffer whose column 0 holds ``t0`` and whose other columns receive the
drafts; the verify forward's graph reads the same run buffer. The drafter's
admission prefill and row scatter stay eager (``draft_prefill`` and
``draft_admit`` stay 0).
"""
from __future__ import annotations

import collections
from typing import Any, Dict, List

import numpy as np
import torch

__all__ = ["SpeculativeDecoder"]


class SpeculativeDecoder:
    """Draft-side state and the draft/verify device plumbing for one
    continuous scheduler. The scheduler keeps slot bookkeeping (emission,
    EOS/budget retirement, Completion assembly); this object owns the draft
    cache, the chain and verify calls, and the acceptance arithmetic."""

    def __init__(self, engine, kv):
        self.eng = engine
        self.cfg = engine.cfg
        self.model = engine.model
        self.kv = kv                      # the PagedKVCache (verifier side)
        self.max_slots = kv.max_slots
        self.draft_k = int(self.cfg.draft_k)
        # host-authoritative draft positions, pushed per chain call
        self.draft_lengths = np.zeros((self.max_slots,), np.int32)
        self._draft_cache = None          # contiguous (max_slots, max_len)
        self._draft_pos = None            # its static position vector
        self._pos_host = None             # the positions' (pinned) staging
        self._runs: Dict[int, torch.Tensor] = {}   # S -> (max_slots, S)
        # lazy counters: non-speculative runs keep their exact trace_counts
        for name in ("draft_prefill", "draft_chain", "draft_admit"):
            engine.trace_counts.setdefault(name, 0)
        self._chain = engine._graph_counted("draft_chain", self._chain_fn)
        self._sched = None
        # observability (surfaced through SchedulerStats)
        self.cycles = 0
        self.proposed = 0
        self.accepted = 0
        self.accepted_len_log: collections.deque = \
            collections.deque(maxlen=4096)

    def bind(self, scheduler) -> None:
        self._sched = scheduler

    # ------------------------------------------------------------ admission
    def _ensure_cache(self) -> None:
        if self._draft_cache is None:
            # fp cache whatever quantize_kv says (speculation is gated off
            # quantize_kv anyway; the drafter only needs self-consistency)
            dev = self.eng.device
            n = self.max_slots
            self._draft_cache = self.model.init_cache(
                n, self.cfg.max_len, quantize_kv=False, device=dev)
            self._draft_pos = torch.zeros((n,), dtype=torch.int32,
                                          device=dev)
            self._pos_host = torch.zeros((n,), dtype=torch.int32,
                                         pin_memory=dev.type == "cuda")
            self._draft_cache["pos"] = self._draft_pos

    def admit_slot(self, slot: int, prompt, draft_params) -> None:
        """Prefill the slot's prompt on the draft tree (batch 1, unpadded:
        the shapes of the paged admission prefill) and copy the rows into
        the slot's row of the draft cache. The prefill's logits are
        discarded: the chain always starts from the verifier-sampled carry
        token, never from a draft-tree sample."""
        self._ensure_cache()
        dev = self.eng.device
        side = self.model.init_cache(1, self.cfg.max_len, quantize_kv=False,
                                     device=dev)
        toks = torch.tensor([[int(t) for t in prompt]], dtype=torch.int64,
                            device=dev)
        _, side = self.model.prefill(draft_params, {"tokens": toks}, side)
        _admit_draft_rows(self._draft_cache, side, slot)
        self.draft_lengths[slot] = len(prompt)

    def retire_slot(self, slot: int) -> None:
        """Stale draft rows are masked by position; only the position needs
        resetting (a later admission prefills the row again)."""
        self.draft_lengths[slot] = 0

    # ---------------------------------------------------------------- chain
    def _chain_fn(self, params, run, cache):
        """The draft chain over the ``(max_slots, S)`` run buffer: column 0
        holds the carry tokens, and ``S`` decode feeds of the draft tree
        write the argmax proposals into columns ``1..S-1``. The last feed
        writes the LAST proposal's K/V row (its logits are discarded), so a
        fully accepted run leaves no gap in the draft cache."""
        tok = run[:, :1]
        for j in range(1, run.shape[1]):
            lg, cache = self.model.decode_step(params, tok, cache)
            tok = torch.argmax(lg, dim=-1, keepdim=True)
            run[:, j:j + 1].copy_(tok)
        _, cache = self.model.decode_step(params, tok, cache)
        return run, cache

    def _run_buffer(self, s: int) -> torch.Tensor:
        buf = self._runs.get(s)
        if buf is None:
            buf = self._runs[s] = torch.zeros(
                (self.max_slots, s), dtype=torch.int64,
                device=self.eng.device)
        return buf

    def propose(self, draft_params, t0: torch.Tensor, k_eff: int
                ) -> torch.Tensor:
        """Run the draft chain from the carry tokens ``t0`` (``(max_slots,)``
        on the device): returns the ``(max_slots, k_eff + 1)`` run buffer
        ``[t0, d_1..d_k]``. Rows of slots outside the speculating set draft
        garbage into their own (position-masked) cache rows and are
        ignored by the caller."""
        self._ensure_cache()
        run = self._run_buffer(k_eff + 1)
        run[:, 0].copy_(t0)
        # the positions through their own staging buffer: written once a
        # cycle, before the cycle's one host sync waits for the copy
        self._pos_host.copy_(torch.from_numpy(self.draft_lengths))
        self._draft_pos.copy_(self._pos_host, non_blocking=True)
        self._chain(draft_params, run, self._draft_cache)
        return run

    # ---------------------------------------------------------------- cycle
    def run_cycle(self, params, draft_params, t0, alive: List[int]):
        """One draft→verify cycle for the ``alive`` slots.

        ``t0``: the ``(max_slots,)`` carry tokens the scheduler just sampled
        (and recorded). Returns ``(k_eff, accept, drafts_np,
        verify_logits)``: ``accept[i]`` is slot i's count of verifier-
        matching draft tokens (0..k_eff), ``drafts_np`` the ``(max_slots,
        k_eff)`` proposals, ``verify_logits`` the device ``(max_slots,
        k_eff+1, vocab)`` verifier output, whose row ``accept[i]`` of slot
        ``i`` is that slot's carry logits for the next step.

        The verifier's lengths advance by ``k_eff + 1`` inside
        ``kv.verify``; the CALLER rewinds survivors by ``k_eff -
        accept[i]``, resyncs their draft positions (:meth:`sync_slot`) and
        retires finished slots."""
        # uniform chain depth, clamped so no slot's verify writes run past
        # its reserved blocks (budget >= 1 for every alive slot)
        k_eff = min([self.draft_k] + [self._budget(i) for i in alive])
        run = self.propose(draft_params, t0, k_eff)
        lg, verdict = self.kv.verify(params, run, alive)
        # the cycle's one host sync: drafts and verdict together
        host = torch.cat([run[:, 1:], verdict], dim=1).cpu().numpy()
        drafts_np, verdict_np = host[:, :k_eff], host[:, k_eff:]
        match = drafts_np == verdict_np
        # longest matching prefix: index of the first mismatch (or k_eff)
        accept = np.where(match.all(axis=1), k_eff, np.argmin(match, axis=1))
        self.cycles += 1
        self.proposed += k_eff * len(alive)
        return k_eff, accept, drafts_np, lg

    def _budget(self, slot: int) -> int:
        """Remaining token budget of an alive slot (>= 1 by the caller's
        retirement invariant): the cap that keeps verify writes inside the
        slot's reserved blocks."""
        s = self._sched.slots[slot]
        return s.req.max_new_tokens - len(s.tokens)

    def sync_slot(self, slot: int) -> None:
        """After the scheduler rewound the verifier, mirror the accepted
        length into the draft clock (draft rewind is position-only)."""
        self.draft_lengths[slot] = int(self.kv._lengths[slot])

    def stats(self) -> Dict[str, Any]:
        al = np.asarray(self.accepted_len_log, np.float64)
        tail = {f"p{q}": float(np.percentile(al, q)) for q in (50, 95)} \
            if al.size else {}
        return {"spec_cycles": self.cycles,
                "draft_tokens_proposed": self.proposed,
                "draft_tokens_accepted": self.accepted,
                "acceptance_rate": (self.accepted / self.proposed
                                    if self.proposed else 0.0),
                "accepted_len": tail}


def _admit_draft_rows(pool, side, slot: int) -> None:
    """Copy the 1-row draft prefill cache into row ``slot`` of the draft
    pool, in place. ``pos`` is host-managed and left untouched."""
    for period, sp in zip(pool["list"], side["list"]):
        for blk in period:
            for name, leaf in period[blk].items():
                leaf[slot] = sp[blk][name][0].to(leaf.dtype)
