"""KV-cache API for the serving engine.

Cache allocation, the decode-position clock, admission side caches and row /
block scatter are owned here, behind one interface with two backends, so
schedulers never touch cache dicts by hand:

* :class:`ContiguousKVCache` — ONE ``max_slots``-row cache, slot = cache
  row, a single integer clock shared by every slot, prompts left-padded to
  the clock at admission (the round scheduler takes a fresh per-round cache
  from :meth:`KVCache.fresh` instead). The bit-exactness oracle of the paged
  backend.

* :class:`PagedKVCache` — K/V in a pool of fixed-size blocks; each slot
  reaches its tokens through a per-slot block table, with a free list,
  refcounts and copy-on-write. Prompts are not left-padded: slot ``b``'s
  tokens sit at positions ``0..L-1`` with a per-slot length as its clock.

Shared-prefix reuse (paged): admitted prompts are chain-hashed at block
granularity; full blocks whose hash and content match a registered block
are *shared* into the new slot's table with a refcount bump, and the
admission prefill shrinks to the unshared suffix (a ``prefill_chunk``
continuation over the gathered prefix). A partially filled tail block can be
shared for its values; a write into a block with other sharers triggers
copy-on-write (``cow_copies``). Retired slots drop their refs; registered
blocks park in a reclaimable cached set (evicted FIFO when the free list
runs dry). Physical block 0 is the *trash block*: retired slots' table rows
point at it, so the batched decode (which writes one K/V row per slot)
never corrupts a live block. Admission reserves the full
``ceil((len(prompt) + max_new) / block_size)`` block budget up front, so an
admitted request can always finish.

Chunked admission (``prefill_chunk > 0``, paged) is a multi-step
lifecycle: ``reserve_pending`` → ``begin_chunked_admit`` (prefix pin +
gather, before any chunk) → N ``prefill_chunk`` continuations on a 1-row
side cache while residents decode → ``complete_chunked_admit`` (or
``abandon_chunked_admit`` on a forced swap, which unpins and releases the
reservation).

Unlike the reference, whose cache operations return new arrays, the device
operations here (:func:`admit_rows`, :func:`gather_blocks`,
:func:`scatter_blocks`, :func:`copy_block`, the decode write) update the
pool *in place*, on the current stream, so each completes before any later
write it protects. Side caches are separate allocations, never views of the
pool. Host tables and lengths are pushed to the device from snapshots that
the host does not mutate before the copy has run, never from views of
state that changes right after the decode is launched. Int8 pools
(``quantize_kv``) move their four leaves (``k``, ``v``, ``k_scale``,
``v_scale``) through every block operation.

The paged backend feeds its decode step and its admission chunks through
static device buffers (the tokens, the per-slot positions and block tables,
the chunk's tokens per width and its 0-d clock) and one logits buffer that
is never rebound, so the engine can capture them as CUDA graphs
(:meth:`ServeEngine._graph_counted`); the host keeps its integer clocks.

Speculative decoding (paged only): :meth:`PagedKVCache.verify` writes and
scores ``S`` positions per slot in one forward through the same static
positions and tables as the decode step (captured per ``S``, the verdict
argmax inside the graph), :meth:`PagedKVCache.carry_logits` installs the
divergence row as a slot's pending logits, and :meth:`PagedKVCache.rewind`
returns the rejected suffix's blocks to the slot's reservation. The
contiguous backend shares one clock and cannot rewind a slot.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

TRASH = 0   # reserved physical block: write target for retired slots

__all__ = ["KVCache", "ContiguousKVCache", "PagedKVCache", "admit_rows",
           "gather_blocks", "scatter_blocks", "copy_block", "TRASH"]


# ---------------------------------------------------------------------------
# device cache operations (in place on the caller's pool)
# ---------------------------------------------------------------------------

def _leaves(cache) -> Iterator[torch.Tensor]:
    """The cache's tensors, layer by layer in a fixed order (two caches of
    one model's structure yield matching leaves)."""
    for period in cache["list"]:
        for blk in sorted(period):
            for name in sorted(period[blk]):
                yield period[blk][name]


def admit_rows(pool, tmp, pool_logits, tmp_logits, idx):
    """Scatter a ``k``-row prefill cache + its last-token logits into the
    ``max_slots``-row pool at slot indices ``idx`` (in place). The side
    cache's clock, computed by the admission prefill, replaces the pool's.
    Returns ``(pool, pool_logits)``."""
    for p, t in zip(_leaves(pool), _leaves(tmp)):
        p[idx] = t.to(p.dtype)
    pool["pos"] = tmp["pos"]
    pool_logits[idx] = tmp_logits.to(pool_logits.dtype)
    return pool, pool_logits


def gather_blocks(side, pool, phys):
    """Copy pool blocks ``phys`` (logical order, ``(n,)`` int64) into the
    first ``n * block_size`` positions of the 1-row contiguous ``side``
    cache — the admission-side materialization of a shared prefix."""
    for s, p in zip(_leaves(side), _leaves(pool)):
        blk = p[phys]                                  # (n, bs, ...)
        flat = blk.reshape((-1,) + tuple(blk.shape[2:]))
        s[0, :flat.shape[0]] = flat.to(s.dtype)
    return side


def scatter_blocks(pool, side, phys, start: int):
    """Write side-cache positions ``[start*bs, (start+n)*bs)`` into pool
    blocks ``phys`` (``(n,)`` int64)."""
    n = phys.shape[0]
    for p, s in zip(_leaves(pool), _leaves(side)):
        bs = p.shape[1]
        seg = s[0, start * bs:(start + n) * bs]
        p[phys] = seg.reshape((n, bs) + tuple(seg.shape[1:])).to(p.dtype)
    return pool


def copy_block(pool, src: int, dst: int):
    """Pool-to-pool block copy (decode-time copy-on-write)."""
    for p in _leaves(pool):
        p[dst] = p[src]
    return pool


# ---------------------------------------------------------------------------
# interface
# ---------------------------------------------------------------------------

class KVCache:
    """Backend-neutral KV-cache state owned on behalf of a scheduler.

    Use :meth:`create` (reads ``ServeConfig.kv_backend``)."""

    backend = "abstract"

    def __init__(self, engine):
        self.eng = engine
        self.cfg = engine.cfg
        self.model = engine.model
        self.max_slots = engine.cfg.max_slots or engine.cfg.max_batch
        self._cache = None            # persistent pool cache (lazy init)
        self._logits = None           # (max_slots, vocab) pending logits
        # admission side caches, keyed by row count and reused across
        # admissions: stale KV rows are harmless (every position is
        # rewritten before any masked-in read); only the clock is rewound.
        # Stacks with recurrent state take a fresh one every admission
        # (:meth:`side_cache`)
        self._side_caches: Dict[int, Any] = {}

    @staticmethod
    def create(engine) -> "KVCache":
        """The one serving entry point for cache construction."""
        backend = getattr(engine.cfg, "kv_backend", "contiguous")
        if backend == "paged":
            return PagedKVCache(engine)
        return ContiguousKVCache(engine)

    # ------------------------------------------------------------- plumbing
    def fresh(self, rows: int) -> dict:
        """A standalone contiguous cache (the round scheduler's per-round
        cache) on the engine's device."""
        return self.model.init_cache(rows, self.cfg.max_len,
                                     quantize_kv=self.cfg.quantize_kv,
                                     device=self.eng.device)

    def side_cache(self, k: int) -> dict:
        """A ``k``-row admission cache with the clock rewound. It is its own
        allocation (never a view of the pool) and is written in place by the
        admission prefill.

        Reused across admissions, except for stacks with recurrent state
        (mamba/rwkv), which get a fresh allocation every time: their state
        leaves are read at the first chunk of a chunked admission, and a
        retired request's state is not masked out the way stale KV rows
        are."""
        if self.model.has_recurrent_state():
            return self.fresh(k)
        cache = self._side_caches.get(k)
        if cache is None:
            cache = self.fresh(k)
            self._side_caches[k] = cache
        return dict(cache, pos=0)

    def _device_index(self, values) -> torch.Tensor:
        """A host list / array as an int64 index tensor on the device (a
        blocking copy of a fresh host array)."""
        return torch.tensor(np.asarray(values, np.int64),
                            device=self.eng.device)

    @property
    def logits(self):
        """Last-token logits per slot, sampled by the scheduler."""
        return self._logits

    def begin_run(self) -> None:
        """Called at the top of each ``run()``."""

    def check_request(self, req) -> None:
        """Backend-specific admissibility (beyond the shared horizon)."""

    def on_weight_swap(self) -> None:
        """Invalidate weight-version-dependent cached state."""

    def rewind(self, slot_id: int, n: int) -> None:
        """Roll one slot back (speculative decoding). Contiguous caches
        share one clock and cannot rewind one slot."""
        raise NotImplementedError(
            f"rewind is not supported by the {self.backend!r} KV backend")

    def stats(self) -> Dict[str, Any]:
        return {"backend": self.backend}


# ---------------------------------------------------------------------------
# contiguous backend (the bit-exactness oracle)
# ---------------------------------------------------------------------------

class ContiguousKVCache(KVCache):
    """One ``max_slots``-row cache with a shared integer clock; admission
    left-pads prompts to the clock and scatters side-cache rows into the
    pool (the :func:`admit_rows` path)."""

    backend = "contiguous"

    def __init__(self, engine):
        super().__init__(engine)
        self._clock = 0

    @property
    def clock(self) -> int:
        """The shared decode position (read-only: advanced by
        :meth:`decode`, set by admissions)."""
        return self._clock

    def begin_run(self) -> None:
        self._clock = 0

    # ----------------------------------------------------------- admission
    def pick(self, queue, nfree: int, fresh: bool, limit_head: bool
             ) -> Tuple[List, Optional[int]]:
        """Choose up to ``nfree`` queued requests admissible at the clock.

        Mid-flight (``fresh=False``): FCFS with skip — a request fits iff
        its prompt fits under the clock (``L <= clock``) and its budget fits
        the cache horizon. ``limit_head`` narrows the scan to the queue head
        (the starvation guard). Fresh wave (``fresh=True``): the pool is
        empty, so the clock restarts at the wave's longest admitted prompt;
        the head is always admitted, and every earlier choice is re-checked
        against the raised clock."""
        max_len = self.cfg.max_len
        clock = self._clock
        chosen: List = []
        new_clock = 0 if fresh else clock
        items = [queue[0]] if (limit_head and not fresh) else list(queue)
        for item in items:
            if len(chosen) >= nfree:
                break
            _, r = item
            if fresh:
                cand = max(new_clock, len(r.prompt))
                if (cand + r.max_new_tokens <= max_len
                        and all(cand + c.max_new_tokens <= max_len
                                for _, c in chosen)):
                    chosen.append(item)
                    new_clock = cand
            else:
                if (len(r.prompt) <= clock
                        and clock + r.max_new_tokens <= max_len):
                    chosen.append(item)
        for item in chosen:
            queue.remove(item)
        return chosen, new_clock

    def solve_target(self, longest: int) -> Optional[int]:
        """Committed completion clock for a mid-flight chunked admission:
        ``P = clock + s - 1`` after ``s`` chunk-steps, with the chunks
        covering all ``P`` positions (``s * chunk >= P``) and the prompt
        fitting the padding (``P >= longest``). None when no ``s`` exists
        (``chunk == 1`` against a moving clock)."""
        clock = self._clock
        chunk = int(self.cfg.prefill_chunk or 0)
        s = max(1, longest - clock + 1)
        if chunk > 1:
            s = max(s, -(-(clock - 1) // (chunk - 1)))
        elif clock + s - 1 > s:
            return None
        return clock + s - 1

    def _ensure_pool(self, lg) -> None:
        if self._cache is None:
            self._cache = self.fresh(self.max_slots)
            self._logits = torch.zeros((self.max_slots, lg.shape[-1]),
                                       dtype=lg.dtype, device=lg.device)

    def admit(self, chosen, slot_ids, clock: int, params) -> None:
        """Monolithic admission: prefill ``chosen`` left-padded to ``clock``
        on a side cache and scatter the rows into the pool. Blocks until
        the device work is done (callers time around it)."""
        k = len(chosen)
        tokens = np.full((k, clock), self.cfg.pad_id, np.int64)
        for j, (_, r) in enumerate(chosen):
            tokens[j, clock - len(r.prompt):] = np.asarray(r.prompt)
        tmp_cache = self.side_cache(k)
        lg, tmp_cache = self.eng._prefill(
            params, {"tokens": torch.from_numpy(tokens).to(self.eng.device)},
            tmp_cache)
        self._ensure_pool(lg)
        idx = self._device_index(slot_ids[:k])
        self._cache, self._logits = self.eng._admit_rows(
            self._cache, tmp_cache, self._logits, lg, idx)
        self.eng._sync()
        self._clock = clock

    def scatter(self, pending) -> None:
        """A completed chunked admission joins the pool: scatter its
        side-cache rows and final-token logits at the committed clock."""
        self._ensure_pool(pending.logits)
        idx = self._device_index(pending.slot_ids)
        self._cache, self._logits = self.eng._admit_rows(
            self._cache, pending.cache, self._logits, pending.logits, idx)
        self.eng._sync()
        self._clock = pending.target

    # -------------------------------------------------------------- decode
    def decode(self, params, nxt, active_ids) -> None:
        self._logits, self._cache = self.eng._decode(
            params, nxt[:, None].to(torch.int64), self._cache)
        self._clock += 1

    def retire(self, slot_id: int) -> None:
        """Contiguous rows are recycled implicitly (masked by position)."""

    def stats(self) -> Dict[str, Any]:
        return {"backend": self.backend, "clock": self._clock}


# ---------------------------------------------------------------------------
# paged backend
# ---------------------------------------------------------------------------

class PagedKVCache(KVCache):
    """Block-pool KV cache with per-slot block tables, prefix sharing and
    copy-on-write. Invariants (asserted by :meth:`check_invariants`):

    * every physical block is in exactly one of {free list, cached set
      (ref == 0, registered, evictable), active (ref > 0)}, plus the
      reserved trash block;
    * registered blocks are immutable: any write into a block another slot
      might read lands on a private copy (COW);
    * an admitted slot can always finish: its remaining decode blocks are
      reserved, and allocation draws from the free list, then evicts cached
      blocks FIFO.
    """

    backend = "paged"

    def __init__(self, engine):
        super().__init__(engine)
        cfg = self.cfg
        self.block_size = cfg.block_size
        self.nb_per_slot = cfg.max_len // cfg.block_size
        self.num_blocks = cfg.kv_blocks or \
            (self.max_slots * self.nb_per_slot + 1)
        # host-authoritative paging state (pushed to the device per decode)
        self._tables = np.full((self.max_slots, self.nb_per_slot), TRASH,
                               np.int32)
        self._lengths = np.zeros((self.max_slots,), np.int32)
        self._ref = np.zeros((self.num_blocks,), np.int32)
        self._free: List[int] = list(range(self.num_blocks - 1, TRASH, -1))
        self._cached: Dict[int, None] = {}     # ref==0 registered, FIFO
        self._slot_reserved = np.zeros((self.max_slots,), np.int32)
        self._reserved = 0
        # shared-prefix blocks pinned by an in-flight admission, held OUT of
        # the slot's table until commit: decode writes every batch row at
        # its position, and an in-flight slot sits at position 0 with an
        # all-TRASH table, so a pinned registered block is never written
        self._pending_pins: Dict[int, List[int]] = {}
        # static inputs of the decode step (made with the pool) and of the
        # chunk forwards: a captured forward reads them by address
        self._dec_tokens = self._dec_pos = self._dec_tables = None
        self._chunk_tokens: Dict[int, torch.Tensor] = {}    # width -> (1, n)
        self._chunk_clock: Optional[torch.Tensor] = None     # 0-d int64
        # prefix registry: chain hash -> (phys, block tokens) for full
        # blocks (content-verified on match), parent hash -> (phys, fill,
        # tokens) for one partial tail per chain position
        self._full_map: Dict[int, Tuple[int, tuple]] = {}
        self._hash_of: Dict[int, int] = {}
        self._partial_map: Dict[int, Tuple[int, int, tuple]] = {}
        self._phys_partial: Dict[int, int] = {}
        # observability
        self.prefix_hits = 0
        self.prefix_tokens_reused = 0
        self.cow_copies = 0
        self.evictions = 0
        self.peak_blocks_active = 0
        # the multi-position verifier forward (speculative decoding only:
        # the counters are lazy, so other paged runs keep their exact
        # trace_counts dict). Its graph, one per S, holds the forward and
        # the verdict argmax; the carry install runs eagerly (spec_carry 0)
        if cfg.speculative:
            for name in ("verify", "spec_carry"):
                engine.trace_counts.setdefault(name, 0)
            model = self.model

            def verify_fused(params, tokens, caches):
                lg, caches = model.verify_step(params, tokens, caches)
                verdict = torch.argmax(lg[:, :-1], dim=-1)
                return (lg, verdict), caches

            self._verify = engine._graph_counted("verify", verify_fused)

    # ---------------------------------------------------------------- clock
    @property
    def clock(self) -> Optional[int]:
        """Paged slots have per-slot positions, not a shared clock."""
        return None

    def check_request(self, req) -> None:
        need = -(-(len(req.prompt) + req.max_new_tokens) // self.block_size)
        if need > self.num_blocks - 1:
            raise ValueError(
                f"request {req.request_id}: prompt + max_new_tokens needs "
                f"{need} KV blocks but the pool only has "
                f"{self.num_blocks - 1} allocatable blocks")

    # ------------------------------------------------------ block lifecycle
    def _alloc(self) -> int:
        """A fresh writable block (ref=1): free list first, then FIFO
        eviction of cached (ref==0, registered) prefix blocks."""
        if self._free:
            ph = self._free.pop()
        elif self._cached:
            ph = next(iter(self._cached))
            del self._cached[ph]
            h = self._hash_of.pop(ph)
            self._full_map.pop(h, None)
            ent = self._partial_map.pop(h, None)
            if ent is not None:
                self._phys_partial.pop(ent[0], None)
            self.evictions += 1
        else:
            raise RuntimeError(
                "paged KV pool exhausted despite admission reservation")
        self._ref[ph] = 1
        active = self.num_blocks - 1 - len(self._free) - len(self._cached)
        self.peak_blocks_active = max(self.peak_blocks_active, active)
        return ph

    def _pin(self, ph: int) -> None:
        if self._ref[ph] == 0:
            self._cached.pop(ph, None)
        self._ref[ph] += 1

    def _unref(self, ph: int) -> None:
        self._ref[ph] -= 1
        assert self._ref[ph] >= 0
        if self._ref[ph] == 0:
            if ph in self._hash_of:
                self._cached[ph] = None      # reclaimable, keeps its hash
            else:
                h = self._phys_partial.pop(ph, None)
                if h is not None:
                    self._partial_map.pop(h, None)
                self._free.append(ph)

    # ------------------------------------------------------- prefix lookup
    def _lookup(self, prompt) -> Tuple[List[int], Optional[Tuple[int, int]]]:
        """Longest registered prefix of ``prompt``: full blocks (capped so at
        least one suffix token remains to prefill) plus at most one partial
        tail share ``(phys, fill)`` whose values seed the side cache (the
        block itself is COWed by the suffix write)."""
        bs = self.block_size
        L = len(prompt)
        h = 0
        full: List[int] = []
        j = 0
        while (j + 1) * bs <= L - 1:
            blk = tuple(prompt[j * bs:(j + 1) * bs])
            h2 = hash((h, blk))
            ent = self._full_map.get(h2)
            if ent is None or ent[1] != blk:
                break
            full.append(ent[0])
            h = h2
            j += 1
        partial = None
        ent = self._partial_map.get(h)
        if ent is not None:
            ph, fill, toks = ent
            f = min(fill, (L - 1) - j * bs)
            if f > 0 and tuple(prompt[j * bs:j * bs + f]) == toks[:f]:
                partial = (ph, f)
        if partial is None and bs > 1 and (j + 1) * bs == L:
            # the prompt's own last block is registered in full but the
            # keep-one-suffix cap excludes it — share all but its last
            # position (identical prompts; triggers COW)
            blk = tuple(prompt[j * bs:L])
            ent = self._full_map.get(hash((h, blk)))
            if ent is not None and ent[1] == blk:
                partial = (ent[0], bs - 1)
        return full, partial

    def _register(self, prompt, table) -> None:
        bs = self.block_size
        L = len(prompt)
        h = 0
        for j in range(L // bs):
            blk = tuple(prompt[j * bs:(j + 1) * bs])
            h = hash((h, blk))
            if h not in self._full_map:
                ph = int(table[j])
                self._full_map[h] = (ph, blk)
                self._hash_of[ph] = h
        f = L % bs
        if f and h not in self._partial_map:
            ph = int(table[L // bs])
            if ph not in self._phys_partial and ph not in self._hash_of:
                self._partial_map[h] = (ph, f, tuple(prompt[L - f:L]))
                self._phys_partial[ph] = h

    def on_weight_swap(self) -> None:
        """Cached prefix K/V were computed under the outgoing weights —
        flush the registry (in-use shared blocks keep their refs; parked
        blocks go back to the free list)."""
        for ph in list(self._cached):
            self._free.append(ph)
        self._cached.clear()
        self._hash_of.clear()
        self._full_map.clear()
        self._partial_map.clear()
        self._phys_partial.clear()

    # ----------------------------------------------------------- admission
    def pick(self, queue, nfree: int, fresh: bool, limit_head: bool
             ) -> Tuple[List, Optional[int]]:
        """FCFS-with-skip under a conservative block budget: a request is
        admissible iff its full ``ceil((L + max_new)/bs)`` block need fits
        in free + evictable blocks net of outstanding reservations."""
        bs = self.block_size
        avail = len(self._free) + len(self._cached) - self._reserved
        chosen: List = []
        items = [queue[0]] if (limit_head and not fresh) else list(queue)
        for item in items:
            if len(chosen) >= nfree:
                break
            _, r = item
            need = -(-(len(r.prompt) + r.max_new_tokens) // bs)
            if need <= avail:
                chosen.append(item)
                avail -= need
        for item in chosen:
            queue.remove(item)
        return chosen, None

    def admit(self, chosen, slot_ids, clock, params) -> None:
        """Admit each request into its slot: prefix lookup → gather shared
        blocks → prefill the unshared suffix (batch 1, unpadded) →
        allocate/COW → scatter the written blocks into the pool. Blocks
        until the device work is done."""
        for (_, r), slot in zip(chosen, slot_ids):
            self._admit_one(slot, r, params)
        self.eng._sync()

    def _ensure_pool(self, lg) -> None:
        if self._cache is None:
            # the pool inherits the config's KV dtype (int8 codes + scale
            # pools under quantize_kv), as the side caches do
            dev = self.eng.device
            self._cache = self.model.init_cache(
                self.num_blocks, self.block_size,
                quantize_kv=self.cfg.quantize_kv, device=dev)
            # one logits buffer for the pool's life: the decode writes it,
            # admissions write their slot's row in place, sampling reads it
            self._logits = torch.zeros((self.max_slots, lg.shape[-1]),
                                       dtype=lg.dtype, device=lg.device)
            n = self.max_slots
            self._dec_tokens = torch.zeros((n, 1), dtype=torch.int64,
                                           device=dev)
            self._dec_pos = torch.zeros((n,), dtype=torch.int32, device=dev)
            self._dec_tables = torch.zeros((n, self.nb_per_slot),
                                           dtype=torch.int32, device=dev)
            pin = dev.type == "cuda"
            self._pos_host = torch.zeros((n,), dtype=torch.int32,
                                         pin_memory=pin)
            self._tables_host = torch.zeros((n, self.nb_per_slot),
                                            dtype=torch.int32,
                                            pin_memory=pin)
            self._cache["pos"] = self._dec_pos
            self._cache["block_tables"] = self._dec_tables

    def _pin_prefix(self, slot: int, prompt) -> Tuple[int, dict]:
        """The start of every paged admission: longest-registered-prefix
        lookup, pin the matched blocks (they leave the evictable cached set
        HERE, before any prefill work runs), and gather their values into
        the 1-row side cache whose clock becomes the shared length ``lp``.
        The pins are parked in ``_pending_pins``, not written into the
        slot's table until :meth:`_commit_blocks`."""
        bs = self.block_size
        full, partial = self._lookup(prompt)
        lp = len(full) * bs + (partial[1] if partial else 0)
        pinned = list(full)
        if partial:
            pinned.append(partial[0])
        for ph in pinned:
            self._pin(ph)
        self._pending_pins[slot] = pinned
        side = self.side_cache(1)
        if lp:
            side = gather_blocks(side, self._cache,
                                 self._device_index(pinned))
            side["pos"] = lp
            self.prefix_hits += 1
            self.prefix_tokens_reused += lp
        return lp, side

    def _commit_blocks(self, slot: int, prompt, lp: int, side, lg,
                       max_new: int) -> int:
        """The end of every paged admission: allocate / copy-on-write the
        write-range blocks, scatter the side-cache rows into them, place the
        last-token logits, register the prompt's blocks for prefix reuse,
        and set the slot's position to its prompt length. Returns the
        decode-only block remainder of the reservation."""
        bs = self.block_size
        L = len(prompt)
        self._ensure_pool(lg)
        table = self._tables[slot]
        for j, ph in enumerate(self._pending_pins.pop(slot, ())):
            table[j] = ph
        nb_prompt = -(-L // bs)
        first_wb = lp // bs
        for j in range(first_wb, nb_prompt):
            ph = int(table[j])
            if ph != TRASH:
                # shared block in the write range: the slot gets a private
                # copy; the side cache already holds the shared values, so
                # the scatter below materializes the copy
                self._unref(ph)
                self.cow_copies += 1
            table[j] = self._alloc()
        phys_w = self._device_index(table[first_wb:nb_prompt])
        self._cache = scatter_blocks(self._cache, side, phys_w, first_wb)
        self._logits[slot] = lg[0].to(self._logits.dtype)
        self._register(prompt, table)
        self._lengths[slot] = L
        return -(-(L + max_new) // bs) - nb_prompt

    def _admit_one(self, slot: int, r, params) -> None:
        prompt = [int(t) for t in r.prompt]
        lp, side = self._pin_prefix(slot, prompt)
        toks = torch.tensor([prompt[lp:]], dtype=torch.int64,
                            device=self.eng.device)
        if lp:
            lg, side = self.eng._prefill_chunk(params, {"tokens": toks}, side)
        else:
            lg, side = self.eng._prefill(params, {"tokens": toks}, side)
        rem = self._commit_blocks(slot, prompt, lp, side, lg,
                                  r.max_new_tokens)
        self._slot_reserved[slot] = rem
        self._reserved += rem

    # ----------------------------------------- chunked (multi-step) admission
    def reserve_pending(self, slot: int, req) -> None:
        """Reserve a chunked admission's FULL block budget before its first
        chunk runs, so resident decode allocations during the multi-step
        admission cannot consume the blocks it needs to land. Completion
        re-points the reservation at the decode-only remainder; abandonment
        releases it."""
        need = -(-(len(req.prompt) + req.max_new_tokens) // self.block_size)
        self._slot_reserved[slot] = need
        self._reserved += need

    def begin_chunked_admit(self, slot: int, req) -> Tuple[int, dict]:
        """First chunk step of a pending entry: prefix lookup + pin + gather
        (pinned here, before any chunk, so FIFO eviction between chunk steps
        cannot recycle a block the pending gathered from). Returns the
        shared-prefix length and the positioned side cache."""
        return self._pin_prefix(slot, [int(t) for t in req.prompt])

    def complete_chunked_admit(self, slot: int, req, lp: int, side,
                               lg) -> None:
        """A pending entry consumed its whole suffix: scatter the side cache
        into the slot's blocks at the slot's own prompt length and re-point
        the up-front reservation at the decode-only remainder."""
        rem = self._commit_blocks(slot, [int(t) for t in req.prompt], lp,
                                  side, lg, req.max_new_tokens)
        resv = int(self._slot_reserved[slot])
        self._reserved -= resv - rem
        self._slot_reserved[slot] = rem
        self.eng._sync()

    def chunk_inputs(self, tokens: np.ndarray, pos: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The static inputs of a chunk forward of ``tokens`` (1-D) at the
        host clock ``pos``: this width's ``(1, n)`` token buffer and the 0-d
        clock, filled in place after the host's bounds check (ValueError
        past ``max_len``). A blocking copy of a fresh host array: the chunk
        is synchronized right after anyway."""
        n = len(tokens)
        self.model.check_chunk(pos, self.model.chunk_rows(n),
                               self.cfg.max_len)
        dev = self.eng.device
        buf = self._chunk_tokens.get(n)
        if buf is None:
            buf = self._chunk_tokens[n] = torch.zeros((1, n),
                                                      dtype=torch.int64,
                                                      device=dev)
        if self._chunk_clock is None:
            self._chunk_clock = torch.zeros((), dtype=torch.int64, device=dev)
        buf.copy_(torch.from_numpy(np.asarray(tokens, np.int64)[None]))
        self._chunk_clock.fill_(pos)
        return buf, self._chunk_clock

    def abandon_chunked_admit(self, slot: int) -> None:
        """A forced swap abandons a pending entry mid-prefill: unpin the
        shared-prefix blocks it pinned at begin and release the slot's
        reserved-block budget."""
        for ph in self._pending_pins.pop(slot, ()):
            self._unref(ph)
        self.retire(slot)

    def check_invariants(self) -> None:
        """Test/debug hook: every non-trash block is in exactly one of
        {free, cached, active (ref > 0)}, reservations are non-negative and
        sum consistently, and every live table entry holds a reference."""
        free, cached = set(self._free), set(self._cached)
        assert TRASH not in free and TRASH not in cached
        assert len(free) == len(self._free), "block twice in the free list"
        assert not free & cached, "block in free AND cached"
        active = {ph for ph in range(1, self.num_blocks)
                  if self._ref[ph] > 0}
        assert not active & free and not active & cached, \
            "referenced block in free/cached"
        assert len(free) + len(cached) + len(active) + 1 == self.num_blocks
        assert all(self._ref[ph] == 0 for ph in free | cached)
        assert self._reserved == int(self._slot_reserved.sum()) >= 0
        assert np.all(self._slot_reserved >= 0)
        for pins in self._pending_pins.values():
            assert all(self._ref[ph] >= 1 for ph in pins), \
                "in-flight admission pin on unreferenced block"
        for s in range(self.max_slots):
            for j in range(self.nb_per_slot):
                ph = int(self._tables[s, j])
                assert ph == TRASH or self._ref[ph] >= 1, \
                    f"slot {s} table points at unreferenced block {ph}"

    # -------------------------------------------------------------- decode
    def _writable_block(self, i: int, j: int) -> None:
        """Make table entry ``(i, j)`` privately writable: allocate a
        reserved block at a TRASH boundary (drawing down the slot's
        reservation), or copy-on-write a block with other sharers."""
        ph = int(self._tables[i, j])
        if ph == TRASH:
            self._tables[i, j] = self._alloc()
            self._slot_reserved[i] -= 1
            self._reserved -= 1
        elif self._ref[ph] > 1:
            nb = self._alloc()
            # same stream as the decode write it protects: the copy lands
            # first
            self._cache = copy_block(self._cache, ph, nb)
            self._unref(ph)
            self._tables[i, j] = nb
            self.cow_copies += 1

    def _push_positions(self) -> None:
        """The step's positions and tables into the static buffers the
        (captured) decode step and verify forward read. Snapshots, not
        views: ``_lengths``/``_tables`` are mutated right after the forward
        is launched, so they are first copied into (pinned) staging buffers
        nothing else touches. The non-blocking copies from the staging are
        safe because it is next written at the next forward, after the
        step's host sync (the scheduler reading the sampled tokens, or a
        cycle's drafts and verdict, back) has waited for them."""
        self._pos_host.copy_(torch.from_numpy(self._lengths))
        self._tables_host.copy_(torch.from_numpy(self._tables))
        self._dec_pos.copy_(self._pos_host, non_blocking=True)
        self._dec_tables.copy_(self._tables_host, non_blocking=True)

    def decode(self, params, nxt, active_ids) -> None:
        bs = self.block_size
        for i in active_ids:
            self._writable_block(i, int(self._lengths[i]) // bs)
        self._push_positions()
        self._dec_tokens.copy_(nxt[:, None])
        self.eng._decode(params, self._dec_tokens, self._cache,
                         out=self._logits)
        self._lengths[active_ids] += 1

    # ------------------------------------------------- speculative verify
    def ensure_rows(self, slot: int, start: int, n: int) -> None:
        """Make positions ``start .. start+n-1`` of ``slot`` writable
        before a multi-position verify: allocate reserved blocks at TRASH
        boundaries exactly as decode does, and privatize (COW) any block
        with other sharers in the write range."""
        bs = self.block_size
        for j in range(start // bs, -(-(start + n) // bs)):
            self._writable_block(slot, j)

    def verify(self, params, tokens: torch.Tensor, active_ids):
        """One multi-position verifier forward over ``tokens`` (``(max_slots,
        S)`` on the device, ``[t0, d_1..d_k]`` per slot; a static buffer of
        the caller's, one per ``S``, as a captured forward reads it by
        address): slot ``b`` writes K/V for, and scores, positions
        ``lengths[b] .. lengths[b]+S-1``. Returns the ``(max_slots, S,
        vocab)`` logits, row ``j`` conditioned on everything through
        position ``lengths[b]+j``, and the ``(max_slots, S-1)`` verdict:
        ``verdict[b, j]`` is the token verifier-only decode emits after
        ``[t0, d_1..d_j]``. Active slots' lengths advance by S (the cycle
        rewinds the rejected suffix); inactive slots' tables are all-TRASH
        so their writes land in the trash block, as in decode."""
        s = int(tokens.shape[1])
        for i in active_ids:
            self.ensure_rows(i, int(self._lengths[i]), s)
        self._push_positions()
        (lg, verdict), _ = self._verify(params, tokens, self._cache)
        self._lengths[np.asarray(active_ids, np.int64)] += s
        return lg, verdict

    def carry_logits(self, lg, slot_ids, rows) -> None:
        """Install ``lg[slot, rows[slot]]`` as each listed slot's pending
        logits: the verifier row at the divergence point, carried into the
        scheduler's next sample, written in place into the logits buffer."""
        dev = self._logits.device
        idx = torch.as_tensor(np.asarray(slot_ids, np.int64), device=dev)
        sel = torch.as_tensor(np.asarray(rows, np.int64), device=dev)
        self._logits[idx] = lg[idx, sel].to(self._logits.dtype)

    def rewind(self, slot_id: int, n: int) -> None:
        """Roll ``slot_id`` back ``n`` positions (reject drafted tokens).

        A block that no longer holds any live position returns to the
        slot's *reservation* (``_slot_reserved``), never to another slot's
        budget: the slot drew down its reservation when it allocated the
        block and needs the claim back to finish its ``max_new_tokens``.
        The physical block itself goes through ``_unref``: an exclusively
        owned unregistered block lands on the free list (where the restored
        reservation keeps it claimable), a registered one parks in the
        cached set, and a block other slots still share just drops this
        slot's ref, so the free/cached/active partition and the ``free +
        cached - reserved`` admission budget both stay consistent."""
        if n <= 0:
            return
        new_len = int(self._lengths[slot_id]) - n
        assert new_len >= 0, "rewind past the start of the slot"
        for j in range(-(-new_len // self.block_size), self.nb_per_slot):
            ph = int(self._tables[slot_id, j])
            if ph != TRASH:
                self._unref(ph)
                self._tables[slot_id, j] = TRASH
                self._slot_reserved[slot_id] += 1
                self._reserved += 1
        self._lengths[slot_id] = new_len

    def retire(self, slot_id: int) -> None:
        """Drop the slot's refs; exclusively-owned unregistered blocks go
        back to the free list, registered ones park in the cached set."""
        for j in range(self.nb_per_slot):
            ph = int(self._tables[slot_id, j])
            if ph != TRASH:
                self._unref(ph)
                self._tables[slot_id, j] = TRASH
        self._lengths[slot_id] = 0
        self._reserved -= int(self._slot_reserved[slot_id])
        self._slot_reserved[slot_id] = 0

    # ------------------------------------------------------- observability
    def block_bytes(self) -> int:
        """Device bytes per physical block (all layers)."""
        if self._cache is None:
            return 0
        total = sum(t.numel() * t.element_size()
                    for t in _leaves(self._cache))
        return total // self.num_blocks

    def bytes_per_position(self) -> int:
        """Device KV bytes per cached position (all layers)."""
        return self.block_bytes() // self.block_size if self.block_size \
            else 0

    def pool_bytes(self) -> int:
        """Total device bytes held by the block pool (all layers)."""
        return self.block_bytes() * self.num_blocks

    def stats(self) -> Dict[str, Any]:
        free, cached = len(self._free), len(self._cached)
        return {"backend": self.backend,
                "quantize_kv": self.cfg.quantize_kv,
                "block_size": self.block_size,
                "bytes_per_position": self.bytes_per_position(),
                "pool_bytes": self.pool_bytes(),
                "blocks_total": self.num_blocks,
                "blocks_free": free,
                "blocks_cached": cached,
                "blocks_active": self.num_blocks - 1 - free - cached,
                "blocks_trash": 1,
                "blocks_reserved": self._reserved,
                "peak_blocks_active": self.peak_blocks_active,
                "block_bytes": self.block_bytes(),
                "prefix_hits": self.prefix_hits,
                "prefix_tokens_reused": self.prefix_tokens_reused,
                "cow_copies": self.cow_copies,
                "evictions": self.evictions}
