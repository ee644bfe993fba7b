"""KV-cache API for the serving engine.

Cache allocation and the decode-position clock are owned here, behind one
interface, so schedulers never touch cache dicts by hand.

* :class:`ContiguousKVCache` — one cache row per request, a single integer
  clock shared by every row, prompts left-padded to the round's longest.
  The round scheduler takes a fresh one per round (:meth:`KVCache.fresh`).

Not ported yet: the persistent slot pool of the continuous scheduler
(admission side caches, row scatter) and the paged backend (block tables,
prefix sharing, copy-on-write). ``ServeEngine`` refuses the configurations
that need them.
"""
from __future__ import annotations

from typing import Any, Dict

__all__ = ["KVCache", "ContiguousKVCache"]


class KVCache:
    """Backend-neutral KV-cache state owned on behalf of a scheduler.

    Use :meth:`create` (reads ``ServeConfig.kv_backend``)."""

    backend = "abstract"

    def __init__(self, engine):
        self.eng = engine
        self.cfg = engine.cfg
        self.model = engine.model
        self.max_slots = engine.cfg.max_slots or engine.cfg.max_batch

    @staticmethod
    def create(engine) -> "KVCache":
        """The one serving entry point for cache construction."""
        backend = getattr(engine.cfg, "kv_backend", "contiguous")
        if backend == "paged":
            raise NotImplementedError("not ported yet: kv_backend='paged'")
        return ContiguousKVCache(engine)

    # ------------------------------------------------------------- plumbing
    def fresh(self, rows: int) -> dict:
        """A standalone contiguous cache (the round scheduler's per-round
        cache) on the engine's device."""
        return self.model.init_cache(rows, self.cfg.max_len,
                                     quantize_kv=self.cfg.quantize_kv,
                                     device=self.eng.device)

    def check_request(self, req) -> None:
        """Backend-specific admissibility (beyond the shared horizon)."""

    def stats(self) -> Dict[str, Any]:
        return {"backend": self.backend}


class ContiguousKVCache(KVCache):
    """Contiguous layout: one row per request and one shared clock."""

    backend = "contiguous"
