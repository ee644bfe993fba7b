"""Versioned quantized weight store for the serving engine.

SQuant's data-free cost makes quantize-on-reload viable inside a live serving
loop: fresh fp weights can be quantized *while serving continues* and swapped
in between decode rounds. This module owns that machinery so the engine never
touches ``quantize_tree`` directly.

Model
-----
* ``WeightVersion`` — an immutable (version, params, report, provenance)
  snapshot. Versions increase monotonically per store.
* ``WeightStore`` — double-buffered: exactly one **live** version (what
  rounds currently read) and at most one **staged** version (fully built,
  device-resident, waiting to be swapped in). Staging happens on a
  background worker (latest request wins); the swap itself is a pointer
  flip a scheduler performs only at its swap points via
  :meth:`WeightStore.acquire` — round boundaries for the round scheduler —
  so an in-flight round can never observe a torn tree: it holds the
  ``WeightVersion`` it started with.

Not ported yet: ``watch()`` over a checkpoint directory (waits for the
checkpoint module) and the speculative draft pipeline.
"""
from __future__ import annotations

import collections
import dataclasses
import queue
import threading
import time
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.quant.qtypes import QuantReport


@dataclasses.dataclass(frozen=True)
class WeightVersion:
    """One immutable generation of serving weights. ``draft_params`` is kept
    for the speculative drafter tree and is None until that is ported."""
    version: int                       # monotonically increasing, from 1
    params: Any                        # serving tree (fp, fake-quant, quantized)
    report: Optional[QuantReport] = None
    source: str = "init"               # "init" | caller tag
    step: Optional[int] = None         # checkpoint step, when applicable
    staged_ms: float = 0.0             # quantize/prepare + device wall time
    draft_params: Any = None


def make_weight_pipeline(model, cfg, device=None):
    """``(model', quantize_fn, prepare_fn)`` for a ``ServeConfig``.

    ``quantize_fn`` maps an fp tree to ``(serving_tree, QuantReport | None)``
    per the config (identity when ``cfg.quantize_weights`` is None), running
    on ``device``. A stacked ``{"periods": ...}`` tree is unrolled first —
    the port's stack is always the layer list. ``prepare_fn`` normalizes an
    already-quantized serving tree the same way.
    """
    from repro_torch.core.pipeline import quantize_tree
    from repro_torch.models.model import build_model
    from repro_torch.models.transformer import n_periods, unstack_stack

    base_cfg = model.cfg
    model = build_model(dataclasses.replace(base_cfg, scan_layers=False))

    def _unstack(tree):
        if isinstance(tree, dict) and "periods" in tree.get("stack", {}):
            tree = dict(tree)
            tree["stack"] = unstack_stack(tree["stack"], n_periods(base_cfg))
        return tree

    def quantize_fn(fp_tree):
        fp_tree = _unstack(fp_tree)
        if not cfg.quantize_weights:
            return fp_tree, None
        return quantize_tree(fp_tree, method=cfg.quantize_weights,
                             bits=cfg.weight_bits,
                             dequantize=cfg.dequantize_for_compute,
                             device=device)

    return model, quantize_fn, _unstack


class WeightStore:
    """Double-buffered, versioned owner of serving weights.

    Exactly one of ``fp_params`` / ``serving_params`` seeds version 1:
    ``fp_params`` goes through ``quantize_fn``; ``serving_params`` is an
    already-serving-format tree (through ``prepare_fn``).
    """

    def __init__(self, quantize_fn: Optional[Callable] = None,
                 fp_params: Any = None, *, serving_params: Any = None,
                 prepare_fn: Optional[Callable] = None,
                 report: Optional[QuantReport] = None, source: str = "init",
                 device=None):
        if (fp_params is None) == (serving_params is None):
            raise ValueError("provide exactly one of fp_params or "
                             "serving_params")
        self._quantize_fn = quantize_fn
        self._prepare_fn = prepare_fn or (lambda t: t)
        self._device = None if device is None else torch.device(device)
        self._lock = threading.Lock()
        self._counter = 0
        self._live: Optional[WeightVersion] = None
        self._staged: Optional[WeightVersion] = None
        self._queue: "queue.Queue" = queue.Queue()
        self._worker: Optional[threading.Thread] = None
        self._staged_at = 0.0             # monotonic time of last staging
        self.swap_count = 0
        # bounded: a persistently failing stager must not grow memory
        self.errors: collections.deque = collections.deque(maxlen=256)
        self._build_and_publish(fp_params, serving_params, report, source,
                                None)
        with self._lock:
            self._live, self._staged = self._staged, None

    # ------------------------------------------------------------- accessors
    @property
    def current(self) -> WeightVersion:
        """The live version (no swap — see :meth:`acquire`)."""
        with self._lock:
            return self._live

    @property
    def version(self) -> int:
        return self.current.version

    @property
    def staged_pending(self) -> bool:
        """True when a fully-built version is waiting to be swapped in."""
        with self._lock:
            return self._staged is not None

    def staged_info(self):
        """:class:`repro_torch.serving.api.StagedInfo` for the staged
        version, or None."""
        from repro_torch.serving.api import StagedInfo
        with self._lock:
            if self._staged is None:
                return None
            return StagedInfo(
                version=self._staged.version,
                age_ms=(time.monotonic() - self._staged_at) * 1e3)

    def acquire(self) -> Tuple[WeightVersion, float]:
        """Swap in any fully-staged version and return ``(live, swap_ms)``.

        This is the ONLY place a new version becomes live. The engine calls
        it at decode-round boundaries; the returned snapshot stays valid for
        the whole round regardless of concurrent staging.
        """
        t0 = time.perf_counter()
        with self._lock:
            if self._staged is not None:
                self._live, self._staged = self._staged, None
                self.swap_count += 1
            live = self._live
        return live, (time.perf_counter() - t0) * 1e3

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            live, staged = self._live, self._staged
            return {"version": live.version, "source": live.source,
                    "step": live.step, "staged_ms": live.staged_ms,
                    "versions_built": self._counter,
                    "swaps": self.swap_count,
                    "staged_pending": staged is not None,
                    "staged_version":
                        staged.version if staged is not None else None,
                    "watching": False,
                    "errors": list(self.errors)}

    # --------------------------------------------------------------- staging
    def _build_and_publish(self, fp_params, serving_params, report, source,
                           step):
        t0 = time.perf_counter()
        if serving_params is not None:
            tree, rep = self._prepare_fn(serving_params), report
        else:
            if self._quantize_fn is None:
                raise ValueError("store has no quantize_fn; cannot stage "
                                 "fp params")
            tree, rep = self._quantize_fn(fp_params)
        # materialize now so the round-boundary swap is a pointer flip
        if self._device is not None and self._device.type == "cuda":
            torch.cuda.synchronize(self._device)
        staged_ms = (time.perf_counter() - t0) * 1e3
        with self._lock:
            self._counter += 1
            self._staged = WeightVersion(self._counter, tree, rep, source,
                                         step, staged_ms)
            self._staged_at = time.monotonic()

    def stage(self, fp_params: Any = None, *, serving_params: Any = None,
              report: Optional[QuantReport] = None, source: str = "manual",
              step: Optional[int] = None, block: bool = False):
        """Quantize/prepare a new weight tree and stage it for the next swap.

        ``block=False`` hands the work to the background worker (latest
        request wins if several arrive while one is building);
        ``block=True`` builds synchronously in the caller's thread.
        """
        if (fp_params is None) == (serving_params is None):
            raise ValueError("provide exactly one of fp_params or "
                             "serving_params")
        if block:
            self._build_and_publish(fp_params, serving_params, report,
                                    source, step)
            return
        self._queue.put((fp_params, serving_params, report, source, step))
        with self._lock:
            if self._worker is None or not self._worker.is_alive():
                self._worker = threading.Thread(target=self._stage_loop,
                                                daemon=True)
                self._worker.start()

    def _stage_loop(self):
        while True:
            req = self._queue.get()
            if req is None:
                return
            try:            # drain: only the newest pending request matters
                while True:
                    nxt = self._queue.get_nowait()
                    if nxt is None:
                        return
                    req = nxt
            except queue.Empty:
                pass
            try:
                self._build_and_publish(*req)
            except Exception as e:          # serving must outlive bad stages
                with self._lock:
                    self.errors.append(f"stage({req[3]}) failed: {e!r}")

    def wait_staged(self, version: Optional[int] = None,
                    timeout: float = 30.0) -> bool:
        """Block until a version newer than ``version`` (default: current
        live) has been built (staged or already swapped in)."""
        base = self.version if version is None else version
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._lock:
                if self._counter > base:
                    return True
            time.sleep(0.005)
        return False

    def watch(self, ckpt_dir, poll_s: float = 1.0, expect=None):
        raise NotImplementedError(
            "not ported yet: WeightStore.watch (checkpoint hot-reload)")

    def close(self):
        """Stop the staging worker (idempotent)."""
        if self._worker is not None and self._worker.is_alive():
            self._queue.put(None)
            self._worker.join(timeout=5)
        self._worker = None
