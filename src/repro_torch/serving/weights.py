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
  ``WeightVersion`` it started with. The continuous scheduler reports each
  drain/swap through :meth:`WeightStore.note_drain`/:meth:`note_swap`.

* ``watch()`` — a poll thread over a checkpoint directory
  (``checkpoint.Checkpointer`` layout). New COMMITTED steps are restored
  (torn/corrupt step dirs are skipped), validated against the serve
  config's quant expectations, and staged: quantized checkpoints
  (``w_q``/``w_q4``/``w_scale`` serving trees) are served directly with no
  re-quantization; fp checkpoints go through the store's quantize_fn.

Speculative serving stages a (target, draft) pair per version: both trees
quantized from the one fp source (:func:`make_draft_quantize_fn`), swapped
together, so a reload can never mix generations.

On a CUDA device every stage (restore, quantize, prepare) runs on the
store's own stream, which first waits on the device for the work already
issued on the calling thread's stream (the inputs a stage may read), and
is the only stream the stage synchronizes: the scheduler, which
synchronizes its own stream, never waits for a stage, and no stage makes a
device-wide synchronization while the scheduler's thread may be capturing
a CUDA graph. Reshard-on-restore (``mesh=``) is not ported yet (M7).
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import queue
import threading
import time
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.quant.qtypes import QuantReport


@dataclasses.dataclass(frozen=True)
class WeightVersion:
    """One immutable generation of serving weights. ``draft_params``: the
    speculative drafter's tree, quantized from the same fp source (None
    unless the store has a draft pipeline)."""
    version: int                       # monotonically increasing, from 1
    params: Any                        # serving tree (fp, fake-quant, quantized)
    report: Optional[QuantReport] = None
    source: str = "init"               # "init" | "ckpt:<step>" | caller tag
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

    _unstack = _unstacker(model.cfg)
    model = build_model(dataclasses.replace(model.cfg, scan_layers=False))

    def quantize_fn(fp_tree):
        fp_tree = _unstack(fp_tree)
        if not cfg.quantize_weights:
            return fp_tree, None
        return quantize_tree(fp_tree, method=cfg.quantize_weights,
                             bits=cfg.weight_bits,
                             dequantize=cfg.dequantize_for_compute,
                             device=device)

    return model, quantize_fn, _unstack


def _unstacker(base_cfg):
    """A stacked ``{"periods": ...}`` tree → the unrolled layer list (other
    trees pass through)."""
    from repro_torch.models.transformer import n_periods, unstack_stack

    def unstack(tree):
        if isinstance(tree, dict) and "periods" in tree.get("stack", {}):
            tree = dict(tree)
            tree["stack"] = unstack_stack(tree["stack"], n_periods(base_cfg))
        return tree
    return unstack


def make_draft_quantize_fn(model, cfg, device=None):
    """``fp tree -> draft serving tree`` for self-speculative serving.

    The drafter is the same checkpoint quantized at ``cfg.draft_bits``
    (data-free, sub-second: SQuant makes draft models free), in the serving
    format of the target pipeline (:func:`make_weight_pipeline`), on
    ``device``. When the target serves fp (``quantize_weights`` None) the
    drafter still quantizes, with 'squant': the ladder needs a cheaper tree
    below the verifier."""
    from repro_torch.core.pipeline import quantize_tree

    unstack = _unstacker(model.cfg)
    method = cfg.quantize_weights or "squant"

    def draft_fn(fp_tree):
        tree, _ = quantize_tree(unstack(fp_tree), method=method,
                                bits=cfg.draft_bits,
                                dequantize=cfg.dequantize_for_compute,
                                device=device)
        return tree

    return draft_fn


class WeightStore:
    """Double-buffered, versioned owner of serving weights.

    Exactly one of ``fp_params`` / ``serving_params`` seeds version 1:
    ``fp_params`` goes through ``quantize_fn``; ``serving_params`` is an
    already-serving-format tree (through ``prepare_fn``).
    """

    def __init__(self, quantize_fn: Optional[Callable] = None,
                 fp_params: Any = None, *, serving_params: Any = None,
                 prepare_fn: Optional[Callable] = None,
                 draft_quantize_fn: Optional[Callable] = None,
                 report: Optional[QuantReport] = None, source: str = "init",
                 device=None):
        if (fp_params is None) == (serving_params is None):
            raise ValueError("provide exactly one of fp_params or "
                             "serving_params")
        self._quantize_fn = quantize_fn
        self._prepare_fn = prepare_fn or (lambda t: t)
        # speculative serving: fp tree -> drafter tree, built beside the
        # target in _build_and_publish so every version is a (target,
        # draft) pair. It needs an fp source: a quantized serving tree
        # cannot rebuild the drafter, so such a stage fails (into
        # ``errors`` on the background path) and serving continues on the
        # previous pair
        self._draft_quantize_fn = draft_quantize_fn
        self._device = None if device is None else torch.device(device)
        # the stages' own stream (see the module docstring)
        self._stream = torch.cuda.Stream(self._device) \
            if self._device is not None and self._device.type == "cuda" \
            else None
        self._lock = threading.Lock()
        self._counter = 0
        self._live: Optional[WeightVersion] = None
        self._staged: Optional[WeightVersion] = None
        self._queue: "queue.Queue" = queue.Queue()
        self._worker: Optional[threading.Thread] = None
        self._watch_stop: Optional[threading.Event] = None
        self._watch_thread: Optional[threading.Thread] = None
        self._last_ckpt_step = -1
        self._ckpt_retries = 0            # transient-failure retries per step
        self._staged_at = 0.0             # monotonic time of last staging
        self.swap_count = 0
        # reload-aware scheduler observability (note_drain/note_swap)
        self.drain_count = 0
        self.forced_swap_count = 0
        self.last_drain_ms = 0.0
        self.last_drain_in_flight = 0
        # bounded: a persistently failing watcher (e.g. deleted ckpt dir)
        # appends per poll and must not grow a long-lived server's memory
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

    # ------------------------------------------------- scheduler drain hooks
    def note_drain(self, in_flight: int = 0) -> None:
        """A scheduler observed the staged version and began draining
        (stopped admitting) with ``in_flight`` slots still decoding."""
        with self._lock:
            self.drain_count += 1
            self.last_drain_in_flight = in_flight

    def note_swap(self, forced: bool = False, drain_ms: float = 0.0) -> None:
        """A scheduler swapped after draining for ``drain_ms``; ``forced``
        means the swap deadline expired with slots still in flight."""
        with self._lock:
            if forced:
                self.forced_swap_count += 1
            self.last_drain_ms = drain_ms

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
                    "drains": self.drain_count,
                    "forced_swaps": self.forced_swap_count,
                    "last_drain_ms": self.last_drain_ms,
                    "last_drain_in_flight": self.last_drain_in_flight,
                    "staged_pending": staged is not None,
                    "staged_version":
                        staged.version if staged is not None else None,
                    "watching": self._watch_thread is not None,
                    "errors": list(self.errors)}

    # --------------------------------------------------------------- staging
    def _staging(self):
        """The context a stage runs in: the store's stream, made to wait
        for what the calling thread's stream has issued so far."""
        if self._stream is None:
            return contextlib.nullcontext()
        self._stream.wait_stream(torch.cuda.current_stream(self._device))
        return torch.cuda.stream(self._stream)

    def _build_and_publish(self, fp_params, serving_params, report, source,
                           step):
        t0 = time.perf_counter()
        with self._staging():
            if serving_params is not None:
                tree, rep = self._prepare_fn(serving_params), report
            else:
                if self._quantize_fn is None:
                    raise ValueError("store has no quantize_fn; cannot stage "
                                     "fp params")
                tree, rep = self._quantize_fn(fp_params)
            draft = None
            if self._draft_quantize_fn is not None:
                if fp_params is None:
                    raise ValueError(
                        "speculative serving stages (target, draft) pairs "
                        "from one fp source; a quantized-native serving "
                        "tree cannot rebuild the drafter — reload fp "
                        "checkpoints instead")
                draft = self._draft_quantize_fn(fp_params)
            # materialize now so the round-boundary swap is a pointer flip
            if self._stream is not None:
                self._stream.synchronize()
        staged_ms = (time.perf_counter() - t0) * 1e3
        with self._lock:
            self._counter += 1
            self._staged = WeightVersion(self._counter, tree, rep, source,
                                         step, staged_ms, draft)
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

    # ------------------------------------------------------ checkpoint watch
    def poll_checkpoints(self, checkpointer, expect: Optional[dict] = None,
                         mesh=None) -> Optional[int]:
        """One watcher step: stage the newest unseen COMMITTED checkpoint.

        Torn step dirs (no COMMITTED) and corrupt ``index.json`` are
        invisible via ``list_steps``. Failures are recorded in ``errors``;
        metadata mismatches (permanent) are never retried, transient
        restore/stage failures are retried on the next few polls before the
        step is given up on. Returns the staged step, or None. The restore
        runs on the store's stream, onto the store's device (default: the
        current CUDA device).
        """
        from repro_torch.checkpoint.checkpointer import CheckpointMetaError

        if mesh is not None:
            raise NotImplementedError(
                "not ported yet: reshard-on-restore (M7)")
        steps = checkpointer.list_steps()
        if not steps or steps[-1] < self._last_ckpt_step or (
                steps[-1] == self._last_ckpt_step and
                self._ckpt_retries == 0):
            return None
        step = steps[-1]
        if step > self._last_ckpt_step:
            self._last_ckpt_step, self._ckpt_retries = step, 3
        try:
            with self._staging():
                tree, meta, _ = checkpointer.restore_serving(
                    step, expect=expect, device=self._device)
            src = f"ckpt:{step}"
            if meta.get("format") == "quantized":
                self.stage(serving_params=tree, source=src, step=step,
                           block=True)
            else:
                self.stage(fp_params=tree, source=src, step=step,
                           block=True)
        except CheckpointMetaError as e:
            self._ckpt_retries = 0       # permanent: wrong bits/method
            with self._lock:
                self.errors.append(f"reload step {step} rejected: {e}")
            return None
        except Exception as e:
            self._ckpt_retries -= 1      # transient? retry a few polls
            with self._lock:
                self.errors.append(f"reload step {step} failed "
                                   f"({self._ckpt_retries} retries left): "
                                   f"{e!r}")
            return None
        self._ckpt_retries = 0
        return step

    def watch(self, ckpt_dir, poll_s: float = 1.0,
              expect: Optional[dict] = None, mesh=None):
        """Poll ``ckpt_dir`` (a path or a ``Checkpointer``) in a daemon
        thread and stage new steps."""
        from repro_torch.checkpoint.checkpointer import Checkpointer
        if mesh is not None:
            raise NotImplementedError(
                "not ported yet: reshard-on-restore (M7)")
        ck = Checkpointer(ckpt_dir, async_save=False) \
            if isinstance(ckpt_dir, str) else ckpt_dir
        if self._watch_thread is not None:
            raise RuntimeError("already watching a checkpoint directory")
        self._watch_stop = threading.Event()

        def loop():
            while not self._watch_stop.wait(poll_s):
                try:
                    self.poll_checkpoints(ck, expect=expect)
                except Exception as e:
                    with self._lock:
                        self.errors.append(f"watcher: {e!r}")

        self._watch_thread = threading.Thread(target=loop, daemon=True)
        self._watch_thread.start()

    def close(self):
        """Stop the watcher and the staging worker (idempotent)."""
        if self._watch_stop is not None:
            self._watch_stop.set()
            self._watch_thread.join(timeout=5)
            self._watch_thread, self._watch_stop = None, None
        if self._worker is not None and self._worker.is_alive():
            self._queue.put(None)
            self._worker.join(timeout=5)
        self._worker = None
