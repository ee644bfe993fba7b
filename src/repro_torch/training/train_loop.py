"""Train step builder + fault-tolerant training loop.

``make_train_step`` supports:
* microbatch gradient accumulation (sequential slices of the batch,
  gradients summed in float32);
* data parallelism over a mesh (``mesh=``): every rank is handed the
  global batch, takes its slice over the ('pod', 'data') axes, and the
  gradients are averaged over those ranks in float32 (the numbers of the
  reference's FSDP over 'data', up to the order of the gradient sum);
* the int8 cross-pod gradient all-reduce with error feedback
  (``pod_compress=True`` on a mesh with a 'pod' axis of 2 or more): float32
  in-pod reduction over 'data', then ``grad_compression``'s int8 ring over
  'pod'.

Tensor-parallel execution over 'model' is not ported yet (M7b): a mesh
whose 'model' axis is larger than 1 raises ``NotImplementedError``.

``Trainer`` owns the loop: checkpoint every N steps, restart from the newest
checkpoint, preemption handling (SIGTERM → checkpoint + clean exit) and a
straggler monitor.
"""
from __future__ import annotations

import dataclasses
import signal
import threading
import time
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.models.transformer import n_periods
from repro_torch.training.grad_compression import (compress_local,
                                                   ring_allreduce_i8,
                                                   ring_pad, unflatten_grads)
from repro_torch.training.optimizer import (AdamWConfig, adamw_init,
                                            adamw_update, decay_mask,
                                            tree_leaves, tree_map)

_NOT_PORTED_TP = ("not ported yet: tensor-parallel execution over 'model' "
                  "(M7b)")


def _value_and_grad(loss_fn, params, batch):
    """``(loss, metrics, grads)`` of ``loss_fn(params, batch)``: gradients
    with respect to every leaf of ``params`` (zeros for a leaf the loss does
    not use), in each leaf's dtype; loss and metrics detached."""
    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    leaves = tree_leaves(live)
    with torch.enable_grad():
        loss, metrics = loss_fn(live, batch)
        gs = torch.autograd.grad(loss, leaves, allow_unused=True)
    by_leaf = {id(p): torch.zeros_like(p) if g is None else g
               for p, g in zip(leaves, gs)}
    grads = tree_map(lambda p: by_leaf[id(p)], live)
    metrics = {k: v.detach() for k, v in metrics.items()}
    return loss.detach(), metrics, grads


def _accumulate_grads(loss_fn, params, batch, microbatches: int):
    """Mean loss and grads over ``microbatches`` sequential slices of the
    batch (grads summed in float32, then divided); the metrics are the last
    microbatch's."""
    if microbatches <= 1:
        return _value_and_grad(loss_fn, params, batch)
    n = next(iter(batch.values())).shape[0]
    if n % microbatches:
        raise ValueError(f"batch {n} is not divisible into {microbatches} "
                         f"microbatches")
    per = n // microbatches
    gsum = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)
    lsum = None
    for i in range(microbatches):
        mb = {k: v[i * per:(i + 1) * per] for k, v in batch.items()}
        loss, metrics, g = _value_and_grad(loss_fn, params, mb)
        gsum = tree_map(lambda a, b: a + b.to(torch.float32), gsum, g)
        del g
        lsum = loss if lsum is None else lsum + loss
    grads = tree_map(lambda g: g / microbatches, gsum)
    return lsum / microbatches, metrics, grads


def make_train_step(model, opt_cfg: AdamWConfig, *, microbatches: int = 1,
                    pod_compress: bool = False, mesh=None,
                    grad_reduce_dtype: Optional[torch.dtype] = None
                    ) -> Callable:
    """Returns ``train_step(params, opt_state, batch) → (params, opt_state,
    metrics)``: ``batch`` holds tensors on the parameters' device, metrics
    ``loss``, ``xent``, ``moe_aux``, ``lr`` and ``grad_norm`` as 0-d
    tensors there (nothing is read back to the host).

    Weight decay falls on the leaves the reference decays for the same
    config: with ``scan_layers`` and more than one period its stack is
    stacked and decays the norm gains too (:func:`decay_mask`).

    ``grad_reduce_dtype`` casts the accumulated gradients before the
    update (the reference's wire-bytes option; the moments stay
    float32).

    ``mesh`` (a ``DeviceMesh``; every rank of it runs the step on the same
    global batch and keeps its own replica of the parameters): the step is
    data-parallel over the mesh's 'pod' and 'data' axes. With
    ``pod_compress`` and a 'pod' axis of 2 or more it returns
    ``train_step(params, opt_state, err, batch) → (params, opt_state,
    err, metrics)``: pod-local float32 gradients (all-reduced over
    'data'), ``compress_local`` with the pod's error-feedback row of
    ``err`` (:func:`init_pod_error`), the int8 ring over 'pod', ``/
    n_pods``, then AdamW; the metrics are averaged over the ranks. Without
    a 'pod' axis of 2 or more ``pod_compress`` is ignored, as in the
    reference. Set ``step.timed = True`` on the pod-compressed step to
    have each call leave its split (``step.split_ms``: grads, in-pod
    all-reduce, compress, ring, update) measured between synchronizations
    of the device.
    """
    sizes = {}
    if mesh is not None:
        from repro_torch.distributed.sharding import mesh_axis_sizes
        sizes = mesh_axis_sizes(mesh)
        if sizes.get("model", 1) > 1:
            raise NotImplementedError(_NOT_PORTED_TP)

    def loss_fn(p, b):
        return model.train_loss(p, b)

    stacked = model.cfg.scan_layers and n_periods(model.cfg) > 1

    def train_step(params, opt_state, batch):
        loss, metrics, grads = _accumulate_grads(loss_fn, params, batch,
                                                 microbatches)
        if grad_reduce_dtype is not None:
            grads = tree_map(lambda g: g.to(grad_reduce_dtype), grads)
        params, opt_state, info = adamw_update(
            params, grads, opt_state, opt_cfg, decay_mask(params, stacked))
        metrics = dict(metrics)
        metrics.update(info)
        metrics["loss"] = loss
        return params, opt_state, metrics

    if sizes.get("pod", 1) * sizes.get("data", 1) == 1:
        return train_step
    return _parallel_step(model, opt_cfg, mesh, sizes, loss_fn, stacked,
                          microbatches, grad_reduce_dtype,
                          pod_compress and sizes.get("pod", 1) >= 2)


class _Timer:
    """Host-clock split of a step between device synchronizations (only
    while ``on``)."""

    def __init__(self, on: bool, device):
        self.on, self.device, self.ms = on, device, {}
        self._t = time.perf_counter() if on else 0.0

    def mark(self, name: str) -> None:
        if not self.on:
            return
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        t = time.perf_counter()
        self.ms[name] = self.ms.get(name, 0.0) + (t - self._t) * 1e3
        self._t = t


def _parallel_step(model, opt_cfg, mesh, sizes, loss_fn, stacked,
                   microbatches, grad_reduce_dtype, compress):
    """The data-parallel (``compress=False``) or pod-compressed step over
    ``mesh`` (see :func:`make_train_step`)."""
    from repro_torch.distributed import group as dgroup
    n_pods = sizes.get("pod", 1)
    n_data = sizes.get("data", 1)
    world = n_pods * n_data
    pod = mesh.get_local_rank("pod") if "pod" in sizes else 0
    dat = mesh.get_local_rank("data") if "data" in sizes else 0
    part = pod * n_data + dat           # this rank's slice of the batch
    data_group = mesh.get_group("data") if n_data > 1 else None
    pod_group = mesh.get_group("pod") if n_pods > 1 else None
    dp_group = dgroup.mesh_group(mesh)  # 'model' is 1: the (pod, data) ranks

    def local_batch(batch):
        n = next(iter(batch.values())).shape[0]
        if n % world:
            raise ValueError(f"global batch {n} is not divisible over "
                             f"{world} data-parallel ranks")
        per = n // world
        return {k: v[part * per:(part + 1) * per] for k, v in batch.items()}

    def mean_metrics(loss, metrics, g):
        vals = [loss] + [metrics[k] for k in sorted(metrics)]
        flat = torch.stack([v.to(torch.float32).reshape(()) for v in vals])
        dgroup.all_reduce(flat, g)
        flat = flat / world
        out = {k: flat[i + 1] for i, k in enumerate(sorted(metrics))}
        return flat[0], out

    def grads_of(params, batch):
        loss, metrics, grads = _accumulate_grads(
            loss_fn, params, local_batch(batch), microbatches)
        if grad_reduce_dtype is not None:
            grads = tree_map(lambda g: g.to(grad_reduce_dtype), grads)
        return loss, metrics, grads

    def reduce_mean(grads, g, n):
        """The tree's mean over group ``g`` of ``n`` ranks, in float32, in
        one all-reduce of the flattened tree."""
        leaves = tree_leaves(grads)
        flat = torch.cat([x.reshape(-1).to(torch.float32) for x in leaves])
        dgroup.all_reduce(flat, g)
        flat = flat / n
        by_leaf, off = {}, 0
        for x in leaves:
            by_leaf[id(x)] = flat[off:off + x.numel()].reshape(x.shape) \
                .to(x.dtype)
            off += x.numel()
        return tree_map(lambda x: by_leaf[id(x)], grads)

    def update(params, opt_state, grads, loss, metrics):
        params, opt_state, info = adamw_update(
            params, grads, opt_state, opt_cfg, decay_mask(params, stacked))
        metrics = dict(metrics)
        metrics.update(info)
        metrics["loss"] = loss
        return params, opt_state, metrics

    if not compress:
        def dp_step(params, opt_state, batch):
            loss, metrics, grads = grads_of(params, batch)
            grads = reduce_mean(grads, dp_group, world)
            loss, metrics = mean_metrics(loss, metrics, dp_group)
            return update(params, opt_state, grads, loss, metrics)
        return dp_step

    def pod_step(params, opt_state, err, batch):
        timer = _Timer(pod_step.timed, dgroup.device())
        loss, metrics, grads = grads_of(params, batch)
        timer.mark("grads")
        if n_data > 1:                  # the in-pod float32 reduction
            grads = reduce_mean(grads, data_group, n_data)
        loss, metrics = mean_metrics(loss, metrics, dp_group)
        timer.mark("in_pod_all_reduce")
        mine = tree_map(lambda e: e[pod:pod + 1], err)
        flat, new_mine = compress_local(grads, mine)
        flat = ring_pad(flat, n_pods)
        timer.mark("compress")
        reduced = ring_allreduce_i8(flat, pod_group)
        timer.mark("ring")
        new_err = tree_map(lambda e: e.clone(), err)
        for e, m in zip(tree_leaves(new_err), tree_leaves(new_mine)):
            e[pod:pod + 1] = m
        grads = unflatten_grads(reduced / n_pods, params)
        params, opt_state, metrics = update(params, opt_state, grads, loss,
                                            metrics)
        timer.mark("update")
        pod_step.split_ms = timer.ms
        return params, opt_state, new_err, metrics

    pod_step.timed, pod_step.split_ms = False, {}
    return pod_step


def init_pod_error(params, n_pods: int):
    """Per-pod error-feedback buffers (leading pod dim). Each rank of the
    pod-compressed step reads and writes its own pod's row."""
    return tree_map(lambda p: torch.zeros((n_pods,) + tuple(p.shape),
                                          dtype=torch.float32,
                                          device=p.device), params)


def to_device(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """A batch of numpy arrays (or tensors) as tensors on ``device``."""
    return {k: (v if torch.is_tensor(v) else torch.from_numpy(
        np.ascontiguousarray(v))).to(device) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# fault-tolerant loop
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    checkpoint_every: int = 50
    checkpoint_dir: str = "repro_ckpt"
    async_checkpoint: bool = True
    log_every: int = 10
    straggler_factor: float = 3.0   # step > factor × EWMA ⇒ flag


class Trainer:
    """Checkpoint/restart training loop with preemption + straggler handling.

    Failure model: any step may die (process kill, preemption signal). On
    restart, ``run`` resumes from the newest complete checkpoint, restored
    into the structure of the params and optimizer state it is given.
    Batches (numpy arrays or tensors) go to ``device``: by default the
    current CUDA device, as every entry point of the package; pass
    ``device="cpu"`` for the host.
    """

    def __init__(self, model, opt_cfg: AdamWConfig, cfg: TrainerConfig,
                 train_step: Optional[Callable] = None, monitor=None,
                 device=None):
        from repro_torch.runtime.monitor import StepMonitor
        self.model = model
        self.opt_cfg = opt_cfg
        self.cfg = cfg
        self.device = torch.device("cuda", torch.cuda.current_device()) \
            if device is None else torch.device(device)
        self.train_step = train_step or make_train_step(model, opt_cfg)
        self.monitor = monitor or StepMonitor(cfg.straggler_factor)
        self._preempted = False

    def _install_signal_handler(self) -> Callable[[], None]:
        """SIGTERM sets the preemption flag (main thread only: signal
        handlers live there). Returns what puts the previous handler back."""
        if threading.current_thread() is not threading.main_thread():
            return lambda: None

        def handler(signum, frame):
            self._preempted = True
        old = signal.signal(signal.SIGTERM, handler)
        # None: the previous handler was not installed from Python; the
        # default action is what a process had before
        return lambda: signal.signal(
            signal.SIGTERM, signal.SIG_DFL if old is None else old)

    def run(self, params, data_iter, opt_state=None,
            step_hook: Optional[Callable] = None) -> Tuple[Any, Any, Dict]:
        """Train from the newest checkpoint in ``checkpoint_dir`` (else from
        ``params`` and ``opt_state``) to ``total_steps``; returns (params,
        opt_state, {"history": losses, "stragglers": flagged steps}). The
        SIGTERM handler is installed for the run and removed after it."""
        restore = self._install_signal_handler()
        try:
            return self._run(params, data_iter, opt_state, step_hook)
        finally:
            restore()

    def _run(self, params, data_iter, opt_state, step_hook):
        import torch.distributed as dist
        from repro_torch.checkpoint.checkpointer import Checkpointer
        # a data-parallel step keeps one replica a rank: rank 0 writes it
        ckpt = Checkpointer(self.cfg.checkpoint_dir,
                            async_save=self.cfg.async_checkpoint,
                            writer=not dist.is_initialized()
                            or dist.get_rank() == 0)
        opt_state = opt_state if opt_state is not None else adamw_init(params)
        start_step = 0
        if ckpt.list_steps():
            params, opt_state, start_step = ckpt.restore_latest(
                template=(params, opt_state), device=self.device)
            print(f"[trainer] resumed from step {start_step}", flush=True)
        history = []
        for step in range(start_step, self.cfg.total_steps):
            batch = to_device(next(data_iter), self.device)
            t0 = time.perf_counter()
            params, opt_state, metrics = self.train_step(params, opt_state,
                                                         batch)
            loss = float(metrics["loss"])          # the step's one sync
            dt = time.perf_counter() - t0
            if self.monitor.record(dt):
                print(f"[trainer] straggler: step {step} took {dt*1e3:.0f}ms "
                      f"(ewma {self.monitor.ewma*1e3:.0f}ms)", flush=True)
            history.append(loss)
            if step % self.cfg.log_every == 0:
                print(f"[trainer] step {step} loss {loss:.4f} "
                      f"({dt*1e3:.0f} ms)", flush=True)
            if step_hook is not None:
                step_hook(step, params, metrics)
            done = step + 1
            if done % self.cfg.checkpoint_every == 0 or self._preempted \
                    or done == self.cfg.total_steps:
                ckpt.save(done, params, opt_state)
            if self._preempted:
                print(f"[trainer] preempted at step {done}; "
                      "checkpoint committed, exiting", flush=True)
                break
        ckpt.wait()
        return params, opt_state, {"history": history,
                                   "stragglers": self.monitor.flagged}
